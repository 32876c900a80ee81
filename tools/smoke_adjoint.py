#!/usr/bin/env python3
"""Run phase 73 of ``chip_smoke.py`` alone on one CUDA card, after building
the wave kernels: K5 (``cuda_wave.fused_adjoint_step``, the stored-wavefield
adjoint step) bitwise its plain twin at the isotropic gradient cell's (187,
401, 401) window, the z-slabs and two ragged shapes, and its times at the
window (order 8) and at 256^3 (order 2) with an int8 history against its
bound, the twin and the wrapper (``chip_smoke.adjoint_march``).

    python3 tools/smoke_adjoint.py

Prints ptxas's registers, spills and shared memory of K5's instantiations,
the phase's line, the kernel's row as JSON and the card's name and power
limit.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("smoke_adjoint: this script needs a CUDA card")
    import chip_smoke
    from jets_tpu_torch import kernels

    t0 = time.perf_counter()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    kernels.build_all(["wave"])
    kernels.load_library("wave")
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; wave kernels built in "
          f"{time.perf_counter() - t0:.1f} s [{smi}]", flush=True)
    lines = kernels.nvcc_log("wave").splitlines()
    for i, line in enumerate(lines):  # each entry's stack, spill and register lines
        if "Compiling entry function" in line and "14adjoint_kernelI" in line:
            print(line.strip(), "|", " | ".join(x.strip() for x in lines[i + 1:i + 4]))
    launched, rows = chip_smoke.adjoint_march(smi)
    print(json.dumps({"launches": launched, "kernels": rows}))
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
