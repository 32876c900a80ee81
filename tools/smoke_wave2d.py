#!/usr/bin/env python3
"""Run phase 70 of ``chip_smoke.py`` alone on one CUDA card: the batched
2-D pair K4-2D/K5-2D (``chip_smoke.wave2d_pair``), after building the wave
kernels.

    python3 tools/smoke_wave2d.py

Prints the ptxas lines of the 2-D kernels, the phase's line (bitwise checks,
times against the plain versions and the bound, the counted 2-D vmap
gradient), the kernels' rows and the card's name and power limit.
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
        raise SystemExit("smoke_wave2d: this script needs a CUDA card")
    import chip_smoke
    from jets_tpu_torch import kernels

    t0 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    kernels.build_all(["wave"])
    kernels.load_library("wave")
    ptxas = [ln for ln in kernels.nvcc_log("wave").splitlines() if "2d" in ln or "Used" in ln]
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; wave kernels built in "
          f"{time.perf_counter() - t0:.1f} s [{smi}]", flush=True)
    print("\n".join(ptxas), flush=True)
    counts, rows = chip_smoke.wave2d_pair(smi)
    print("phase 70 launches", counts, flush=True)
    print(json.dumps({"kernels": rows}))
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
