#!/usr/bin/env python3
"""Run the visco benchmark cell's checks of ``chip_smoke.py`` alone on one
CUDA card, after building the wave kernels: K14 bitwise at the cell's
(187, 401, 401) window with its free-surface sponge (``chip_smoke.k14_window``,
part of phase 1) and phase 71 (``chip_smoke.visco_window``), a short
``multishot_q_wave_operator`` gradient at the cell's geometry whose K14
launches and step counters are counted and whose φ, (δc, δQ) and traces
equal the plain route's bit for bit.

    python3 tools/smoke_visco.py

Prints the K14 check's line, the phase's line, its launches and the card's
name and power limit.
"""
from __future__ import annotations

import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("smoke_visco: this script needs a CUDA card")
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
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; wave kernels built in "
          f"{time.perf_counter() - t0:.1f} s [{smi}]", flush=True)
    err = chip_smoke.k14_window(torch.Generator(device="cuda").manual_seed(1))
    chip_smoke.log(1, f"K14 bitwise and in place at {chip_smoke.Q_WINDOW}, orders 2/4/8, f32 "
                      f"and bf16 friction fields, free-surface sponge of 20 cells: max abs "
                      f"err {err}")
    print("phase 71 launches", chip_smoke.visco_window(smi), flush=True)
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
