#!/usr/bin/env python3
"""Run phases 62-64 of ``chip_smoke.py`` alone on one CUDA card: the
``"vmap"`` stacks with ``remat_blocks`` (``chip_smoke.vmap_remat``) and the
``utils`` layer (``chip_smoke.utils_path``), after building the kernels.

    python3 tools/smoke_phases.py [--skip-62]

The 256³ velocity model and the wave keywords are built as
``chip_smoke.main`` builds them (1500 m/s plus four seeded Gaussian
anomalies, dt 5e-4, dx 10, 15 Hz, sponge 12, 128 receivers). Prints the
phases' lines, each with the card's name and power limit, and their
launch counts.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--skip-62", action="store_true", help="run phases 63-64 only")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("smoke_phases: this script needs a CUDA card")
    import chip_smoke
    from jets_tpu_torch import kernels

    t0 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    kernels.build_all()
    for name in kernels.SOURCES:
        kernels.load_library(name)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; kernels built in "
          f"{time.perf_counter() - t0:.1f} s [{smi}]", flush=True)
    dev, shape = torch.device("cuda"), (256, 256, 256)
    rs = np.random.default_rng(0)
    axis = torch.arange(256, dtype=torch.float32, device=dev)
    c_true = torch.full(shape, 1500.0, device=dev)
    for _ in range(4):
        (cz, cy, cx), a, sig = rs.uniform(48, 208, 3), rs.uniform(-80, 80), rs.uniform(12, 32)
        gz, gy, gx = (torch.exp(-0.5 * ((axis - float(o)) / sig) ** 2) for o in (cz, cy, cx))
        c_true += a * (gz[:, None, None] * gy[None, :, None] * gx[None, None, :])
    rcv = [int(np.ravel_multi_index((128, 128, x), shape)) for x in range(0, 256, 2)]
    wkw = dict(dt=5e-4, dx=10.0, freq=15.0, rcv_idx=rcv, sponge_width=12)
    if not args.skip_62:
        print("phase 62 launches", chip_smoke.vmap_remat(smi, c_true, wkw), flush=True)
    print("phases 63-64 launches", chip_smoke.utils_path(smi, c_true, wkw), flush=True)
    print(f"total {time.perf_counter() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
