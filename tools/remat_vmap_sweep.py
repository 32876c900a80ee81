#!/usr/bin/env python3
"""Peak device memory and time of the ``"vmap"`` shot stack's gradient over
``remat_blocks`` on one CUDA card.

    python3 tools/remat_vmap_sweep.py [--blocks 1 4 6 12 24] [--shots 4]
        [--nt 120] [--n 256]

Builds ``multishot_wave_operator`` on an ``n``³ float32 grid (the wave
stages' geometry of ``chip_smoke.py``: dt 5e-4, dx 10, 15 Hz, sponge 12,
128 receivers on the x-line through the centre) with ``shot_map="vmap"``
and, for each ``remat_blocks``, takes the autograd gradient of
``0.5||F(c) - d||^2`` and the derived adjoint ``linearize(c).H(r)``
(``chip_smoke._grad_and_adjoint``), printing each one's peak device memory
above its start and its seconds, with the card's name and power limit.
Each segment keeps its two boundary fields per shot and the backward one
segment's tape, so the peak follows ``a·B + t·nt/B + w``.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--blocks", type=int, nargs="+", default=[1, 4, 6, 12, 24])
    ap.add_argument("--shots", type=int, default=4)
    ap.add_argument("--nt", type=int, default=120)
    ap.add_argument("--n", type=int, default=256)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("remat_vmap_sweep: this script needs a CUDA card")
    import chip_smoke
    from jets_tpu_torch.ops.wave import multishot_wave_operator

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    n, dev = args.n, torch.device("cuda")
    shape = (n, n, n)
    rcv = [int(np.ravel_multi_index((n // 2, n // 2, x), shape)) for x in range(0, n, 2)]
    kw = dict(dt=5e-4, dx=10.0, freq=15.0, rcv_idx=rcv, sponge_width=12, nt=args.nt)
    srcs = [int(np.ravel_multi_index((n // 2, n // 2, n * (k + 1) // (args.shots + 1)),
                                     shape)) for k in range(args.shots)]
    c0 = torch.full(shape, 1500.0, device=dev)
    d_obs = 0.9 * multishot_wave_operator(shape, srcs, shot_map="vmap", **kw)(c0 * 1.01)
    for rb in args.blocks:
        F = multishot_wave_operator(shape, srcs, shot_map="vmap", remat_blocks=rb, **kw)
        out, g, a, peaks, times = chip_smoke._grad_and_adjoint(F, c0, d_obs)
        print(f"remat_blocks {rb}: peak gradient {peaks[0]:.3f} GiB, derived adjoint "
              f"{peaks[1]:.3f} GiB; {times[0]:.3f} / {times[1]:.3f} s [{smi}]", flush=True)
        del F, out, g, a
    return 0


if __name__ == "__main__":
    sys.exit(main())
