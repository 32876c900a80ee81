#!/usr/bin/env python3
"""Run phases 67-68 of ``chip_smoke.py`` alone on one CUDA card: the block
x grid mesh (``chip_smoke.block_by_grid``), after building the kernels and
recomputing the references it holds the mesh runs to (phase 3's LSQR of
the 3-D flagship, phases 42-43's configs 4 and 5, phase 65's 16-shot
isotropic int8 multishot gradient); with ``--examples`` then phase 69, the
examples of ``examples_torch/`` (``chip_smoke.examples_phase``).

    python3 tools/smoke_block_grid.py [--examples]

Every line carries the card's name and power limit.
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
        raise SystemExit("smoke_block_grid: this script needs a CUDA card")
    import chip_smoke
    from jets_tpu_torch import kernels
    from jets_tpu_torch.models import configs
    from jets_tpu_torch.models.seismic import make_seismic_problem
    from jets_tpu_torch.ops.wave import multishot_wave_operator
    from jets_tpu_torch.solvers import lsqr

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
    A, _, d = make_seismic_problem(*chip_smoke.FLAGSHIP, seed=0, noise=0.05)
    r = lsqr(A, d, maxiter=50, tol=0.0)
    flagship_ref = (r.x, r.history)
    del A, d, r
    for name, (_, maxiter, _) in chip_smoke.MESH_CONFIGS.items():
        res, _, _ = configs.run_config(getattr(configs, name), maxiter=maxiter, tol=1e-10)
        chip_smoke.BASELINE_X[name] = res.x
    c_true, src0, wkw, _ = chip_smoke.wave_model(torch.device("cuda"))
    F1 = multishot_wave_operator(tuple(c_true.shape), chip_smoke.MSRC, nt=220,
                                 store_adjoint="int8", shot_map="map", **wkw)
    chip_smoke.DIST_REF["ms_grad"] = F1.linearize(torch.full_like(c_true, 1500.0)).H(
        F1(c_true))
    del F1
    t1 = time.perf_counter()
    launched = chip_smoke.block_by_grid(smi, c_true, src0, wkw, flagship_ref)
    print(f"phases 67-68 launches {launched} in {time.perf_counter() - t1:.1f} s; "
          f"{time.perf_counter() - t0:.1f} s in all [{smi}]", flush=True)
    if "--examples" in sys.argv[1:]:
        t1 = time.perf_counter()
        launched = chip_smoke.examples_phase(smi)
        print(f"phase 69 launches {launched} in {time.perf_counter() - t1:.1f} s [{smi}]",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
