#!/usr/bin/env python3
"""Run phases 65-66 of ``chip_smoke.py`` alone on one CUDA card: the
distribution layer (``chip_smoke.distribution``), after building the
kernels and recomputing the references it holds the mesh runs to (phase
3's LSQR of the 3-D flagship, phases 42-43's configs 4 and 5).

    python3 tools/smoke_distribution.py [--profile]

With ``--profile``, it then times the flagship's LSQR (marginal ms per
iteration between 10 and 60 iterations, CUDA events, twice in turns)
without a mesh, with ``mesh=`` at world size 1 on NCCL, and with the mesh
but its collectives replaced by the identity, and prints a
``torch.profiler`` table of 20 iterations without and with the mesh:
where the world-size-1 mesh spends its extra time. Every line carries
the card's name and power limit.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def profile_lsqr(smi):
    import chip_smoke
    from torch.profiler import ProfilerActivity, profile

    from jets_tpu_torch.models.seismic import make_seismic_problem
    from jets_tpu_torch.parallel import collectives
    from jets_tpu_torch.parallel.sharded import make_block_mesh
    from jets_tpu_torch.solvers import lsqr

    mesh = make_block_mesh()
    A0, _, d0 = make_seismic_problem(*chip_smoke.FLAGSHIP, seed=0, noise=0.05)
    A1, _, d1 = make_seismic_problem(*chip_smoke.FLAGSHIP, seed=0, noise=0.05, mesh=mesh)
    all_reduce = collectives._all_reduce
    for rep in range(2):
        for name, A, d, reduce_ in (
                ("no mesh", A0, d0, all_reduce), ("mesh, NCCL world of one", A1, d1, all_reduce),
                ("mesh, collectives as the identity", A1, d1, lambda x, op, mesh: x)):
            collectives._all_reduce = reduce_
            ms = chip_smoke.ms_per_iter(lsqr, A, d, 10, 60)
            print(f"round {rep}: {name}: {ms:.4f} ms/iter [{smi}]", flush=True)
    collectives._all_reduce = all_reduce
    for name, A, d in (("no mesh", A0, d0), ("mesh, NCCL world of one", A1, d1)):
        lsqr(A, d, maxiter=10, tol=0.0)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            lsqr(A, d, maxiter=20, tol=0.0)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        print(f"--- {name}: 20 LSQR iterations in {1e3 * wall:.1f} ms under the profiler "
              f"[{smi}]")
        print(prof.key_averages().table(sort_by="self_cpu_time_total", row_limit=12))
        print(prof.key_averages().table(sort_by="self_device_time_total", row_limit=8))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="then profile the flagship's LSQR with and without the mesh")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("smoke_distribution: this script needs a CUDA card")
    import chip_smoke
    from jets_tpu_torch import kernels
    from jets_tpu_torch.models import configs
    from jets_tpu_torch.models.seismic import make_seismic_problem
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
    t1 = time.perf_counter()
    launched = chip_smoke.distribution(smi, c_true, src0, wkw, flagship_ref)
    print(f"phases 65-66 launches {launched} in {time.perf_counter() - t1:.1f} s", flush=True)
    if args.profile:
        profile_lsqr(smi)
        torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
