"""Example 2 — distributed multi-shot linearized seismic inversion (the
port of ``examples/02_distributed_seismic.py``).

The flagship workload: shots stacked on a leading block axis, sharded over
the ranks of a ``torch.distributed`` group (one process per card), the
adjoint accumulated with one ``all_reduce``, and the SAME LSQR running
unchanged on top. Alone the script is a world of one; under ``torchrun``
each rank takes its slab of the shots:

    python examples_torch/02_distributed_seismic.py [--device cpu]
    torchrun --nproc_per_node 4 examples_torch/02_distributed_seismic.py

NCCL takes one rank per card; with ``--device cpu`` the ranks run gloo.
"""
import argparse

import torch
import torch.distributed as dist

from jets_tpu_torch.models.seismic import make_seismic_problem
from jets_tpu_torch.parallel.collectives import gather_blocks
from jets_tpu_torch.parallel.runner import init_distributed, local_block_range
from jets_tpu_torch.parallel.sharded import make_block_mesh
from jets_tpu_torch.solvers import lsqr


def main(device=None, *, wr=None, m_true=None, eps=None, init_method=None) -> dict:
    """The sharded LSQR on ``device`` (``None``: the card; one rank per
    process). ``wr`` (the per-shot weights, whose rows set the shot count),
    ``m_true`` and ``eps`` (the noise draw) replace the problem's seeded
    draws; ``init_method`` is the group's rendezvous (default: torchrun's
    environment, or a world of one)."""
    made = not dist.is_initialized()
    rank = init_distributed(device=device, init_method=init_method)
    mesh = make_block_mesh(device=device)
    n_dev = dist.get_world_size()
    say = print if rank == 0 else (lambda *a, **k: None)
    say(f"devices: {n_dev}, mesh: {mesh.shape}")

    nshots = max(8, n_dev * 2) if wr is None else len(wr)
    A, _, d_obs = make_seismic_problem(
        (256, 256), nshots=nshots, nreceivers=512, seed=0, wr=wr, mesh=mesh,
        noise=0.02 if m_true is None else 0.0, dtype=torch.float32,
    )
    # under a mesh the data are already this rank's slab of the shots
    if m_true is not None:  # given draws: the data as make_seismic_problem makes them
        d_obs = A(torch.tensor(m_true, dtype=torch.float32).to(mesh.device))
        lo = local_block_range(nshots, mesh)[0]
        scale = 0.02 * torch.std(gather_blocks(d_obs, nshots, mesh), correction=0)
        d_obs = d_obs + scale * torch.tensor(eps, dtype=torch.float32)[
            lo:lo + len(d_obs)].to(mesh.device)

    res = lsqr(A, d_obs, maxiter=60, tol=1e-6)
    rel = float(res.resnorm) / float(A.rng.norm(d_obs))
    say(f"distributed LSQR: {int(res.iterations)} iters, rel residual {rel:.3f}")
    if made:
        dist.destroy_process_group()
    return {"devices": n_dev, "iterations": int(res.iterations), "relres": rel}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description="sharded seismic LSQR over torch.distributed")
    ap.add_argument("--device", choices=("cuda", "cpu"), default=None,
                    help="where to run (default: the CUDA card; no card is an error)")
    ap.add_argument("--init-method", default=None,
                    help="the group's rendezvous, e.g. file:///tmp/rdv (default: "
                         "torchrun's environment, or a world of one)")
    args = ap.parse_args()
    main(args.device, init_method=args.init_method)
