"""Example 09 — Multi-parameter FWI on a block-vector model (the port of
``examples/09_multiparameter_fwi.py``).

The variable-density propagator's model is a ``BlockSpace`` holding
velocity ``c`` and buoyancy ``b = 1/ρ`` (the reference family's
multi-parameter model is exactly a block vector, ``src/Jets.jl:736-760``).
Everything downstream — the least-squares objective, the adjoint-state
gradient, L-BFGS's two-loop recursion and line search — runs on the block
vector unchanged. The variable-density step is plain PyTorch.

Run: ``python examples_torch/09_multiparameter_fwi.py [--device cpu]`` (the
CUDA card by default).
"""
import argparse

import torch

from jets_tpu_torch.core.spaces import resolve_device
from jets_tpu_torch.ops.wave import vd_wave_propagator
from jets_tpu_torch.solvers import lbfgs, least_squares_objective


def main(device=None) -> dict:
    """Velocity + buoyancy L-BFGS on ``device`` (``None``: the card); no
    random input."""
    dev = resolve_device(device)
    n = 24
    grid = (n, n)
    F = vd_wave_propagator(grid, nt=48, dt=0.0008, dx=10.0, freq=18.0,
                           src_idx=n * (n // 2) + n // 2, sponge_width=4,
                           dtype=torch.float32, device=dev)

    # true model: background + a velocity anomaly and a density anomaly
    c_bg = torch.full(grid, 2000.0, device=dev)
    b_bg = torch.full(grid, 1e-3, device=dev)          # rho = 1000 kg/m^3
    c_t, b_t = c_bg.clone(), b_bg.clone()
    c_t[8:12, 8:12] += 80.0
    b_t[14:18, 6:10] *= 1.2
    m_true = F.dom.zeros().setblock(0, c_t).setblock(1, b_t)
    d_obs = F(m_true)

    # start from the smooth background
    m0 = F.dom.zeros().setblock(0, c_bg).setblock(1, b_bg)
    fg = least_squares_objective(F, d_obs)
    phi0, g0 = fg(m0)
    print(f"initial misfit: {float(phi0):.4e}  "
          f"(grad blocks: |g_c|={float(torch.linalg.norm(g0.getblock(0))):.2e}, "
          f"|g_b|={float(torch.linalg.norm(g0.getblock(1))):.2e})")

    res = lbfgs(fg, m0, maxiter=15, mem=5, tol=0.0)
    phi1, _ = fg(res.m)
    print(f"misfit after {int(res.iterations)} L-BFGS iterations: "
          f"{float(phi1):.4e}  ({float(phi1) / float(phi0):.3f} of initial)")
    assert float(phi1) < 0.5 * float(phi0)
    print("done")
    return {"phi0": float(phi0), "gc": float(torch.linalg.norm(g0.getblock(0))),
            "gb": float(torch.linalg.norm(g0.getblock(1))),
            "iterations": int(res.iterations), "phi": float(phi1)}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description="velocity + buoyancy FWI by L-BFGS")
    ap.add_argument("--device", choices=("cuda", "cpu"), default=None,
                    help="where to run (default: the CUDA card; no card is an error)")
    main(ap.parse_args().device)
