"""Example 5 — FWI with L-BFGS (adjoint-state gradients) (the port of
``examples/05_fwi_lbfgs.py``).

The same miniature full-waveform inversion as example 3, solved with the
gradient-based nonlinear path instead of Gauss–Newton: the objective
``phi(c) = 1/2 ||F(c) - d||^2`` gets its gradient from the framework's
adjoint machinery (``least_squares_objective``), and L-BFGS with Armijo
line searches runs on top (one host read per line-search trial).

Run: ``python examples_torch/05_fwi_lbfgs.py [--device cpu]`` (the CUDA card
by default).
"""
import argparse

import torch

from jets_tpu_torch.core.spaces import resolve_device
from jets_tpu_torch.ops.wave import wave_propagator
from jets_tpu_torch.solvers import lbfgs, least_squares_objective


def main(device=None) -> dict:
    """L-BFGS FWI on ``device`` (``None``: the card); no random input."""
    dev = resolve_device(device)
    grid = (32, 32)
    F = wave_propagator(grid, nt=200, dt=0.0022, dx=10.0, freq=12.0,
                        src_idx=32 * 16 + 16, sponge_width=5,
                        dtype=torch.float64, device=dev)
    c_true = torch.full(grid, 2000.0, dtype=torch.float64, device=dev)
    c_true[18:24, 18:24] += 150.0
    d_obs = F(c_true)
    dnorm = float(F.rng.norm(d_obs))

    fg = least_squares_objective(F, d_obs)
    c0 = torch.full(grid, 2000.0, dtype=torch.float64, device=dev)
    phi0 = float(fg(c0)[0])

    res = lbfgs(fg, c0, maxiter=80, mem=10, tol=1e-6)
    err = float(torch.abs(res.m - c_true).max())
    rel = (2.0 * float(res.phi)) ** 0.5 / dnorm
    print(f"phi: {phi0:.3e} -> {float(res.phi):.3e} "
          f"in {int(res.iterations)} L-BFGS iterations")
    print(f"relative data residual: {rel:.3e}")
    print(f"max velocity error: {err:.1f} m/s (anomaly is 150 m/s)")
    return {"phi0": phi0, "phi": float(res.phi), "iterations": int(res.iterations),
            "relres": rel, "err": err}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description="L-BFGS FWI with adjoint-state gradients")
    ap.add_argument("--device", choices=("cuda", "cpu"), default=None,
                    help="where to run (default: the CUDA card; no card is an error)")
    main(ap.parse_args().device)
