"""Example 3 — miniature full-waveform inversion (FWI) (the port of
``examples/03_fwi_gauss_newton.py``).

A nonlinear wave propagator jet, linearized per Gauss–Newton iteration
(``upstate`` machinery at work), with CGLS inner solves on the Born
operator. This is the reference family's flagship nonlinear workflow
(COFII FWI) end-to-end in ~30 lines. FWI in physical units needs float64
(squared gradient norms underflow float32), so the propagator runs its
plain float64 step and no kernel.

Run: ``python examples_torch/03_fwi_gauss_newton.py [--device cpu]`` (the
CUDA card by default).
"""
import argparse

import torch

from jets_tpu_torch.core.spaces import resolve_device
from jets_tpu_torch.ops.wave import wave_propagator
from jets_tpu_torch.solvers import gauss_newton


def main(device=None) -> dict:
    """Gauss–Newton FWI on ``device`` (``None``: the card); no random input."""
    dev = resolve_device(device)
    grid = (32, 32)
    # dt sized for CFL ~0.45 so the wavefront crosses the grid in ~nt steps
    F = wave_propagator(grid, nt=200, dt=0.0022, dx=10.0, freq=12.0,
                        src_idx=32 * 16 + 16, sponge_width=5,
                        dtype=torch.float64, device=dev)
    c_true = torch.full(grid, 2000.0, dtype=torch.float64, device=dev)
    c_true[18:24, 18:24] += 150.0
    d_obs = F(c_true)
    dnorm = float(F.rng.norm(d_obs))

    c0 = torch.full(grid, 2000.0, dtype=torch.float64, device=dev)
    res = gauss_newton(F, d_obs, c0, outer_iters=4, inner_iters=15, inner_tol=1e-8)
    rel = [r / dnorm for r in res.residuals]
    print("relative data residual per outer iteration:", [f"{r:.3e}" for r in rel])
    return {"residuals": rel}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description="Gauss–Newton FWI with CGLS inner solves")
    ap.add_argument("--device", choices=("cuda", "cpu"), default=None,
                    help="where to run (default: the CUDA card; no card is an error)")
    main(ap.parse_args().device)
