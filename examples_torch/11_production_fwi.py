"""Example 11 — production-style FWI: velocity bounds, recording-grid data,
stored compressed-wavefield gradients (the port of
``examples/11_production_fwi.py``).

Three features together, the way a production inversion uses them:

* ``dtrec=`` — the FD scheme steps at the CFL-limited modeling ``dt``
  while the observed data live on a coarser recording grid (the reference
  family's dtmod/dtrec split); the operator's range IS the recording grid,
  so observed data plug in directly;
* ``store_adjoint="int8"`` — gradients come from an on-device
  per-snapshot-scaled int8 copy of the forward wavefield (4× less adjoint
  memory, no recompute — the CvxCompress trade of JetPackWaveFD's
  production imaging);
* ``bounds=(lo, hi)`` on L-BFGS — trial models are projected onto the
  velocity box every line-search step, and convergence is measured by the
  projected gradient.

The 2-D grid takes the plain steps (the wave kernels take 3-D grids).

Run: ``python examples_torch/11_production_fwi.py [--device cpu]`` (the
CUDA card by default).
"""
import argparse

import torch

from jets_tpu_torch.core.spaces import as_tensor, resolve_device
from jets_tpu_torch.ops.wave import wave_propagator
from jets_tpu_torch.solvers import lbfgs, least_squares_objective


def main(device=None, *, c_true=None) -> dict:
    """Bounded L-BFGS on ``device`` (``None``: the card); ``c_true`` (the
    clipped random velocity model) replaces its seeded draw."""
    dev = resolve_device(device)
    grid = (32, 32)
    lo, hi = 1400.0, 1700.0
    F = wave_propagator(
        grid, nt=240, dt=1e-3, dx=10.0, freq=12.0, src_idx=32 * 4 + 16,
        sponge_width=5,
        dtrec=4e-3,               # record every 4 ms, model at 1 ms
        store_adjoint="int8",     # compressed stored-wavefield gradient
        dtype=torch.float32, device=dev,
    )
    print(f"modeling steps: 240 @ 1 ms; recording grid: {F.rng.shape[0]} "
          f"samples @ 4 ms")

    if c_true is None:
        c_true = torch.clamp(1500.0 + 60.0 * torch.randn(
            grid, generator=torch.Generator().manual_seed(0)), lo, hi)
    c_true = as_tensor(c_true).to(dev, torch.float32)
    d_obs = F(c_true)

    fg = least_squares_objective(F, d_obs)
    c0 = torch.full(grid, 1500.0, device=dev)
    res = lbfgs(fg, c0, maxiter=15, mem=5, tol=1e-8, bounds=(lo, hi))

    phi0 = float(fg(c0)[0])
    print(f"phi: {phi0:.3e} -> {float(res.phi):.3e} "
          f"({int(res.iterations)} iterations)")
    m = res.m
    print(f"model range: [{float(m.min()):.1f}, {float(m.max()):.1f}] "
          f"(box [{lo}, {hi}])")
    assert float(m.min()) >= lo - 1e-3 and float(m.max()) <= hi + 1e-3
    assert float(res.phi) < 0.2 * phi0
    err0 = float(torch.linalg.norm(c0 - c_true))
    err = float(torch.linalg.norm(m - c_true))
    print(f"model error: {err0:.1f} -> {err:.1f}")
    assert err < err0
    print("ok")
    return {"ntrec": int(F.rng.shape[0]), "phi0": phi0, "phi": float(res.phi),
            "iterations": int(res.iterations), "range": (float(m.min()), float(m.max())),
            "err0": err0, "err": err, "history": res.history.tolist()}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description="bounded L-BFGS FWI with int8 gradients")
    ap.add_argument("--device", choices=("cuda", "cpu"), default=None,
                    help="where to run (default: the CUDA card; no card is an error)")
    main(ap.parse_args().device)
