"""Example 08 — Reverse-time migration with production acquisition geometry
(the port of ``examples/08_rtm_imaging.py``).

Puts the deepened wave pack together the way a seismic imaging shop would:

* CPML absorbing boundaries (clean gathers — no sponge reflections
  contaminating the image),
* 8th-order spatial stencil (coarser grid per wavelength),
* an OFF-GRID receiver cable at fractional depth (Kaiser-windowed-sinc
  extraction — Hicks interpolation as banded matrix products inside the
  time loop),
* Born modeling for synthetic data, LSQR for the linearized image
  (RTM = the first adjoint application; least-squares migration = the
  full solve).

The wave steps here are plain PyTorch (no kernel takes an off-grid
geometry or CPML); on the card LSQR's x/w update is the kernel
``xw_update``.

Run: ``python examples_torch/08_rtm_imaging.py [--device cpu]`` (the CUDA
card by default).
"""
import argparse

import torch

from jets_tpu_torch.core.spaces import resolve_device
from jets_tpu_torch.ops.wave import (born_operator, cpml_wave_propagator,
                                     offgrid_wave_propagator, wave_propagator)
from jets_tpu_torch.solvers import lsqr


def main(device=None) -> dict:
    """Born data, RTM, LSM and the boundary check on ``device`` (``None``:
    the card); no random input."""
    dev = resolve_device(device)
    n = 48
    grid = (n, n)

    # -- background model and a reflectivity anomaly ---------------------
    c0 = torch.full(grid, 2000.0, device=dev)
    dc_true = torch.zeros(grid, device=dev)
    dc_true[28:32, 12:36] = 40.0

    # -- modeling operator: off-grid cable at depth 4.5 cells --------------
    F = offgrid_wave_propagator(
        grid,
        src_pos=(2.0, n / 2 - 0.5),                      # near-surface source
        rcv_depth=4.5,                                   # fractional cable depth
        rcv_coords=torch.linspace(4.0, n - 5.0, 24).numpy(),  # fractional offsets
        nt=300, dt=0.0012, dx=10.0, freq=12.0,
        sponge_width=8, space_order=8, dtype=torch.float32, device=dev,
    )
    J = born_operator(F, c0)

    # synthetic linearized data
    d_obs = J(dc_true)
    energy = float(J.rng.norm(d_obs))
    print(f"data energy: {energy:.4e}")

    # -- RTM image: one adjoint application -------------------------------
    image = J.T(d_obs)
    peak = tuple(int(i) for i in torch.unravel_index(torch.argmax(torch.abs(image)), grid))
    print(f"RTM peak at {peak} (true rows 28:32)")

    # -- least-squares migration: a few LSQR iterations -------------------
    res = lsqr(J, d_obs, maxiter=6, tol=1e-7)
    rel = float(J.rng.norm(J(res.x) - d_obs)) / float(J.rng.norm(d_obs))
    print(f"LSM relative residual after 6 iterations: {rel:.3f}")

    # -- CPML vs sponge boundary quality check ------------------------------
    # record the FULL final wavefield snapshot: everything still in the
    # domain after the wavefront has left is boundary reflection
    kw = dict(nt=260, dt=0.0012, dx=10.0, freq=12.0, src_idx=n * (n // 2) + n // 2,
              rcv_idx=torch.arange(n * n), dtype=torch.float32, device=dev)
    d_cpml = cpml_wave_propagator(grid, pml_width=8, cmax=2200.0, **kw)(c0)
    d_spng = wave_propagator(grid, sponge_width=8, **kw)(c0)

    def reflected(tr):
        peak = float(torch.max(torch.abs(tr)))
        inner = tr[-1].reshape(grid)[12:-12, 12:-12]
        return float(torch.max(torch.abs(inner))) / peak

    r_cpml, r_spng = reflected(d_cpml), reflected(d_spng)
    print(f"boundary reflection amplitude  cpml: {r_cpml:.2e}   sponge: {r_spng:.2e}")
    print("done")
    return {"energy": energy, "peak": peak, "relres": rel, "cpml": r_cpml,
            "sponge": r_spng}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description="RTM and LSM with CPML and an off-grid cable")
    ap.add_argument("--device", choices=("cuda", "cpu"), default=None,
                    help="where to run (default: the CUDA card; no card is an error)")
    main(ap.parse_args().device)
