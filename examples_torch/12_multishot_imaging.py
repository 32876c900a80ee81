"""Example 12 — multishot imaging gradients at production settings: the
BASELINE config-#5 workload shape, scaled down to run anywhere (the port of
``examples/12_multishot_imaging.py``).

Features together, the way a production RTM/FWI workflow uses them:

* ``multishot_wave_operator(store_adjoint="int8", shot_map="map")`` —
  every shot's gradient is a STORED-wavefield adjoint sweep; the shots run
  one after another so that, on the card, each forward step is the kernel
  ``fused_leapfrog_step`` and each reverse step ``fused_adjoint_step``;
  shot contributions sum in the stacked adjoint;
* anisotropic gradients are first-class: the TTI propagator's
  ``store_adjoint=`` runs the hand-derived transpose of the rotated
  coupled system and returns the full (δc, δε, δδ, δθ, δφ) tuple in one
  reverse pass; ``coeff_dtype=torch.bfloat16`` streams the five smooth
  coefficient fields at half width (on the card: the TTI step, history and
  reverse kernels);
* on a mesh, pass ``mesh=make_block_mesh()`` and nothing else changes —
  the same script runs on many cards.

Run: ``python examples_torch/12_multishot_imaging.py [--device cpu]`` (the
CUDA card by default).
"""
import argparse

import numpy as np
import torch

from jets_tpu_torch.core.spaces import resolve_device
from jets_tpu_torch.ops.wave import multishot_wave_operator, tti_wave_propagator


def main(device=None) -> dict:
    """The isotropic multishot and the TTI gradients on ``device``
    (``None``: the card); no random input."""
    dev = resolve_device(device)

    # --- isotropic multishot FWI gradient (config-#5 shape, scaled) ------
    grid = (16, 32, 128)
    rcv = [int(np.ravel_multi_index((8, 16, x), grid)) for x in range(128)]
    srcs = [int(np.ravel_multi_index((8, 16, 32 + 16 * k), grid)) for k in range(4)]
    F = multishot_wave_operator(
        grid, srcs, nt=24, dt=6e-4, dx=10.0, freq=16.0, rcv_idx=rcv,
        sponge_width=3,
        store_adjoint="int8",    # per-shot stored int8 adjoint sweeps
        shot_map="map",          # sequential shots -> the kernels per shot
        dtype=torch.float32, device=dev,
    )
    c_true = torch.full(grid, 1500.0, device=dev)
    c_true[10:] = 1560.0
    c0 = torch.full(grid, 1500.0, device=dev)
    d_obs = F(c_true)

    def fwi_gradient(c, d):
        J = F.linearize(c)
        r = F(c) - d
        return 0.5 * torch.sum(r * r), J.H(r)

    phi, g = fwi_gradient(c0, d_obs)
    gmax = float(torch.max(torch.abs(g)))
    print(f"multishot FWI: {len(srcs)} shots, phi={float(phi):.3e}, |g|max={gmax:.3e}")
    assert gmax > 0.0

    # --- TTI imaging gradient: full 5-parameter tuple in one pass --------
    Ft = tti_wave_propagator(
        grid, nt=24, dt=6e-4, dx=10.0, freq=16.0, rcv_idx=rcv,
        src_idx=srcs[0], sponge_width=3,
        store_adjoint="int8",
        coeff_dtype=torch.bfloat16,   # half-width smooth coefficient fields
        dtype=torch.float32, device=dev,
    )

    def full(v):
        return torch.full(grid, v, device=dev)

    m0 = Ft.dom.zeros()
    for b, v in enumerate((1500.0, 0.1, 0.05, 0.2, 0.7)):
        m0 = m0.setblock(b, full(v))
    dt_obs = Ft(m0.setblock(0, full(1540.0)))

    gt = Ft.linearize(m0).H(Ft(m0) - dt_obs)
    names = ("c", "eps", "delta", "theta", "phi")
    mags = {nm: float(torch.max(torch.abs(gt.getblock(b)))) for b, nm in enumerate(names)}
    print("TTI 5-parameter gradient |.|max:", {k: f"{v:.2e}" for k, v in mags.items()})
    assert all(v > 0.0 for v in mags.values())
    print("ok")
    return {"phi": float(phi), "gmax": gmax, **{f"tti_{k}": v for k, v in mags.items()}}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description="multishot int8 and TTI 5-parameter gradients")
    ap.add_argument("--device", choices=("cuda", "cpu"), default=None,
                    help="where to run (default: the CUDA card; no card is an error)")
    main(ap.parse_args().device)
