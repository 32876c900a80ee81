"""Example 13 — production anisotropic + attenuating gradients from stored
compressed wavefield histories (the port of
``examples/13_anisotropic_denq_gradient.py``).

Three gradient paths a production imaging shop runs daily, all through
the SAME jet/solver machinery:

* **VTI FWI gradient** from the stored two-field history
  (``vti_wave_propagator(store_adjoint="int8")``; on a 3-D float32 grid
  the card runs it on the VTI step, history and reverse kernels, on this
  2-D grid the plain sweep);
* **IsoDenQ gradient** — velocity, buoyancy AND attenuation
  (``vdq_wave_propagator``, the Prop*AcoIsoDenQ parameter set) with the
  hand-derived Kosloff-friction transpose: one reverse pass returns the
  full (δc, δb, δQ) BlockVector;
* **attenuating VTI** (``q=``): static constant-Q friction composed with
  the stored anisotropic sweep — the ``Prop*AcoVTIDenQ`` slot.

Run: ``python examples_torch/13_anisotropic_denq_gradient.py [--device
cpu]`` (the CUDA card by default).
"""
import argparse

import torch

from jets_tpu_torch.core.spaces import resolve_device
from jets_tpu_torch.ops.wave import vdq_wave_propagator, vti_wave_propagator


def main(device=None) -> dict:
    """The three gradients on ``device`` (``None``: the card); no random
    input."""
    dev = resolve_device(device)
    grid = (24, 24)
    kw = dict(nt=36, dt=8e-4, dx=10.0, freq=18.0, src_idx=12 * 24 + 12,
              sponge_width=4, dtype=torch.float32, device=dev)

    def full(v):
        return torch.full(grid, v, device=dev)

    out = {}
    # --- VTI gradient from the stored int8 two-field history ------------
    F = vti_wave_propagator(grid, store_adjoint="int8", **kw)
    m0 = (F.dom.zeros().setblock(0, full(1500.0))
          .setblock(1, full(0.1)).setblock(2, full(0.05)))
    # synthetic observed data from a perturbed model -> physical residual
    d_obs = F(m0.setblock(0, full(1530.0)))
    r = F(m0) - d_obs
    g = F.linearize(m0).H(r)
    print("VTI stored-int8 gradient blocks:")
    for b, nm in enumerate(("velocity", "epsilon", "delta")):
        out[f"vti_{nm}"] = float(torch.max(torch.abs(g.getblock(b))))
        print(f"  d{nm:<9} |g|max = {out[f'vti_{nm}']:.3e}")

    # --- full IsoDenQ (c, b, Q) gradient --------------------------------
    Fq = vdq_wave_propagator(grid, store_adjoint="int8", **kw)
    mq = (Fq.dom.zeros().setblock(0, full(2000.0))
          .setblock(1, full(1e-3)).setblock(2, full(30.0)))
    dq_obs = Fq(mq.setblock(2, full(20.0)))     # attenuation anomaly
    rq = Fq(mq) - dq_obs
    gq = Fq.linearize(mq).H(rq)
    print("IsoDenQ stored-int8 gradient blocks:")
    for b, nm in enumerate(("velocity", "buoyancy", "Q")):
        out[f"denq_{nm}"] = float(torch.max(torch.abs(gq.getblock(b))))
        print(f"  d{nm:<9} |g|max = {out[f'denq_{nm}']:.3e}")

    # --- attenuating VTI: static Q + stored anisotropic sweep -----------
    Fv = vti_wave_propagator(grid, q=25.0, store_adjoint="f32", **kw)
    gv = Fv.linearize(m0).H(r)
    out["vtiq"] = float(torch.max(torch.abs(gv.getblock(0))))
    print("VTI+staticQ stored gradient |g|max =", f"{out['vtiq']:.3e}")

    assert out["vti_velocity"] > 0
    assert out["denq_Q"] > 0
    print("done")
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description="VTI, IsoDenQ and VTI + Q stored gradients")
    ap.add_argument("--device", choices=("cuda", "cpu"), default=None,
                    help="where to run (default: the CUDA card; no card is an error)")
    main(ap.parse_args().device)
