"""Example 7 — simultaneous-source deblending by sparse inversion (the port
of ``examples/07_deblending.py``).

A blended acquisition fires ``nshots`` overlapping sources into ONE
continuous record ``d = B m`` (``blend_operator``; its adjoint gathers in a
fixed order). Recovering the unblended gather ``m`` is underdetermined where
shots overlap; solving damped LSQR on ``B`` composed with a causal
integration (sparsity-in-difference prior, the classic deblending trick)
gives a useful (L2) separation; full separation needs a sparsity solver on
top of the same operators.

Run: ``python examples_torch/07_deblending.py [--device cpu]`` (the CUDA
card by default).
"""
import argparse

import torch

import jets_tpu_torch as jt
from jets_tpu_torch.core.spaces import as_tensor, resolve_device
from jets_tpu_torch.ops import blend_operator, integration_operator
from jets_tpu_torch.solvers import lsqr


def main(device=None, *, t0=None, spikes=None, gate_m=None, gate_d=None) -> dict:
    """Deblend on ``device`` (``None``: the card). ``t0`` (the sorted firing
    times), ``spikes`` (the unintegrated gather, ``(nshots, nt)``) and the
    dot-product test's ``gate_m``/``gate_d`` replace their seeded draws."""
    dev = resolve_device(device)
    nshots, nt = 16, 400
    g = torch.Generator().manual_seed(0)
    # dense firing schedule: shots overlap by ~25%
    if t0 is None:
        t0 = torch.sort(torch.randint(0, (3 * nshots * nt) // 4, (nshots,), generator=g))[0]
    t0 = [int(t) for t in t0]
    T = max(t0) + nt
    B = blend_operator(nshots, nt, t0, T, device=dev)

    # mandatory adjoint gate before solving
    m = B.dom.randn(torch.Generator().manual_seed(1)) if gate_m is None else gate_m
    d = B.rng.randn(torch.Generator().manual_seed(2)) if gate_d is None else gate_d
    lhs, rhs = jt.dot_product_test(B, as_tensor(m).to(dev, torch.float32),
                                   as_tensor(d).to(dev, torch.float32))
    print(f"dot-product gate: {float(lhs):.6f} vs {float(rhs):.6f}")

    # synthetic unblended gather: a few spiky arrivals per shot, integrated
    # once so traces are piecewise-smooth
    if spikes is None:
        spikes = torch.zeros((nshots, nt))
        for s in range(nshots):
            idx = torch.randint(20, nt - 20, (4,), generator=g)
            spikes[s, idx] = torch.randn(4, generator=g)
    S = integration_operator(jt.Space((nshots, nt), torch.float32, dev), axis=1)
    m_true = S(as_tensor(spikes).to(dev, torch.float32))
    d = B(m_true)

    # solve in the spike domain: d = (B ∘ S) z, m = S z — the integration
    # prior concentrates energy, which is what separates overlapping shots
    A = B @ S
    res = lsqr(A, d, maxiter=400, tol=1e-10, damp=1e-3)
    m_est = S(res.x)

    rel = float(torch.linalg.norm(m_est - m_true) / torch.linalg.norm(m_true))
    relres = float(B.rng.norm(B(m_est) - d) / B.rng.norm(d))
    print(f"LSQR: {int(res.iterations)} iterations")
    print(f"blended-data residual {relres:.2e}, model error {rel:.2e}")
    return {"gate": (float(lhs), float(rhs)), "iterations": int(res.iterations),
            "relres": relres, "model_err": rel}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description="deblending by damped LSQR")
    ap.add_argument("--device", choices=("cuda", "cpu"), default=None,
                    help="where to run (default: the CUDA card; no card is an error)")
    main(ap.parse_args().device)
