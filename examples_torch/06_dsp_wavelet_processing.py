"""Example 6 — DSP + wavelet processing chain as one operator (the port of
``examples/06_dsp_wavelet_processing.py``).

A seismic-trace processing workflow built entirely from the operator
algebra: taper → bandpass → fractional shift, solved BACKWARDS by damped
LSQR (deprocessing = least-squares inversion of the chain), plus a
wavelet-domain view of the result. The chain passes the dot-product gate
like any single operator.

Run: ``python examples_torch/06_dsp_wavelet_processing.py [--device cpu]``
(the CUDA card by default).
"""
import argparse

import torch

import jets_tpu_torch as jt
from jets_tpu_torch.core.spaces import as_tensor, resolve_device
from jets_tpu_torch.ops import bandpass_operator, shift_operator, taper_operator, \
    wavelet_operator
from jets_tpu_torch.solvers import lsqr


def main(device=None, *, gate_m=None, gate_d=None, noise=None) -> dict:
    """The chain and its inversion on ``device`` (``None``: the card).
    ``gate_m``/``gate_d`` (the dot-product test's vectors) and ``noise`` (the
    white section that is bandpassed into the model) replace their seeded
    draws."""
    dev = resolve_device(device)
    ntr, nt, dt = 16, 512, 0.004
    sp = jt.Space((ntr, nt), torch.float64, dev)

    def given(x, seed):
        return sp.randn(torch.Generator().manual_seed(seed)) if x is None \
            else as_tensor(x).to(dev, torch.float64)

    # the processing chain, composed like matrices
    T = taper_operator(sp, (0, 32))
    B = bandpass_operator(sp, dt, 8.0, 45.0, f_taper=4.0, axis=-1)
    S = shift_operator(sp, 3.5 * dt, dt=dt, axis=-1)
    A = S @ B @ T

    # verify the whole chain as one operator
    lhs, rhs = jt.dot_product_test(A, given(gate_m, 0), given(gate_d, 1))
    print(f"chain dot-product test: {float(lhs):+.6e} vs {float(rhs):+.6e}")

    # synthesize data: band-limited reflectivity-ish traces
    m_true = bandpass_operator(sp, dt, 2.0, 18.0)(given(noise, 7))
    d_obs = A(m_true)

    # invert the processing (damped LS — the chain kills out-of-band energy,
    # damping keeps the nullspace quiet)
    res = lsqr(A, d_obs, maxiter=200, tol=1e-10, damp=1e-4)
    rel = float(A.rng.norm(A(res.x) - d_obs) / A.rng.norm(d_obs))
    print(f"lsqr deprocessing: {int(res.iterations)} iters, "
          f"relative data misfit {rel:.2e}")

    # wavelet-domain compression of the recovered section
    W = wavelet_operator(sp, "db2", levels=3, axes=(1,))
    c = W(res.x)
    thresh = torch.quantile(torch.abs(c), 0.90)
    c_sparse = torch.where(torch.abs(c) > thresh, c, 0.0)
    x_compressed = jt.adjoint(W)(c_sparse)
    err = float(sp.norm(x_compressed - res.x) / sp.norm(res.x))
    print(f"wavelet 10%-coefficient reconstruction error: {err:.1%}")
    return {"gate": (float(lhs), float(rhs)), "iterations": int(res.iterations),
            "relres": rel, "wavelet_err": err}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description="DSP chain inverted by damped LSQR")
    ap.add_argument("--device", choices=("cuda", "cpu"), default=None,
                    help="where to run (default: the CUDA card; no card is an error)")
    main(ap.parse_args().device)
