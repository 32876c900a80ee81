"""Example 1 — sparse-spike deconvolution with the operator algebra (the
port of ``examples/01_deconvolution.py``).

Builds ``A = D ∘ S`` (derivative after wavelet convolution), generates data
from a sparse reflectivity, and solves with LSQR — the canonical matrix-free
workflow of the reference framework (docs ``lsqr(vec(A), vec(d))``), without
any vec bridge. On the card LSQR's x/w update is the hand-written kernel
``xw_update``.

Run: ``python examples_torch/01_deconvolution.py [--device cpu]`` (the CUDA
card by default).
"""
import argparse

import torch

import jets_tpu_torch as jt
from jets_tpu_torch.core.spaces import as_tensor, resolve_device
from jets_tpu_torch.ops.conv import conv1d_operator, derivative_operator
from jets_tpu_torch.solvers import lsqr


def main(device=None, *, gate_m=None, gate_d=None, x_true=None) -> dict:
    """Deconvolve on ``device`` (``None``: the card). ``gate_m``/``gate_d``
    (the dot-product test's vectors) and ``x_true`` (the spike model) are
    drawn from seeded generators unless given."""
    dev = resolve_device(device)
    n = 2000
    t = torch.arange(25, dtype=torch.float32)
    wavelet = torch.exp(-0.5 * ((t - 12.0) / 3.0) ** 2)

    S = conv1d_operator(wavelet, n, device=dev)   # wavelet convolution
    D = derivative_operator(n, device=dev)        # first difference
    A = D @ S                                     # composition

    # mandatory adjoint gate before solving
    m = A.dom.randn(torch.Generator().manual_seed(0)) if gate_m is None else gate_m
    d = A.rng.randn(torch.Generator().manual_seed(1)) if gate_d is None else gate_d
    lhs, rhs = jt.dot_product_test(A, as_tensor(m).to(dev, torch.float32),
                                   as_tensor(d).to(dev, torch.float32))
    print(f"dot-product gate: {float(lhs):.6f} vs {float(rhs):.6f}")

    if x_true is None:
        spikes = torch.randint(50, n - 50, (20,), generator=torch.Generator().manual_seed(42))
        x_true = torch.zeros(n).index_fill_(0, spikes, 1.0)
    x_true = as_tensor(x_true).to(dev, torch.float32)
    d = A(x_true)

    res = lsqr(A, d, maxiter=300, tol=1e-8, damp=1e-4)
    rel = float(A.rng.norm(A(res.x) - d)) / float(A.rng.norm(d))
    print(f"LSQR: {int(res.iterations)} iterations, relative residual {rel:.2e}")
    return {"gate": (float(lhs), float(rhs)), "iterations": int(res.iterations),
            "relres": rel}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description="sparse-spike deconvolution by LSQR")
    ap.add_argument("--device", choices=("cuda", "cpu"), default=None,
                    help="where to run (default: the CUDA card; no card is an error)")
    main(ap.parse_args().device)
