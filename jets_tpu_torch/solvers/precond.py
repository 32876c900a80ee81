"""Normal-equations and preconditioning helpers for the Krylov layer
(counterpart of ``jets_tpu/solvers/precond.py``):

* :func:`normal_operator` — ``A^H A (+ damp^2 I)`` as a self-adjoint
  :class:`LinearOperator` that :func:`~jets_tpu_torch.solvers.krylov.cg`
  consumes directly;
* :func:`estimate_diagonal` — matrix-free Hutchinson estimate of
  ``diag(A^H A)`` from Rademacher probes drawn with a ``torch.Generator``
  (where the JAX package takes a ``jax.random`` key);
* :func:`jacobi_preconditioner` — ``M ≈ diag(A^H A)^{-1}`` from that
  estimate or an exact diagonal, for ``cg(..., M=M)``.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..core.jet import Jet, LinearOperator, adjoint
from ..ops.diagonal import diagonal_operator
from ..utils import tree

__all__ = ["normal_operator", "estimate_diagonal", "jacobi_preconditioner"]


def normal_operator(A: LinearOperator, damp: float = 0.0) -> LinearOperator:
    """Self-adjoint ``N = A^H A + damp^2 I`` on ``A.dom`` — SPD whenever
    ``A`` has full column rank or ``damp > 0``; feed it to ``cg``."""

    def _df(dm, m0, state):
        op = state["op"]
        out = op.adjoint_apply(op(dm))
        d = state["damp"]
        if d:
            out = out + (d * d) * dm
        return out

    j = Jet(dom=A.dom, rng=A.dom, df=_df, dft="self",
            state={"op": A, "damp": float(damp)})
    return LinearOperator(j)


def estimate_diagonal(A: LinearOperator, generator: Optional[torch.Generator] = None,
                      nsamples: int = 32):
    """Hutchinson estimate of ``diag(A^H A)``: ``mean_z [conj(z) ⊙ (A^H A
    z)]`` over Rademacher probes ``z = sign(u − 0.5)``, ``u`` uniform members
    of the domain drawn in turn from ``generator`` (default: a CPU
    generator seeded 0) — exact in expectation, variance ~1/nsamples. Block
    domains work too: the probes are the space's own members."""
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    dom, Ah = A.dom, adjoint(A)
    acc = None
    for _ in range(nsamples):
        z = tree.tmap(lambda a: torch.sign(torch.real(a) - 0.5).to(a.dtype),
                      dom.rand(generator))
        s = tree.tmap(lambda zz, nn: torch.conj(zz) * nn, z, Ah(A(z)))
        acc = s if acc is None else tree.add(acc, s)
    return tree.scale(1.0 / nsamples, acc)


def jacobi_preconditioner(
    A: LinearOperator,
    diag=None,
    *,
    generator: Optional[torch.Generator] = None,
    nsamples: int = 32,
    eps: float = 1e-12,
) -> LinearOperator:
    """Diagonal preconditioner ``M = diag(A^H A)^{-1}`` (the diagonal
    clamped at ``eps``), estimated by :func:`estimate_diagonal` unless an
    exact ``diag`` is given; on ``A``'s device. Use as ``cg(N, b, M=M)``
    with ``N = normal_operator(A)``."""
    if diag is None:
        diag = estimate_diagonal(A, generator, nsamples)
    inv = tree.tmap(lambda d: (1.0 / torch.clamp_min(torch.real(d), eps)).to(A.dom.dtype),
                    diag)
    if isinstance(inv, torch.Tensor):
        return diagonal_operator(inv, device=A.dom.device)

    def _df(dm, m0, state):  # a block diagonal: the generic elementwise multiply
        return tree.tmap(lambda w, x: w * x, state["w"], dm)

    j = Jet(dom=A.dom, rng=A.dom, df=_df, dft="self", state={"w": inv})
    return LinearOperator(j)
