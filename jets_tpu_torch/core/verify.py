"""Correctness gates and operator materialization — L3 (counterpart of
``jets_tpu/core/verify.py``): the dot-product (adjoint) test, the
linearity test, the linearization (Taylor-decay) test, and the dense
matrix of a small linear operator. Random draws take a
:class:`torch.Generator`."""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from .jet import LinearOperator, Operator

__all__ = [
    "dot_product_test",
    "linearity_test",
    "linearization_test",
    "materialize",
]


def _generator(generator: Optional[torch.Generator], seed: int) -> torch.Generator:
    return generator if generator is not None else torch.Generator().manual_seed(seed)


def dot_product_test(
    A: LinearOperator, m, d, *, mmask=None, dmask=None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(lhs, rhs)`` of ``<d̃, A m̃> == <A^H d̃, m̃>``, optionally restricted
    by masks. For mixed real/complex operators the complex side contributes
    its real part."""
    mt = m if mmask is None else mmask * m
    dt = d if dmask is None else dmask * d
    lhs = A.rng.dot(dt, A(mt))
    rhs = A.dom.dot(A.adjoint_apply(dt), mt)
    dom_cplx, rng_cplx = A.dom.dtype.is_complex, A.rng.dtype.is_complex
    if rng_cplx and not dom_cplx:
        lhs = torch.real(lhs)
    if dom_cplx and not rng_cplx:
        rhs = torch.real(rhs)
    return lhs, rhs


def linearity_test(A: LinearOperator, generator: Optional[torch.Generator] = None):
    """``(A(m1 + m2), A m1 + A m2)``; their difference should be roundoff."""
    g = _generator(generator, 0)
    m1 = A.dom.randn(g)
    m2 = A.dom.randn(g)
    return A(m1 + m2), A(m1) + A(m2)


def linearization_test(
    F: Operator,
    m0,
    *,
    mu: Sequence[float] = (1.0, 0.5, 0.25, 0.125, 0.0625),
    delta_m=None,
    generator: Optional[torch.Generator] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Second-order Taylor decay of ``phi(mu) = ||F(m0 + mu dm) - F(m0) -
    mu J dm||``: returns ``(observed, expected)`` ratios of successive
    ``phi``, where expected is ``(mu[i-1]/mu[i])**2``."""
    if delta_m is None:
        delta_m = F.dom.randn(_generator(generator, 17))
    J = F.linearize(m0)
    d0 = F(m0)
    Jdm = J(delta_m)
    phis = torch.stack(
        [F.rng.norm(F(m0 + mu_i * delta_m) - d0 - mu_i * Jdm) for mu_i in mu]
    )
    observed = phis[:-1] / phis[1:]
    mus = torch.as_tensor(mu, dtype=phis.dtype, device=phis.device)
    expected = (mus[:-1] / mus[1:]) ** 2
    return observed, expected


def materialize(A: LinearOperator) -> torch.Tensor:
    """Dense ``(rng.size, dom.size)`` matrix of a linear operator, column by
    column. For tests and small operators: ``dom.size`` applications."""
    dom, rng = A.dom, A.rng
    eye = torch.eye(dom.size, dtype=dom.dtype, device=dom.device)
    cols = [rng.ravel(A(dom.reshape(e))) for e in eye]
    return torch.stack(cols, dim=1)
