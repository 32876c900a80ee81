"""Gauss–Newton for nonlinear least squares (counterpart of
``jets_tpu/solvers/gauss_newton.py``), the outer loop of FWI-style
inversion: linearize, solve the normal equations with a Krylov method,
update, repeat.

``min_m ‖F(m) − d‖²`` by::

    J_k   = linearize(F, m_k)
    dm_k  = argmin ‖J_k dm − r_k‖   (CGLS by default)
    m_k+1 = m_k + step · dm_k

The outer loop is a Python loop with one host read of the residual norm
per outer iteration, as in the JAX package.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

from ..core.jet import Operator
from ..utils import tree as tr
from .krylov import cgls

__all__ = ["gauss_newton", "GNResult"]


class GNResult(NamedTuple):
    m: Any  # final model
    residuals: list  # data-residual norm per outer iteration
    inner_iterations: list  # Krylov iterations per outer iteration


def gauss_newton(
    F: Operator,
    d,
    m0,
    *,
    outer_iters: int = 5,
    inner_iters: int = 20,
    inner_tol: float = 1e-6,
    step: float = 1.0,
    inner_solver: Optional[Callable] = None,
    callback: Optional[Callable] = None,
) -> GNResult:
    """Gauss–Newton with a matrix-free Krylov inner solve (default CGLS).
    Stops early once the residual falls to ``1e-12·‖d‖`` (an inner solve
    there would divide by zero); otherwise the residual of the last update
    is appended, so ``residuals`` has ``outer_iters + 1`` entries."""
    solve = inner_solver if inner_solver is not None else cgls
    m = m0
    dnorm = float(F.rng.norm(d))
    residuals = []
    inner_its = []
    converged = False
    for k in range(outer_iters):
        r = tr.sub(d, F(m))
        rnorm = float(F.rng.norm(r))
        residuals.append(rnorm)
        if callback is not None:
            callback(k, m, rnorm)
        if rnorm <= 1e-12 * max(dnorm, 1e-30):
            converged = True  # already at the data
            break
        J = F.linearize(m)
        res = solve(J, r, maxiter=inner_iters, tol=inner_tol)
        inner_its.append(int(res.iterations))
        m = tr.xpay(m, step, res.x)
    if not converged:
        residuals.append(float(F.rng.norm(tr.sub(d, F(m)))))
    return GNResult(m, residuals, inner_its)
