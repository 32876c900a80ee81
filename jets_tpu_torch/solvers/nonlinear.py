"""Nonlinear first-order solvers: NLCG and L-BFGS (counterpart of
``jets_tpu/solvers/nonlinear.py``).

The JAX package runs a whole solve, line searches included, as one
``lax.while_loop`` with every branch a masked select. Here the loop is a
Python loop that reads from the device only the scalars it branches on:
the stopping test once per iteration, the Armijo test once per trial step,
and (L-BFGS) the curvature test once per iteration. A line search stops at
its first accepted trial, which computes what the masked loop computes.
Everything else stays on the device, and every tensor lives on the device
of ``m0`` (or of the state resumed from).

* Gradients of the least-squares objective come from the operators'
  adjoints (``g = J(m)ᴴ r`` through ``linearize`` and ``adjoint``), the
  adjoint-state route, not autodiff through the forward: with a stored
  adjoint the wave operators run their hand-written reverse sweeps.
* L-BFGS keeps its pairs in a ``(mem, n)`` ring of raveled vectors
  (:func:`jets_tpu_torch.utils.tree.ravel_pytree`, JAX's layout).
* The line search is backtracking Armijo, monotone, and keeps the point
  when every trial fails.

``bounds=(lo, hi)`` switches both solvers to their projected variants; the
state is a NamedTuple a later call resumes from.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch
from torch.utils import _pytree as pytree

from ..core.jet import Operator, adjoint, linearize
from ..utils import tree as tr
from ..utils.profiling import span

__all__ = [
    "nlcg",
    "lbfgs",
    "least_squares_objective",
    "NLCGState",
    "LBFGSState",
    "OptResult",
]


def least_squares_objective(F: Operator, d) -> Callable:
    """``fg(m) -> (phi, grad)`` for ``phi = ½‖F(m) − d‖²``, the gradient by
    the adjoint-state route ``g = J(m)ᴴ r`` (the operator's own adjoint, not
    autodiff through the propagator). Each evaluation is a span
    ``objective``."""

    def fg(m):
        with span("objective"):
            r = tr.sub(F(m), d)
            phi = 0.5 * torch.real(F.rng.dot(r, r))
            g = adjoint(linearize(F, m))(r)
        return phi, g

    return fg


class OptResult(NamedTuple):
    m: Any
    iterations: int
    phi: torch.Tensor
    gnorm: torch.Tensor
    history: torch.Tensor  # phi per iteration (inf-padded to maxiter)
    state: Any


def _dot(x, y):
    return torch.real(torch.vdot(tr.ravel_pytree(x)[0], tr.ravel_pytree(y)[0]))


def _norm(x):
    return torch.sqrt(_dot(x, x))


def _inv_clamped(x):
    """``1 / max(x, 1e-30)``."""
    return 1.0 / torch.clamp(x, min=1e-30)


def _make_proj(bounds):
    """Box-constraint machinery from ``bounds = (lo, hi)``: each side is
    ``None`` (unbounded), a scalar (applied to every leaf), or a pytree
    congruent with the model (per-leaf bounds, e.g. a BlockVector bounding
    only the velocity block). Returns ``(proj, pgrad)``: ``proj`` clips onto
    the box and ``pgrad`` masks gradient components that point out of the
    box at active constraints; ``None`` for an unconstrained problem, so
    the solvers keep their unconstrained trace exactly."""
    if bounds is None:
        return None
    lo, hi = bounds
    if lo is None and hi is None:
        return None

    def _leafwise(f, b, *trees):
        """Map ``f(leaf..., bound_leaf)`` with ``b`` either congruent with
        the model pytree (per-leaf bounds) or broadcast to every leaf."""
        if pytree.tree_structure(b) == pytree.tree_structure(trees[0]):
            return tr.tmap(f, *trees, b)
        return tr.tmap(lambda *xs: f(*xs, b), *trees)

    def proj(m):
        if lo is not None:
            m = _leafwise(lambda x, b: torch.clamp(x, min=b), lo, m)
        if hi is not None:
            m = _leafwise(lambda x, b: torch.clamp(x, max=b), hi, m)
        return m

    def pgrad(m, g):
        """Active-set projected gradient: at an active lower bound only
        components that keep the point feasible (g <= 0, since the step is
        ``-g``) survive; symmetrically at the upper bound. This measures
        first-order optimality WITHOUT forming ``m - g`` (whose projection
        underflows in f32 whenever ``|g| << ulp(|m|)``, exactly the FWI
        regime: velocity ~1.5e3, gradient ~1e-16)."""
        if lo is not None:
            g = _leafwise(lambda gg, x, b: torch.where(x <= b, torch.clamp(gg, max=0.0),
                                                       gg), lo, g, m)
        if hi is not None:
            g = _leafwise(lambda gg, x, b: torch.where(x >= b, torch.clamp(gg, min=0.0),
                                                       gg), hi, g, m)
        return g

    return proj, pgrad


def _pgnorm(m, g, pb):
    """Projected-gradient norm, the first-order optimality measure for box
    constraints (exactly ``‖g‖`` when unconstrained)."""
    if pb is None:
        return _norm(g)
    return _norm(pb[1](m, g))


def _armijo(fg, m, phi, g, p, alpha0, *, c1, ls_max, proj=None):
    """Backtracking line search: the largest ``alpha0 / 2^k`` (k < ls_max)
    with ``phi(m + a p) <= phi + c1 a <g, p>``. Returns ``(m_new, phi_new,
    g_new, alpha, ok)``. If every trial fails, the point is kept and
    ``ok=False`` (``alpha`` is then ``alpha0 / 2^ls_max``): callers reseed
    their step rather than trust it. With ``proj`` the trial point is
    projected onto the box and the decrease term is ``c1 <g, P(m + a p) −
    m>`` (projected backtracking, Bertsekas), clamped at 0."""
    gTp = _dot(g, p)
    alpha = alpha0
    for _ in range(ls_max):
        m_try = tr.xpay(m, alpha, p)
        if proj is not None:
            m_try = proj(m_try)
            # For p = −g the Bertsekas term is ≤ 0, but for NLCG/L-BFGS
            # directions it can turn positive at active constraints (the
            # projection bends the step toward +g) and would accept a trial
            # with a higher objective: clamped at 0, acceptance always
            # requires non-increase.
            dec = torch.clamp(c1 * _dot(g, tr.sub(m_try, m)), max=0.0)
        else:
            dec = c1 * alpha * gTp
        phi_try, g_try = fg(m_try)
        if bool(phi_try <= phi + dec):  # one host read per trial
            return m_try, phi_try, g_try, alpha, True
        alpha = 0.5 * alpha
    return m, phi, g, alpha, False


def _history(maxiter, phi):
    return torch.full((maxiter,), float("inf"), dtype=phi.dtype, device=phi.device)


def _where_descent(gTp, p, g):
    """``p`` where ``<g, p> < 0`` (a descent direction), else ``-g``, on the
    device."""
    return tr.tmap(lambda pp, gg: torch.where(gTp < 0, pp, -gg), p, g)


class NLCGState(NamedTuple):
    m: Any
    phi: torch.Tensor
    g: Any
    p: Any
    alpha: torch.Tensor
    g0norm: torch.Tensor  # ‖grad‖ at the ORIGINAL start, kept across resume
    i: int


def nlcg(
    fg: Callable,
    m0,
    *,
    maxiter: int = 100,
    tol: float = 1e-6,
    ls_max: int = 25,
    c1: float = 1e-4,
    bounds=None,
    state: NLCGState = None,
) -> OptResult:
    """Nonlinear conjugate gradients (Polak–Ribière+, restarting along
    ``-g`` when the PR beta goes negative or the direction loses descent).
    ``bounds=(lo, hi)`` switches to the projected variant (trial points
    clipped onto the box, the projected-gradient stopping rule), the
    velocity-bound constraint of production FWI. Stops at ``maxiter`` (the
    total count, resumed runs included) or once the projected-gradient
    norm falls to ``tol`` times its value at the original start."""
    pb = _make_proj(bounds)
    proj = None if pb is None else pb[0]
    if state is None:
        if proj is not None:
            m0 = proj(m0)
        phi0, g0 = fg(m0)
        st = NLCGState(m0, phi0, g0, tr.scale(-1.0, g0), _inv_clamped(_norm(g0)),
                       _pgnorm(m0, g0, pb), 0)
    else:
        st = state
    # the relative tolerance's baseline travels with the state, so a resumed
    # run continues the original stopping rule
    hist = _history(maxiter, st.phi)

    while st.i < maxiter and bool(_pgnorm(st.m, st.g, pb) > tol * st.g0norm):
        p = _where_descent(_dot(st.g, st.p), st.p, st.g)
        m, phi, g, alpha, ok = _armijo(
            fg, st.m, st.phi, st.g, p, torch.clamp(st.alpha, min=1e-30) * 2.0, c1=c1,
            ls_max=ls_max, proj=proj)
        if not ok:
            # a fully failed search keeps the point; reseed the step from the
            # gradient scale instead of letting alpha collapse toward 0
            alpha = _inv_clamped(_norm(g))
        # Polak–Ribière+ beta with restart floor at 0
        y = tr.sub(g, st.g)
        beta = torch.clamp(_dot(g, y) / torch.clamp(_dot(st.g, st.g), min=1e-30), min=0.0)
        p_new = tr.tmap(lambda gg, pp: -gg + beta * pp, g, p)
        hist[st.i] = phi
        st = NLCGState(m, phi, g, p_new, alpha, st.g0norm, st.i + 1)
    return OptResult(st.m, st.i, st.phi, _pgnorm(st.m, st.g, pb), hist, st)


class LBFGSState(NamedTuple):
    m: Any
    phi: torch.Tensor
    g: Any
    S: torch.Tensor  # (mem, n) model-step ring
    Y: torch.Tensor  # (mem, n) gradient-step ring
    rho: torch.Tensor  # (mem,) 1/<y, s>
    head: int  # next write slot
    count: int  # filled slots (<= mem)
    alpha: torch.Tensor
    g0norm: torch.Tensor  # ‖grad‖ at the ORIGINAL start, kept across resume
    i: int


def _two_loop(g, st, mem):
    """``H g`` by the two-loop recursion over the filled ring slots, newest
    first (slot ``(head − 1 − j) mod mem``), then oldest first."""
    q, unravel = tr.ravel_pytree(g)
    slots = [(st.head - 1 - j) % mem for j in range(st.count)]
    a = {}
    for k in slots:
        a[k] = st.rho[k] * torch.dot(st.S[k], q)
        q = q - a[k] * st.Y[k]
    r = q
    if st.count > 0:
        # initial Hessian scale gamma = <s, y>/<y, y> of the newest pair
        k = slots[0]
        yy = torch.dot(st.Y[k], st.Y[k])
        gamma = torch.where(yy > 0, _inv_clamped(st.rho[k]) / torch.clamp(yy, min=1e-30),
                            1.0)
        r = gamma * q
    for k in reversed(slots):
        b = st.rho[k] * torch.dot(st.Y[k], r)
        r = r + (a[k] - b) * st.S[k]
    return unravel(r)


def lbfgs(
    fg: Callable,
    m0,
    *,
    maxiter: int = 100,
    mem: int = 10,
    tol: float = 1e-6,
    ls_max: int = 25,
    c1: float = 1e-4,
    bounds=None,
    state: LBFGSState = None,
) -> OptResult:
    """Limited-memory BFGS with the two-loop recursion over a ``mem``-pair
    ring and a backtracking Armijo line search; a pair enters the ring only
    when its curvature ``<s, y>`` is positive beyond roundoff, and a
    direction that is not one of descent falls back to ``-g``.
    ``bounds=(lo, hi)`` switches to the projected variant (each side
    ``None``, a scalar or a model-congruent pytree, e.g. a BlockVector that
    bounds only the velocity block). The ring is cloned from a ``state``
    on entry, so a saved state can be resumed from more than once."""
    pb = _make_proj(bounds)
    proj = None if pb is None else pb[0]
    if state is None:
        if proj is not None:
            m0 = proj(m0)
        phi0, g0 = fg(m0)
        gflat0 = tr.ravel_pytree(g0)[0]
        n, dt, dev = gflat0.shape[0], gflat0.dtype, gflat0.device
        st = LBFGSState(m0, phi0, g0, torch.zeros((mem, n), dtype=dt, device=dev),
                        torch.zeros((mem, n), dtype=dt, device=dev),
                        torch.zeros((mem,), dtype=dt, device=dev), 0, 0,
                        torch.ones((), dtype=dt, device=dev), _pgnorm(m0, g0, pb), 0)
    else:
        st = state._replace(S=state.S.clone(), Y=state.Y.clone(), rho=state.rho.clone())
    hist = _history(maxiter, st.phi)

    while st.i < maxiter and bool(_pgnorm(st.m, st.g, pb) > tol * st.g0norm):
        p = tr.scale(-1.0, _two_loop(st.g, st, mem))
        # safeguard: fall back to steepest descent if not a descent direction
        p = _where_descent(_dot(st.g, p), p, st.g)
        alpha0 = torch.ones_like(st.alpha) if st.count > 0 else _inv_clamped(_norm(st.g))
        m, phi, g, alpha, _ok = _armijo(fg, st.m, st.phi, st.g, p, alpha0, c1=c1,
                                        ls_max=ls_max, proj=proj)
        s_f = tr.ravel_pytree(tr.sub(m, st.m))[0]
        y_f = tr.ravel_pytree(tr.sub(g, st.g))[0]
        sy = torch.dot(s_f, y_f)
        head, count = st.head, st.count
        accept = sy > 1e-12 * torch.clamp(torch.linalg.vector_norm(s_f)
                                          * torch.linalg.vector_norm(y_f), min=1e-30)
        if bool(accept):  # one host read per iteration
            st.S[head] = s_f
            st.Y[head] = y_f
            st.rho[head] = 1.0 / sy
            head, count = (head + 1) % mem, min(count + 1, mem)
        hist[st.i] = phi
        st = LBFGSState(m, phi, g, st.S, st.Y, st.rho, head, count, alpha, st.g0norm,
                        st.i + 1)
    return OptResult(st.m, st.i, st.phi, _pgnorm(st.m, st.g, pb), hist, st)
