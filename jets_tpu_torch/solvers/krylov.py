"""Krylov solvers (counterpart of ``jets_tpu/solvers/krylov.py``): CG,
CGLS, LSQR, LSMR, MINRES, BiCGStab, GMRES and Chebyshev.

The JAX package runs each solver as one ``lax.while_loop`` program; here
the loop is a Python loop that reads one residual estimate on the host per
iteration to decide whether to go on (CG ``rnorm``, CGLS ``sqrt(gamma)``,
LSQR ``|phibar|``, LSMR ``|zetabar|``). Every other quantity stays on the
device: the recurrence scalars are 0-d tensors that the kernels read
through device pointers, the guarded divisions are ``torch.where`` on the
device, and the residual history is written on the device.

On float32 tensors of one shape the solver tails update their vectors in
place through the kernels of :mod:`jets_tpu_torch.ops.cuda_solver` (the
counterpart of the Pallas kernels' buffer aliasing; the plain versions on
the CPU): LSQR's x/w through K1, CG's x/r (with ``rho``) through K6a and p
through K6b, LSMR's h/hbar/x through K7. Block vectors and other dtypes
take the generic tree form, as in the JAX package; a float32 member whose
layout the kernels cannot take makes the wrapper raise. Each solver clones
``x0`` and a ``state=`` it is handed once, on entry, into contiguous
buffers, so a caller's tensors are never mutated and a saved state can be
resumed from more than once; buffers a kernel writes never alias one
another (CG's start ``p = r`` is a copy).

MINRES, BiCGStab, GMRES (with complex Givens rotations), Chebyshev and
``estimate_spectral_bounds`` are plain PyTorch (the JAX package has no
Pallas kernel on them) with the same conventions: one host read per
iteration (GMRES: per restart cycle; Chebyshev: per ``check_every``
iterations), 0-d device scalars, states cloned on entry, and the history
written on the device.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch
from torch.utils import _pytree as pytree

from ..core.jet import AdjointOperator, LinearOperator
from ..core.spaces import true_div
from ..ops.cuda_solver import cg_update, lsmr_update, p_update, xw_update
from ..utils import tree as tr

__all__ = ["cg", "cgls", "lsqr", "lsmr", "minres", "bicgstab", "gmres", "chebyshev",
           "estimate_spectral_bounds", "CGState", "CGLSState", "LSQRState",
           "LSMRState", "MINRESState", "BiCGStabState", "GMRESState",
           "ChebyshevState", "SolveResult"]


def _normalize(space, vct):
    """(vct/‖vct‖, ‖vct‖) with a safe division at exact zero."""
    n = space.norm(vct)
    safe = torch.where(n > 0, n, 1.0)
    return tr.scale(1.0 / safe, vct), n


def _sym_ortho(a, bb):
    """Stable Givens rotation (c, s, r) with the (0, 0) -> (1, 0, 0)
    convention, so recurrences stay NaN-free after exact convergence (the
    rotations of LSQR and all three of LSMR).

    ``r`` is ``hypot(a, bb)``, not the JAX package's ``sqrt(a**2 + bb**2)``:
    once LSQR has converged, ``rhobar`` decays below ~1e-19 in float32 and
    its square falls among the denormals, which keep a few bits only. XLA
    flushes denormals to zero, so there the rotation degenerates to the
    (1, 0, 0) convention; the card and PyTorch on the CPU keep them, and
    ``|c|`` then strays from 1 by up to 13%, so the residual estimate
    ``phibar`` jumps. ``hypot`` never squares, so ``|c| = 1`` holds exactly
    for ``bb = 0`` and ``|s| <= 1`` always."""
    r = torch.hypot(a, bb)
    rsafe = torch.where(r > 0, r, 1.0)
    c = torch.where(r > 0, a / rsafe, 1.0)
    s = torch.where(r > 0, bb / rsafe, 0.0)
    return c, s, r


def _adjoint_axpy_norm(A, dd, v, s, dom):
    """``v_hat = A^H dd + s·v`` and ``‖v_hat‖`` — through the operator's
    fused epilogue hook when its state advertises one
    (``adjoint_axpy_norm``; the 3-D seismic flagship with
    ``epilogue_hook=True``), else the generic three-step form."""
    jet = getattr(A, "jet", None)
    hook = None
    if jet is not None and not isinstance(A, AdjointOperator):
        hook = jet.state.get("adjoint_axpy_norm")
    if hook is not None:
        return hook(dd, v, s, jet.state)
    v_hat = tr.axpy(s, v, A.adjoint_apply(dd))
    return v_hat, dom.norm(v_hat)


def _f32_tensors(*vs):
    """True when every vector is a float32 tensor of one shape: the members
    the solver-tail kernels take. The route reads dtype and shape only, so a
    float32 member with a layout the kernels cannot take reaches the wrapper,
    which raises, instead of slipping onto the tree path."""
    return (all(isinstance(v, torch.Tensor) and v.dtype == torch.float32 for v in vs)
            and len({v.shape for v in vs}) == 1)


def _xw_update(x, w, v_hat, t1, t2, inv_a):
    """``x' = x + t1·w, w' = inv_a·v_hat + t2·w``. Float32 tensors of one
    shape go through K1 (``cuda_solver.xw_update``: the CUDA kernel on the
    card, its plain version on the CPU), updating x and w in place; any
    other member type takes the generic elementwise form."""
    if _f32_tensors(x, w, v_hat):
        return xw_update(x, w, v_hat, t1, t2, inv_a)
    x = tr.xpay(x, t1, w)
    w = tr.tmap(lambda vh, ww: inv_a * vh + t2 * ww, v_hat, w)
    return x, w


def _lsmr_model_update(v_hat, h, hbar, x, c_hb, c_x, c_h, inv_a):
    """LSMR's model-space tail ``hbar' = h + c_hb·hbar``, ``x' = x +
    c_x·hbar'``, ``h' = inv_a·v_hat + c_h·h``: through K7 (in place) for
    float32 tensors of one shape, generic tree maps otherwise. Returns
    ``(h', hbar', x')``."""
    if _f32_tensors(v_hat, h, hbar, x):
        return lsmr_update(v_hat, h, hbar, x, c_hb, c_x, c_h, inv_a)
    hbar = tr.tmap(lambda h_, hb: h_ + c_hb * hb, h, hbar)
    x = tr.xpay(x, c_x, hbar)
    h = tr.tmap(lambda vh, h_: inv_a * vh + c_h * h_, v_hat, h)
    return h, hbar, x


def _cg_xr_update(dom, x, r, p, q, alpha):
    """``x' = x + α·p, r' = r − α·q, rho' = <r', r'>``: through K6a (x, r in
    place, rho summed in the same pass) for float32 tensors of one shape,
    generic tree maps otherwise."""
    if _f32_tensors(x, r, p, q):
        return cg_update(x, r, p, q, alpha)
    x = tr.xpay(x, alpha, p)
    r = tr.xpay(r, -alpha, q)
    return x, r, torch.real(dom.dot(r, r))


def _cg_p_update(r, p, beta):
    """``p' = r + β·p``: through K6b (p in place) for float32 tensors of one
    shape, a generic tree map otherwise."""
    if _f32_tensors(r, p):
        return p_update(r, p, beta)
    return tr.xpay(r, beta, p)


def _guarded_div(num, den):
    """``num/den`` where ``den > 0``, else 0: the JAX package's guard that
    keeps a converged recurrence idle instead of NaN, on the device."""
    return torch.where(den > 0, num / torch.where(den > 0, den, 1.0), 0.0)


class SolveResult(NamedTuple):
    x: Any
    iterations: int
    resnorm: torch.Tensor
    history: torch.Tensor  # residual-norm estimate per iteration (inf-padded)
    state: Any  # final solver state — pass back via ``state=`` to resume


class LSQRState(NamedTuple):
    x: Any
    u: Any  # data-space Lanczos vector
    v: Any  # model-space Lanczos vector, UNNORMALIZED (‖v‖ = alpha)
    w: Any  # search direction
    alpha: torch.Tensor
    phibar: torch.Tensor  # signed residual-norm estimate
    rhobar: torch.Tensor
    i: int


def _clone(x):
    """A contiguous copy of every tensor in ``x``: the buffers the kernels
    update in place."""
    return tr.tmap(lambda t: t.clone(memory_format=torch.contiguous_format)
                   if isinstance(t, torch.Tensor) else t, x)


def _history(maxiter, like):
    return torch.full((maxiter,), float("inf"), dtype=like.dtype, device=like.device)


# ---------------------------------------------------------------------------
# CG — Hermitian positive-definite systems A x = b
# ---------------------------------------------------------------------------


class CGState(NamedTuple):
    x: Any
    r: Any
    p: Any
    rho: torch.Tensor
    rnorm: torch.Tensor  # carried so the stopping test costs no extra reduction
    i: int


def cg(
    A: LinearOperator,
    b,
    x0=None,
    *,
    maxiter: int = 100,
    tol: float = 1e-6,
    M: Optional[LinearOperator] = None,
    state: Optional[CGState] = None,
) -> SolveResult:
    """(Preconditioned) conjugate gradients on a Hermitian positive-definite
    operator (self-adjoint on its space, as the dot-product gate certifies;
    e.g. :func:`~jets_tpu_torch.solvers.precond.normal_operator`).

    ``M`` is an optional SPD preconditioner applying the approximate
    INVERSE of ``A`` (e.g. :func:`~jets_tpu_torch.solvers.precond.
    jacobi_preconditioner`); with ``M`` set, ``rho`` tracks ``<r, M r>``,
    the updates are generic tree maps (as in the JAX package) and the
    stopping test uses the true residual norm. Without ``M``, ``rho = <r,
    r>`` is the squared residual norm: the x/r update with its ``rho``
    (K6a) and the p update (K6b) each run as one in-place pass.

    Iterations stop at ``maxiter`` (the total count, resumed runs included)
    or once ``rnorm <= tol * ||b||``; ``history`` holds ``rnorm`` per
    iteration, inf where none ran."""
    dom = A.dom
    bnorm = dom.norm(b)
    if state is None:
        x = dom.zeros() if x0 is None else _clone(x0)
        # K6a updates r and K6b p in place: r is laid out densely (it takes
        # b's strides otherwise) and p starts as a copy of z
        r = tr.tmap(torch.Tensor.contiguous, tr.sub(b, A(x)))
        z = r if M is None else M(r)
        st = CGState(x, r, _clone(z), torch.real(dom.dot(r, z)), dom.norm(r), 0)
    else:
        st = CGState(*(_clone(f) for f in state))
    threshold = tol * bnorm
    hist = _history(maxiter, bnorm)

    while st.i < maxiter and bool(st.rnorm > threshold):
        q = A(st.p)
        alpha = _guarded_div(st.rho, torch.real(dom.dot(st.p, q)))
        if M is None:
            x, r, rho = _cg_xr_update(dom, st.x, st.r, st.p, q, alpha)
            p = _cg_p_update(r, st.p, _guarded_div(rho, st.rho))
            rnorm = torch.sqrt(rho)
        else:
            x = tr.xpay(st.x, alpha, st.p)
            r = tr.xpay(st.r, -alpha, q)
            z = M(r)
            rho = torch.real(dom.dot(r, z))
            p = tr.xpay(z, _guarded_div(rho, st.rho), st.p)
            rnorm = dom.norm(r)
        hist[st.i] = rnorm
        st = CGState(x, r, p, rho, rnorm, st.i + 1)

    return SolveResult(st.x, st.i, st.rnorm, hist, st)


# ---------------------------------------------------------------------------
# CGLS — least squares min ||A x - b||, normal equations in stable form
# ---------------------------------------------------------------------------


class CGLSState(NamedTuple):
    x: Any
    r: Any  # data-space residual b - A x
    s: Any  # model-space gradient A' r
    p: Any
    gamma: torch.Tensor  # ||s||^2
    i: int


def cgls(
    A: LinearOperator,
    b,
    x0=None,
    *,
    maxiter: int = 100,
    tol: float = 1e-6,
    state: Optional[CGLSState] = None,
) -> SolveResult:
    """CGLS: conjugate gradients on the normal equations without forming
    ``A'A`` — one forward and one adjoint application per iteration, every
    update a generic tree map (no kernel; nothing is updated in place, so
    the start state may share ``b``).

    Stops at ``maxiter`` or once ``||A' r|| <= tol * ||A' b||``;
    ``history`` holds ``||r||`` per iteration."""
    dom, rng = A.dom, A.rng
    s_b = A.adjoint_apply(b)
    snorm0 = dom.norm(s_b)
    if state is None:
        if x0 is None:
            x, r, s = dom.zeros(), b, s_b
        else:
            x = _clone(x0)
            r = tr.sub(b, A(x))
            s = A.adjoint_apply(r)
        st = CGLSState(x, r, s, s, torch.real(dom.dot(s, s)), 0)
    else:
        st = CGLSState(*(_clone(f) for f in state))
    threshold = tol * snorm0
    hist = _history(maxiter, snorm0)

    while st.i < maxiter and bool(torch.sqrt(st.gamma) > threshold):
        q = A(st.p)
        # guarded divisions: at exact convergence delta/gamma collapse to 0;
        # idle (alpha = beta = 0) instead of poisoning the carry with NaN
        alpha = _guarded_div(st.gamma, torch.real(rng.dot(q, q)))
        x = tr.xpay(st.x, alpha, st.p)
        r = tr.xpay(st.r, -alpha, q)
        s = A.adjoint_apply(r)
        gamma = torch.real(dom.dot(s, s))
        p = tr.xpay(s, _guarded_div(gamma, st.gamma), st.p)
        hist[st.i] = rng.norm(r)
        st = CGLSState(x, r, s, p, gamma, st.i + 1)

    return SolveResult(st.x, st.i, rng.norm(st.r), hist, st)


def lsqr(
    A: LinearOperator,
    b,
    x0=None,
    *,
    maxiter: int = 100,
    tol: float = 1e-6,
    damp: float = 0.0,
    state: Optional[LSQRState] = None,
) -> SolveResult:
    """LSQR (Paige & Saunders 1982) for ``min ||A x - b||^2 + damp^2 ||x||^2``,
    with the recurrence of the JAX package: the model-space Lanczos vector
    is kept unnormalized (the ``1/alpha`` folds into the scalars), the
    adjoint tail may run through the operator's epilogue hook, and x/w are
    updated in one pass.

    Iterations stop at ``maxiter`` (the total count, resumed runs included)
    or once ``|phibar| <= tol * ||b||``. ``history`` has length ``maxiter``
    and is inf where no iteration ran.
    """
    dom, rng = A.dom, A.rng
    if state is None:
        if x0 is None:
            x = dom.zeros()
            r0 = b
        else:
            x = _clone(x0)
            r0 = tr.sub(b, A(x))
        u, beta = _normalize(rng, r0)
        v_hat = A.adjoint_apply(u)  # unnormalized; ‖v_hat‖ = alpha
        alpha = dom.norm(v_hat)
        a_safe = torch.where(alpha > 0, alpha, 1.0)
        w = tr.scale(1.0 / a_safe, v_hat)
        st = LSQRState(x, u, v_hat, w, alpha, beta, alpha, 0)
    else:
        st = LSQRState(*(_clone(f) for f in state))
    # the stopping baseline is ALWAYS ||b||, so a resumed run continues the
    # same criterion as a fresh one
    bnorm = rng.norm(b)
    threshold = tol * bnorm
    hist = _history(maxiter, st.phibar)
    damp = torch.as_tensor(damp, dtype=st.phibar.dtype, device=st.phibar.device)

    # one host read of |phibar| per iteration decides whether to go on
    while st.i < maxiter and bool(torch.abs(st.phibar) > threshold):
        # bidiagonalization with v stored unnormalized (v_math = v/alpha):
        #   beta u' = A v_math - alpha u  →  A(v)/alpha - alpha u
        a_safe = torch.where(st.alpha > 0, st.alpha, 1.0)
        u_next = tr.axpy(-st.alpha, st.u, tr.scale(1.0 / a_safe, A(st.v)))
        u_next, beta = _normalize(rng, u_next)
        #   alpha' v_math' = A' u' - beta v_math  →  v' = A'u' - (beta/alpha) v
        v_hat, alpha = _adjoint_axpy_norm(A, u_next, st.v, -beta / a_safe, dom)
        # eliminate damping (regularization) via an extra rotation
        c1, _, rhobar1 = _sym_ortho(st.rhobar, damp)
        phibar1 = c1 * st.phibar
        # plane rotation on the bidiagonal
        c, s, rho = _sym_ortho(rhobar1, beta)
        theta = s * alpha
        rhobar = -c * alpha
        phi = c * phibar1
        phibar = s * phibar1
        t1, t2 = _guarded_div(phi, rho), _guarded_div(-theta, rho)
        an_safe = torch.where(alpha > 0, alpha, 1.0)
        inv_a = 1.0 / an_safe
        x, w = _xw_update(st.x, st.w, v_hat, t1, t2, inv_a)
        hist[st.i] = torch.abs(phibar)
        st = LSQRState(x, u_next, v_hat, w, alpha, phibar, rhobar, st.i + 1)

    return SolveResult(st.x, st.i, torch.abs(st.phibar), hist, st)


# ---------------------------------------------------------------------------
# LSMR — Fong & Saunders (2011): MINRES on the normal equations through
# Golub-Kahan bidiagonalization; monotonic in ||A'r||.
# ---------------------------------------------------------------------------


class LSMRState(NamedTuple):
    x: Any
    u: Any
    v: Any  # model-space Lanczos vector, UNNORMALIZED (‖v‖ = alpha)
    h: Any  # search direction
    hbar: Any  # second recurrence direction
    alpha: torch.Tensor
    alphabar: torch.Tensor
    zeta: torch.Tensor
    zetabar: torch.Tensor
    rho: torch.Tensor
    rhobar: torch.Tensor
    cbar: torch.Tensor
    sbar: torch.Tensor
    i: int


def lsmr(
    A: LinearOperator,
    b,
    x0=None,
    *,
    maxiter: int = 100,
    tol: float = 1e-6,
    damp: float = 0.0,
    state: Optional[LSMRState] = None,
) -> SolveResult:
    """LSMR for ``min ||A x - b||^2 + damp^2 ||x||^2``, with the recurrence
    of the JAX package: one forward and one adjoint application per
    iteration (the adjoint tail through the operator's epilogue hook when it
    has one, K2 on the hooked flagship), the model-space Lanczos vector kept
    unnormalized, and h/hbar/x updated in one pass (K7). The three rotations
    use :func:`_sym_ortho`'s ``hypot``.

    Stops at ``maxiter`` or once ``|zetabar| <= tol * ||A' b||`` (the
    baseline recomputed on fresh and resumed runs alike); ``history`` holds
    the ``||A' r||`` estimate ``|zetabar|``."""
    dom, rng = A.dom, A.rng
    if state is None:
        if x0 is None:
            x = dom.zeros()
            r0 = b
        else:
            x = _clone(x0)
            r0 = tr.sub(b, A(x))
        u, beta = _normalize(rng, r0)
        v_hat = A.adjoint_apply(u)  # unnormalized; ‖v_hat‖ = alpha
        alpha = dom.norm(v_hat)
        a_safe = torch.where(alpha > 0, alpha, 1.0)
        h0 = tr.scale(1.0 / a_safe, v_hat)
        one, zero = torch.ones_like(alpha), torch.zeros_like(alpha)
        st = LSMRState(x=x, u=u, v=v_hat, h=h0, hbar=tr.scale(0.0, h0), alpha=alpha,
                       alphabar=alpha, zeta=zero, zetabar=alpha * beta, rho=one,
                       rhobar=one, cbar=one, sbar=zero, i=0)
    else:
        st = LSMRState(*(_clone(f) for f in state))
    threshold = tol * dom.norm(A.adjoint_apply(b))
    damp = torch.as_tensor(damp, dtype=st.zetabar.dtype, device=st.zetabar.device)
    hist = _history(maxiter, st.zetabar)

    while st.i < maxiter and bool(torch.abs(st.zetabar) > threshold):
        # Golub-Kahan step, v stored unnormalized (v_math = v/alpha)
        a_safe = torch.where(st.alpha > 0, st.alpha, 1.0)
        u_next = tr.axpy(-st.alpha, st.u, tr.scale(1.0 / a_safe, A(st.v)))
        u_next, beta = _normalize(rng, u_next)
        #   v' = A'u' - (beta/alpha) v ; alpha' = ‖v'‖ (hook-able)
        v_next, alpha = _adjoint_axpy_norm(A, u_next, st.v, -beta / a_safe, dom)
        # rotation eliminating damp
        _, _, alphahat = _sym_ortho(st.alphabar, damp)
        # rotation on the bidiagonal
        c, s, rho = _sym_ortho(alphahat, beta)
        thetanew = s * alpha
        alphabar = c * alpha
        # second rotation (the MINRES part)
        thetabar = st.sbar * rho
        cbar, sbar, rhobar = _sym_ortho(st.cbar * rho, thetanew)
        zeta = cbar * st.zetabar
        zetabar = -sbar * st.zetabar
        # update scalars (1/alpha' folded into the h recurrence)
        rho_s = torch.where(st.rho > 0, st.rho, 1.0)
        rb_s = torch.where(st.rhobar > 0, st.rhobar, 1.0)
        c_hb = -(thetabar * rho) / (rho_s * rb_s)
        c_x = zeta / torch.where(rho * rhobar > 0, rho * rhobar, 1.0)
        c_h = -(thetanew / torch.where(rho > 0, rho, 1.0))
        inv_a = 1.0 / torch.where(alpha > 0, alpha, 1.0)
        h, hbar, x = _lsmr_model_update(v_next, st.h, st.hbar, st.x, c_hb, c_x, c_h,
                                        inv_a)
        hist[st.i] = torch.abs(zetabar)
        st = LSMRState(x=x, u=u_next, v=v_next, h=h, hbar=hbar, alpha=alpha,
                       alphabar=alphabar, zeta=zeta, zetabar=zetabar, rho=rho,
                       rhobar=rhobar, cbar=cbar, sbar=sbar, i=st.i + 1)

    return SolveResult(st.x, st.i, torch.abs(st.zetabar), hist, st)


def _pos_safe(x):
    return torch.where(x > 0, x, 1.0)


# ---------------------------------------------------------------------------
# MINRES — self-adjoint, possibly INDEFINITE systems A x = b (Paige &
# Saunders 1975)
# ---------------------------------------------------------------------------


class MINRESState(NamedTuple):
    x: Any
    v: Any  # current Lanczos vector (normalized)
    v_old: Any
    w1: Any  # previous two update directions
    w0: Any
    beta: torch.Tensor
    eta: torch.Tensor  # |eta| = current residual norm
    gamma1: torch.Tensor
    gamma0: torch.Tensor
    sigma1: torch.Tensor
    sigma0: torch.Tensor
    i: int


def minres(
    A: LinearOperator,
    b,
    x0=None,
    *,
    maxiter: int = 100,
    tol: float = 1e-6,
    state: Optional[MINRESState] = None,
) -> SolveResult:
    """MINRES on a self-adjoint operator (definite or indefinite): minimizes
    ``||A x - b||`` over the Krylov space with a monotone residual — one
    operator application, one Lanczos three-term recurrence and one Givens
    rotation per iteration (the rotation's ``rho1`` is a ``hypot``, as in
    :func:`_sym_ortho`).

    Stops at ``maxiter`` or once ``|eta| <= tol * ||b||``; ``history``
    holds ``|eta|``, the residual norm, per iteration."""
    dom = A.dom
    bnorm = dom.norm(b)
    if state is None:
        if x0 is None:
            x, r = dom.zeros(), b
        else:
            x = _clone(x0)
            r = tr.sub(b, A(x))
        beta1 = dom.norm(r)
        v = tr.scale(1.0 / _pos_safe(beta1), r)
        zero = tr.zeros_like(v)
        one, nul = torch.ones_like(beta1), torch.zeros_like(beta1)
        st = MINRESState(x, v, zero, zero, zero, nul, beta1, one, one, nul, nul, 0)
    else:
        st = MINRESState(*(_clone(f) for f in state))
    threshold = tol * bnorm
    hist = _history(maxiter, st.eta)

    while st.i < maxiter and bool(torch.abs(st.eta) > threshold):
        Av = A(st.v)
        alpha = torch.real(dom.dot(st.v, Av))
        v_next = tr.tmap(lambda av, vv, vo: av - alpha * vv - st.beta * vo,
                         Av, st.v, st.v_old)
        beta_next = dom.norm(v_next)
        v_next = tr.scale(1.0 / _pos_safe(beta_next), v_next)
        # apply the two previous rotations to the new tridiagonal column
        delta = st.gamma1 * alpha - st.gamma0 * st.sigma1 * st.beta
        rho2 = st.sigma1 * alpha + st.gamma0 * st.gamma1 * st.beta
        rho3 = st.sigma0 * st.beta
        rho1 = torch.hypot(delta, beta_next)
        r1s = _pos_safe(rho1)
        gamma = torch.where(rho1 > 0, delta / r1s, 1.0)
        sigma = torch.where(rho1 > 0, beta_next / r1s, 0.0)
        w_next = tr.tmap(lambda vv, w0, w1: (vv - rho3 * w0 - rho2 * w1) / r1s,
                         st.v, st.w0, st.w1)
        x = tr.xpay(st.x, gamma * st.eta, w_next)
        eta = -sigma * st.eta
        hist[st.i] = torch.abs(eta)
        st = MINRESState(x, v_next, st.v, w_next, st.w1, beta_next, eta, gamma,
                         st.gamma1, sigma, st.sigma1, st.i + 1)

    return SolveResult(st.x, st.i, torch.abs(st.eta), hist, st)


# ---------------------------------------------------------------------------
# BiCGStab — square nonsymmetric systems, two applications per iteration
# ---------------------------------------------------------------------------


class BiCGStabState(NamedTuple):
    x: Any
    r: Any
    rhat: Any  # fixed shadow residual
    p: Any
    v: Any
    rho: torch.Tensor
    alpha: torch.Tensor
    omega: torch.Tensor
    rnorm: torch.Tensor
    i: int


def _sdiv(num, den):
    """``num/den`` where ``den != 0``, else 0 (real or complex)."""
    ok = torch.abs(den) > 0
    return torch.where(ok, num / torch.where(ok, den, 1.0), 0.0)


def bicgstab(
    A: LinearOperator,
    b,
    x0=None,
    *,
    maxiter: int = 100,
    tol: float = 1e-6,
    state: Optional[BiCGStabState] = None,
) -> SolveResult:
    """BiCGStab (van der Vorst) for a square, possibly nonsymmetric operator:
    two forward applications per iteration and no adjoint. Every division
    is guarded, so the recurrence parks instead of producing NaNs, and the
    fatal breakdown (``rho = <rhat, r> = 0`` with a nonzero residual) ends
    the loop: ``result.iterations < maxiter`` with the residual above
    tolerance shows it. Recurrence scalars live in the operator's field.

    Stops at ``maxiter`` or once ``||r|| <= tol * ||b||``; ``history``
    holds ``||r||`` per iteration."""
    dom = A.dom
    if state is None:
        if x0 is None:
            x, r = dom.zeros(), b
        else:
            x = _clone(x0)
            r = tr.sub(b, A(x))
        zero = tr.zeros_like(r)
        one = torch.ones((), dtype=dom.dtype, device=dom.device)
        st = BiCGStabState(x, r, r, zero, zero, one, one, one, dom.norm(r), 0)
    else:
        st = BiCGStabState(*(_clone(f) for f in state))
    bnorm = dom.norm(b)
    threshold = tol * bnorm
    hist = _history(maxiter, bnorm)

    # |rho| = 0 after the first iteration is the fatal breakdown: every later
    # step would be a no-op, so it ends the loop
    while st.i < maxiter and bool((st.rnorm > threshold) & (torch.abs(st.rho) > 0)):
        rho_new = dom.dot(st.rhat, st.r)
        beta = _sdiv(rho_new * st.alpha, st.rho * st.omega)
        p = tr.tmap(lambda r_, p_, v_: r_ + beta * (p_ - st.omega * v_), st.r, st.p, st.v)
        v = A(p)
        alpha = _sdiv(rho_new, dom.dot(st.rhat, v))
        s = tr.xpay(st.r, -alpha, v)
        t = A(s)
        omega = _sdiv(dom.dot(t, s), dom.dot(t, t))
        x = tr.tmap(lambda x_, p_, s_: x_ + alpha * p_ + omega * s_, st.x, p, s)
        r = tr.xpay(s, -omega, t)
        rnorm = dom.norm(r)
        hist[st.i] = rnorm
        st = BiCGStabState(x, r, st.rhat, p, v, rho_new, alpha, omega, rnorm, st.i + 1)

    return SolveResult(st.x, st.i, st.rnorm, hist, st)


# ---------------------------------------------------------------------------
# GMRES(restart) — square nonsymmetric systems, minimal residual
# ---------------------------------------------------------------------------


class GMRESState(NamedTuple):
    x: Any
    rnorm: torch.Tensor
    i: int  # total inner iterations so far (resume at a restart boundary)


def _dot_all(stack, leaves):
    """``<V_k, w>`` for every basis row ``k`` at once: one batched reduction
    per leaf (classical Gram-Schmidt), conjugate-linear in the basis."""
    return sum(torch.tensordot(torch.conj(s), w, dims=(list(range(1, s.ndim)),
                                                       list(range(w.ndim))))
               for s, w in zip(stack, leaves))


def _combine(stack, coeff):
    """``Σ_k coeff[k]·V_k`` per leaf of the stacked basis."""
    return [torch.tensordot(coeff, s, dims=1) for s in stack]


def _cgivens(f, g):
    """LAPACK ``lartg``-style Givens rotation for possibly complex ``f`` and
    ``g``: ``(c, s, r)`` with ``c`` real and ``[c s; -conj(s) c] @ [f; g] =
    [r; 0]`` — the complex form of :func:`_sym_ortho`, with its ``(0, 0) ->
    (1, 0, 0)`` convention and its ``hypot``."""
    af, ag = torch.abs(f), torch.abs(g)
    d = torch.hypot(af, ag)
    dsafe = _pos_safe(d)
    phase = torch.where(af > 0, f / _pos_safe(af), torch.ones_like(f))
    c = torch.where(d > 0, af / dsafe, 1.0)
    s = torch.where(d > 0, phase * torch.conj(g) / dsafe, torch.zeros_like(f))
    return c, s, phase * d


def gmres(
    A: LinearOperator,
    b,
    x0=None,
    *,
    maxiter: int = 100,
    restart: int = 20,
    tol: float = 1e-6,
    state: Optional[GMRESState] = None,
) -> SolveResult:
    """Restarted GMRES for a square, nonsymmetric operator (real or complex):
    minimizes ``||A x - b||`` over each restart cycle's Krylov space.

    The Arnoldi basis is a stack of ``restart + 1`` rows per leaf, so the
    orthogonalization is classical Gram-Schmidt run twice, two batched
    reductions per step (unfilled rows are zero, so no masking). Complex
    Givens rotations (:func:`_cgivens`) condense each Hessenberg column; the
    Hessenberg scalars live in the operator's field, the cosines are real.
    ``maxiter`` counts inner iterations, checked once per cycle (a run may
    end up to ``restart - 1`` past it); ``history`` holds the residual
    estimate ``|g[j+1]|`` per inner iteration. Resuming from ``state=``
    restarts at a cycle boundary, as a continuous run does."""
    dom = A.dom
    m = int(restart)
    bnorm = dom.norm(b)
    hdtype = dom.dtype if dom.dtype.is_complex else bnorm.dtype
    dev = bnorm.device
    leaves0, spec = pytree.tree_flatten(b)
    if state is None:
        if x0 is None:
            x, r = dom.zeros(), b
        else:
            x = _clone(x0)
            r = tr.sub(b, A(x))
        st = GMRESState(x, dom.norm(r), 0)
    else:
        st = GMRESState(*(_clone(f) for f in state))
    threshold = tol * bnorm
    hist = _history(maxiter, bnorm)

    while st.i < maxiter and bool(st.rnorm > threshold):
        r = tr.sub(b, A(st.x))
        beta = dom.norm(r)
        V = [torch.zeros((m + 1,) + leaf.shape, dtype=leaf.dtype, device=leaf.device)
             for leaf in leaves0]
        for row, leaf in zip(V, pytree.tree_leaves(tr.scale(1.0 / _pos_safe(beta), r))):
            row[0] = leaf
        H = torch.zeros((m + 1, m), dtype=hdtype, device=dev)
        cs = torch.zeros((m,), dtype=bnorm.dtype, device=dev)  # c is always real
        sn = torch.zeros((m,), dtype=hdtype, device=dev)
        g = torch.zeros((m + 1,), dtype=hdtype, device=dev)
        g[0] = beta
        for j in range(m):
            w = pytree.tree_leaves(A(pytree.tree_unflatten([row[j] for row in V], spec)))
            # CGS2: project twice against the whole (zero-padded) basis
            h = _dot_all(V, w)
            w = [wl - cl for wl, cl in zip(w, _combine(V, h))]
            h2 = _dot_all(V, w)
            w = [wl - cl for wl, cl in zip(w, _combine(V, h2))]
            hcol = (h + h2).to(hdtype)
            wnorm = torch.sqrt(sum(torch.real(torch.vdot(wl.reshape(-1), wl.reshape(-1)))
                                   for wl in w))
            for row, wl in zip(V, w):
                row[j + 1] = wl / _pos_safe(wnorm)
            hcol[j + 1] = wnorm
            # the previous rotations 0..j-1 on the new column (both new
            # entries are computed before either is written)
            for k in range(j):
                hcol[k], hcol[k + 1] = (cs[k] * hcol[k] + sn[k] * hcol[k + 1],
                                        -torch.conj(sn[k]) * hcol[k] + cs[k] * hcol[k + 1])
            c, s, rr = _cgivens(hcol[j], hcol[j + 1])
            hcol[j], hcol[j + 1] = rr, 0.0
            cs[j], sn[j] = c, s
            g[j], g[j + 1] = c * g[j], -torch.conj(s) * g[j]
            H[:, j] = hcol
            if st.i + j < maxiter:
                hist[st.i + j] = torch.abs(g[j + 1])
        # guard breakdown and early convergence: dead columns get a unit diagonal
        R = H[:m, :m]
        R = R + torch.diag((torch.abs(torch.diagonal(R)) == 0).to(hdtype))
        y = torch.linalg.solve_triangular(R, g[:m, None], upper=True)[:, 0]
        dx = pytree.tree_unflatten(_combine([row[:m] for row in V], y), spec)
        x = tr.add(st.x, dx)
        st = GMRESState(x, dom.norm(tr.sub(b, A(x))), st.i + m)

    return SolveResult(st.x, st.i, st.rnorm, hist, st)


# ---------------------------------------------------------------------------
# Chebyshev semi-iteration — an SPD solver without inner products
# ---------------------------------------------------------------------------


class ChebyshevState(NamedTuple):
    x: Any
    r: Any
    p: Any
    alpha: torch.Tensor
    beta: torch.Tensor
    i: int


def chebyshev(
    A: LinearOperator,
    b,
    lmin: float,
    lmax: float,
    x0=None,
    *,
    maxiter: int = 100,
    tol: float = 1e-6,
    check_every: int = 10,
    state: Optional[ChebyshevState] = None,
) -> SolveResult:
    """Chebyshev semi-iteration on an SPD operator with spectrum inside
    ``[lmin, lmax]`` (estimate them with :func:`estimate_spectral_bounds`;
    tensors are read once, on entry). The recurrence has no inner products:
    one operator application and three axpys per iteration; the residual
    norm is taken, and read on the host, every ``check_every`` iterations
    only, for the stopping test and the history (one entry per check).

    The test runs at ``check_every`` granularity, so a run may go up to
    ``check_every - 1`` iterations past ``maxiter`` (``iterations`` reports
    the true count). ``lmin`` must be a true lower bound: the iteration
    diverges on eigenmodes below it, while an overestimated ``lmax`` only
    slows it."""
    dom = A.dom
    lmin, lmax = float(lmin), float(lmax)
    theta = 0.5 * (lmax + lmin)
    delta = 0.5 * (lmax - lmin)
    bnorm = dom.norm(b)
    if state is None:
        if x0 is None:
            x, r = dom.zeros(), b
        else:
            x = _clone(x0)
            r = tr.sub(b, A(x))
        zero = torch.zeros_like(bnorm)
        st = ChebyshevState(x, r, tr.zeros_like(r), zero, zero, 0)
    else:
        st = ChebyshevState(*(_clone(f) for f in state))
    nchecks = -(-maxiter // check_every)
    hist = _history(nchecks, bnorm)
    threshold = tol * bnorm
    rnorm = dom.norm(st.r)

    while st.i < maxiter and bool(rnorm > threshold):
        for _ in range(check_every):
            # the Chebyshev recurrence on 0-d device scalars
            if st.i == 0:
                beta = torch.zeros_like(st.alpha)
                alpha = torch.full_like(st.alpha, 1.0 / theta)
            else:
                beta = (0.5 * (delta * st.alpha) ** 2 if st.i == 1
                        else (0.5 * delta * st.alpha) ** 2)
                alpha = 1.0 / (theta - beta / st.alpha)
            p = tr.xpay(st.r, beta, st.p)
            x = tr.xpay(st.x, alpha, p)
            r = tr.xpay(st.r, -alpha, A(p))
            st = ChebyshevState(x, r, p, alpha, beta, st.i + 1)
        rnorm = dom.norm(st.r)
        k = (st.i - 1) // check_every
        if k < nchecks:
            hist[k] = rnorm

    return SolveResult(st.x, st.i, rnorm, hist, st)


def estimate_spectral_bounds(
    A: LinearOperator,
    generator: Optional[torch.Generator] = None,
    *,
    iters: int = 30,
    safety: float = 1.05,
):
    """``(lmin, lmax)`` estimates (0-d tensors) for an SPD operator: power
    iteration for ``lmax`` (inflated by ``safety``), then power iteration on
    ``lmax I - A`` for ``lmin`` (deflated). The start vectors are drawn from
    ``generator`` (default: a CPU generator seeded with 23).

    The ``lmin`` deflation is deliberately aggressive: an unconverged power
    iteration on ``lmax I - A`` underestimates ``lmax - λ_min``, which would
    put ``lmin`` above the smallest eigenvalue (fatal for Chebyshev), so the
    shift is inflated by ``safety`` and the result deflated by it again."""
    dom = A.dom
    g = generator if generator is not None else torch.Generator().manual_seed(23)

    def power(op_apply, v, lam):
        for _ in range(iters):
            w = op_apply(v)
            lam = dom.norm(w)
            v = tr.scale(1.0 / _pos_safe(lam), w)
        return lam

    v1, n1 = _normalize(dom, dom.randn(g))
    lmax = power(A, v1, torch.zeros_like(n1)) * safety
    v2, n2 = _normalize(dom, dom.randn(g))
    lmin_shift = power(lambda v: tr.xpay(tr.scale(lmax, v), -1.0, A(v)), v2,
                       torch.zeros_like(n2))
    lmin = true_div(torch.clamp(lmax - safety * lmin_shift, min=0.0), safety)
    return lmin, lmax
