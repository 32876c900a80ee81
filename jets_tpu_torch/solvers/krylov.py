"""Krylov solvers (counterpart of ``jets_tpu/solvers/krylov.py``): CG,
CGLS, LSQR and LSMR.

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

MINRES, GMRES, BiCGStab, Chebyshev and ``estimate_spectral_bounds`` are not
ported yet.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch

from ..core.jet import AdjointOperator, LinearOperator
from ..ops.cuda_solver import cg_update, lsmr_update, p_update, xw_update
from ..utils import tree as tr

__all__ = ["cg", "cgls", "lsqr", "lsmr", "CGState", "CGLSState", "LSQRState",
           "LSMRState", "SolveResult"]


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
