"""Krylov solvers (counterpart of ``jets_tpu/solvers/krylov.py``): LSQR.

The JAX package runs each solver as one ``lax.while_loop`` program; here
the loop is a Python loop that reads the residual estimate ``|phibar|`` on
the host once per iteration to decide whether to go on. Every other
quantity stays on the device: the recurrence scalars are 0-d tensors that
the kernels read through device pointers, and the residual history is
written on the device.

The solver updates ``x`` and ``w`` in place (kernel K1 on CUDA float32, the
counterpart of the Pallas kernel's buffer aliasing). It clones ``x0`` and a
``state=`` it is handed once, on entry, so a caller's tensors are never
mutated and a saved state can be resumed from more than once.

CG, CGLS, LSMR and the other solvers are not ported yet.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch

from ..core.jet import AdjointOperator, LinearOperator
from ..ops.cuda_solver import xw_update
from ..utils import tree as tr

__all__ = ["lsqr", "LSQRState", "SolveResult"]


def _normalize(space, vct):
    """(vct/‖vct‖, ‖vct‖) with a safe division at exact zero."""
    n = space.norm(vct)
    safe = torch.where(n > 0, n, 1.0)
    return tr.scale(1.0 / safe, vct), n


def _sym_ortho(a, bb):
    """Stable Givens rotation (c, s, r) with the (0, 0) -> (1, 0, 0)
    convention, so recurrences stay NaN-free after exact convergence.

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


def _xw_update(x, w, v_hat, t1, t2, inv_a):
    """``x' = x + t1·w, w' = inv_a·v_hat + t2·w``. Float32 tensors of one
    shape go through K1 (``cuda_solver.xw_update``: the CUDA kernel on the
    card, its plain version on the CPU), updating x and w in place; any
    other member type takes the generic elementwise form."""
    if (
        isinstance(x, torch.Tensor)
        and isinstance(w, torch.Tensor)
        and isinstance(v_hat, torch.Tensor)
        and x.shape == w.shape == v_hat.shape
        and x.dtype == w.dtype == v_hat.dtype == torch.float32
    ):
        return xw_update(x, w, v_hat, t1, t2, inv_a)
    x = tr.xpay(x, t1, w)
    w = tr.tmap(lambda vh, ww: inv_a * vh + t2 * ww, v_hat, w)
    return x, w


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
    return tr.tmap(lambda t: t.clone() if isinstance(t, torch.Tensor) else t, x)


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
    hist = torch.full((maxiter,), float("inf"), dtype=st.phibar.dtype,
                      device=st.phibar.device)
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
        rho_safe = torch.where(rho > 0, rho, 1.0)
        t1 = torch.where(rho > 0, phi / rho_safe, 0.0)
        t2 = torch.where(rho > 0, -theta / rho_safe, 0.0)
        an_safe = torch.where(alpha > 0, alpha, 1.0)
        inv_a = 1.0 / an_safe
        x, w = _xw_update(st.x, st.w, v_hat, t1, t2, inv_a)
        hist[st.i] = torch.abs(phibar)
        st = LSQRState(x, u_next, v_hat, w, alpha, phibar, rhobar, st.i + 1)

    return SolveResult(st.x, st.i, torch.abs(st.phibar), hist, st)
