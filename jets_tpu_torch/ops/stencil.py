"""Laplacian stencils (counterpart of the Laplacian half of
``jets_tpu/ops/stencil.py``).

:func:`laplacian_nd` keeps the JAX package's floating-point add tree, so on
the same inputs it is bitwise equal to the eager (non-jitted)
``jets_tpu.ops.stencil.laplacian_nd``; the hand-written 3-D CUDA kernel
(``ops/cuda_solver.laplacian3d``) keeps it too. :func:`d2_axis` is the
one-axis second derivative of the anisotropic wave physics (the JAX
package's ``ops/wave._d2_axis``), with its own tree, and :func:`d1_axis` the
one-axis first derivative of the TTI physics (``ops/wave._d1_axis``).
:func:`stencil_operator` applies a constant-coefficient stencil with a zero
boundary as one ``torch.nn.functional.conv{1,2,3}d`` (the JAX package's
``lax.conv_general_dilated``), its adjoint derived with
:func:`torch.func.vjp`; :func:`blur2d_operator` is the Gaussian blur of
BASELINE config 3 built on it.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F

from ..core.jet import Jet, LinearOperator
from ..core.spaces import Space, as_tensor

__all__ = ["laplacian_nd", "d2_axis", "d1_axis", "laplacian_operator",
           "stencil_operator", "blur2d_operator"]

# Central finite-difference coefficients of the second derivative,
# (c0, (c1, c2, ...)): d²u/dx² ≈ (c0*u[i] + Σ_s c_s*(u[i-s]+u[i+s])) / h².
_D2_COEFFS = {
    2: (-2.0, (1.0,)),
    4: (-5.0 / 2.0, (4.0 / 3.0, -1.0 / 12.0)),
    8: (
        -205.0 / 72.0,
        (8.0 / 5.0, -1.0 / 5.0, 8.0 / 315.0, -1.0 / 560.0),
    ),
}

# Central first-derivative coefficients, (c1, c2, ...): du/dx ≈
# Σ_s c_s*(u[i+s]-u[i-s]) / h (the JAX package's ops/wave._D1_COEFFS).
_D1_COEFFS = {
    2: (0.5,),
    4: (2.0 / 3.0, -1.0 / 12.0),
    8: (4.0 / 5.0, -1.0 / 5.0, 4.0 / 105.0, -1.0 / 280.0),
}


def _shifts(x: torch.Tensor, ax: int, hw: int):
    """``shifted(s)``: ``x`` moved by ``s`` along ``ax`` with zeros past the
    boundary (a slice of a zero-padded copy)."""
    nd = x.ndim
    pad = [0] * (2 * nd)
    pad[2 * (nd - 1 - ax)] = pad[2 * (nd - 1 - ax) + 1] = hw
    xp = F.pad(x, pad)
    n = x.shape[ax]
    return lambda s: xp.narrow(ax, hw + s, n)


def laplacian_nd(x: torch.Tensor, order: int = 2) -> torch.Tensor:
    """n-D Laplacian with a zero boundary, by shifted slices of a
    zero-padded tensor. Self-adjoint at every order (symmetric taps, zero
    boundary). The summation order is that of the JAX package, including
    the two-add association ``(out + lo) + hi`` for unit coefficients."""
    nd = x.ndim
    c0, cs = _D2_COEFFS[order]
    halfw = len(cs)
    xp = F.pad(x, (halfw,) * (2 * nd))
    out = (c0 * nd) * x
    for ax in range(nd):
        for s, c in enumerate(cs, start=1):
            lo = tuple(
                slice(halfw - s, -(halfw + s))
                if i == ax else slice(halfw, -halfw)
                for i in range(nd)
            )
            hi = tuple(
                slice(halfw + s, (s - halfw) or None)
                if i == ax else slice(halfw, -halfw)
                for i in range(nd)
            )
            if c == 1.0:
                out = out + xp[lo] + xp[hi]
            else:
                out = out + c * (xp[lo] + xp[hi])
    return out


def d2_axis(x: torch.Tensor, ax: int, inv_dx2, order: int = 2) -> torch.Tensor:
    """Second derivative along ``ax`` with a zero boundary: the tree
    ``(c0·x + Σ_s c_s·(x[i+s] + x[i−s]))·inv_dx2`` of the JAX package's
    ``ops/wave._d2_axis``, bitwise equal to it when eager."""
    c0, cs = _D2_COEFFS[order]
    shifted = _shifts(x, ax, len(cs))
    out = c0 * x
    for s, c in enumerate(cs, start=1):
        out = out + c * (shifted(s) + shifted(-s))
    return out * inv_dx2


def d1_axis(x: torch.Tensor, ax: int, inv_dx, order: int = 2) -> torch.Tensor:
    """First derivative along ``ax`` with a zero boundary: the tree
    ``(Σ_s c_s·(x[i+s] − x[i−s]))·inv_dx``, the first term alone and each
    later one added, of the JAX package's ``ops/wave._d1_axis``, bitwise
    equal to it when eager."""
    cs = _D1_COEFFS[order]
    shifted = _shifts(x, ax, len(cs))
    out = None
    for s, c in enumerate(cs, start=1):
        term = c * (shifted(s) - shifted(-s))
        out = term if out is None else out + term
    return out * inv_dx


def _laplacian_df(dm, m0, state):
    return laplacian_nd(dm, order=state["order"])


def _laplacian_kernel_df(dm, m0, state):
    from .cuda_solver import laplacian3d

    return laplacian3d(dm)


def laplacian_operator(
    shape: Sequence[int],
    dtype: torch.dtype = torch.float32,
    device: torch.device | str | None = None,
    *,
    impl: str = "torch",
    order: int = 2,
) -> LinearOperator:
    """Self-adjoint n-D Laplacian operator with a zero boundary, on
    ``device`` (``None``: the CUDA card).

    ``impl="torch"`` (default): :func:`laplacian_nd` at ``order`` 2, 4 or 8.
    ``impl="kernel"``: the hand-written CUDA 7-point kernel
    (``cuda_solver.laplacian3d``, K3), 3-D float32 order 2 only, bitwise
    equal to :func:`laplacian_nd`; a CPU tensor takes its plain version.
    On 2-D grids ``impl="kernel"`` routes to the torch path, as the JAX
    package routes ``impl="pallas"``.
    """
    sp = Space(shape, dtype, device)
    if order not in _D2_COEFFS:
        raise ValueError(f"order must be one of {sorted(_D2_COEFFS)}")
    if impl not in ("torch", "kernel"):
        raise ValueError(f"impl must be 'torch' or 'kernel', got {impl!r}")
    if impl == "kernel" and len(shape) == 2:
        impl = "torch"
    if impl == "kernel":
        if len(shape) != 3 or dtype != torch.float32:
            raise ValueError("kernel laplacian supports 3-D float32 grids")
        if order != 2:
            raise ValueError("kernel laplacian implements order=2 only")
        j = Jet(dom=sp, rng=sp, df=_laplacian_kernel_df, dft="self")
    else:
        j = Jet(dom=sp, rng=sp, df=_laplacian_df, dft="self",
                state={"order": order})
    return LinearOperator(j)


# -- constant-coefficient stencils -------------------------------------------------

_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}


def _correlate(m, k, pads):
    """Correlation of the n-D (n ≤ 3) ``m`` with the kernel ``k`` after
    zero-padding each axis by its ``(lo, hi)`` pair in ``pads`` (asymmetric
    for even kernel lengths, which ``F.conv*``'s own padding cannot say)."""
    flat = [p for lo_hi in reversed(pads) for p in lo_hi]  # F.pad: last axis first
    return _CONV[m.ndim](F.pad(m[None, None], flat), k[None, None])[0, 0]


def _stencil_df(dm, m0, state):
    # a convolution, not a correlation: flip the stencil on every axis
    k = state["stencil"]
    pads = [((s - 1) // 2, s - 1 - (s - 1) // 2) for s in k.shape]
    return _correlate(dm, k.flip(tuple(range(k.ndim))), pads)


def stencil_operator(space: Space, stencil) -> LinearOperator:
    """Constant-coefficient stencil (a tensor or an array) applied with SAME
    (zero) padding on an n-D grid (n ≤ 3), on the space's device. The
    adjoint (the flipped stencil) is derived with ``torch.func.vjp``."""
    k = as_tensor(stencil).to(dtype=space.dtype, device=space.device)
    if k.ndim != space.ndim:
        raise ValueError(f"stencil ndim {k.ndim} != space ndim {space.ndim}")
    if k.ndim not in _CONV:
        raise ValueError("stencil_operator supports 1-3 spatial dims")
    return LinearOperator(Jet(dom=space, rng=space, df=_stencil_df,
                              state={"stencil": k}))


def blur2d_operator(shape: Sequence[int], radius: int = 2,
                    dtype: torch.dtype = torch.float32,
                    device: torch.device | str | None = None) -> LinearOperator:
    """Gaussian-ish blur on a 2-D grid — the CGLS deblurring operator of
    BASELINE config 3 — built on ``device`` (``None``: the CUDA card). The
    kernel is computed on the CPU and moved, so it is the same on every
    device."""
    n = 2 * radius + 1
    x = torch.arange(n, dtype=dtype) - radius
    g = torch.exp(-0.5 * (x / max(radius, 1)) ** 2)
    k = torch.outer(g, g)
    return stencil_operator(Space(shape, dtype, device), k / torch.sum(k))
