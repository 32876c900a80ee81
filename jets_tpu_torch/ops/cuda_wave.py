"""Hand-written CUDA kernels of the isotropic and constant-Q wave paths
(counterpart of the isotropic half of ``jets_tpu/ops/pallas_wave.py`` and
its Q step), with their plain PyTorch versions.

==========================  =============================================  ========
wrapper                     replaces (TPU kernel)                          plain
==========================  =============================================  ========
:func:`fused_leapfrog_step` ``pallas_wave.fused_leapfrog_step`` (K4)       :func:`fused_leapfrog_step_torch`
:func:`fused_adjoint_step`  ``pallas_wave.fused_adjoint_step`` (K5)        :func:`fused_adjoint_step_torch`
:func:`fused_q_step`        ``pallas_wave.fused_q_step`` (K14)             :func:`fused_q_step_torch`
==========================  =============================================  ========

The kernels live in ``csrc/wave_kernels.cu`` (design notes there) and are
built by :mod:`jets_tpu_torch.kernels`. Each wrapper checks device, dtype,
shape and contiguity and raises on anything its kernel does not take. For
tensors on the CPU it calls the plain version; for CUDA tensors it
launches the kernel or raises — there is no fallback. Each wrapper counts
its kernel launches in the counter ``launches.<wrapper>`` of
:mod:`~jets_tpu_torch.utils.profiling`.

The sponge enters as its per-axis factors ``spz (D,)``, ``sy (H,)``,
``sx (W,)``; the scalars ``s_t``, ``amp`` and ``sc`` are 0-d float32
tensors on the grid's device, read by the kernel through a pointer, so a
time loop makes no host sync. :func:`fits_wave_kernel` is the Hopper shape
guard that replaces ``fits_wave_pallas``/``fits_adjoint_pallas``/
``fits_q_pallas`` and the ``*_step_tile`` VMEM budgets of the TPU package.

On the card the kernels are bitwise equal to their plain versions (no FMA
contraction; the Laplacian keeps ``laplacian_nd``'s add order).
"""
from __future__ import annotations

import torch

from .. import kernels
from ..utils.profiling import count
from .cuda_solver import _check_f32, _device_of, _launch_counters, _scalar, _stream
from .stencil import _D2_COEFFS, laplacian_nd

__all__ = [
    "fused_leapfrog_step",
    "fused_adjoint_step",
    "fused_q_step",
    "fused_leapfrog_step_torch",
    "fused_adjoint_step_torch",
    "fused_q_step_torch",
    "fits_wave_kernel",
    "sponge_product",
    "source_mask",
    "leapfrog_plain",
    "q_plain",
    "reset_launch_counts",
    "launch_counts",
]

_MAX_GRID = 65535  # gridDim.y / gridDim.z limit of the launch
_STORE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_G_CODE = {torch.float32: 0, torch.bfloat16: 1}  # K14's friction field


def fits_wave_kernel(shape, dtype, order: int) -> bool:
    """True when K4/K5/K14 (and the VTI and TTI kernels of :mod:`.cuda_vti`
    and :mod:`.cuda_tti`, whose launch grids are no larger) take a grid: 3-D float32, order 2/4/8, and a grid
    the launch limits admit (one block row of 8 per y-block, one z-plane
    per gridDim.z)."""
    if len(shape) != 3 or dtype != torch.float32 or order not in _D2_COEFFS:
        return False
    D, H, W = (int(s) for s in shape)
    return 0 < D <= _MAX_GRID and 0 < -(-H // 8) <= _MAX_GRID and W > 0


# -- plain versions --------------------------------------------------------------


def sponge_product(spz, sy, sx):
    """The full-grid sponge ``(sz·sy)·sx`` from its per-axis factors — the
    multiplication tree of the JAX package's ``_mul_sponge``."""
    return (spz.reshape(-1, 1, 1) * sy.reshape(1, -1, 1)) * sx.reshape(1, 1, -1)


def source_mask(shape, src_idx, amp):
    """One-hot source mask: ``amp`` at flat index ``src_idx``, 0 elsewhere
    (the JAX package's ``_iota_src_mask``). ``src_idx`` may be batched under
    ``vmap``."""
    n = 1
    for s in shape:
        n *= int(s)
    flat = torch.arange(n, device=amp.device).reshape(shape)
    return torch.where(flat == src_idx, amp, torch.zeros_like(amp))


def leapfrog_plain(u_prev, u, c2dt2, sponge, s_t, mask, order):
    """``((2u − u_prev) + c²dt²·L(u))·S + s_t·mask`` with ``S`` a full-grid
    sponge: the tree of K4 and of ``ops/wave._propagate``'s XLA step."""
    e = (2.0 * u - u_prev) + c2dt2 * laplacian_nd(u, order=order)
    return e * sponge + s_t * mask


def q_plain(u_prev, u, c2dt2, om1g, inv1pg, sponge, s_t, mask, order):
    """``(((2u − om1g·u_prev) + c²dt²·L(u))·inv1pg)·S + s_t·mask`` with the
    friction factors ``om1g = 1 − g``, ``inv1pg = 1/(1 + g)`` and ``S`` full
    grids: the tree of K14 and of ``ops/wave._propagate_q``'s XLA step."""
    e = ((2.0 * u - om1g * u_prev) + c2dt2 * laplacian_nd(u, order=order)) * inv1pg
    return e * sponge + s_t * mask


def fused_q_step_torch(u_prev, u, c2dt2, g, spz, sy, sx, s_t, src_idx, amp, *,
                       order: int = 2):
    """Plain K14: :func:`q_plain` with ``om1g = 1 − g`` and ``inv1pg =
    1/(1 + g)`` from the friction field ``g`` (float32 or bfloat16, upcast),
    a fresh tensor."""
    g = g.to(torch.float32)
    return q_plain(u_prev, u, c2dt2, 1.0 - g, 1.0 / (1.0 + g),
                   sponge_product(spz, sy, sx), s_t, source_mask(u.shape, src_idx, amp),
                   order)


def fused_leapfrog_step_torch(u_prev, u, c2dt2, spz, sy, sx, s_t, src_idx, amp, *,
                              order: int = 2):
    """Plain K4: ``u_next = ((2u − u_prev) + c²dt²·L(u))·((sz·sy)·sx) +
    s_t·onehot(src)·amp``, a fresh tensor."""
    return leapfrog_plain(u_prev, u, c2dt2, sponge_product(spz, sy, sx), s_t,
                          source_mask(u.shape, src_idx, amp), order)


def fused_adjoint_step_torch(a1, a2, gc2, c2dt2, u_enc, sc, spz, sy, sx, *,
                             order: int = 2):
    """Plain K5: returns ``(a_core, gc2_new)`` with ``ē = S⊙a1``,
    ``a_core = (2ē + L(c²dt²·ē)) − S⊙a2``, ``gc2_new = gc2 + L(q·sc)⊙ē``."""
    S = sponge_product(spz, sy, sx)
    ebar = a1 * S
    u = u_enc.to(torch.float32) * sc
    gc2_new = gc2 + laplacian_nd(u, order=order) * ebar
    core = (2.0 * ebar + laplacian_nd(c2dt2 * ebar, order=order)) - a2 * S
    return core, gc2_new


# -- argument checks -------------------------------------------------------------


def _check_grid(name, u, order):
    if u.ndim != 3:
        raise ValueError(f"{name}: expected a (D, H, W) grid, got shape {tuple(u.shape)}")
    if order not in _D2_COEFFS:
        raise ValueError(f"{name}: order must be one of {sorted(_D2_COEFFS)}, got {order}")
    if not fits_wave_kernel(u.shape, u.dtype, order):
        raise ValueError(f"{name}: grid {tuple(u.shape)} exceeds the launch grid")


def _check_factors(name, u, spz, sy, sx):
    for f, n, ax in ((spz, u.shape[0], "spz"), (sy, u.shape[1], "sy"),
                     (sx, u.shape[2], "sx")):
        _check_f32(name, f)
        if f.device != u.device:
            raise ValueError(f"{name}: {ax} on {f.device}, grid on {u.device}")
        if f.ndim != 1 or f.shape[0] != n:
            raise ValueError(f"{name}: {ax} must have shape ({n},), got {tuple(f.shape)}")


# -- wrappers --------------------------------------------------------------------


def fused_leapfrog_step(u_prev, u, c2dt2, spz, sy, sx, s_t, src_idx, amp, *,
                        order: int = 2, out=None):
    """K4: one leapfrog step of the isotropic wave equation in one pass over
    the grid. ``out`` is None (a fresh tensor) or ``u_prev`` (written in
    place: ``u_prev`` is read only at the output point). ``src_idx`` is the
    flat source index (an int or a 0-d integer tensor on the CPU)."""
    name = "fused_leapfrog_step"
    _check_f32(name, u_prev, u, c2dt2)
    _check_grid(name, u, order)
    _check_factors(name, u, spz, sy, sx)
    if u.data_ptr() == u_prev.data_ptr():
        raise ValueError(f"{name}: u and u_prev must be distinct buffers")
    if out is not None and out is not u_prev:
        raise ValueError(f"{name}: out must be None or u_prev")
    dev = _device_of(name, u)
    s_t, amp = _scalar(s_t, dev), _scalar(amp, dev)
    src = int(src_idx)
    if dev.type == "cpu":
        res = fused_leapfrog_step_torch(u_prev, u, c2dt2, spz, sy, sx, s_t, src, amp,
                                        order=order)
        return res if out is None else out.copy_(res)
    res = torch.empty_like(u) if out is None else out
    lib = kernels.load_library("wave")
    kernels.check(lib.jt_leapfrog_step(
        *(t.data_ptr() for t in (u_prev, u, c2dt2, spz, sy, sx, s_t, amp)), src,
        res.data_ptr(), *u.shape, order, _stream(dev)), name, "wave")
    count("launches.fused_leapfrog_step")
    return res


def fused_adjoint_step(a1, a2, gc2, c2dt2, u_enc, sc, spz, sy, sx, *,
                       order: int = 2, inplace: bool = False):
    """K5: one reverse step of the stored-wavefield adjoint in one pass over
    the grid. Returns ``(a_core, gc2_new)``; with ``inplace`` they are
    written into ``a2``'s and ``gc2``'s buffers (both are read only at the
    output point). ``u_enc`` is the history snapshot, float32, bfloat16 or
    int8, decoded as ``u_enc·sc``."""
    name = "fused_adjoint_step"
    _check_f32(name, a1, a2, gc2, c2dt2)
    _check_grid(name, a1, order)
    _check_factors(name, a1, spz, sy, sx)
    if u_enc.dtype not in _STORE_CODE:
        raise TypeError(f"{name}: history must be float32, bfloat16 or int8, "
                        f"got {u_enc.dtype}")
    if u_enc.shape != a1.shape or u_enc.device != a1.device:
        raise ValueError(f"{name}: history {tuple(u_enc.shape)} on {u_enc.device}, "
                         f"grid {tuple(a1.shape)} on {a1.device}")
    if not u_enc.is_contiguous():
        raise ValueError(f"{name}: tensors must be contiguous")
    ptrs = {a1.data_ptr(), a2.data_ptr(), gc2.data_ptr()}
    if len(ptrs) < 3 or {c2dt2.data_ptr(), u_enc.data_ptr()} & ptrs:
        raise ValueError(f"{name}: a1, a2, gc2, c2dt2 and the history must be "
                         "distinct buffers")
    dev = _device_of(name, a1)
    sc = _scalar(sc, dev)
    if dev.type == "cpu":
        core, gnew = fused_adjoint_step_torch(a1, a2, gc2, c2dt2, u_enc, sc, spz, sy,
                                              sx, order=order)
        if inplace:
            return a2.copy_(core), gc2.copy_(gnew)
        return core, gnew
    core = a2 if inplace else torch.empty_like(a1)
    gnew = gc2 if inplace else torch.empty_like(a1)
    lib = kernels.load_library("wave")
    kernels.check(lib.jt_adjoint_step(
        *(t.data_ptr() for t in (a1, a2, gc2, c2dt2, u_enc, sc, spz, sy, sx, core,
                                 gnew)),
        *a1.shape, order, _STORE_CODE[u_enc.dtype], _stream(dev)), name, "wave")
    count("launches.fused_adjoint_step")
    return core, gnew


def fused_q_step(u_prev, u, c2dt2, g, spz, sy, sx, s_t, src_idx, amp, *,
                 order: int = 2, out=None):
    """K14: one Kosloff constant-Q leapfrog step in one pass over the grid,
    with the friction field ``g = π·f0·dt/Q`` stored as float32 or bfloat16
    (``1 − g`` and ``1/(1 + g)`` recomputed per point). ``out`` is None (a
    fresh tensor) or ``u_prev`` (written in place: ``u_prev`` is read only
    at the output point)."""
    name = "fused_q_step"
    _check_f32(name, u_prev, u, c2dt2)
    _check_grid(name, u, order)
    _check_factors(name, u, spz, sy, sx)
    if g.dtype not in _G_CODE:
        raise TypeError(f"{name}: g must be float32 or bfloat16, got {g.dtype}")
    if g.shape != u.shape or g.device != u.device:
        raise ValueError(f"{name}: g {tuple(g.shape)} on {g.device}, grid "
                         f"{tuple(u.shape)} on {u.device}")
    if not g.is_contiguous():
        raise ValueError(f"{name}: tensors must be contiguous")
    if u.data_ptr() == u_prev.data_ptr():
        raise ValueError(f"{name}: u and u_prev must be distinct buffers")
    if out is not None and out is not u_prev:
        raise ValueError(f"{name}: out must be None or u_prev")
    dev = _device_of(name, u)
    s_t, amp = _scalar(s_t, dev), _scalar(amp, dev)
    src = int(src_idx)
    if dev.type == "cpu":
        res = fused_q_step_torch(u_prev, u, c2dt2, g, spz, sy, sx, s_t, src, amp,
                                 order=order)
        return res if out is None else out.copy_(res)
    res = torch.empty_like(u) if out is None else out
    lib = kernels.load_library("wave")
    kernels.check(lib.jt_q_step(
        *(t.data_ptr() for t in (u_prev, u, c2dt2, g, spz, sy, sx, s_t, amp)), src,
        res.data_ptr(), *u.shape, order, _G_CODE[g.dtype], _stream(dev)), name, "wave")
    count("launches.fused_q_step")
    return res


_WRAPPERS = (fused_leapfrog_step, fused_adjoint_step, fused_q_step)

reset_launch_counts, launch_counts = _launch_counters(_WRAPPERS)
