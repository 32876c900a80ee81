"""Hand-written CUDA kernels of the 3-D TTI anisotropic wave path
(counterpart of the TTI part of ``jets_tpu/ops/pallas_wave.py``), with their
plain PyTorch versions.

=============================  ==============================================  ========
wrapper                        replaces (TPU kernel)                           plain
=============================  ==============================================  ========
:func:`fused_tti_step`         ``pallas_wave.fused_tti_step`` (K11)            :func:`fused_tti_step_torch`
:func:`fused_tti_hist_step`    ``pallas_wave.fused_tti_hist_step`` (K12)       :func:`fused_tti_hist_step_torch`
:func:`fused_tti_adjoint_step` ``pallas_wave.fused_tti_adjoint_step`` (K13)    :func:`fused_tti_adjoint_step_torch`
=============================  ==============================================  ========

The kernels live in ``csrc/tti_kernels.cu`` (design notes there) and are
built by :mod:`jets_tpu_torch.kernels`. As in :mod:`.cuda_vti`, each wrapper
checks device, dtype, shape and contiguity and raises on anything its
kernel does not take; for tensors on the CPU it calls the plain version,
for CUDA tensors it launches the kernel or raises, and it counts its
launches in the counter ``launches.<wrapper>`` of
:mod:`~jets_tpu_torch.utils.profiling`.

The coupled system (axis 0 = z; the symmetry axis ``n = (nz, ny, nx) =
(cosθ, sinθ·cosφ, sinθ·sinφ)``; ``C = c²dt²``, ``ah = 1+2ε``,
``av = √(1+2δ)``)::

    V(u) = czz·∂zz u + cyy·∂yy u + cxx·∂xx u + czy·∂zy u + czx·∂zx u + cyx·∂yx u
    H(u) = (1−czz)·∂zz u + (1−cyy)·∂yy u + (1−cxx)·∂xx u − czy·∂zy u − …
    e_p = (2p − p_prev) + C·(ah·H(p) + av·V(q))
    e_q = (2q − q_prev) + C·(av·H(p) + V(q))
    p_next = e_p·S + s_t·mask,   q_next = e_q·S + s_t·mask

with ``cii = nᵢ·nᵢ`` and ``cij = (2·nᵢ)·nⱼ`` rebuilt from the three axis
fields, ``∂ii`` the second derivative of :func:`.stencil.d2_axis` and
``∂ij = d1_axis(d1_axis(u, i), j)`` (inner ``i``, outer ``j``, each with a
zero boundary). The five coefficient fields ``ah, av, nz, ny, nx`` are
float32, or bfloat16 in the reduced-precision coefficient mode (upcast on
load); ``C`` is always float32. The sponge enters as its per-axis factors;
the scalars are 0-d float32 tensors on the grid's device. The kernels
march along z (one thread per point of a 32 × 8 tile, 32 z-planes per
block, a shared-memory ring of the staged planes; design notes in the
source) and take every grid K4–K10 take, so
:func:`.cuda_wave.fits_wave_kernel` is their Hopper shape guard, in place
of ``fits_tti_pallas``, ``fits_tti_adjoint_pallas`` and the ``tti_*_tile``
VMEM budgets. K12's per-block partial maxima are one per tile and
z-chunk (``jt_tti_num_partials``).

On the card the kernels are bitwise equal to their plain versions (no FMA
contraction; every stencil keeps ``d2_axis``'s and ``d1_axis``'s trees).
"""
from __future__ import annotations

import torch

from .. import kernels
from ..utils.profiling import count
from .cuda_solver import _check_f32, _launch_counters, _scalar, _stream
from .cuda_vti import (_STORE_DTYPES, SCALE_FLOOR, _check_distinct, _check_history,
                       _ptrs, encode)
from .cuda_wave import (_STORE_CODE, _check_factors, _check_grid, _device_of,
                        source_mask, sponge_product)
from .stencil import d1_axis, d2_axis

__all__ = [
    "fused_tti_step",
    "fused_tti_hist_step",
    "fused_tti_adjoint_step",
    "fused_tti_step_torch",
    "fused_tti_hist_step_torch",
    "fused_tti_adjoint_step_torch",
    "derivs",
    "directions",
    "h_of",
    "v_of",
    "ht",
    "vt",
    "tti_plain",
    "reset_launch_counts",
    "launch_counts",
]

_COEFF_CODE = {torch.float32: 0, torch.bfloat16: 1}


# -- plain versions --------------------------------------------------------------


def _dij(u, i, j, inv_dx, order):
    return d1_axis(d1_axis(u, i, inv_dx, order), j, inv_dx, order)


def derivs(u, inv_dx2, inv_dx, order):
    """``(∂zz, ∂yy, ∂xx, ∂zy, ∂zx, ∂yx)`` of ``u``: the JAX package's
    ``derivs`` of ``ops/wave._adjoint_stored_tti3d``."""
    return (d2_axis(u, 0, inv_dx2, order), d2_axis(u, 1, inv_dx2, order),
            d2_axis(u, 2, inv_dx2, order), _dij(u, 0, 1, inv_dx, order),
            _dij(u, 0, 2, inv_dx, order), _dij(u, 1, 2, inv_dx, order))


def directions(nz, ny, nx):
    """The six direction coefficients ``(czz, cyy, cxx, czy, czx, cyx)``,
    ``nᵢ·nᵢ`` and ``(2·nᵢ)·nⱼ``."""
    return (nz * nz, ny * ny, nx * nx, 2.0 * nz * ny, 2.0 * nz * nx, 2.0 * ny * nx)


def v_of(d6, cf):
    """``V`` from the six derivatives, left to right."""
    czz, cyy, cxx, czy, czx, cyx = cf
    uzz, uyy, uxx, uzy, uzx, uyx = d6
    return czz * uzz + cyy * uyy + cxx * uxx + czy * uzy + czx * uzx + cyx * uyx


def h_of(d6, cf):
    """``H = ∇² − V`` expanded with ``(1 − cᵢᵢ)`` and ``−cᵢⱼ``."""
    czz, cyy, cxx, czy, czx, cyx = cf
    uzz, uyy, uxx, uzy, uzx, uyx = d6
    return ((1.0 - czz) * uzz + (1.0 - cyy) * uyy + (1.0 - cxx) * uxx
            - czy * uzy - czx * uzx - cyx * uyx)


def ht(w, cf, inv_dx2, inv_dx, order):
    """``Hᵀ(w) = Σ_d D_d(κ_d·w)``: the coefficients move inside."""
    czz, cyy, cxx, czy, czx, cyx = cf
    return (d2_axis((1.0 - czz) * w, 0, inv_dx2, order)
            + d2_axis((1.0 - cyy) * w, 1, inv_dx2, order)
            + d2_axis((1.0 - cxx) * w, 2, inv_dx2, order)
            - _dij(czy * w, 0, 1, inv_dx, order) - _dij(czx * w, 0, 2, inv_dx, order)
            - _dij(cyx * w, 1, 2, inv_dx, order))


def vt(w, cf, inv_dx2, inv_dx, order):
    """``Vᵀ(w)``."""
    czz, cyy, cxx, czy, czx, cyx = cf
    return (d2_axis(czz * w, 0, inv_dx2, order) + d2_axis(cyy * w, 1, inv_dx2, order)
            + d2_axis(cxx * w, 2, inv_dx2, order) + _dij(czy * w, 0, 1, inv_dx, order)
            + _dij(czx * w, 0, 2, inv_dx, order) + _dij(cyx * w, 1, 2, inv_dx, order))


def tti_plain(p_prev, p, q_prev, q, C, ah, av, nz, ny, nx, sponge, inv_dx2, inv_dx,
              s_t, mask, order, og=None, ig=None):
    """One coupled 3-D TTI step with a full-grid sponge and source mask (f32
    coefficient fields): the tree of K11 and of ``ops/wave._propagate_tti3d``'s
    XLA step; with the static-Q friction factors ``og``, ``ig`` as
    :func:`cuda_vti.vti_plain` takes them (no kernel does)."""
    cf = directions(nz, ny, nx)
    Hp = h_of(derivs(p, inv_dx2, inv_dx, order), cf)
    Vq = v_of(derivs(q, inv_dx2, inv_dx, order), cf)
    if og is None:
        e_p = (2.0 * p - p_prev) + C * (ah * Hp + av * Vq)
        e_q = (2.0 * q - q_prev) + C * (av * Hp + Vq)
    else:
        e_p = ((2.0 * p - og * p_prev) + C * (ah * Hp + av * Vq)) * ig
        e_q = ((2.0 * q - og * q_prev) + C * (av * Hp + Vq)) * ig
    src = s_t * mask
    return e_p * sponge + src, e_q * sponge + src


def _f32(*tensors):
    return tuple(t.to(torch.float32) for t in tensors)


def fused_tti_step_torch(p_prev, p, q_prev, q, C, ah, av, nz, ny, nx, spz, sy, sx,
                         inv_dx2, inv_dx, s_t, src_idx, amp, *, order: int = 2):
    """Plain K11: ``(p_next, q_next)``, fresh tensors (coefficients upcast)."""
    return tti_plain(p_prev, p, q_prev, q, C, *_f32(ah, av, nz, ny, nx),
                     sponge_product(spz, sy, sx), inv_dx2, inv_dx, s_t,
                     source_mask(p.shape, src_idx, amp), order)


def fused_tti_hist_step_torch(p_prev, p, q_prev, q, C, ah, av, nz, ny, nx, spz, sy, sx,
                              inv_dx2, inv_dx, s_t, src_idx, amp, qfp, qfq, *,
                              store: str = "int8", order: int = 2):
    """Plain K12: ``(p_next, q_next, p_enc, q_enc, scales)`` — K11's step,
    the codes of the INPUT fields at ``qfp``/``qfq`` and the next step's
    int8 scales ``max((max|p_next|, max|q_next|), 1e-30)`` (a (2,) tensor),
    as :func:`.cuda_vti.fused_vti_hist_step_torch`."""
    p_next, q_next = fused_tti_step_torch(p_prev, p, q_prev, q, C, ah, av, nz, ny, nx,
                                          spz, sy, sx, inv_dx2, inv_dx, s_t, src_idx,
                                          amp, order=order)
    peak = torch.stack([torch.amax(torch.abs(p_next)), torch.amax(torch.abs(q_next))])
    scales = torch.maximum(peak, torch.full_like(peak, SCALE_FLOOR))
    return (p_next, q_next, encode(p, qfp, store), encode(q, qfq, store), scales)


def fused_tti_adjoint_step_torch(ap1, aq1, ap2, aq2, gC, gah, gav, gnz, gny, gnx, C, ah,
                                 av, nz, ny, nx, p_enc, q_enc, psc, qsc, inv_dx2, inv_dx,
                                 spz, sy, sx, *, order: int = 2):
    """Plain K13: ``(ap_core, aq_core, gC', gah', gav', gnz', gny', gnx')``
    with ``ēp = S⊙ap1``, ``ēq = S⊙aq1``, the histories decoded as
    ``enc.to(f32)·sc``, ``Hp = H(derivs(p))``, ``Vq = V(derivs(q))`` and, per
    derivative label d, ``δc_d = C·((av·q_d − ah·p_d)·ēp + (q_d − av·p_d)·ēq)``::

        gC'  = gC + ((ah·Hp + av·Vq)·ēp + (av·Hp + Vq)·ēq)
        gah' = gah + (C·Hp)·ēp
        gav' = gav + C·(Vq·ēp + Hp·ēq)
        gnz' = gnz + ((2nz)·δczz + (2ny)·δczy + (2nx)·δczx)
        gny' = gny + ((2ny)·δcyy + (2nz)·δczy + (2nx)·δcyx)
        gnx' = gnx + ((2nx)·δcxx + (2nz)·δczx + (2ny)·δcyx)
        ap_core = (2ēp + Hᵀ((C·ah)·ēp + (C·av)·ēq)) − S⊙ap2
        aq_core = (2ēq + Vᵀ((C·av)·ēp + C·ēq)) − S⊙aq2

    — the trees of ``ops/wave._adjoint_stored_tti3d``'s XLA reverse step."""
    ah, av, nz, ny, nx = _f32(ah, av, nz, ny, nx)
    cf = directions(nz, ny, nx)
    S = sponge_product(spz, sy, sx)
    ebp, ebq = ap1 * S, aq1 * S
    dp6 = derivs(p_enc.to(torch.float32) * psc, inv_dx2, inv_dx, order)
    dq6 = derivs(q_enc.to(torch.float32) * qsc, inv_dx2, inv_dx, order)
    Hp, Vq = h_of(dp6, cf), v_of(dq6, cf)
    gC_n = gC + ((ah * Hp + av * Vq) * ebp + (av * Hp + Vq) * ebq)
    gah_n = gah + (C * Hp) * ebp
    gav_n = gav + C * (Vq * ebp + Hp * ebq)
    dczz, dcyy, dcxx, dczy, dczx, dcyx = (
        C * ((av * q_d - ah * p_d) * ebp + (q_d - av * p_d) * ebq)
        for p_d, q_d in zip(dp6, dq6))
    gnz_n = gnz + (2.0 * nz * dczz + 2.0 * ny * dczy + 2.0 * nx * dczx)
    gny_n = gny + (2.0 * ny * dcyy + 2.0 * nz * dczy + 2.0 * nx * dcyx)
    gnx_n = gnx + (2.0 * nx * dcxx + 2.0 * nz * dczx + 2.0 * ny * dcyx)
    ap = (2.0 * ebp + ht(C * ah * ebp + C * av * ebq, cf, inv_dx2, inv_dx, order)) - ap2 * S
    aq = (2.0 * ebq + vt(C * av * ebp + C * ebq, cf, inv_dx2, inv_dx, order)) - aq2 * S
    return ap, aq, gC_n, gah_n, gav_n, gnz_n, gny_n, gnx_n


# -- argument checks -------------------------------------------------------------


def _check_coefficients(name, C, coeffs):
    """``ah, av, nz, ny, nx``: one type, float32 or bfloat16, on ``C``'s
    grid; returns the kernels' coefficient-type code."""
    dt = coeffs[0].dtype
    if dt not in _COEFF_CODE:
        raise TypeError(f"{name}: coefficients must be float32 or bfloat16, got {dt}")
    for t in coeffs:
        if t.dtype != dt:
            raise TypeError(f"{name}: coefficients of two types, {dt} and {t.dtype}")
        if t.shape != C.shape or t.device != C.device:
            raise ValueError(f"{name}: coefficient {tuple(t.shape)} on {t.device}, grid "
                             f"{tuple(C.shape)} on {C.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
    return _COEFF_CODE[dt]


def _check_step(name, p_prev, p, q_prev, q, C, coeffs, spz, sy, sx, order, out):
    _check_f32(name, p_prev, p, q_prev, q, C)
    _check_grid(name, p, order)
    _check_factors(name, p, spz, sy, sx)
    code = _check_coefficients(name, C, coeffs)
    _check_distinct(name, (p_prev, q_prev), (p, q, C, *coeffs))
    if p.data_ptr() == q.data_ptr():
        raise ValueError(f"{name}: p and q must be distinct buffers")
    if out is not None and (len(out) != 2 or out[0] is not p_prev
                            or out[1] is not q_prev):
        raise ValueError(f"{name}: out must be None or (p_prev, q_prev)")
    return _device_of(name, p), code


# -- wrappers --------------------------------------------------------------------


def fused_tti_step(p_prev, p, q_prev, q, C, ah, av, nz, ny, nx, spz, sy, sx, inv_dx2,
                   inv_dx, s_t, src_idx, amp, *, order: int = 2, out=None):
    """K11: one coupled 3-D TTI step in one pass over the grid; returns
    ``(p_next, q_next)``. ``out`` is None (fresh tensors) or ``(p_prev,
    q_prev)`` (written in place: the previous fields are read only at the
    output point). ``src_idx`` is the flat source index."""
    name = "fused_tti_step"
    coeffs = (ah, av, nz, ny, nx)
    dev, code = _check_step(name, p_prev, p, q_prev, q, C, coeffs, spz, sy, sx, order,
                            out)
    s_t, amp, inv_dx2, inv_dx = (_scalar(x, dev) for x in (s_t, amp, inv_dx2, inv_dx))
    src = int(src_idx)
    if dev.type == "cpu":
        pn, qn = fused_tti_step_torch(p_prev, p, q_prev, q, C, *coeffs, spz, sy, sx,
                                      inv_dx2, inv_dx, s_t, src, amp, order=order)
        return (pn, qn) if out is None else (out[0].copy_(pn), out[1].copy_(qn))
    pn, qn = (torch.empty_like(p), torch.empty_like(p)) if out is None else out
    lib = kernels.load_library("tti")
    kernels.check(lib.jt_tti_step(
        *_ptrs(p_prev, p, q_prev, q, C, *coeffs, spz, sy, sx, s_t, amp, inv_dx2, inv_dx),
        src, *_ptrs(pn, qn), *p.shape, order, code, _stream(dev)), name, "tti")
    count("launches.fused_tti_step")
    return pn, qn


def fused_tti_hist_step(p_prev, p, q_prev, q, C, ah, av, nz, ny, nx, spz, sy, sx,
                        inv_dx2, inv_dx, s_t, src_idx, amp, qfp, qfq, *,
                        store: str = "int8", order: int = 2, out=None):
    """K12: K11 plus the history codes of the INPUT fields ``p``, ``q``
    (int8 at ``qfp``/``qfq = 127/scale``, bf16, or an f32 copy) and the next
    step's int8 scales, reduced from per-block partial maxima the kernel
    writes. Returns ``(p_next, q_next, p_enc, q_enc, scales)``; ``out`` as
    for :func:`fused_tti_step`."""
    name = "fused_tti_hist_step"
    coeffs = (ah, av, nz, ny, nx)
    dev, code = _check_step(name, p_prev, p, q_prev, q, C, coeffs, spz, sy, sx, order,
                            out)
    if store not in _STORE_DTYPES:
        raise ValueError(f"{name}: store must be one of {tuple(_STORE_DTYPES)}, got "
                         f"{store!r}")
    s_t, amp, inv_dx2, inv_dx, qfp, qfq = (
        _scalar(x, dev) for x in (s_t, amp, inv_dx2, inv_dx, qfp, qfq))
    src = int(src_idx)
    if dev.type == "cpu":
        res = fused_tti_hist_step_torch(p_prev, p, q_prev, q, C, *coeffs, spz, sy, sx,
                                        inv_dx2, inv_dx, s_t, src, amp, qfp, qfq,
                                        store=store, order=order)
        if out is None:
            return res
        return (out[0].copy_(res[0]), out[1].copy_(res[1])) + res[2:]
    pn, qn = (torch.empty_like(p), torch.empty_like(p)) if out is None else out
    sdt = _STORE_DTYPES[store]
    penc = torch.empty(p.shape, dtype=sdt, device=dev)
    qenc = torch.empty(p.shape, dtype=sdt, device=dev)
    lib = kernels.load_library("tti")
    nparts = int(lib.jt_tti_num_partials(*p.shape))
    partials = torch.empty((2, nparts), dtype=torch.float32, device=dev)
    kernels.check(lib.jt_tti_hist_step(
        *_ptrs(p_prev, p, q_prev, q, C, *coeffs, spz, sy, sx, s_t, amp, inv_dx2, inv_dx,
               qfp, qfq), src, *_ptrs(pn, qn, penc, qenc, partials), *p.shape, order,
        code, _STORE_CODE[sdt], _stream(dev)), name, "tti")
    count("launches.fused_tti_hist_step")
    peak = torch.amax(partials, dim=1)
    return pn, qn, penc, qenc, torch.maximum(peak, torch.full_like(peak, SCALE_FLOOR))


def fused_tti_adjoint_step(ap1, aq1, ap2, aq2, gC, gah, gav, gnz, gny, gnx, C, ah, av,
                           nz, ny, nx, p_enc, q_enc, psc, qsc, inv_dx2, inv_dx, spz, sy,
                           sx, *, order: int = 2, inplace: bool = False):
    """K13: one reverse step of the stored-history TTI adjoint in one pass
    over the grid; returns ``(ap_core, aq_core, gC', gah', gav', gnz', gny',
    gnx')`` (see :func:`fused_tti_adjoint_step_torch`). With ``inplace``
    they are written into ``ap2``, ``aq2`` and the six accumulators (each
    read only at the output point). ``p_enc``/``q_enc`` are the history
    snapshots (float32, bfloat16 or int8, one type), decoded as ``enc·psc``
    and ``enc·qsc``. The receiver injection is not part of the step."""
    name = "fused_tti_adjoint_step"
    accs = (gC, gah, gav, gnz, gny, gnx)
    coeffs = (ah, av, nz, ny, nx)
    _check_f32(name, ap1, aq1, ap2, aq2, *accs, C)
    _check_grid(name, ap1, order)
    _check_factors(name, ap1, spz, sy, sx)
    code = _check_coefficients(name, C, coeffs)
    _check_history(name, p_enc, ap1)
    _check_history(name, q_enc, ap1)
    if p_enc.dtype != q_enc.dtype:
        raise TypeError(f"{name}: histories of two types, {p_enc.dtype} and "
                        f"{q_enc.dtype}")
    _check_distinct(name, (ap2, aq2, *accs), (ap1, aq1, C, *coeffs, p_enc, q_enc))
    dev = _device_of(name, ap1)
    psc, qsc, inv_dx2, inv_dx = (_scalar(x, dev) for x in (psc, qsc, inv_dx2, inv_dx))
    if dev.type == "cpu":
        res = fused_tti_adjoint_step_torch(ap1, aq1, ap2, aq2, *accs, C, *coeffs, p_enc,
                                           q_enc, psc, qsc, inv_dx2, inv_dx, spz, sy, sx,
                                           order=order)
        if inplace:
            return tuple(o.copy_(r) for o, r in zip((ap2, aq2, *accs), res))
        return res
    outs = ((ap2, aq2, *accs) if inplace
            else tuple(torch.empty_like(ap1) for _ in range(8)))
    lib = kernels.load_library("tti")
    kernels.check(lib.jt_tti_adjoint_step(
        *_ptrs(ap1, aq1, ap2, aq2, *accs, C, *coeffs, p_enc, q_enc, psc, qsc, inv_dx2,
               inv_dx, spz, sy, sx), *_ptrs(*outs), *ap1.shape, order, code,
        _STORE_CODE[p_enc.dtype], _stream(dev)), name, "tti")
    count("launches.fused_tti_adjoint_step")
    return outs


_WRAPPERS = (fused_tti_step, fused_tti_hist_step, fused_tti_adjoint_step)

reset_launch_counts, launch_counts = _launch_counters(_WRAPPERS)
