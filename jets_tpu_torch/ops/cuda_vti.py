"""Hand-written CUDA kernels of the VTI anisotropic wave path (counterpart of
the VTI part of ``jets_tpu/ops/pallas_wave.py``), with their plain PyTorch
versions.

============================  ==============================================  ========
wrapper                       replaces (TPU kernel)                           plain
============================  ==============================================  ========
:func:`fused_vti_step`        ``pallas_wave.fused_vti_step`` (K8)             :func:`fused_vti_step_torch`
:func:`fused_vti_hist_step`   ``pallas_wave.fused_vti_hist_step`` (K9)        :func:`fused_vti_hist_step_torch`
:func:`fused_vti_adjoint_step` ``pallas_wave.fused_vti_adjoint_step`` (K10)   :func:`fused_vti_adjoint_step_torch`
============================  ==============================================  ========

The kernels live in ``csrc/vti_kernels.cu`` (design notes there) and are
built by :mod:`jets_tpu_torch.kernels`. As in :mod:`.cuda_wave`, each
wrapper checks device, dtype, shape and contiguity and raises on anything
its kernel does not take; for tensors on the CPU it calls the plain
version, for CUDA tensors it launches the kernel or raises, and it counts
its launches in the counter ``launches.<wrapper>`` of
:mod:`~jets_tpu_torch.utils.profiling`.

The coupled system (axis 0 = z, ``Lh`` the in-plane second derivative,
``∂zz`` the vertical one, each axis ``(c0·x + Σ c_s·(lo + hi))·inv_dx2``
as :func:`.stencil.d2_axis`; ``C = c²dt²``, ``ah = 1+2ε``,
``av = √(1+2δ)``)::

    e_p = (2p − p_prev) + C·(ah·Lh(p) + av·∂zz(q))
    e_q = (2q − q_prev) + C·(av·Lh(p) + ∂zz(q))
    p_next = e_p·S + s_t·mask,   q_next = e_q·S + s_t·mask

The sponge enters as its per-axis factors ``spz (D,)``, ``sy (H,)``,
``sx (W,)``; the scalars (``s_t``, ``amp``, ``inv_dx2``, the history
quantization factors and decode scales) are 0-d float32 tensors on the
grid's device, read by the kernels through pointers. The kernels launch
as K4/K5 do (one thread per point, one z-plane per ``gridDim.z``), so
:func:`.cuda_wave.fits_wave_kernel` is their Hopper shape guard too, in
place of ``fits_vti_pallas``, ``fits_vti_adjoint_pallas`` and the
``vti_*_tile`` VMEM budgets.

On the card the kernels are bitwise equal to their plain versions (no FMA
contraction; every stencil keeps ``d2_axis``'s tree).
"""
from __future__ import annotations

import torch

from .. import kernels
from ..utils.profiling import count
from .cuda_solver import _check_f32, _launch_counters, _scalar, _stream
from .cuda_wave import (_STORE_CODE, _check_factors, _check_grid, _device_of,
                        source_mask, sponge_product)
from .stencil import d2_axis

__all__ = [
    "fused_vti_step",
    "fused_vti_hist_step",
    "fused_vti_adjoint_step",
    "fused_vti_step_torch",
    "fused_vti_hist_step_torch",
    "fused_vti_adjoint_step_torch",
    "lh",
    "dzz",
    "vti_plain",
    "encode",
    "SCALE_FLOOR",
    "reset_launch_counts",
    "launch_counts",
]

_STORE_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16, "int8": torch.int8}
SCALE_FLOOR = 1e-30  # the int8 scale of an all-zero snapshot, as _store_codec's


# -- plain versions --------------------------------------------------------------


def lh(u, inv_dx2, order):
    """The in-plane second derivative ``d2_axis(u, 1) + d2_axis(u, 2) + …``."""
    out = d2_axis(u, 1, inv_dx2, order)
    for ax in range(2, u.ndim):
        out = out + d2_axis(u, ax, inv_dx2, order)
    return out


def dzz(u, inv_dx2, order):
    """The vertical second derivative ``d2_axis(u, 0)``."""
    return d2_axis(u, 0, inv_dx2, order)


def vti_plain(p_prev, p, q_prev, q, C, ah, av, sponge, inv_dx2, s_t, mask, order,
              og=None, ig=None):
    """One coupled step with a full-grid sponge and source mask, any
    dimension: the tree of K8 and of ``ops/wave._propagate_vti``'s XLA step.
    With the static-Q friction factors ``og = 1 − g`` and ``ig = 1/(1 + g)``
    (no kernel takes them) each update is
    ``((2p − og·p_prev) + C·(...))·ig`` before the sponge."""
    lhp = lh(p, inv_dx2, order)
    dzq = dzz(q, inv_dx2, order)
    if og is None:
        e_p = (2.0 * p - p_prev) + C * (ah * lhp + av * dzq)
        e_q = (2.0 * q - q_prev) + C * (av * lhp + dzq)
    else:
        e_p = ((2.0 * p - og * p_prev) + C * (ah * lhp + av * dzq)) * ig
        e_q = ((2.0 * q - og * q_prev) + C * (av * lhp + dzq)) * ig
    src = s_t * mask
    return e_p * sponge + src, e_q * sponge + src


def encode(u, qf, store: str):
    """The history code of ``u`` in a buffer of its own: ``round(u·qf)`` as
    int8 (half to even, ``qf = 127/scale``), bf16, or a copy for f32 — the
    codes of ``ops/wave._store_codec``'s ``enc``."""
    if store == "int8":
        return torch.round(u * qf).to(torch.int8)
    if store == "bf16":
        return u.to(torch.bfloat16)
    return u.clone()


def fused_vti_step_torch(p_prev, p, q_prev, q, C, ah, av, spz, sy, sx, inv_dx2,
                         s_t, src_idx, amp, *, order: int = 2):
    """Plain K8: ``(p_next, q_next)``, fresh tensors."""
    return vti_plain(p_prev, p, q_prev, q, C, ah, av, sponge_product(spz, sy, sx),
                     inv_dx2, s_t, source_mask(p.shape, src_idx, amp), order)


def fused_vti_hist_step_torch(p_prev, p, q_prev, q, C, ah, av, spz, sy, sx, inv_dx2,
                              s_t, src_idx, amp, qfp, qfq, *, store: str = "int8",
                              order: int = 2):
    """Plain K9: ``(p_next, q_next, p_enc, q_enc, scales)`` — K8's step, the
    codes of the INPUT fields ``p``, ``q`` at the quantization factors
    ``qfp``, ``qfq``, and ``scales = max((max|p_next|, max|q_next|), 1e-30)``,
    the next step's int8 scales (a (2,) tensor)."""
    p_next, q_next = fused_vti_step_torch(p_prev, p, q_prev, q, C, ah, av, spz, sy, sx,
                                          inv_dx2, s_t, src_idx, amp, order=order)
    peak = torch.stack([torch.amax(torch.abs(p_next)), torch.amax(torch.abs(q_next))])
    scales = torch.maximum(peak, torch.full_like(peak, SCALE_FLOOR))
    return (p_next, q_next, encode(p, qfp, store), encode(q, qfq, store), scales)


def fused_vti_adjoint_step_torch(ap1, aq1, ap2, aq2, gC, gah, gav, C, av, ah,
                                 p_enc, q_enc, psc, qsc, inv_dx2, spz, sy, sx, *,
                                 order: int = 2):
    """Plain K10: ``(ap_core, aq_core, gC', gah', gav')`` with ``ēp = S⊙ap1``,
    ``ēq = S⊙aq1``, the histories decoded as ``enc.to(f32)·sc``::

        gC'  = gC + ((ah·Lh(p) + av·∂zz(q))·ēp + (av·Lh(p) + ∂zz(q))·ēq)
        gah' = gah + (C·Lh(p))·ēp
        gav' = gav + C·(∂zz(q)·ēp + Lh(p)·ēq)
        ap_core = ((2ēp + Lh((C·ah)·ēp)) + Lh((C·av)·ēq)) − S⊙ap2
        aq_core = ((2ēq + ∂zz((C·av)·ēp)) + ∂zz(C·ēq)) − S⊙aq2

    — the trees of ``ops/wave._adjoint_stored_vti``'s XLA reverse step."""
    S = sponge_product(spz, sy, sx)
    ebp, ebq = ap1 * S, aq1 * S
    lh_k = lh(p_enc.to(torch.float32) * psc, inv_dx2, order)
    dzz_k = dzz(q_enc.to(torch.float32) * qsc, inv_dx2, order)
    gC_n = gC + ((ah * lh_k + av * dzz_k) * ebp + (av * lh_k + dzz_k) * ebq)
    gah_n = gah + (C * lh_k) * ebp
    gav_n = gav + C * (dzz_k * ebp + lh_k * ebq)
    ap = (2.0 * ebp + lh(C * ah * ebp, inv_dx2, order)
          + lh(C * av * ebq, inv_dx2, order)) - ap2 * S
    aq = (2.0 * ebq + dzz(C * av * ebp, inv_dx2, order)
          + dzz(C * ebq, inv_dx2, order)) - aq2 * S
    return ap, aq, gC_n, gah_n, gav_n


# -- argument checks -------------------------------------------------------------


def _check_distinct(name, outs, ins):
    """Every buffer in ``outs`` distinct from each other and from ``ins``."""
    po = [t.data_ptr() for t in outs]
    if len(set(po)) < len(po) or set(po) & {t.data_ptr() for t in ins}:
        raise ValueError(f"{name}: stencilled inputs and outputs must be distinct "
                         "buffers")


def _check_step(name, p_prev, p, q_prev, q, C, ah, av, spz, sy, sx, order, out):
    _check_f32(name, p_prev, p, q_prev, q, C, ah, av)
    _check_grid(name, p, order)
    _check_factors(name, p, spz, sy, sx)
    _check_distinct(name, (p_prev, q_prev), (p, q, C, ah, av))
    if p.data_ptr() == q.data_ptr():
        raise ValueError(f"{name}: p and q must be distinct buffers")
    if out is not None and (len(out) != 2 or out[0] is not p_prev
                            or out[1] is not q_prev):
        raise ValueError(f"{name}: out must be None or (p_prev, q_prev)")
    return _device_of(name, p)


def _check_history(name, u, ref):
    if u.dtype not in _STORE_CODE:
        raise TypeError(f"{name}: history must be float32, bfloat16 or int8, got "
                        f"{u.dtype}")
    if u.shape != ref.shape or u.device != ref.device:
        raise ValueError(f"{name}: history {tuple(u.shape)} on {u.device}, grid "
                         f"{tuple(ref.shape)} on {ref.device}")
    if not u.is_contiguous():
        raise ValueError(f"{name}: tensors must be contiguous")


def _ptrs(*tensors):
    return [t.data_ptr() for t in tensors]


# -- wrappers --------------------------------------------------------------------


def fused_vti_step(p_prev, p, q_prev, q, C, ah, av, spz, sy, sx, inv_dx2, s_t,
                   src_idx, amp, *, order: int = 2, out=None):
    """K8: one coupled VTI step in one pass over the grid; returns
    ``(p_next, q_next)``. ``out`` is None (fresh tensors) or
    ``(p_prev, q_prev)`` (written in place: the previous fields are read
    only at the output point). ``src_idx`` is the flat source index (an
    int or a 0-d integer tensor on the CPU)."""
    name = "fused_vti_step"
    dev = _check_step(name, p_prev, p, q_prev, q, C, ah, av, spz, sy, sx, order, out)
    s_t, amp, inv_dx2 = (_scalar(x, dev) for x in (s_t, amp, inv_dx2))
    src = int(src_idx)
    if dev.type == "cpu":
        pn, qn = fused_vti_step_torch(p_prev, p, q_prev, q, C, ah, av, spz, sy, sx,
                                      inv_dx2, s_t, src, amp, order=order)
        return (pn, qn) if out is None else (out[0].copy_(pn), out[1].copy_(qn))
    pn, qn = (torch.empty_like(p), torch.empty_like(p)) if out is None else out
    lib = kernels.load_library("vti")
    kernels.check(lib.jt_vti_step(
        *_ptrs(p_prev, p, q_prev, q, C, ah, av, spz, sy, sx, s_t, amp, inv_dx2), src,
        *_ptrs(pn, qn), *p.shape, order, _stream(dev)), name, "vti")
    count("launches.fused_vti_step")
    return pn, qn


def fused_vti_hist_step(p_prev, p, q_prev, q, C, ah, av, spz, sy, sx, inv_dx2, s_t,
                        src_idx, amp, qfp, qfq, *, store: str = "int8", order: int = 2,
                        out=None):
    """K9: K8 plus the history codes of the INPUT fields ``p``, ``q``
    (quantized with ``qfp``/``qfq = 127/scale`` for int8; bf16 or an f32
    copy otherwise) and the next step's int8 scales. Returns ``(p_next,
    q_next, p_enc, q_enc, scales)``; ``scales`` is a (2,) tensor, ``max(max
    |p_next|, 1e-30)`` and the same for ``q_next``, reduced from per-block
    partial maxima the kernel writes. ``out`` as for :func:`fused_vti_step`."""
    name = "fused_vti_hist_step"
    dev = _check_step(name, p_prev, p, q_prev, q, C, ah, av, spz, sy, sx, order, out)
    if store not in _STORE_DTYPES:
        raise ValueError(f"{name}: store must be one of {tuple(_STORE_DTYPES)}, got "
                         f"{store!r}")
    s_t, amp, inv_dx2, qfp, qfq = (_scalar(x, dev)
                                   for x in (s_t, amp, inv_dx2, qfp, qfq))
    src = int(src_idx)
    if dev.type == "cpu":
        res = fused_vti_hist_step_torch(p_prev, p, q_prev, q, C, ah, av, spz, sy, sx,
                                        inv_dx2, s_t, src, amp, qfp, qfq, store=store,
                                        order=order)
        if out is None:
            return res
        return (out[0].copy_(res[0]), out[1].copy_(res[1])) + res[2:]
    pn, qn = (torch.empty_like(p), torch.empty_like(p)) if out is None else out
    sdt = _STORE_DTYPES[store]
    penc = torch.empty(p.shape, dtype=sdt, device=dev)
    qenc = torch.empty(p.shape, dtype=sdt, device=dev)
    lib = kernels.load_library("vti")
    nparts = int(lib.jt_vti_num_partials(*p.shape))
    partials = torch.empty((2, nparts), dtype=torch.float32, device=dev)
    kernels.check(lib.jt_vti_hist_step(
        *_ptrs(p_prev, p, q_prev, q, C, ah, av, spz, sy, sx, s_t, amp, inv_dx2, qfp,
               qfq), src, *_ptrs(pn, qn, penc, qenc, partials), *p.shape, order,
        _STORE_CODE[sdt], _stream(dev)), name, "vti")
    count("launches.fused_vti_hist_step")
    peak = torch.amax(partials, dim=1)
    return pn, qn, penc, qenc, torch.maximum(peak, torch.full_like(peak, SCALE_FLOOR))


def fused_vti_adjoint_step(ap1, aq1, ap2, aq2, gC, gah, gav, C, av, ah, p_enc, q_enc,
                           psc, qsc, inv_dx2, spz, sy, sx, *, order: int = 2,
                           inplace: bool = False):
    """K10: one reverse step of the stored-history VTI adjoint in one pass
    over the grid; returns ``(ap_core, aq_core, gC', gah', gav')`` (see
    :func:`fused_vti_adjoint_step_torch`). With ``inplace`` they are written
    into ``ap2``, ``aq2``, ``gC``, ``gah`` and ``gav`` (each read only at
    the output point). ``p_enc``/``q_enc`` are the history snapshots
    (float32, bfloat16 or int8, one type), decoded as ``enc·psc`` and
    ``enc·qsc``. The receiver injection is not part of the step."""
    name = "fused_vti_adjoint_step"
    _check_f32(name, ap1, aq1, ap2, aq2, gC, gah, gav, C, av, ah)
    _check_grid(name, ap1, order)
    _check_factors(name, ap1, spz, sy, sx)
    _check_history(name, p_enc, ap1)
    _check_history(name, q_enc, ap1)
    if p_enc.dtype != q_enc.dtype:
        raise TypeError(f"{name}: histories of two types, {p_enc.dtype} and "
                        f"{q_enc.dtype}")
    _check_distinct(name, (ap2, aq2, gC, gah, gav),
                    (ap1, aq1, C, av, ah, p_enc, q_enc))
    dev = _device_of(name, ap1)
    psc, qsc, inv_dx2 = (_scalar(x, dev) for x in (psc, qsc, inv_dx2))
    if dev.type == "cpu":
        res = fused_vti_adjoint_step_torch(ap1, aq1, ap2, aq2, gC, gah, gav, C, av, ah,
                                           p_enc, q_enc, psc, qsc, inv_dx2, spz, sy,
                                           sx, order=order)
        if inplace:
            return tuple(o.copy_(r) for o, r in zip((ap2, aq2, gC, gah, gav), res))
        return res
    outs = ((ap2, aq2, gC, gah, gav) if inplace
            else tuple(torch.empty_like(ap1) for _ in range(5)))
    lib = kernels.load_library("vti")
    kernels.check(lib.jt_vti_adjoint_step(
        *_ptrs(ap1, aq1, ap2, aq2, gC, gah, gav, C, av, ah, p_enc, q_enc, psc, qsc,
               inv_dx2, spz, sy, sx), *_ptrs(*outs), *ap1.shape, order,
        _STORE_CODE[p_enc.dtype], _stream(dev)), name, "vti")
    count("launches.fused_vti_adjoint_step")
    return outs


_WRAPPERS = (fused_vti_step, fused_vti_hist_step, fused_vti_adjoint_step)

reset_launch_counts, launch_counts = _launch_counters(_WRAPPERS)
