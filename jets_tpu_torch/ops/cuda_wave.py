"""Hand-written CUDA kernels of the isotropic and constant-Q wave paths
(counterpart of the isotropic half of ``jets_tpu/ops/pallas_wave.py`` and
its Q step), with their plain PyTorch versions.

=============================  ================================================  ========
wrapper                        replaces (TPU kernel)                             plain
=============================  ================================================  ========
:func:`fused_leapfrog_step`    ``pallas_wave.fused_leapfrog_step`` (K4)          :func:`fused_leapfrog_step_torch`
:func:`fused_adjoint_step`     ``pallas_wave.fused_adjoint_step`` (K5)           :func:`fused_adjoint_step_torch`
:func:`fused_q_step`           ``pallas_wave.fused_q_step`` (K14)                :func:`fused_q_step_torch`
:func:`fused_leapfrog_step2d`  none: the JAX package's 2-D step is XLA (K4-2D)   :func:`fused_leapfrog_step2d_torch`
:func:`fused_adjoint_step2d`   none: the JAX package's 2-D step is XLA (K5-2D)   :func:`fused_adjoint_step2d_torch`
:func:`fused_q_adjoint_step`   none: the JAX package's reverse Q step is XLA     :func:`fused_q_adjoint_step_torch`
                               (K15)
=============================  ================================================  ========

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

**The 2-D pair** (K4-2D, K5-2D): K4's and K5's functions over a batch of
two-dimensional shots, ``(B, H, W)``, one launch for the batch, with the
full-grid 2-D sponge ``(H, W)``. Added because the ``"vmap"`` shot stacks
of a 2-D gradient ran each step as ~37 plain operations a shot, whose
dispatch on the host set the pace; each moves 16 B (forward) or 25 B
(reverse) a cell and is bound by device memory (the tiling is described in
``csrc/wave_kernels.cu``). An operand is ``(H, W)``, shared by the batch,
or ``(B, H, W)``; a scalar (``s_t``, ``amp``, the int64 source index, the
history scale ``sc``) is ``()`` or ``(B,)``; each is read through a
pointer with its batch stride, so no shot's value is read on the host. An
unbatched call is B = 1. A sweep binds its fixed operands once
(:func:`leapfrog2d_stepper`, :func:`adjoint2d_stepper`). Under one
:func:`torch.func.vmap` level a step unwraps its shots, moves the batch
dimension to the front and launches once for the stack, without
functorch's generic dispatch of an autograd Function's ``vmap`` rule,
which costs ~0.5 ms of host a call, several times the step's device time.
Under any other transform K4-2D is :class:`_Leapfrog2D`, whose ``vmap``
rule is the same move and whose tangent under :func:`torch.func.jvp` is
the plain step's, formed as forward-mode autodiff forms it, so it has the
same bits; K5-2D refuses other transforms. Neither has a backward: the
isotropic propagators take the plain 2-D step while an autograd tape
records the model, or, for the stored adjoint, while anything but one
vmap level watches.
:func:`fits_wave2d_kernel` is their shape guard.
"""
from __future__ import annotations

import functools

import torch

from .. import kernels
from ..utils.profiling import count
from .cuda_solver import _check_f32, _device_of, _launch_counters, _scalar, _stream
from .stencil import _D2_COEFFS, laplacian_nd

__all__ = [
    "fused_leapfrog_step",
    "fused_adjoint_step",
    "fused_q_step",
    "fused_q_adjoint_step",
    "fused_leapfrog_step_torch",
    "fused_adjoint_step_torch",
    "fused_q_step_torch",
    "fused_q_adjoint_step_torch",
    "fused_leapfrog_step2d",
    "fused_adjoint_step2d",
    "leapfrog2d_stepper",
    "adjoint2d_stepper",
    "fused_leapfrog_step2d_torch",
    "fused_adjoint_step2d_torch",
    "fits_wave_kernel",
    "fits_wave2d_kernel",
    "sponge_product",
    "source_mask",
    "leapfrog_plain",
    "q_plain",
    "q_adjoint_plain",
    "reset_launch_counts",
    "launch_counts",
]

_MAX_GRID = 65535  # gridDim.y / gridDim.z limit of the launch
_STORE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_G_CODE = {torch.float32: 0, torch.bfloat16: 1}  # K14's and K15's friction field


def fits_wave_kernel(shape, dtype, order: int) -> bool:
    """True when K4/K5/K14/K15 (and the VTI and TTI kernels of :mod:`.cuda_vti`
    and :mod:`.cuda_tti`, whose launch grids are no larger) take a grid: 3-D float32, order 2/4/8, and a grid
    the launch limits admit (one block row of 8 per y-block, one z-plane
    per gridDim.z)."""
    if len(shape) != 3 or dtype != torch.float32 or order not in _D2_COEFFS:
        return False
    D, H, W = (int(s) for s in shape)
    return 0 < D <= _MAX_GRID and 0 < -(-H // 8) <= _MAX_GRID and W > 0


_TILE2D = 32  # rows (and columns) of a K4-2D/K5-2D block's tile


def fits_wave2d_kernel(shape, dtype, order: int) -> bool:
    """True when K4-2D/K5-2D take a grid: 2-D float32, order 2/4/8, and a
    grid the launch limits admit (one block row of 32 rows per y-block; the
    batch, checked by the wrappers, one shot per gridDim.z)."""
    if len(shape) != 2 or dtype != torch.float32 or order not in _D2_COEFFS:
        return False
    H, W = (int(s) for s in shape)
    return 0 < -(-H // _TILE2D) <= _MAX_GRID and W > 0


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


def q_adjoint_plain(a1, a2, gC, gig, gog, c2dt2, om1g, inv1pg, sponge, u, order):
    """One reverse step of the stored-history constant-Q adjoint with the
    friction factors ``om1g = 1 − g``, ``inv1pg = 1/(1 + g)``, ``S`` and the
    decoded snapshot ``u`` full grids: ``sē = S⊙a1``, ``ē = inv1pg⊙sē``, the
    same of ``a2`` for the next step's, and returns ``(a_core, gC', gig',
    gog')``, each term in the order of ``ops/wave._adjoint_stored_q``'s
    sweep: the tree of K15 and of that sweep's plain route."""
    sbar = a1 * sponge
    ebar = inv1pg * sbar
    sbar_next = a2 * sponge
    ebar_next = inv1pg * sbar_next
    lap_u = laplacian_nd(u, order=order)
    gC = gC + lap_u * ebar
    gig = gig + (sbar * (2.0 * u + c2dt2 * lap_u) - om1g * (u * sbar_next))
    gog = gog - u * ebar_next
    core = (2.0 * ebar + laplacian_nd(c2dt2 * ebar, order=order)) - om1g * ebar_next
    return core, gC, gig, gog


def fused_q_step_torch(u_prev, u, c2dt2, g, spz, sy, sx, s_t, src_idx, amp, *,
                       order: int = 2):
    """Plain K14: :func:`q_plain` with ``om1g = 1 − g`` and ``inv1pg =
    1/(1 + g)`` from the friction field ``g`` (float32 or bfloat16, upcast),
    a fresh tensor."""
    g = g.to(torch.float32)
    return q_plain(u_prev, u, c2dt2, 1.0 - g, 1.0 / (1.0 + g),
                   sponge_product(spz, sy, sx), s_t, source_mask(u.shape, src_idx, amp),
                   order)


def fused_q_adjoint_step_torch(a1, a2, gC, gig, gog, c2dt2, g, u_enc, sc, spz, sy, sx, *,
                               order: int = 2):
    """Plain K15: :func:`q_adjoint_plain` with ``1 − g`` and ``1/(1 + g)``
    from the friction field ``g`` (float32 or bfloat16, upcast), ``S =
    (sz·sy)·sx`` and the snapshot decoded as ``u_enc·sc``; returns fresh
    ``(a_core, gC', gig', gog')``."""
    g = g.to(torch.float32)
    return q_adjoint_plain(a1, a2, gC, gig, gog, c2dt2, 1.0 - g, 1.0 / (1.0 + g),
                           sponge_product(spz, sy, sx), u_enc.to(torch.float32) * sc, order)


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


def _lap2d(x, order):
    """``laplacian_nd`` of each ``(H, W)`` plane of a ``(H, W)`` or
    ``(B, H, W)`` field."""
    if x.ndim == 2:
        return laplacian_nd(x, order=order)
    return torch.func.vmap(functools.partial(laplacian_nd, order=order))(x)


def _per_shot(x):
    """A ``(B,)`` per-shot scalar as ``(B, 1, 1)``, to meet ``(B, H, W)``
    fields; a 0-d one as it is."""
    return x.reshape(-1, 1, 1) if x.ndim == 1 else x


def fused_leapfrog_step2d_torch(u_prev, u, c2dt2, sponge, s_t, src_idx, amp, *,
                                order: int = 2):
    """Plain K4-2D: ``((2u − u_prev) + c²dt²·L(u))·S + s_t·onehot(src)·amp``
    of each shot, :func:`leapfrog_plain`'s tree, with ``L`` the 2-D Laplacian
    of each plane; fields ``(H, W)`` or ``(B, H, W)``, scalars and the
    source index ``()`` or ``(B,)``; a fresh tensor."""
    src, s_t, amp = (_per_shot(torch.as_tensor(x)) for x in (src_idx, s_t, amp))
    mask = source_mask(u.shape[-2:], src, amp)
    e = (2.0 * u - u_prev) + c2dt2 * _lap2d(u, order)
    return e * sponge + s_t * mask


def fused_adjoint_step2d_torch(a1, a2, gc2, c2dt2, u_enc, sc, sponge, *, order: int = 2):
    """Plain K5-2D: :func:`fused_adjoint_step_torch`'s tree on each 2-D shot
    with the full-grid sponge ``S``; returns ``(a_core, gc2_new)``."""
    ebar = a1 * sponge
    u = u_enc.to(torch.float32) * _per_shot(torch.as_tensor(sc))
    gc2_new = gc2 + _lap2d(u, order) * ebar
    core = (2.0 * ebar + _lap2d(c2dt2 * ebar, order)) - a2 * sponge
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


def _dense_planes(shape, stride):
    """Whether the last two dimensions of a tensor of ``shape`` and
    ``stride`` are row-major dense (read from its strides: a tensor operation
    costs host time, the more under ``vmap``)."""
    (h, w), (sh, sw) = shape[-2:], stride[-2:]
    return (w < 2 or sw == 1) and (h < 2 or sh == w)


def _batch2d(name, dev, operands):
    """The batch size (None: unbatched) and the batch strides of K4-2D's or
    K5-2D's ``operands``, ``(what, tensor, dtypes, hw)``: a field (``hw =
    (H, W)``) is ``(H, W)``, shared by the batch (stride 0), or ``(B, H, W)``
    with dense planes; a scalar (``hw = ()``) is ``()`` or ``(B,)``."""
    batch, strides = None, []
    for what, t, dtypes, hw in operands:
        if t.dtype not in dtypes:
            raise TypeError(f"{name}: {what} must be {' or '.join(map(str, dtypes))}, "
                            f"got {t.dtype}")
        if t.device != dev:
            raise ValueError(f"{name}: {what} on {t.device}, grid on {dev}")
        shape, stride = t.shape, t.stride()
        k = len(shape) - len(hw)
        if k not in (0, 1) or shape[k:] != hw:
            raise ValueError(f"{name}: {what} must have shape {hw} or (B, *{hw}), got "
                             f"{tuple(shape)}")
        if hw and not _dense_planes(shape, stride):
            raise ValueError(f"{name}: {what}'s planes must be contiguous")
        if k == 0:
            strides.append(0)
            continue
        if batch is not None and shape[0] != batch:
            raise ValueError(f"{name}: batches of {batch} and {shape[0]} shots")
        batch = shape[0]
        strides.append(stride[0])
    if batch is not None and batch > _MAX_GRID:
        raise ValueError(f"{name}: a batch of {batch} exceeds the launch grid")
    return batch, strides


def _grid2d(name, u, order):
    if u.ndim not in (2, 3):
        raise ValueError(f"{name}: expected a (H, W) or (B, H, W) grid, got shape "
                         f"{tuple(u.shape)}")
    if order not in _D2_COEFFS:
        raise ValueError(f"{name}: order must be one of {sorted(_D2_COEFFS)}, got {order}")
    hw = tuple(u.shape[-2:])
    if not fits_wave2d_kernel(hw, torch.float32, order):
        raise ValueError(f"{name}: grid {hw} exceeds the launch grid")
    return hw


def _scalar2d(x, device, dtype=torch.float32):
    """A 0-d or ``(B,)`` scalar as a tensor on ``device`` (a Python number
    made there with ``torch.full``, which does not wait for the stream)."""
    if torch.is_tensor(x):
        return x if x.device == device else x.to(device)
    return torch.full((), x, dtype=dtype, device=device)


def _raw_stream(device):
    """The current CUDA stream of ``device`` as the integer the kernels take,
    in one call (``torch.cuda.current_stream`` builds a Stream object)."""
    return torch._C._cuda_getCurrentRawStream(device.index)


def _lone_vmap_level():
    """The level of the one :func:`torch.func.vmap` the call runs under, None
    under no transform, False under any other (a jvp, a grad, nested vmaps)."""
    if not torch._C._are_functorch_transforms_active():
        return None
    stack = torch._C._functorch.get_interpreter_stack()
    if len(stack) == 1 and stack[0].key() == torch._C._functorch.TransformType.Vmap:
        return stack[0].level()
    return False


def _unwrapped(t):
    """``t`` with every ``torch.func`` wrapper (a vmap's batching, a jvp's
    dual) taken off: the tensor an autograd tape records."""
    while torch._C._functorch.is_functorch_wrapped_tensor(t):
        t = torch._C._functorch.get_unwrapped(t)
    return t


def _physical(ts, level):
    """``(tensors, batched)``: ``ts`` as the tensors under vmap ``level``
    (None: no transform), each batch dimension moved to the front
    (:func:`_lead`), and whether any of them was batched at that level."""
    if level is None:
        return list(ts), False
    unwrapped = [torch._C._functorch._unwrap_batched(t, level) for t in ts]
    dims = [d for _, d in unwrapped]
    return _lead([t for t, _ in unwrapped], dims), any(d is not None for d in dims)


def _one_batch(name, *batches):
    sizes = {b for b in batches if b is not None}
    if len(sizes) > 1:
        raise ValueError(f"{name}: batches of {' and '.join(map(str, sorted(sizes)))} shots")
    return sizes.pop() if sizes else None


def _ptrs(tensors, strides):
    return tuple(v for t, sb in zip(tensors, strides) for v in (t.data_ptr(), sb))


_F32, _I64 = (torch.float32,), (torch.int64,)


def leapfrog2d_stepper(c2dt2, sponge, src_idx, amp, *, order: int = 2):
    """``step(u_prev, u, s_t, out=None)``: :func:`fused_leapfrog_step2d` with
    the operands a sweep holds fixed (``c2dt2``, ``sponge``, ``src_idx``,
    ``amp``) checked, unwrapped and resolved to pointers once, for the
    host's sake: a vmapped 2-D step is host-bound. Under one
    :func:`torch.func.vmap` level a step unwraps its shots, launches once for
    the stack (the batching rule of :class:`_Leapfrog2D`, without functorch's
    generic dispatch of an autograd Function, ~0.5 ms of host a call) and
    batches the result at 0; under any other transform it is
    :class:`_Leapfrog2D`, whose rule and tangent functorch dispatches. Made
    where it is used: the transforms it sees are those of its steps."""
    name = "fused_leapfrog_step2d"
    level = _lone_vmap_level()
    if level is False:
        def general(u_prev, u, s_t, out=None):
            return _Leapfrog2D.apply(u_prev, u, c2dt2, sponge, s_t, src_idx, amp, order)
        return general
    hw = _grid2d(name, c2dt2, order)
    dev = _device_of(name, c2dt2)
    fixed, fixed_batched = _physical((c2dt2, sponge, _scalar2d(amp, dev),
                                      _scalar2d(src_idx, dev, torch.int64)), level)
    c2p, sp, ampp, srcp = fixed
    b_fixed, sb_fixed = _batch2d(name, dev, (
        ("c2dt2", c2p, _F32, hw), ("sponge", sp, _F32, hw), ("amp", ampp, _F32, ()),
        ("src_idx", srcp, _I64, ())))
    if dev.type == "cuda":
        lib = kernels.load_library("wave")
        head, tail = _ptrs(fixed[:2], sb_fixed[:2]), _ptrs(fixed[2:], sb_fixed[2:])

    def step(u_prev, u, s_t, out=None):
        (upp, up, stp), batched = _physical((u_prev, u, _scalar2d(s_t, dev)), level)
        b, sb = _batch2d(name, dev, (("u_prev", upp, _F32, hw), ("u", up, _F32, hw),
                                     ("s_t", stp, _F32, ())))
        B = _one_batch(name, b_fixed, b)
        if up.data_ptr() == upp.data_ptr():
            raise ValueError(f"{name}: u and u_prev must be distinct buffers")
        if level is not None:
            out = None  # under vmap the result is always fresh
        elif out is not None and (out is not u_prev or (B is not None and u_prev.ndim == 2)):
            raise ValueError(f"{name}: out must be None or u_prev holding the whole batch")
        if dev.type == "cpu":
            res = fused_leapfrog_step2d_torch(upp, up, c2p, sp, stp, srcp, ampp, order=order)
            res = res if out is None else out.copy_(res)
        else:
            res = out if out is not None else torch.empty(
                hw if B is None else (B, *hw), dtype=torch.float32, device=dev)
            kernels.check(lib.jt_leapfrog_step2d(
                *_ptrs((upp, up), sb[:2]), *head, stp.data_ptr(), sb[2], *tail,
                res.data_ptr(), B or 1, *hw, order, _raw_stream(dev)), name, "wave")
            count("launches.fused_leapfrog_step2d")
        if batched or fixed_batched:
            return torch._C._functorch._add_batch_dim(res, 0, level)
        return res

    return step


def adjoint2d_stepper(c2dt2, sponge, *, order: int = 2):
    """``step(a1, a2, gc2, u_enc, sc, inplace=False) -> (a_core, gc2_new)``:
    :func:`fused_adjoint_step2d` with ``c2dt2`` and ``sponge`` bound once;
    under one :func:`torch.func.vmap` level a step launches once for the
    stacked shots, as :func:`leapfrog2d_stepper`'s steps do. K5-2D has no
    tangent and no backward, and its stepper refuses any other transform:
    the stored adjoint takes the plain reverse step there."""
    name = "fused_adjoint_step2d"
    level = _lone_vmap_level()
    if level is False:
        raise ValueError(f"{name}: runs under no torch.func transform but one vmap level")
    hw = _grid2d(name, c2dt2, order)
    dev = _device_of(name, c2dt2)
    (c2p, sp), fixed_batched = _physical((c2dt2, sponge), level)
    b_fixed, sb_fixed = _batch2d(name, dev, (("c2dt2", c2p, _F32, hw),
                                             ("sponge", sp, _F32, hw)))
    if dev.type == "cuda":
        lib = kernels.load_library("wave")
        c2_ptrs, s_ptrs = _ptrs((c2p,), sb_fixed[:1]), _ptrs((sp,), sb_fixed[1:])

    def step(a1, a2, gc2, u_enc, sc, inplace=False):
        (a1p, a2p, gp, qp, scp), batched = _physical(
            (a1, a2, gc2, u_enc, _scalar2d(sc, dev)), level)
        b, sb = _batch2d(name, dev, (
            ("a1", a1p, _F32, hw), ("a2", a2p, _F32, hw), ("gc2", gp, _F32, hw),
            ("history", qp, tuple(_STORE_CODE), hw), ("sc", scp, _F32, ())))
        B = _one_batch(name, b_fixed, b)
        fields = {t.data_ptr() for t in (a1p, a2p, gp)}
        if len(fields) < 3 or {c2p.data_ptr(), qp.data_ptr()} & fields:
            raise ValueError(f"{name}: a1, a2, gc2, c2dt2 and the history must be "
                             "distinct buffers")
        inplace = inplace and level is None  # under vmap the results are always fresh
        if inplace and B is not None and (a2.ndim == 2 or gc2.ndim == 2):
            raise ValueError(f"{name}: in place needs a2 and gc2 holding the whole batch")
        if dev.type == "cpu":
            core, gnew = fused_adjoint_step2d_torch(a1p, a2p, gp, c2p, qp, scp, sp,
                                                    order=order)
            if inplace:
                core, gnew = a2.copy_(core), gc2.copy_(gnew)
        else:
            shape = hw if B is None else (B, *hw)
            core = a2 if inplace else torch.empty(shape, dtype=torch.float32, device=dev)
            gnew = gc2 if inplace else torch.empty(shape, dtype=torch.float32, device=dev)
            kernels.check(lib.jt_adjoint_step2d(
                *_ptrs((a1p, a2p, gp), sb[:3]), *c2_ptrs, *_ptrs((qp, scp), sb[3:]), *s_ptrs,
                core.data_ptr(), gnew.data_ptr(), B or 1, *hw, order,
                _STORE_CODE[qp.dtype], _raw_stream(dev)), name, "wave")
            count("launches.fused_adjoint_step2d")
        if batched or fixed_batched:
            return tuple(torch._C._functorch._add_batch_dim(t, 0, level)
                         for t in (core, gnew))
        return core, gnew

    return step


def _lead(args, in_dims):
    """A vmap rule's operands: each batched one with its batch dimension
    moved to the front, and its planes made dense where that move left them
    strided (a copy)."""
    out = []
    for a, d in zip(args, in_dims):
        if d:
            a = a.movedim(d, 0)
            if a.ndim == 3 and not _dense_planes(a.shape, a.stride()):
                a = a.contiguous()
        out.append(a)
    return out


def _tsum(a, b):
    """``a + b`` of two tangents, either one absent (None)."""
    return b if a is None else a if b is None else a + b


class _Leapfrog2D(torch.autograd.Function):
    """K4-2D under :mod:`torch.func`: the forward is the wrapper, the
    ``vmap`` rule hands the stacked shots to one launch as its leading
    dimension, and the tangent is the plain step's, each term formed as
    forward-mode autodiff of :func:`fused_leapfrog_step2d_torch` forms it
    (``2·du − dup``, then ``c²dt²·L(du) + dc²dt²·L(u)``, then ``·S``), so it
    has the same bits (:func:`torch.func.jvp` hands every input a tangent, a
    zero one where it has none). No backward: a tape takes the plain step."""

    @staticmethod
    def forward(u_prev, u, c2dt2, sponge, s_t, src, amp, order):
        return fused_leapfrog_step2d(u_prev, u, c2dt2, sponge, s_t, src, amp, order=order)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_forward(*inputs[:7])
        ctx.order = inputs[7]

    @staticmethod
    def jvp(ctx, dup, du, dc2, dS, dst, _dsrc, damp, _dorder):
        u_prev, u, c2, S, s_t, src, amp = ctx.saved_tensors
        lap = functools.partial(_lap2d, order=ctx.order)
        d_lin = None if du is None else 2.0 * du
        d_lin = d_lin if dup is None else (-dup if d_lin is None else d_lin - dup)
        d_e = _tsum(d_lin, _tsum(None if du is None else c2 * lap(du),
                                 None if dc2 is None else dc2 * lap(u)))
        out = None if d_e is None else d_e * S
        if dS is not None:
            out = _tsum(out, ((2.0 * u - u_prev) + c2 * lap(u)) * dS)
        if dst is not None or damp is not None:
            src, s_t, amp = _per_shot(src), _per_shot(s_t), _per_shot(amp)
            d_src = None if dst is None else _per_shot(dst) * source_mask(
                u.shape[-2:], src, amp)
            if damp is not None:
                d_src = _tsum(d_src, s_t * source_mask(u.shape[-2:], src, _per_shot(damp)))
            out = _tsum(out, d_src)
        return out

    @staticmethod
    def vmap(info, in_dims, *args):
        return _Leapfrog2D.apply(*_lead(args, in_dims)), 0


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


def fused_q_adjoint_step(a1, a2, gC, gig, gog, c2dt2, g, u_enc, sc, spz, sy, sx, *,
                         order: int = 2, inplace: bool = True):
    """K15: one reverse step of the stored-history constant-Q adjoint in
    one pass over the grid. Returns ``(a_core, gC', gig', gog')`` of
    :func:`q_adjoint_plain`; with ``inplace`` they are written into ``a2``'s,
    ``gC``'s, ``gig``'s and ``gog``'s buffers (each is read only at the
    output point). ``g`` is the friction field, float32 or bfloat16;
    ``u_enc`` the history snapshot, float32, bfloat16 or int8, decoded as
    ``u_enc·sc``."""
    name = "fused_q_adjoint_step"
    _check_f32(name, a1, a2, gC, gig, gog, c2dt2)
    _check_grid(name, a1, order)
    _check_factors(name, a1, spz, sy, sx)
    for what, t, codes in (("g", g, _G_CODE), ("history", u_enc, _STORE_CODE)):
        if t.dtype not in codes:
            raise TypeError(f"{name}: {what} must be "
                            f"{' or '.join(str(d)[6:] for d in codes)}, got {t.dtype}")
        if t.shape != a1.shape or t.device != a1.device:
            raise ValueError(f"{name}: {what} {tuple(t.shape)} on {t.device}, grid "
                             f"{tuple(a1.shape)} on {a1.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
    fields = {t.data_ptr() for t in (a1, a2, gC, gig, gog)}
    if len(fields) < 5 or {t.data_ptr() for t in (c2dt2, g, u_enc)} & fields:
        raise ValueError(f"{name}: a1, a2, gC, gig, gog, c2dt2, g and the history must "
                         "be distinct buffers")
    dev = _device_of(name, a1)
    sc = _scalar(sc, dev)
    if dev.type == "cpu":
        res = fused_q_adjoint_step_torch(a1, a2, gC, gig, gog, c2dt2, g, u_enc, sc, spz,
                                         sy, sx, order=order)
        if inplace:
            return tuple(t.copy_(r) for t, r in zip((a2, gC, gig, gog), res))
        return res
    outs = (a2, gC, gig, gog) if inplace else tuple(torch.empty_like(a1) for _ in range(4))
    lib = kernels.load_library("wave")
    kernels.check(lib.jt_q_adjoint_step(
        *(t.data_ptr() for t in (a1, a2, gC, gig, gog, c2dt2, g, u_enc, sc, spz, sy, sx,
                                 *outs)),
        *a1.shape, order, _STORE_CODE[u_enc.dtype], _G_CODE[g.dtype], _stream(dev)), name,
        "wave")
    count("launches.fused_q_adjoint_step")
    return outs


def fused_leapfrog_step2d(u_prev, u, c2dt2, sponge, s_t, src_idx, amp, *,
                          order: int = 2, out=None):
    """K4-2D: one leapfrog step of a batch of 2-D shots in one launch,
    ``((2u − u_prev) + c²dt²·L(u))·S + s_t·onehot(src_b)·amp``. Fields
    ``(H, W)`` (shared by the batch) or ``(B, H, W)``; ``sponge`` the full-grid
    ``(H, W)`` sponge; ``s_t``, ``amp`` and the int64 source index
    ``src_idx`` (flat in the ``(H, W)`` plane) ``()`` or ``(B,)``. The result
    is ``(B, H, W)`` if anything is batched, else ``(H, W)``. ``out`` is None
    (a fresh tensor) or ``u_prev`` holding the whole batch (written in place:
    ``u_prev`` is read only at the output point); under :mod:`torch.func`
    transforms the result is always fresh, and under
    :func:`torch.func.vmap` the stacked shots are one launch. A sweep binds
    its fixed operands once with :func:`leapfrog2d_stepper`."""
    return leapfrog2d_stepper(c2dt2, sponge, src_idx, amp, order=order)(u_prev, u, s_t,
                                                                       out=out)


def fused_adjoint_step2d(a1, a2, gc2, c2dt2, u_enc, sc, sponge, *, order: int = 2,
                         inplace: bool = False):
    """K5-2D: one reverse step of the stored-wavefield adjoint of a batch of
    2-D shots in one launch. Returns ``(a_core, gc2_new)`` with ``ē = S⊙a1``,
    ``a_core = (2ē + L(c²dt²·ē)) − S⊙a2``, ``gc2_new = gc2 + L(q·sc)⊙ē``.
    Shapes as for :func:`fused_leapfrog_step2d`; ``u_enc`` the snapshot
    (float32, bfloat16 or int8), ``sc`` its scale, ``()`` or ``(B,)``. With
    ``inplace`` (``a2`` and ``gc2`` holding the whole batch) the outputs are
    written into their buffers; under :func:`torch.func.vmap` they are
    always fresh and the stacked shots are one launch; any other
    :mod:`torch.func` transform raises. A sweep binds ``c2dt2`` and
    ``sponge`` once with :func:`adjoint2d_stepper`."""
    return adjoint2d_stepper(c2dt2, sponge, order=order)(a1, a2, gc2, u_enc, sc,
                                                         inplace=inplace)


_WRAPPERS = (fused_leapfrog_step, fused_adjoint_step, fused_q_step, fused_leapfrog_step2d,
             fused_adjoint_step2d, fused_q_adjoint_step)

reset_launch_counts, launch_counts = _launch_counters(_WRAPPERS)
