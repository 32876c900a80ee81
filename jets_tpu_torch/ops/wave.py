"""Isotropic, variable-density, VTI and TTI anisotropic and constant-Q
visco-acoustic wave operators (counterpart of ``jets_tpu/ops/wave.py``,
with the same names).

Physics: constant-density acoustic wave equation, 2nd order in time,
orders 2/4/8 in space, time-stepped by an explicit leapfrog with a sponge
taper at the boundaries::

    u_next = ((2u − u_prev) + c²dt²/dx²·L(u))·S + s(t)·dt²·δ(x − x_src)

* :func:`wave_propagator` — nonlinear forward modelling ``F: c → traces``;
  its tangent is ``torch.func.jvp`` through the time loop, its adjoint
  either autograd's reverse pass through it (``store_adjoint=None``) or the
  hand-derived reverse sweep over a stored, optionally compressed,
  forward-wavefield history (``store_adjoint`` ∈ f32/bf16/int8).
* :func:`born_operator` — the Jacobian pinned at a background velocity.
* :func:`multishot_wave_operator` — one propagator per shot, stacked over
  shots (``shot_map="map"``: a loop over shots, each on the kernels;
  ``"vmap"``: one batched plain program), optionally inside a per-shot
  Ginsu window of the model or with CPML boundaries.
* :func:`cpml_wave_propagator` — the isotropic physics with convolutional
  PML boundaries (two memory fields per axis) instead of the sponge; plain
  PyTorch, its adjoint derived.
* :func:`vti_wave_propagator` and :func:`multishot_vti_wave_operator` —
  the pseudo-acoustic VTI system (two coupled fields p, q; model
  ``(c, ε, δ)`` on a ``BlockSpace([grid, grid, grid])``), with the same
  tangent, autodiff adjoint and stored two-field-history adjoint.
* :func:`tti_wave_propagator` and :func:`multishot_tti_wave_operator` —
  the tilted system: VTI's operators rotated onto the symmetry axis, model
  ``(c, ε, δ, θ, φ)`` on five blocks in 3-D (``(c, ε, δ, θ)`` on four in
  2-D), optionally with its five coefficient fields in bfloat16.
* :func:`q_wave_propagator` and :func:`multishot_q_wave_operator` —
  visco-acoustic modelling with Kosloff constant-Q friction, model
  ``(c, Q)`` on ``BlockSpace([grid, grid])``, the friction field optionally
  in bfloat16, with the same tangent, autodiff adjoint and stored-history
  adjoint, the multishot one with Ginsu windows of both blocks. ``q=`` on
  the VTI and TTI propagators adds the same friction as a static modelling
  parameter.
* :func:`vd_wave_propagator` and :func:`vdq_wave_propagator` — variable
  density (model ``(c, b)``, buoyancy ``b = 1/ρ``) and the full IsoDenQ
  physics (``(c, b, Q)``), with the same tangent, autodiff adjoint and
  stored-history adjoint.
* :func:`offgrid_wave_propagator` — the isotropic physics with off-grid
  acquisition: a Kaiser-sinc source stamp and receiver interpolation
  (:mod:`.sampling`).

Every constructor builds on the CUDA card unless ``device`` says otherwise
(``device="cpu"``, as the tests ask).

On a 3-D float32 grid on a CUDA card the isotropic forward step is the
hand-written kernel K4 (:func:`cuda_wave.fused_leapfrog_step`) and the
reverse step of its stored adjoint K5 (:func:`cuda_wave.fused_adjoint_step`);
on a 2-D one they are the batched pair K4-2D and K5-2D
(:func:`cuda_wave.fused_leapfrog_step2d`, :func:`cuda_wave.fused_adjoint_step2d`),
which the ``"vmap"`` shot stacks launch once a step for all their shots;
the VTI step is K8 (:func:`cuda_vti.fused_vti_step`), its stored adjoint's
forward sweep K9 (:func:`cuda_vti.fused_vti_hist_step`, which also encodes
the history) and reverse sweep K10 (:func:`cuda_vti.fused_vti_adjoint_step`);
the 3-D TTI step is K11 (:func:`cuda_tti.fused_tti_step`), its stored
adjoint's forward sweep K12 (:func:`cuda_tti.fused_tti_hist_step`) and
reverse sweep K13 (:func:`cuda_tti.fused_tti_adjoint_step`); the 3-D
constant-Q step is K14 (:func:`cuda_wave.fused_q_step`), also in the forward
sweep of its stored adjoint, whose reverse sweep is K15
(:func:`cuda_wave.fused_q_adjoint_step`). Elsewhere, and
with ``fused=False``, the plain PyTorch step with the same floating-point
tree runs. What no kernel computes always takes the plain step, and
``fused=True`` raises for it: variable density, static Q on VTI and TTI,
and a custom source mask, extractor or injector (off-grid geometry). The JAX package pairs two steps per ``lax.scan``
iteration on the TPU to avoid carry copies; a Python loop rotates
``(u_prev, u) → (u, u_next)`` for free, so the port steps one at a time and
writes ``u_next`` into ``u_prev``'s buffer on sweeps that no autodiff
transform watches.

``remat_blocks > 1`` groups the time loop into that many segments while
an autograd tape records the model: the backward keeps the carries at the
segment boundaries and recomputes each segment's steps, through the same
kernels, instead of keeping every step's saved tensors. Each segment runs
under :func:`torch.utils.checkpoint.checkpoint` (non-reentrant), or, under
the ``"vmap"`` multishot stacks' ``torch.func.vmap``, where the checkpoint
does not run, as a :class:`_Segment` autograd Function that recomputes
under ``torch.func.vjp``. The traces are the same bits, and so are the
gradients. Every derived adjoint runs by :func:`torch.autograd.grad`
(:func:`_vjp_by_autograd`), since ``torch.func.vjp`` refuses checkpointed
segments: per shot in ``"map"`` mode, over the whole vmapped stack in
``"vmap"`` mode.

**Distribution** (:mod:`jets_tpu_torch.parallel`): ``mesh=`` on the three
multishot operators shards the shots over the ranks of a
:class:`~jets_tpu_torch.parallel.sharded.BlockMesh` (each rank's shots as
above, their adjoint contributions met in one ``all_reduce`` over the shot
axis); on a 2-D (block × grid) mesh each shot's wavefields are sharded over
the grid axis too, the shots then running one after another.
``wavefield_sharding=BlockSharding(mesh, spec)`` on :func:`wave_propagator`,
:func:`vti_wave_propagator` and :func:`tti_wave_propagator` (3-D only)
splits the grid over the ranks, any dimensions over any mesh axes: every
step exchanges ``order/2`` halo planes with the neighbours of each sharded
dimension (:class:`_Slab`) and runs on the halo-extended slab — K4 for a
z-only sharding of a 3-D float32 grid, the plain step otherwise, as in the
JAX package. A slab count that does not divide its dimension and a slab
thinner than the halo are refused (``ValueError`` naming
``wavefield_sharding``).
"""
from __future__ import annotations

import functools
import math
import warnings
from typing import Optional, Sequence

import numpy as np
import torch
from torch.utils import _pytree as pytree
from torch.utils.checkpoint import checkpoint

from ..core.blockspace import BlockSpace, BlockVector
from ..core.jet import Jet, LinearOperator, Operator, with_state
from ..core.spaces import Space, true_div
from ..parallel.collectives import halo_exchange, max_replicated, sum_replicated
from ..parallel.sharded import (BlockSharding, ShardedSpace, grid_axis, local_slices,
                                stacked_block_operator)
from ..utils.profiling import count, span
from ..utils.tree import tmap
from . import cuda_tti, cuda_vti, cuda_wave
from .sampling import _axis_contract, kaiser_sinc_matrix, kaiser_sinc_matrix_np
from .stencil import d1_axis, d2_axis
from .stencil import laplacian_nd as _laplacian

__all__ = [
    "wave_propagator",
    "born_operator",
    "multishot_wave_operator",
    "vti_wave_propagator",
    "multishot_vti_wave_operator",
    "tti_wave_propagator",
    "multishot_tti_wave_operator",
    "q_wave_propagator",
    "multishot_q_wave_operator",
    "cpml_wave_propagator",
    "vd_wave_propagator",
    "vdq_wave_propagator",
    "offgrid_wave_propagator",
    "with_wave_arrays",
]

_STORES = ("f32", "bf16", "int8")


def _check_space_order(order: int) -> int:
    """Validate the spatial accuracy order at operator construction time."""
    if order not in (2, 4, 8):
        raise ValueError(f"space_order must be one of (2, 4, 8), got {order}")
    return int(order)


def _remat_segments(nt: int, remat_blocks: int) -> int:
    """The number of checkpointed segments of an ``nt``-step loop: a
    ``remat_blocks`` that does not divide ``nt`` snaps, with a warning, to
    the nearest divisor, so the blocked memory saving is kept."""
    if remat_blocks > 1 and nt % remat_blocks != 0:
        divisors = [k for k in range(2, nt + 1) if nt % k == 0]
        if divisors:
            snapped = min(divisors, key=lambda k: abs(k - remat_blocks))
            warnings.warn(f"remat_blocks={remat_blocks} does not divide nt={nt}; "
                          f"using the nearest divisor {snapped} instead", stacklevel=4)
            return snapped
        return 1  # nt == 1
    return max(int(remat_blocks), 1)


class _Segment(torch.autograd.Function):
    """One segment of a time loop under ``torch.func.vmap`` (the shot
    stacks' remat route, where :func:`torch.utils.checkpoint.checkpoint`
    does not run): ``run(carry, xs, params, consts) -> (traces, carry)``
    over the flat carry leaves, the model's coefficient tensors ``params``
    and every other tensor the steps read, ``consts`` (the sponge, the
    shot's source mask, scalars made in the propagation: a tensor that
    ``vmap`` batches or ``torch.func.vjp`` tracks must come in as an input,
    not by closure). The forward runs the segment's steps without a tape
    and saves only its inputs; the backward recomputes the segment under
    :func:`torch.func.vjp` and pulls the cotangents of the traces and of the
    output carry back to the input carry and ``params``. The outputs also
    pass ``params`` through (as views), so the next segment's cotangent of
    them reaches this backward first and each coefficient's gradient sums
    its steps in the order autograd sums them through the straight loop:
    the same bits."""

    generate_vmap_rule = True

    @staticmethod
    def forward(run, n, k, xs, *tensors):
        carry, params, consts = tensors[:n], tensors[n:n + k], tensors[n + k:]
        recs, carry = run(carry, xs, params, consts)
        return (recs, *carry, *(p.view_as(p) for p in params))

    @staticmethod
    def setup_context(ctx, inputs, output):
        run, n, k, xs, *tensors = inputs
        ctx.save_for_backward(xs, *tensors)
        ctx.run, ctx.n, ctx.k = run, n, k

    @staticmethod
    def backward(ctx, d_recs, *d_out):
        xs, *tensors = ctx.saved_tensors
        n, k = ctx.n, ctx.k
        consts = tuple(tensors[n + k:])

        def seg(carry, params):
            recs, out = ctx.run(carry, xs, params, consts)
            return recs, out, params

        _, pull = torch.func.vjp(seg, tuple(tensors[:n]), tuple(tensors[n:n + k]))
        d_carry, d_params = pull((d_recs, tuple(d_out[:n]), tuple(d_out[n:])))
        return (None, None, None, None, *d_carry, *d_params, *(None,) * len(consts))


def _friction(og, ig):
    """The static-Q factors as step arguments: none without friction."""
    return () if og is None else (og, ig)


def _time_loop(step, carry, wavelet, remat_blocks: int, tape: bool, params=(),
               consts=(), vmapped: bool = False):
    """Receiver traces ``(nt, nrcv)`` of ``step(carry, s_t, params, consts)
    -> (carry, rec)`` run over the wavelet, ``params`` being the model's
    coefficient tensors the step reads and ``consts`` the shot's other
    tensors (see :class:`_Segment`). With more than one segment
    (:func:`_remat_segments`) and ``tape`` (an autograd tape records the
    model), each segment runs under non-reentrant
    :func:`torch.utils.checkpoint.checkpoint`, the carry crossing its
    boundary and its traces coming out: the backward keeps the boundary
    carries and recomputes a segment's steps when it reaches them. Under
    the shot stacks' ``torch.func.vmap`` (``vmapped``), where the checkpoint
    does not run, each segment is a :class:`_Segment` instead, with the same
    memory and the same bits. The traces are the same bits either way.
    Without a tape (and under ``torch.func.jvp``, whose forward mode stores
    nothing) the loop runs straight."""
    nt = int(wavelet.shape[0])
    blocks = _remat_segments(nt, remat_blocks)

    def segment(carry, xs, params, consts):
        recs = []
        for s_t in xs:
            carry, rec = step(carry, s_t, params, consts)
            recs.append(rec)
        return carry, torch.stack(recs)

    if blocks == 1 or not tape:
        return segment(carry, wavelet, params, consts)[1]
    blk = nt // blocks
    parts = []
    if vmapped:
        leaves, spec = pytree.tree_flatten(carry)
        n, k = len(leaves), len(params)

        def run(leaves, xs, params, consts):
            carry, recs = segment(pytree.tree_unflatten(list(leaves), spec), xs, params,
                                  consts)
            return recs, tuple(pytree.tree_leaves(carry))

        for b in range(blocks):
            recs, *rest = _Segment.apply(run, n, k, wavelet[b * blk:(b + 1) * blk],
                                         *leaves, *params, *consts)
            leaves, params = rest[:n], tuple(rest[n:])
            parts.append(recs)
        return torch.cat(parts)
    for b in range(blocks):
        carry, recs = checkpoint(segment, carry, wavelet[b * blk:(b + 1) * blk], params,
                                 consts, use_reentrant=False)
        parts.append(recs)
    return torch.cat(parts)


def _records(*model) -> bool:
    """True when an autograd tape records any of the model tensors."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in model)


def _records_within(*model) -> bool:
    """:func:`_records` of the tensors inside ``torch.func`` transforms: a
    vmapped or dual tensor does not show that a tape records the tensor it
    wraps. The 2-D pair, which has no backward, decides by it."""
    return _records(*map(cuda_wave._unwrapped, model))


def _vjp_by_autograd(fn, m0, dd):
    """``vjp(fn, m0)(dd)`` by :func:`torch.autograd.grad` on a detached leaf
    copy of ``m0`` (a tensor or a BlockVector): every propagator's derived
    adjoint, which also runs through checkpointed segments, where
    ``torch.func.vjp`` refuses them (it does not take saved-tensor hooks). A block the output does not depend on gets
    zeros, as from ``torch.func.vjp``."""
    leaves, spec = pytree.tree_flatten(m0)
    with torch.enable_grad():
        xs = [t.detach().requires_grad_() for t in leaves]
        out = fn(pytree.tree_unflatten(xs, spec))
        grads = torch.autograd.grad(out, xs, grad_outputs=dd, allow_unused=True)
    return pytree.tree_unflatten([torch.zeros_like(x) if g is None else g
                                  for x, g in zip(xs, grads)], spec)


def _damp(n: int, width: int, strength: float, bottom_only: bool):
    """One axis of the cosine-taper sponge, float32 on the CPU (the sponge
    is made on the CPU and moved, so it is the same on every device)."""
    x = torch.arange(n)
    edge = (n - 1 - x) if bottom_only else torch.minimum(x, n - 1 - x)
    edge = edge.to(torch.float32)
    return torch.where(edge < width,
                       torch.exp(-strength * (width - edge) ** 2 / width),
                       torch.ones_like(edge))


def _sponge_factors(shape, width: int, strength: float = 0.015,
                    free_surface: bool = False):
    """The per-axis factors of :func:`_sponge`, in broadcastable shapes.
    With ``free_surface`` the top of axis 0 is left undamped."""
    nd = len(shape)
    return tuple(
        _damp(n, width, strength, free_surface and ax == 0).reshape(
            tuple(n if i == ax else 1 for i in range(nd)))
        for ax, n in enumerate(shape))


def _sponge(shape, width: int, strength: float = 0.015, free_surface: bool = False):
    """The full-grid sponge: ``((1·d0)·d1)·…`` as the JAX package builds it."""
    prof = torch.ones(shape, dtype=torch.float32)
    for d in _sponge_factors(shape, width, strength, free_surface):
        prof = prof * d
    return prof


def _make_sponge(shape, width: int, strength: float = 0.015,
                 free_surface: bool = False, dtype=torch.float32):
    """A tuple of per-axis factors for 3-D+ grids, a full-grid tensor for
    1-/2-D grids (the representations of the JAX package)."""
    if len(shape) >= 3:
        return tuple(f.to(dtype) for f in _sponge_factors(shape, width, strength,
                                                          free_surface))
    return _sponge(shape, width, strength, free_surface).to(dtype)


def _sponge_full(sponge):
    """The full-grid sponge from either representation: the factor product
    ``(s0·s1)·s2`` (the JAX package's ``_mul_sponge`` tree) is bit-identical
    to the full array, so the plain steps build it once and multiply each
    step by it (``e·S``)."""
    if isinstance(sponge, tuple):
        s = sponge[0]
        for p in sponge[1:]:
            s = s * p
        return s
    return sponge


def _ricker(nt: int, dt: float, freq: float, dtype=torch.float32):
    t0 = min(1.0 / freq, 0.25 * nt * dt)
    t = torch.arange(nt, dtype=dtype) * dt - t0
    a = (math.pi * freq * t) ** 2
    return ((1 - 2 * a) * torch.exp(-a)).to(dtype)


def _trace_resampler(nt: int, dt: float, dtrec, dtype=torch.float32):
    """``(ntrec, resample)``: linear interpolation of ``(nt, ...)`` traces
    on the modelling grid onto the recording interval ``dtrec`` (``None``:
    the identity, ``resample`` is None)."""
    if dtrec is None:
        return nt, None
    dtrec = float(dtrec)
    if dtrec < dt - 1e-12:
        raise ValueError(f"dtrec={dtrec} must be >= modeling dt={dt}")
    ntrec = int(np.floor((nt - 1) * dt / dtrec + 1e-9)) + 1
    t = np.arange(ntrec) * (dtrec / dt)
    i0 = np.minimum(np.floor(t).astype(np.int64), max(nt - 2, 0))
    i1 = np.minimum(i0 + 1, nt - 1)
    w = torch.as_tensor(t - i0).to(dtype)
    i0, i1 = torch.as_tensor(i0), torch.as_tensor(i1)

    def resample(traces):
        dev = traces.device
        wb = w.to(dev).reshape((ntrec,) + (1,) * (traces.ndim - 1))
        lo = traces.index_select(0, i0.to(dev))
        hi = traces.index_select(0, i1.to(dev))
        return (1.0 - wb) * lo + wb * hi

    return ntrec, resample


def _resample_transpose(resample, shape, dtype):
    """The adjoint of ``resample`` on ``shape`` traces (``torch.func.vjp``
    at zero traces)."""
    def rt(d):
        zeros = torch.zeros(shape, dtype=dtype, device=d.device)
        _, vjp = torch.func.vjp(resample, zeros)
        (out,) = vjp(d)
        return out

    return rt


def _c2dt2(c, dt: float, dx: float):
    """``(c*c) * (dt*dt) / (dx*dx)``, rounded as the JAX package rounds it."""
    return true_div((c * c) * (dt * dt), dx * dx)


def _store_codec(store: str, dtype, mesh=None, axes=None):
    """Per-snapshot ``(enc, dec)`` of the stored-wavefield adjoint: ``f32``
    lossless, ``bf16`` 2× smaller, ``int8`` max-abs-scaled 4× smaller.
    ``enc(u) -> (encoded, scale)``; ``dec(encoded, scale)`` inverts it.
    The int8 code is ``round(u·(127/s))`` (half to even, as ``jnp.round``)
    with ``s = max(max|u|, 1e-30)``; with ``mesh`` (``u`` a rank's slab of a
    grid split over the mesh ``axes``) the max is over the whole grid, one
    MAX ``all_reduce`` over those axes per snapshot, so the stored bytes are
    those of the unsharded grid. Each ``enc`` call is a span
    ``codec.encode`` and counts one in ``snapshots.encoded`` and its code's
    and scale's bytes in ``history.bytes`` (a vmapped batch's: the whole
    batch, once)."""
    if store == "f32":
        code, dec = ((lambda u: (u, torch.ones((), dtype=dtype, device=u.device))),
                     (lambda q, s: q))
    elif store == "bf16":
        code, dec = ((lambda u: (u.to(torch.bfloat16),
                                 torch.ones((), dtype=dtype, device=u.device))),
                     (lambda q, s: q.to(dtype)))
    elif store == "int8":
        def code(u):
            amax = torch.linalg.vector_norm(u, float("inf"))  # max|u|
            if mesh is not None:
                amax = max_replicated(amax, mesh, axes)
            s = torch.maximum(amax, torch.tensor(1e-30, dtype=dtype, device=u.device))
            return torch.round(u * (torch.full_like(s, 127.0) / s)).to(torch.int8), s

        def dec(q, s):
            return q.to(dtype) * true_div(s, 127.0)
    else:
        raise ValueError(f"store must be one of {_STORES}, got {store!r}")

    def enc(u):
        with span("codec.encode"):
            q, s = code(u)
        count("snapshots.encoded")
        count("history.bytes", _stored_bytes(q) + _stored_bytes(s))
        return q, s

    return enc, dec


def _stored_bytes(t) -> int:
    """The bytes ``t`` holds on its device; inside ``torch.func.vmap``, those
    of the whole batch."""
    while torch._C._functorch.is_batchedtensor(t):
        t = torch._C._functorch.get_unwrapped(t)
    return t.numel() * t.element_size()


_ON_GRID_ONLY = ("fused wave step requires a 2-D or 3-D float32 grid with the default "
                 "on-grid source and receivers")


def _kernel_route(fused, c, sponge, order: int, refuse: Optional[str] = None,
                  pair2d: bool = False) -> bool:
    """Whether the time loop rides the kernels: ``fused=None`` takes them
    for a 3-D float32 grid on a CUDA card; ``fused=True`` insists (on a CPU
    tensor the wrappers then run their plain versions) and raises where the
    kernels cannot go, as the JAX package does. ``refuse`` names what the
    call asks that no kernel computes (a custom source mask, extractor or
    injector; static-Q friction): it turns the route off, and ``fused=True``
    raises it. ``pair2d``: the caller (the isotropic sweeps) also has the
    batched 2-D pair K4-2D/K5-2D, for a 2-D float32 grid with its full-grid
    sponge; every other physics leaves it False, so a 2-D grid never reaches
    a 3-D kernel."""
    if pair2d and len(c.shape) == 2:
        can = refuse is None and torch.is_tensor(sponge) and cuda_wave.fits_wave2d_kernel(
            c.shape, c.dtype, order)
    else:
        can = refuse is None and isinstance(sponge, tuple) and cuda_wave.fits_wave_kernel(
            c.shape, c.dtype, order)
    if fused is None:
        return can and c.device.type == "cuda"
    if fused and not can:
        raise ValueError(refuse or _ON_GRID_ONLY)
    return bool(fused)


def _factors_1d(sponge):
    return tuple(f.reshape(-1).contiguous() for f in sponge)


def _on_device(src_idx, dev):
    """A source index as an int64 tensor on ``dev``, made once a sweep; a
    vmapped batch's indices already are."""
    return torch.as_tensor(src_idx).to(device=dev, dtype=torch.int64)


class _LeapfrogStep(torch.autograd.Function):
    """K4 under autodiff (the counterpart of the ``custom_jvp`` around the
    Pallas step in ``jets_tpu/ops/wave.py``): the forward is the kernel,
    writing a fresh tensor; the tangent is the plain expression
    ``S⊙(2du − dup + dc2·L(u) + c2·L(du)) + dst·mask`` and the backward its
    transpose, both plain PyTorch (the JAX package has no backward kernel
    for K4 either)."""

    @staticmethod
    def forward(u_prev, u, c2, s_t, spz, sy, sx, src, amp, order):
        return cuda_wave.fused_leapfrog_step(u_prev, u, c2, spz, sy, sx, s_t, src,
                                             amp, order=order)

    @staticmethod
    def setup_context(ctx, inputs, output):
        _, u, c2, _, spz, sy, sx, src, amp, order = inputs
        ctx.save_for_backward(u, c2, spz, sy, sx, amp)
        ctx.save_for_forward(u, c2, spz, sy, sx, amp)
        ctx.src, ctx.order = src, order

    @staticmethod
    def jvp(ctx, dup, du, dc2, dst, *_):
        u, c2, spz, sy, sx, amp = ctx.saved_tensors
        zero = torch.zeros_like(u)
        dup = zero if dup is None else dup
        du = zero if du is None else du
        dc2 = zero if dc2 is None else dc2
        t = (2.0 * du - dup + dc2 * _laplacian(u, order=ctx.order)
             + c2 * _laplacian(du, order=ctx.order))
        out = t * cuda_wave.sponge_product(spz, sy, sx)
        if dst is not None:
            out = out + dst * cuda_wave.source_mask(u.shape, ctx.src, amp)
        return out

    @staticmethod
    def backward(ctx, g):
        u, c2, spz, sy, sx, amp = ctx.saved_tensors
        gs = g * cuda_wave.sponge_product(spz, sy, sx)
        d_up = -gs
        d_u = 2.0 * gs + _laplacian(c2 * gs, order=ctx.order)
        d_c2 = _laplacian(u, order=ctx.order) * gs
        d_st = torch.sum(g * cuda_wave.source_mask(u.shape, ctx.src, amp))
        return d_up, d_u, d_c2, d_st, None, None, None, None, None, None


def _gather(u, idx, vmapped: bool):
    """The flat entries ``idx`` of ``u``: ``index_select``, or under
    ``torch.func.vmap`` indexing, since ``index_select`` batches as a
    ``gather``, which saves the whole field for its backward (one more grid
    per shot and step on the tape) where indexing saves the index only."""
    return u.reshape(-1)[idx] if vmapped else u.reshape(-1).index_select(0, idx)


def _field_loop(step, nfields: int, shape, dtype, dev, src_wavelet, rcv_idx,
                inplace: bool, remat_blocks: int, tape: bool, extract=None, params=(),
                consts=(), vmapped: bool = False):
    """The traces of the first field of ``step(prev_0, cur_0, prev_1, cur_1,
    ..., s_t, *params, *consts) -> next_0`` (or a tuple ``(next_0, next_1,
    ...)`` of ``nfields`` fields) run from zero fields, each field's pair
    rotating ``(prev, cur) -> (cur, next)``: in place when ``inplace``
    (``step`` then may write each ``next`` into its ``prev``'s buffer), else
    through :func:`_time_loop` (``params``, ``consts`` and ``vmapped`` as it
    takes them). Each step's trace is the field gathered at the flat
    indices ``rcv_idx`` (in place: into a preallocated trace tensor) or, with
    ``extract``, ``extract(field)`` of any shape. The loop is a span
    ``sweep.forward`` and counts its steps in ``steps.forward`` (a vmapped
    batch's step once)."""
    def advance(carry, nxt):
        nxt = (nxt,) if torch.is_tensor(nxt) else tuple(nxt)
        return tuple(x for i, n in enumerate(nxt) for x in (carry[2 * i + 1], n)), nxt[0]

    def record(u):
        return _gather(u, rcv_idx, vmapped) if extract is None else extract(u)

    nt = int(src_wavelet.shape[0])
    count("steps.forward", nt)
    with span("sweep.forward"):
        carry = tuple(torch.zeros(shape, dtype=dtype, device=dev) for _ in range(2 * nfields))
        if not inplace:
            def body(carry, s_t, params, consts):
                carry, first = advance(carry, step(*carry, s_t, *params, *consts))
                return carry, record(first)

            return _time_loop(body, carry, src_wavelet, remat_blocks, tape, params, consts,
                              vmapped)
        _remat_segments(nt, remat_blocks)  # the same warning on every path
        traces = (None if extract is not None
                  else torch.empty((nt, int(rcv_idx.shape[0])), dtype=dtype, device=dev))
        recs = []
        for k in range(nt):
            carry, first = advance(carry, step(*carry, src_wavelet[k], *params, *consts))
            if traces is None:  # custom extractors run on the plain steps' fresh fields
                recs.append(extract(first))
            else:
                torch.index_select(first.reshape(-1), 0, rcv_idx, out=traces[k])
        return torch.stack(recs) if traces is None else traces


def _propagate(c, src_wavelet, src_idx, rcv_idx, *, dt, dx, sponge,
               remat_blocks: int = 1, order: int = 2, src_mask=None, extract=None,
               fused=None, wavefield_sharding=None, inplace: bool = False,
               vmap_tape: Optional[bool] = None):
    """Leapfrog time stepping; returns receiver traces ``(nt, nrcv)``.

    ``fused`` selects the kernel route (see :func:`_kernel_route`): K4 on a
    3-D grid, K4-2D (batched under the ``"vmap"`` stacks) on a 2-D one,
    which has no backward: while a tape records ``c`` the 2-D step is the
    plain one. ``inplace=True`` allows the no-autodiff fast path: ``u_next`` written
    into ``u_prev``'s buffer and the traces gathered into a preallocated
    tensor. It is ignored while a tape records ``c``; callers inside a
    ``torch.func`` transform (or ``vmap``) pass ``inplace=False``.
    ``remat_blocks`` checkpoints the loop in segments under a tape
    (:func:`_time_loop`). ``src_mask`` (a full-grid injection mask, ``dt²``
    included) and ``extract`` (``u -> trace``) replace the on-grid point
    source and the receiver gather (the off-grid geometry of
    :func:`offgrid_wave_propagator`); either one takes the plain step, as no
    kernel takes them. ``vmap_tape`` is set by the ``"vmap"`` shot stacks
    (:func:`_multishot_operator`): whether a tape records the stacked model,
    which a batched tensor inside ``torch.func.vmap`` does not show; the
    loop's segments then run as :class:`_Segment`.
    """
    if wavefield_sharding is not None:
        return _propagate_sharded(c, src_wavelet, src_idx, rcv_idx, dt=dt, dx=dx,
                                  sponge=sponge, remat_blocks=remat_blocks, order=order,
                                  fused=fused, ws=wavefield_sharding, inplace=inplace)
    shape, dtype, dev = c.shape, c.dtype, c.device
    c2dt2 = _c2dt2(c, dt, dx)
    amp = torch.tensor(dt * dt, dtype=dtype, device=dev)
    custom = src_mask is not None or extract is not None
    kernel = _kernel_route(fused, c, sponge, order, _ON_GRID_ONLY if custom else None,
                           pair2d=True)
    tape = _records(c) if vmap_tape is None else vmap_tape
    inplace = inplace and not tape
    params = consts = ()

    if kernel and len(shape) == 2:  # the 2-D pair has no backward
        kernel = not (tape or _records_within(c))
    if kernel and len(shape) == 2:
        step2d = cuda_wave.leapfrog2d_stepper(c2dt2, sponge, _on_device(src_idx, dev), amp,
                                              order=order)

        def step(up, uu, s_t):
            return step2d(up, uu, s_t, out=up if inplace else None)
    elif kernel:
        spz, sy, sx = _factors_1d(sponge)
        src = int(src_idx)
        if inplace:
            def step(up, uu, s_t):
                return cuda_wave.fused_leapfrog_step(up, uu, c2dt2, spz, sy, sx, s_t,
                                                     src, amp, order=order, out=up)
        else:
            def step(up, uu, s_t):
                return _LeapfrogStep.apply(up, uu, c2dt2, s_t, spz, sy, sx, src, amp,
                                           order)
    else:
        S = _sponge_full(sponge)
        mask = cuda_wave.source_mask(shape, src_idx, amp) if src_mask is None else src_mask

        def step(up, uu, s_t, c2, S, mask):
            return cuda_wave.leapfrog_plain(up, uu, c2, S, s_t, mask, order)

        params, consts = (c2dt2,), (S, mask)
    return _field_loop(step, 1, shape, dtype, dev, src_wavelet, rcv_idx, inplace,
                       remat_blocks, tape, extract, params, consts, vmap_tape is not None)


def _zonly_axis(ws):
    """The mesh axis name when ``ws`` shards axis 0 ONLY, over one mesh axis
    (the z-slab layout K4 takes), else None."""
    spec = tuple(ws.spec)
    if not spec or spec[0] is None or isinstance(spec[0], tuple):
        return None
    if any(sp is not None for sp in spec[1:]):
        return None
    return spec[0] if spec[0] in ws.mesh.shape else None


def _check_wavefield_sharding(ws, shape, order: int):
    """``ws``'s mesh, or a ``ValueError`` naming ``wavefield_sharding`` for
    what the sharded propagators cannot take: a spec with more entries than
    the grid has dimensions or with names the mesh lacks, a slab count that
    does not divide its dimension, a slab thinner than the stencil's halo."""
    if not (hasattr(ws, "mesh") and hasattr(ws, "spec")):
        raise ValueError("wavefield_sharding must be a parallel.sharded.BlockSharding"
                         f"(mesh, spec), got {type(ws).__name__}")
    spec, hw = tuple(ws.spec), order // 2
    if len(spec) > len(shape):
        raise ValueError(f"wavefield_sharding spec {spec} has more entries than the grid "
                         f"{tuple(shape)} has dimensions")
    try:
        ws.axes
    except ValueError as e:
        raise ValueError(f"wavefield_sharding: {e}") from None
    for d, e in enumerate(spec):
        if e is None:
            continue
        n = ws.mesh.axis_size(e)
        if shape[d] % n:
            raise ValueError(f"wavefield_sharding: {n} slabs do not divide dimension {d} "
                             f"= {shape[d]}")
        if shape[d] // n < hw:
            raise ValueError(f"wavefield_sharding: slabs of {shape[d] // n} planes of "
                             f"dimension {d} are thinner than the order-{order} halo of "
                             f"{hw}")
    return ws.mesh


def fits_fused_sharded(shape, dtype, order: int, ws) -> bool:
    """True when the sharded isotropic propagator can ride K4: a 3-D float32
    grid, a z-only sharding over one mesh axis whose slab count divides D,
    slabs no thinner than the halo, and a halo-extended slab
    ``(D/n + 2·hw, H, W)`` K4 takes. Every other sharding takes the plain
    step, as the JAX package's GSPMD route does."""
    try:
        mesh = _check_wavefield_sharding(ws, shape, order)
    except ValueError:
        return False
    ax = _zonly_axis(ws)
    if ax is None or len(shape) != 3:
        return False
    D, H, W = shape
    return cuda_wave.fits_wave_kernel((D // mesh.shape[ax] + order, H, W), dtype, order)


class _Slab:
    """One rank's part of a grid split by ``wavefield_sharding`` (any
    dimensions, each over a mesh axis or a tuple of them): the local and
    halo-extended shapes, the source index in the extended slab (−1 off this
    rank: nothing is injected), the receivers this rank holds, the sponge
    and a source mask on the extended slab, and the moves between the slab
    and its extension. ``ext`` exchanges the ``hw = order/2`` boundary
    planes of one sharded dimension after another, each on the array the
    previous one extended, so the planes of a later dimension carry the
    corners the mixed-derivative taps read; ``pad`` zero-extends what a step
    reads only pointwise (its halo outputs are discarded)."""

    def __init__(self, gshape, dtype, dev, src_idx, rcv_idx, *, sponge, order, ws):
        mesh = ws.mesh
        self.mesh, self.hw, self.gshape = mesh, order // 2, tuple(gshape)
        self.axes, self.zonly = ws.axes, _zonly_axis(ws) is not None
        self.slices = local_slices(self.gshape, mesh, ws.spec)
        self.dims = [d for d, e in enumerate(ws.spec) if e is not None]
        self.axis_of = {d: ws.spec[d] for d in self.dims}
        self.lshape = tuple(s.stop - s.start for s in self.slices)
        hw = self.hw
        self.eshape = tuple(n + 2 * hw if d in self.dims else n
                            for d, n in enumerate(self.lshape))
        lo = [s.start for s in self.slices]
        sc = np.unravel_index(int(src_idx), self.gshape)
        if all(self.slices[d].start <= sc[d] < self.slices[d].stop for d in self.dims):
            ext = [c - lo[d] + (hw if d in self.dims else 0) for d, c in enumerate(sc)]
            self.src = int(np.ravel_multi_index(ext, self.eshape))
        else:
            self.src = -1
        own = torch.ones(rcv_idx.shape, dtype=torch.bool, device=rcv_idx.device)
        loc = torch.zeros_like(rcv_idx)
        rest = rcv_idx
        for d in reversed(range(len(self.gshape))):
            cd = rest % self.gshape[d]
            rest = torch.div(rest, self.gshape[d], rounding_mode="floor")
            s = self.slices[d]
            own &= (cd >= s.start) & (cd < s.stop)
            loc = loc + (cd - s.start) * math.prod(self.lshape[d + 1:])
        self.r_in = own.to(dtype)
        self.r_loc = torch.where(own, loc, 0)
        self.own_loc, self.own = self.r_loc[own], own
        if sponge is None:  # a boundary of its own (CPML)
            return
        if isinstance(sponge, tuple):  # per-axis factors, each sliced and edge-extended
            self.sponge = tuple(self._ext_factor(f, d) for d, f in enumerate(sponge))
        else:
            self.sponge = self.pad(sponge[self.slices])
        self.S = _sponge_full(self.sponge)

    def _ext_factor(self, f, d):
        """Sponge factor ``d`` sliced to the slab, its end values repeated
        over the halo of a sharded dimension."""
        f = f.narrow(d, self.slices[d].start, self.lshape[d])
        if d not in self.dims:
            return f
        edge = list(f.shape)
        edge[d] = self.hw
        return torch.cat([f.narrow(d, 0, 1).expand(edge), f,
                          f.narrow(d, self.lshape[d] - 1, 1).expand(edge)], d)

    def mask(self, amp):
        return cuda_wave.source_mask(self.eshape, self.src, amp)

    def narrow(self, f, d):
        """``f``'s part on the rank's slab along dimension ``d`` (a full
        grid array or a profile broadcast along the others)."""
        if f.shape[d] == 1 or d not in self.dims:
            return f
        return f.narrow(d, self.slices[d].start, self.lshape[d])

    def along(self, fn, u, d):
        """``fn(u)`` of a stencil ``fn`` along dimension ``d`` only: ``u``'s
        halo exchanged along ``d`` where it is split over several ranks, the
        interior kept (``fn`` itself zero-pads, so with one rank along ``d``
        it runs on ``u`` as the unsharded step does, autograd graph and all)."""
        if d not in self.dims or self.mesh.axis_size(self.axis_of[d]) == 1:
            return fn(u)
        return fn(halo_exchange(u, self.hw, self.mesh, d, self.axis_of[d])).narrow(
            d, self.hw, self.lshape[d])

    def local(self, x):
        """The rank's slab of a global grid array."""
        return x[self.slices]

    def pad(self, u):
        widths = []
        for d in reversed(range(u.ndim)):
            widths += [self.hw, self.hw] if d in self.dims else [0, 0]
        return torch.nn.functional.pad(u, widths)

    def interior(self, u_ext):
        return u_ext[tuple(slice(self.hw, self.hw + n) if d in self.dims else slice(None)
                           for d, n in enumerate(self.lshape))]

    def ext(self, u):
        for d in self.dims:
            u = halo_exchange(u, self.hw, self.mesh, d, self.axis_of[d])
        return u

    def apply(self, fn, u):
        """``fn(u)`` of a stencil ``fn`` on the rank's slab, the neighbours'
        planes exchanged."""
        return self.interior(fn(self.ext(u)))

    def extract(self, u):
        """The rank's receivers of ``u`` (zeros at the others')."""
        return u.reshape(-1)[self.r_loc] * self.r_in

    def inject(self, row):
        """The transpose of :meth:`extract`."""
        return torch.zeros(math.prod(self.lshape), dtype=row.dtype,
                           device=row.device).index_add(
            0, self.own_loc, row[self.own]).reshape(self.lshape)

    def sum(self, traces):
        """The traces of every rank's receivers, the same on every rank of
        the wavefield's mesh axes (each receiver lives on one rank, so
        adding the others' zeros is exact)."""
        return sum_replicated(traces, self.mesh, self.axes)

    def codec(self, store, dtype):
        return _store_codec(store, dtype, self.mesh, self.axes)


def _propagate_sharded(c, src_wavelet, src_idx, rcv_idx, *, dt, dx, sponge, remat_blocks,
                       order, fused, ws, inplace):
    """The isotropic leapfrog on a sharded grid (the counterpart of the JAX
    package's ``_propagate_fused_sharded`` on K4 and of its GSPMD partition
    of the plain step): each rank holds its slab of ``c``; every step the
    ``hw`` boundary planes of ``u`` travel to the neighbours of each sharded
    dimension (:meth:`_Slab.ext`; the edges receive zeros, the global zero
    boundary), the step runs on the halo-extended slab and the interior is
    kept. Each rank gathers the receivers it holds for the whole ``(nt,
    nrcv)`` trace, zeros elsewhere, and one :func:`sum_replicated` over the
    wavefield's mesh axes at the end assembles it. K4 takes the step of a
    z-only 3-D float32 slab (:func:`fits_fused_sharded`); its tangent and
    adjoint follow :class:`_LeapfrogStep`'s plain rules composed with the
    exchange's."""
    sl = _slab_of(c, src_idx, rcv_idx, sponge, order, ws)
    step = _iso_slab_step(sl, c, dt, dx, order, fused)
    tape = _records(c)
    traces = _field_loop(step, 1, c.shape, c.dtype, c.device, src_wavelet, rcv_idx,
                         inplace and not tape, remat_blocks, tape, sl.extract)
    return sl.sum(traces)


def _global_shape(c, ws):
    """The global grid shape of which ``c`` is a rank's slab under ``ws``."""
    return tuple(n * (ws.mesh.axis_size(ws.spec[d]) if d < len(ws.spec)
                      and ws.spec[d] is not None else 1) for d, n in enumerate(c.shape))


def _iso_slab_step(sl, c, dt, dx, order, fused):
    """``step(u_prev, u, s_t) -> u_next`` of the rank's slab: K4 where the
    sharding is z-only over one mesh axis (:func:`_zonly_axis`) and
    :func:`_kernel_route` takes the extended slab, else the plain step, each
    on the halo-extended slab."""
    c2_ext = sl.pad(_c2dt2(c, dt, dx))
    amp = torch.tensor(dt * dt, dtype=c.dtype, device=c.device)
    if sl.zonly and _kernel_route(fused, c2_ext, sl.sponge, order):
        factors = _factors_1d(sl.sponge)

        def step(up, u, s_t):
            return sl.interior(_LeapfrogStep.apply(sl.pad(up), sl.ext(u), c2_ext, s_t,
                                                   *factors, sl.src, amp, order))
    else:
        mask = sl.mask(amp)

        def step(up, u, s_t):
            return sl.interior(cuda_wave.leapfrog_plain(sl.pad(up), sl.ext(u), c2_ext,
                                                        sl.S, s_t, mask, order))
    return step


def _adjoint_stored_sharded(c, dd, src_wavelet, src_idx, rcv_idx, *, dt, dx, sponge,
                            order, store, fused, ws):
    """:func:`_adjoint_stored` on a sharded grid: the forward sweep is
    :func:`_propagate_sharded`'s step (K4 where it applies), storing each
    slab's snapshot with the global int8 scale (one MAX ``all_reduce`` over
    the wavefield's mesh axes per snapshot); the reverse sweep is the plain
    one on the slab, with ``L(u_k)`` and ``L(c²dt²·ē_k)`` taken over the
    halo-extended slab and the receiver rows injected where this rank holds
    them. Returns the rank's slab of the gradient."""
    dtype, dev, shape = c.dtype, c.device, c.shape
    sl = _slab_of(c, src_idx, rcv_idx, sponge, order, ws)
    step = _iso_slab_step(sl, c, dt, dx, order, fused)
    c2dt2 = _c2dt2(c, dt, dx)
    enc, dec = sl.codec(store, dtype)
    dd = dd.to(dtype)
    nt = int(src_wavelet.shape[0])
    hist = []
    count("steps.history", nt)
    with span("sweep.history"):
        u_prev = torch.zeros(shape, dtype=dtype, device=dev)
        u = torch.zeros(shape, dtype=dtype, device=dev)
        for k in range(nt):
            hist.append(enc(u))
            u_prev, u = u, step(u_prev, u, src_wavelet[k])
        del u_prev, u

    def lap(u):
        return sl.apply(lambda v: _laplacian(v, order=order), u)

    count("steps.reverse", nt)
    with span("sweep.reverse"):
        S = sl.interior(sl.S)
        dd_shift = torch.cat([torch.zeros_like(dd[:1]), dd[:-1]])
        a_next = sl.inject(dd[-1])
        ebar_next = torch.zeros(shape, dtype=dtype, device=dev)
        gc2 = torch.zeros(shape, dtype=dtype, device=dev)
        for k in range(nt - 1, -1, -1):
            q, s = hist[k]
            hist[k] = None
            ebar = a_next * S
            gc2 = gc2 + lap(dec(q, s)) * ebar
            a_next = ((2.0 * ebar + lap(c2dt2 * ebar)) - ebar_next + sl.inject(dd_shift[k]))
            ebar_next = ebar
    scale = torch.tensor((dt * dt) / (dx * dx), dtype=dtype, device=dev)
    return gc2 * (2.0 * c) * scale


def _adjoint_stored(c, dd, src_wavelet, src_idx, rcv_idx, *, dt, dx, sponge,
                    order: int = 2, store: str = "int8", fused=None,
                    wavefield_sharding=None, src_mask=None, inject=None):
    """Adjoint-state gradient ``(∂F/∂c)ᵀ dd`` over a stored forward-wavefield
    history, encoded per snapshot (``store``: f32 lossless, bf16, int8).
    With ``ē_k = S ⊙ a_{k+1}``::

        a_k  = Pᵀ ḡ_{k-1} + 2ē_k + L(c²dt²·ē_k) − ē_{k+1}
        gc2 += L(u_k) ⊙ ē_k

    On the kernel route the forward sweep is K4 (in place, except for an
    f32 history, which keeps the fields themselves) and the reverse sweep
    K5 (``a_k`` into ``a_{k+2}``'s buffer, ``gc2`` in place) followed by the
    receiver injection ``index_add_``; a 2-D grid runs K4-2D and K5-2D the
    same way (one launch a step for a vmapped batch, whose outputs are fresh
    tensors), where no tape records ``c`` or ``dd`` and no transform but
    one ``vmap`` watches. The plain route is the JAX package's
    XLA sweep, tree for tree. ``src_mask`` and ``inject`` (``trace row ->
    full-grid field``, the transpose of the forward's ``extract``) replace
    the on-grid source and the receiver scatter; either one takes the plain
    route. The forward sweep is a span ``sweep.history``, the reverse one a
    span ``sweep.reverse``, and each counts its steps (``steps.history``,
    ``steps.reverse``; a vmapped batch's step once)."""
    if wavefield_sharding is not None:
        return _adjoint_stored_sharded(c, dd, src_wavelet, src_idx, rcv_idx, dt=dt, dx=dx,
                                       sponge=sponge, order=order, store=store,
                                       fused=fused, ws=wavefield_sharding)
    custom = src_mask is not None or inject is not None
    shape, dtype, dev = c.shape, c.dtype, c.device
    size = math.prod(shape)
    nt = int(src_wavelet.shape[0])
    c2dt2 = _c2dt2(c, dt, dx)
    amp = torch.tensor(dt * dt, dtype=dtype, device=dev)
    enc, dec = _store_codec(store, dtype)
    dd = dd.to(dtype)

    if inject is None:
        def inject(row):
            return torch.zeros(size, dtype=dtype, device=dev).index_add(
                0, rcv_idx, row).reshape(shape)

    scale = torch.tensor((dt * dt) / (dx * dx), dtype=dtype, device=dev)
    hist, scales = [], []
    count("steps.history", nt)
    count("steps.reverse", nt)
    kernel = _kernel_route(fused, c, sponge, order, _ON_GRID_ONLY if custom else None,
                           pair2d=True)
    if kernel and len(shape) == 2:  # the 2-D pair has no backward and no tangent
        kernel = not _records_within(c, dd) and cuda_wave._lone_vmap_level() is not False
    if kernel:
        if len(shape) == 2:
            fwd = cuda_wave.leapfrog2d_stepper(c2dt2, sponge, _on_device(src_idx, dev), amp,
                                               order=order)
            rev = functools.partial(cuda_wave.adjoint2d_stepper(c2dt2, sponge, order=order),
                                    inplace=True)
        else:
            spz, sy, sx = _factors_1d(sponge)
            src = int(src_idx)

            def fwd(up, uu, s_t, out):
                return cuda_wave.fused_leapfrog_step(up, uu, c2dt2, spz, sy, sx, s_t, src,
                                                     amp, order=order, out=out)

            def rev(a1, a2, gc2, q, sc):
                return cuda_wave.fused_adjoint_step(a1, a2, gc2, c2dt2, q, sc, spz, sy, sx,
                                                    order=order, inplace=True)
        with span("sweep.history"):
            u_prev = torch.zeros(shape, dtype=dtype, device=dev)
            u = torch.zeros(shape, dtype=dtype, device=dev)
            for k in range(nt):
                q, s = enc(u)
                hist.append(q)
                scales.append(s)
                u_next = fwd(u_prev, u, src_wavelet[k], None if store == "f32" else u_prev)
                u_prev, u = u, u_next
            del u_prev, u, u_next  # the history holds what the reverse sweep needs
        with span("sweep.reverse"):
            scs = (true_div(torch.stack(scales), 127.0) if store == "int8"
                   else torch.ones(nt, dtype=dtype, device=dev))
            a1 = inject(dd[-1])
            a2 = torch.zeros(shape, dtype=dtype, device=dev)
            gc2 = torch.zeros(shape, dtype=dtype, device=dev)
            for k in range(nt - 1, -1, -1):
                core, gc2 = rev(a1, a2, gc2, hist[k], scs[k])
                hist[k] = None  # release the snapshot as the sweep passes it
                if k > 0:  # ḡ_{k-1}; the JAX sweep adds a zero row at k = 0
                    core.reshape(-1).index_add_(0, rcv_idx, dd[k - 1])
                a1, a2 = core, a1
        return gc2 * (2.0 * c) * scale

    S = _sponge_full(sponge)
    mask = cuda_wave.source_mask(shape, src_idx, amp) if src_mask is None else src_mask
    with span("sweep.history"):
        u_prev = torch.zeros(shape, dtype=dtype, device=dev)
        u = torch.zeros(shape, dtype=dtype, device=dev)
        for k in range(nt):
            hist.append(enc(u))  # history entry k holds u_k
            u_next = cuda_wave.leapfrog_plain(u_prev, u, c2dt2, S, src_wavelet[k], mask,
                                              order)
            u_prev, u = u, u_next
    with span("sweep.reverse"):
        # ḡ_{k-1} aligned to reverse step k (rec_k samples u_{k+1})
        dd_shift = torch.cat([torch.zeros_like(dd[:1]), dd[:-1]])
        a_next = inject(dd[-1])
        ebar_next = torch.zeros(shape, dtype=dtype, device=dev)
        gc2 = torch.zeros(shape, dtype=dtype, device=dev)
        for k in range(nt - 1, -1, -1):
            q, s = hist[k]
            hist[k] = None
            ebar = a_next * S
            gc2 = gc2 + _laplacian(dec(q, s), order=order) * ebar
            # sum order of the kernel's tree: the stencil/sponge core first, the
            # (sparse) receiver injection added last
            a_next = ((2.0 * ebar + _laplacian(c2dt2 * ebar, order=order)) - ebar_next
                      + inject(dd_shift[k]))
            ebar_next = ebar
    return gc2 * (2.0 * c) * scale


def _check_store(store_adjoint):
    if store_adjoint is not None and store_adjoint not in _STORES:
        raise ValueError("store_adjoint must be one of (None, 'f32', 'bf16', "
                         f"'int8'), got {store_adjoint!r}")


def _index_tensor(idx, device):
    return torch.as_tensor(np.array(idx), dtype=torch.int64).reshape(-1).to(device)


def _default_receivers(size: int):
    return torch.arange(0, size, max(1, size // 128))[:128]


def wave_propagator(
    grid_shape: Sequence[int],
    *,
    nt: int = 256,
    dt: float = 0.001,
    dx: float = 10.0,
    freq: float = 15.0,
    src_idx: int = 0,
    rcv_idx=None,
    sponge_width: int = 12,
    space_order: int = 2,
    remat_blocks: int = 1,
    free_surface: bool = False,
    fused=None,
    dtrec: Optional[float] = None,
    store_adjoint: Optional[str] = None,
    wavefield_sharding=None,
    dtype: torch.dtype = torch.float32,
    device: torch.device | str | None = None,
) -> Operator:
    """Nonlinear forward-modelling operator ``F: velocity c → traces d``.

    Domain: the velocity grid on ``device`` (``None``: the CUDA card).
    Range: ``(ntrec, nrcv)`` receiver traces (``ntrec = nt`` unless the
    recording interval ``dtrec`` is given). ``space_order`` ∈ {2, 4, 8}.
    ``fused``: ``None`` rides the kernels K4/K5 on a 3-D float32 grid on a
    CUDA card (K4-2D/K5-2D on a 2-D one), ``True`` insists, ``False`` takes
    the plain step. ``store_adjoint`` ∈ {None, "f32",
    "bf16", "int8"} switches the adjoint from autograd through the time
    loop (:func:`_vjp_by_autograd`) to the stored-history sweep
    (:func:`_adjoint_stored`).
    ``remat_blocks > 1`` checkpoints the time loop in that many segments
    under an autograd tape (the module docstring).

    ``wavefield_sharding=BlockSharding(mesh, spec)`` (``parallel.sharded``;
    ``block_sharding(mesh, axis)`` for z-slabs) splits the grid over the
    mesh's ranks, any dimensions over any axes (``P(None, "grid")``, the
    pencil ``P("block", "grid")``, ``P(("block", "grid"))``): the domain is a
    :class:`~jets_tpu_torch.parallel.sharded.ShardedSpace` whose members are
    the rank's slab, the traces are the same on every rank of the
    wavefield's axes, and the operator is built on the mesh's device
    (:func:`_propagate_sharded`, :func:`_adjoint_stored_sharded`). ``fused``
    then picks K4 on the halo-extended slab of a z-only sharding of a 3-D
    float32 grid (:func:`fits_fused_sharded`); every other sharding takes
    the plain step. Each split must divide its dimension into slabs no
    thinner than the halo (``ValueError``).
    """
    grid_shape = tuple(int(s) for s in grid_shape)
    space_order = _check_space_order(space_order)
    _check_store(store_adjoint)
    ws = wavefield_sharding
    if ws is not None:
        mesh = _check_wavefield_sharding(ws, grid_shape, space_order)
        if fused and not fits_fused_sharded(grid_shape, dtype, space_order, ws):
            raise ValueError("fused=True under wavefield_sharding needs a z-only sharding "
                             "of a float32 grid whose halo-extended slab K4 takes")
        sp = ShardedSpace(grid_shape, dtype, mesh, spec=ws.spec)
        prop = functools.partial(_propagate, wavefield_sharding=ws)
        adj = functools.partial(_adjoint_stored, wavefield_sharding=ws)
    else:
        if fused and not (cuda_wave.fits_wave_kernel(grid_shape, dtype, space_order)
                          or cuda_wave.fits_wave2d_kernel(grid_shape, dtype, space_order)):
            raise ValueError("fused wave step requires a 2-D or 3-D float32 grid")
        sp, prop, adj = Space(grid_shape, dtype, device), _propagate, _adjoint_stored
    return _single_shot_operator(
        sp, sp, prop, adj, nt=nt, dt=dt, dx=dx, freq=freq,
        src_idx=src_idx, rcv_idx=rcv_idx, dtrec=dtrec, store_adjoint=store_adjoint,
        fused=fused, order=space_order, remat_blocks=remat_blocks,
        boundary={"sponge": _make_sponge(grid_shape, sponge_width,
                                         free_surface=free_surface, dtype=dtype)})


def _sharded_grid(ws, grid_shape, dtype, order, fused, device):
    """The grid space of a two-field propagator: the rank's slab under a
    sharding, which the plain step only takes (``fused=True`` raises)."""
    if ws is None:
        return Space(grid_shape, dtype, device)
    mesh = _check_wavefield_sharding(ws, grid_shape, order)
    if fused:
        raise ValueError("wavefield_sharding rides the plain step; fused=True is "
                         "incompatible")
    return ShardedSpace(grid_shape, dtype, mesh, spec=ws.spec)


def _with_sharding(ws, propagate, adjoint):
    """``(propagate, adjoint)`` bound to ``wavefield_sharding=ws``."""
    if ws is None:
        return propagate, adjoint
    return (functools.partial(propagate, wavefield_sharding=ws),
            functools.partial(adjoint, wavefield_sharding=ws))


def _to_device(arrays, device):
    """A boundary array (a tensor or a tuple of per-axis tensors) on
    ``device``."""
    if isinstance(arrays, tuple):
        return tuple(f.to(device) for f in arrays)
    return arrays.to(device)


def _single_shot_operator(dom, gsp, propagate, adjoint, *, nt, dt, dx, freq, src_idx,
                          rcv_idx, boundary, dtrec, store_adjoint, fused, order,
                          remat_blocks=1):
    """The single-shot propagator of :func:`wave_propagator`,
    :func:`vti_wave_propagator` and the others on the model space ``dom``
    (grid space ``gsp``): ``propagate(m, wavelet, src, rcv, *, inplace,
    remat_blocks, **boundary, ...)`` runs the time loop, ``adjoint(m, dd,
    wavelet, src, rcv, *, store, **boundary, ...)`` the stored-history
    sweep. ``boundary`` names the boundary's arrays, kept in the state
    (``{"sponge": ...}``, or the CPML profiles, with a static-Q
    propagator's friction factors ``og``, ``ig`` beside them). The tangent is
    ``torch.func.jvp`` through the loop, the adjoint
    :func:`_vjp_by_autograd` through it or, with ``store_adjoint``, the
    stored sweep."""
    dtype = gsp.dtype
    rcv = _index_tensor(_default_receivers(gsp.size) if rcv_idx is None else rcv_idx,
                        gsp.device)
    nrcv = int(rcv.shape[0])
    ntrec, resample = _trace_resampler(nt, dt, dtrec, dtype)
    cfg = dict(dt=dt, dx=dx, order=order, fused=fused)

    def _forward(m, state, inplace):
        traces = propagate(m, state["wavelet"], state["src_idx"], state["rcv_idx"],
                           inplace=inplace, remat_blocks=remat_blocks,
                           **{k: state[k] for k in boundary}, **cfg)
        return resample(traces) if resample is not None else traces

    def _f(m, state):
        return _forward(m, state, True)

    def _df(dm, m0, state):
        _, tangent = torch.func.jvp(lambda m: _forward(m, state, False), (m0,), (dm,))
        return tangent

    if store_adjoint is None:
        def _dft(dd, m0, state):
            return _vjp_by_autograd(lambda m: _forward(m, state, False), m0, dd)
    else:
        rt = (_resample_transpose(resample, (nt, nrcv), dtype)
              if resample is not None else None)

        def _dft(dd, m0, state):
            if rt is not None:
                dd = rt(dd)
            return adjoint(m0, dd, state["wavelet"], state["src_idx"], state["rcv_idx"],
                           store=store_adjoint, **{k: state[k] for k in boundary}, **cfg)

    j = Jet(dom=dom, rng=Space((ntrec, nrcv), dtype, gsp.device), f=_f, df=_df,
            dft=_dft, state={
                "wavelet": _ricker(nt, dt, freq, dtype).to(gsp.device),
                **{k: _to_device(v, gsp.device) for k, v in boundary.items()},
                "src_idx": torch.tensor(int(src_idx), dtype=torch.int64),
                "rcv_idx": rcv,
            })
    return Operator(j)


def _windowing(grid_shape, window_shape, device, blocks=None):
    """``(take, place)`` of per-shot Ginsu windows of ``window_shape`` in a
    ``grid_shape`` model, each at a corner tensor (a row of ``window_corners``,
    batched under ``torch.func.vmap``): ``take(m, corner)`` gathers the
    window, ``place(g, corner)`` scatter-adds a window-shaped gradient into a
    zero full grid. Both index through flat offsets, so a corner needs no
    host read and ``vmap`` batches them. ``blocks=(dom, wdom)``, the model's
    :class:`BlockSpace` and the window's, makes both act block by block on a
    :class:`BlockVector` (the ``(c, Q)`` pair): ``take`` gives a member of
    ``wdom``, ``place`` one of ``dom``, the offsets made once a call. Each
    call is a span (``window.take``, ``window.place``) and counts one in
    ``windows.take`` or ``windows.place`` (a vmapped batch's call once, a
    BlockVector's once)."""
    size = math.prod(grid_shape)
    strides = torch.tensor([math.prod(grid_shape[i + 1:]) for i in range(len(grid_shape))],
                           device=device)
    base = torch.zeros((), dtype=torch.int64, device=device)
    for n, st in zip(window_shape, strides):
        base = base[..., None] + torch.arange(n, device=device) * st
    base = base.reshape(-1)

    def flat(corner):
        return base + torch.sum(corner * strides)

    def each(fn, x, i):
        return fn(x) if blocks is None else BlockVector([fn(b) for b in x.blocks], blocks[i])

    def take(m, corner):
        count("windows.take")
        with span("window.take"):
            idx = flat(corner)
            return each(lambda b: b.reshape(-1).index_select(0, idx).reshape(window_shape),
                        m, 1)

    def place(g, corner):
        count("windows.place")
        with span("window.place"):
            idx = flat(corner)
            return each(lambda b: torch.zeros(size, dtype=b.dtype, device=b.device).index_add(
                0, idx, b.reshape(-1)).reshape(grid_shape), g, 0)

    return take, place


def _sharded_windowing(dom, window_shape):
    """``(take, place)`` of :func:`_windowing` on a model whose leading
    dimension is split over a mesh axis (``dom``, a :class:`ShardedSpace`),
    at host corner rows: ``take`` pads the rank's planes of the window with
    zeros to the window's shape and sums it over the grid axis (each plane
    lives on one rank, so adding the others' zeros is exact), which gives
    every rank of the row the whole window; ``place`` keeps the rank's
    planes of a window-shaped gradient, zero elsewhere in its slab. Each
    shot then propagates unsharded in its window on its block rank, and
    ``take``'s backward (the sum's is the identity) returns each owner its
    planes of the window's gradient. What moves is one window per shot, not
    the model. Spans and counters as :func:`_windowing`'s."""
    z0, Dl = dom.slices[0].start, dom.local_shape[0]
    rest_shape = tuple(window_shape[1:])

    def planes(corner):
        cz = int(corner[0])
        lo, hi = max(cz, z0), min(cz + window_shape[0], z0 + Dl)
        return (lo, hi) if hi > lo else (cz, cz)

    def pad(x, widths):
        return torch.nn.functional.pad(x, [w for pair in reversed(widths) for w in pair])

    def take(m, corner):
        count("windows.take")
        with span("window.take"):
            cz, (lo, hi) = int(corner[0]), planes(corner)
            rest = tuple(slice(int(c), int(c) + n) for c, n in zip(corner[1:], rest_shape))
            part = m[(slice(lo - z0, hi - z0),) + rest]
            w = pad(part, [(lo - cz, cz + window_shape[0] - hi)] + [(0, 0)] * len(rest))
            return sum_replicated(w, dom.mesh, dom.axes)

    def place(g, corner):
        count("windows.place")
        with span("window.place"):
            cz, (lo, hi) = int(corner[0]), planes(corner)
            if hi == lo:  # the window misses this rank's planes
                return g.new_zeros(dom.local_shape)
            widths = [(lo - z0, z0 + Dl - hi)] + [
                (int(c), n - int(c) - k) for c, k, n in zip(corner[1:], rest_shape,
                                                            dom.local_shape[1:])]
            return pad(g[lo - cz:hi - cz], widths)

    return take, place


def _multishot_grid(grid_shape, dtype, mesh, axis, device, order):
    """The grid space of a multishot operator: on a 2-D mesh the rank's slab
    of the leading dimension over the grid axis (:func:`grid_axis`), else the
    whole grid on the mesh's device (or ``device`` without a mesh)."""
    gax = grid_axis(mesh, axis)
    if gax is None:
        return Space(grid_shape, dtype, device if mesh is None else mesh.device)
    ws = BlockSharding(mesh, (gax,))
    _check_wavefield_sharding(ws, grid_shape, order)
    return ShardedSpace(grid_shape, dtype, mesh, spec=ws.spec)


def _multishot_operator(dom, gsp, propagate, adjoint, src_indices, *, nt, dt, dx, freq,
                        rcv_idx, boundary, dtrec, store_adjoint, shot_map, order,
                        remat_blocks=1, windows=None, mesh=None, axis="block"):
    """The multi-shot propagator of :func:`multishot_wave_operator` and the
    VTI, TTI and Q ones (``propagate``/``adjoint``/``boundary`` as for
    :func:`_single_shot_operator`, ``gsp`` the grid each shot propagates
    on): the shots' source indices (and window corners) are the stacked
    block state, everything else is shared. ``shot_map="map"`` runs the
    shots one after another with ``fused=None`` (the kernels where they
    apply), each shot's derived adjoint by :func:`_vjp_by_autograd`;
    ``"vmap"`` runs them as one ``torch.func.vmap`` of the plain step (the
    3-D kernels do not batch; a 2-D stack passes ``fused=None``, on which
    the isotropic sweeps take the batched pair K4-2D/K5-2D and every other
    physics' :func:`_kernel_route` stays plain), its derived adjoint
    :func:`_vjp_by_autograd` of the whole vmapped forward.
    While a tape records the model (which a batched tensor does not show, so
    the stack tells each shot's loop through ``vmap_tape``), the vmap stack
    hands every shot its own expanded copy of the model: a coefficient's
    gradient then sums each shot's steps, then the shots, both in the
    straight loop and in the :class:`_Segment` segments of
    ``remat_blocks > 1``, which therefore give the same bits.
    ``windows=(window_shape, corners)`` runs each shot in its window of the
    model (:func:`_windowing`; of each block of a :class:`BlockSpace`
    model). ``mesh``/``axis`` shard the shots over a
    mesh's ranks: each rank runs its slab of shots as above, and their
    contributions to the adjoint meet in one ``all_reduce`` over ``axis``
    (:func:`stacked_block_operator`). When ``dom`` is a rank's slab (a 2-D
    mesh: :func:`_multishot_grid`), the shots run one after another whatever
    ``shot_map`` says (collectives do not run inside ``torch.func.vmap``):
    without windows ``gsp`` is that slab and each shot's wavefields are
    sharded over the grid axis (``wavefield_sharding``, the sponge or the
    CPML boundary); with windows each shot gathers its window from the
    planes' owners and propagates it unsharded (:func:`_sharded_windowing`).
    The forward and the adjoint are spans (``multishot.f``,
    ``multishot.adjoint``), each shot of ``"map"`` mode a span ``shot`` with
    its ``index`` in the stack, and the forward counts the rank's
    shots in ``shots``."""
    dtype = gsp.dtype
    if isinstance(gsp, ShardedSpace):
        propagate, adjoint = _with_sharding(BlockSharding(gsp.mesh, gsp.spec), propagate,
                                            adjoint)
    sharded = isinstance(dom, ShardedSpace)  # windows on a split model
    if sharded or isinstance(gsp, ShardedSpace):
        shot_map = "map"
    src = _index_tensor(src_indices, "cpu")
    rcv = _index_tensor(_default_receivers(gsp.size) if rcv_idx is None else rcv_idx,
                        gsp.device)
    nrcv = int(rcv.shape[0])
    ntrec, resample = _trace_resampler(nt, dt, dtrec, dtype)
    rt = (_resample_transpose(resample, (nt, nrcv), dtype)
          if resample is not None else None)
    is_map = shot_map == "map"
    # a 2-D batch may ride the batched pair K4-2D/K5-2D (each physics' own route
    # decides: only the isotropic sweeps have it); the 3-D kernels do not batch
    cfg = dict(dt=dt, dx=dx, order=order,
               fused=None if is_map or len(gsp.shape) == 2 else False)
    bstate = {"src": src}
    take = place = None
    if windows is not None:
        if sharded:
            take, place = _sharded_windowing(dom, windows[0])
        elif isinstance(dom, BlockSpace):  # a window of each block
            take, place = _windowing(dom.spaces[0].shape, windows[0], gsp.device,
                                     (dom, BlockSpace([gsp] * dom.nblocks)))
        else:
            take, place = _windowing(dom.shape, windows[0], gsp.device)
        bstate["corner"] = _index_tensor(windows[1], "cpu" if sharded else gsp.device
                                         ).reshape(int(src.shape[0]), len(windows[0]))

    def local(m, corner):
        return m if take is None else take(m, corner)

    def shot_f(m, s, corner, st, inplace, **vmap_tape):
        traces = propagate(local(m, corner), st["wavelet"], s, st["rcv"], inplace=inplace,
                           remat_blocks=remat_blocks, **{k: st[k] for k in boundary},
                           **cfg, **vmap_tape)
        return resample(traces) if resample is not None else traces

    def per_shot(fn, bs, *stacked):
        """``fn(s, corner, *rows)`` of each shot: the one shot of ``bs`` in
        ``map`` mode, a ``vmap`` over the stack otherwise."""
        corners = bs.get("corner")
        if is_map:
            # bs holds rows b:b+1 of the stacked state (parallel.sharded._blocks),
            # so the offset of its source row is the shot's index b
            with span("shot", index=bs["src"].storage_offset()):
                return fn(bs["src"][0], None if corners is None else corners[0],
                          *(t[0] for t in stacked))
        src_b = bs["src"].to(gsp.device)  # the batched source index meets the grid
        if corners is None:
            return torch.func.vmap(lambda s, *r: fn(s, None, *r))(src_b, *stacked)
        return torch.func.vmap(fn)(src_b, corners, *stacked)

    def child(m, bs, inplace):
        if is_map:
            return per_shot(lambda s, cr: shot_f(m, s, cr, bs, inplace), bs)[None]
        leaves, spec = pytree.tree_flatten(m)
        tape = _records(*leaves)
        if tape:  # each shot its own copy of the model (see the docstring)
            n = int(bs["src"].shape[0])
            leaves = [t.expand(n, *t.shape) for t in leaves]

        def fn(s, cr, *ls):
            return shot_f(pytree.tree_unflatten(list(ls), spec), s, cr, bs, False,
                          vmap_tape=tape)

        corners = bs.get("corner")
        return torch.func.vmap(fn, in_dims=(0, None if corners is None else 0)
                               + (0 if tape else None,) * len(leaves))(
            bs["src"].to(gsp.device), corners, *leaves)

    def f(m, bs):
        return child(m, bs, True)

    def df(dm, m0, bs):
        _, tangent = torch.func.jvp(lambda m: child(m, bs, False), (m0,), (dm,))
        return tangent

    dft = stack_dft = None
    if store_adjoint is not None:
        def shot_dft(s, corner, d, m0, st):
            if rt is not None:
                d = rt(d)
            g = adjoint(local(m0, corner), d, st["wavelet"], s, st["rcv"],
                        store=store_adjoint, **{k: st[k] for k in boundary}, **cfg)
            return g if place is None else place(g, corner)

        def dft(d_b, m0, bs):
            out = per_shot(lambda s, cr, d: shot_dft(s, cr, d, m0, bs), bs, d_b)
            return tmap(lambda t: t[None], out) if is_map else out
    elif is_map:
        # the derived per-shot adjoint (through the checkpointed segments
        # when remat_blocks > 1)
        def dft(d_b, m0, bs):
            out = per_shot(lambda s, cr, d: _vjp_by_autograd(
                lambda m: shot_f(m, s, cr, bs, False), m0, d), bs, d_b)
            return tmap(lambda t: t[None], out)
    else:
        def stack_dft(dd, m0, bs):
            return _vjp_by_autograd(lambda m: child(m, bs, False), m0, dd)

    op = stacked_block_operator(
        nblocks=int(src.shape[0]),
        dom=dom,
        rng_block=Space((ntrec, nrcv), dtype, gsp.device),
        bstate=bstate,
        sstate={"wavelet": _ricker(nt, dt, freq, dtype).to(gsp.device),
                **{k: _to_device(v, gsp.device) for k, v in boundary.items()},
                "rcv": rcv},
        f=f,
        df=df,
        dft=dft,
        stack_dft=stack_dft,
        mesh=mesh,
        axis=axis,
        shot_map=shot_map,
    )

    def stack_f(m, state):
        count("shots", state["nblocks"])
        with span("multishot.f"):
            return op.jet.f(m, state)

    def stack_adjoint(dd, m0, state):
        with span("multishot.adjoint"):
            return op.jet.dft(dd, m0, state)

    return Operator(op.jet.replace(f=stack_f, dft=stack_adjoint))


def born_operator(F: Operator, c0) -> LinearOperator:
    """Linearized (Born) modelling operator: the Jacobian of the wave
    propagator pinned at the background velocity ``c0``. Forward =
    demigration, adjoint = migration."""
    return F.linearize(c0)


def _ginsu_windows(grid_shape, src_indices, window_shape, window_corners):
    """``(window_shape, corners)`` of a multishot operator's Ginsu windows,
    checked against the grid (a gather past it would fault or read another
    shot's model, so the corners are checked here, once), or None without
    windows."""
    if (window_shape is None) != (window_corners is None):
        raise ValueError("ginsu windowing needs BOTH window_shape and "
                         "window_corners (or neither)")
    if window_shape is None:
        return None
    nshots = int(np.asarray(src_indices).reshape(-1).shape[0])
    prop_shape = tuple(int(s) for s in window_shape)
    corners = np.asarray(window_corners, np.int64)
    if corners.shape != (nshots, len(grid_shape)):
        raise ValueError("window_corners must be (nshots, ndim) when window_shape "
                         "is given")
    out = (corners < 0).any(axis=1) | (corners + np.asarray(prop_shape)
                                       > np.asarray(grid_shape)).any(axis=1)
    if out.any():
        raise ValueError(f"ginsu window out of bounds for shots "
                         f"{np.nonzero(out)[0].tolist()}: need 0 <= corner and "
                         f"corner + {prop_shape} <= {grid_shape}")
    return prop_shape, corners


def multishot_wave_operator(
    grid_shape: Sequence[int],
    src_indices,
    *,
    nt: int = 128,
    dt: float = 0.001,
    dx: float = 10.0,
    freq: float = 15.0,
    rcv_idx=None,
    sponge_width: int = 12,
    space_order: int = 2,
    remat_blocks: int = 1,
    window_corners=None,
    window_shape: Optional[Sequence[int]] = None,
    dtrec: Optional[float] = None,
    store_adjoint: Optional[str] = None,
    free_surface: bool = False,
    boundary: str = "sponge",
    cmax: float = 4000.0,
    mesh=None,
    axis: str = "block",
    shot_map: str = "vmap",
    dtype: torch.dtype = torch.float32,
    device: torch.device | str | None = None,
) -> Operator:
    """Nonlinear multi-shot modelling ``F: c → (nshots, ntrec, nrcv)``.

    Per-shot state is the source location; receivers are shared. With
    ``shot_map="map"`` the shots run one after another, each on the
    kernels K4/K5 where they apply; with ``"vmap"`` the shots run as one
    batched program (``torch.func.vmap``): on a 2-D float32 grid on the
    card its steps are the batched pair K4-2D/K5-2D, one launch a step for
    the batch; a 3-D batch runs plain (the 3-D kernels do not batch).
    ``store_adjoint`` switches the per-shot adjoint to the stored-history
    sweep, summed over shots; without it the adjoint is derived: per shot
    (:func:`_vjp_by_autograd` of the shot) in ``map`` mode, over the whole
    vmapped stack in ``vmap`` mode. ``remat_blocks`` segments the time loop
    in both modes (see the module docstring).

    **Ginsu windows** (per-shot model subsetting): ``window_shape`` (one
    shape for every shot) and ``window_corners`` ``(nshots, ndim)``; each
    shot then propagates only inside ``c[corner : corner + window_shape]``
    (on the kernels, in ``map`` mode, where the window's shape takes
    them), and ``src_indices``/``rcv_idx`` are window-relative flat
    indices. The stored-history adjoint scatter-adds each window's gradient
    into a zero full grid, the derived one gets the same scatter from
    autodiff of the gather, so overlapping windows accumulate exactly.

    **Boundaries**: ``free_surface=True`` leaves the top edge of axis 0
    undamped (a pressure-release surface); ``boundary="cpml"`` swaps the
    sponge for the convolutional PML of :func:`cpml_wave_propagator` (width
    ``sponge_width``, ``cmax`` scaling its damping). CPML shots run plain
    with the derived adjoint: ``store_adjoint`` and windows compose with the
    sponge only.

    **Mesh**: ``mesh``/``axis`` shard the shots over a
    :class:`~jets_tpu_torch.parallel.sharded.BlockMesh` (its size must divide
    the shot count); the operator is built on the mesh's device, the data
    are each rank's slab of shots and the adjoint all-reduces once. On a
    2-D mesh the model's leading dimension splits over the grid axis too,
    with either boundary and with windows.
    """
    grid_shape = tuple(int(s) for s in grid_shape)
    space_order = _check_space_order(space_order)
    _check_store(store_adjoint)
    windows = _ginsu_windows(grid_shape, src_indices, window_shape, window_corners)
    prop_shape = grid_shape if windows is None else windows[0]
    if boundary not in ("sponge", "cpml"):
        raise ValueError(f"boundary must be 'sponge' or 'cpml', got {boundary!r}")
    use_cpml = boundary == "cpml"
    if use_cpml and store_adjoint is not None:
        raise ValueError("store_adjoint is not available with CPML boundaries (the "
                         "stored sweep transposes the sponge scheme); CPML shots use "
                         "the derived adjoint")
    if use_cpml and windows is not None:
        raise ValueError("ginsu windowing composes with boundary='sponge'")
    if use_cpml:
        a_prof, b_prof = _cpml_profiles(prop_shape, sponge_width, dt, dx, cmax, freq,
                                        dtype=dtype, free_surface=free_surface)
        bnd = {"a_prof": a_prof, "b_prof": b_prof}
    else:
        bnd = {"sponge": _make_sponge(prop_shape, sponge_width,
                                      free_surface=free_surface, dtype=dtype)}
    sp = _multishot_grid(grid_shape, dtype, mesh, axis, device, space_order)
    return _multishot_operator(
        sp, sp if windows is None else Space(prop_shape, dtype, sp.device),
        _propagate_cpml if use_cpml else _propagate, _adjoint_stored, src_indices,
        nt=nt, dt=dt, dx=dx, freq=freq, rcv_idx=rcv_idx, dtrec=dtrec,
        store_adjoint=store_adjoint, shot_map=shot_map, order=space_order,
        remat_blocks=remat_blocks, windows=windows, boundary=bnd, mesh=mesh, axis=axis)


# ---------------------------------------------------------------------------
# CPML absorbing boundaries: second-order-form convolutional PML with two
# memory fields per axis (psi on the first derivative, zeta on the second),
# after Pasalic & McGarry (SEG 2010). The memory fields are full grids whose
# update coefficients (a, b) are 0 and 1 in the interior, so every update is
# one elementwise pass. Plain PyTorch with the derived adjoint: the JAX
# package has no kernel for this step either. The one-axis derivatives are
# stencil.d1_axis / d2_axis, bitwise the JAX package's eager _d1_axis /
# _d2_axis.
# ---------------------------------------------------------------------------


def _cpml_profiles(shape, width, dt, dx, cmax, f0, R=1e-3, dtype=torch.float32,
                   free_surface: bool = False):
    """Per-axis CPML update coefficients ``(a_ax, b_ax)`` as broadcastable
    profiles, computed in float64 and rounded to ``dtype`` (on the CPU; the
    operators move them). ``sigma`` ramps quadratically to ``sigma_max =
    3·cmax·ln(1/R) / (2·W·dx)`` at the outer edge; ``alpha`` ramps linearly
    from ``π·f0`` at the inner PML edge to 0 outside. In the interior
    ``sigma = alpha = 0`` gives ``b = 1, a = 0``. With ``free_surface`` the
    top of axis 0 has no PML (the stencil's zero boundary is the
    pressure-release surface)."""
    a_profiles, b_profiles = [], []
    sig_max = 3.0 * cmax * np.log(1.0 / R) / (2.0 * width * dx)
    for ax, n in enumerate(shape):
        i = np.arange(n, dtype=np.float64)
        edge = (n - 1 - i) if free_surface and ax == 0 else np.minimum(i, n - 1 - i)
        depth = np.maximum(width - edge, 0.0) / width
        sig = sig_max * depth**2
        alpha = np.pi * f0 * (1.0 - depth) * (depth > 0)
        b = np.exp(-(sig + alpha) * dt)
        denom = np.where(sig + alpha > 0, sig + alpha, 1.0)
        a = np.where(sig > 0, sig / denom * (b - 1.0), 0.0)
        bshape = tuple(n if j == ax else 1 for j in range(len(shape)))
        a_profiles.append(torch.as_tensor(a).to(dtype).reshape(bshape))
        b_profiles.append(torch.as_tensor(b).to(dtype).reshape(bshape))
    return tuple(a_profiles), tuple(b_profiles)


def _propagate_cpml(c, src_wavelet, src_idx, rcv_idx, *, dt, dx, a_prof, b_prof,
                    order: int = 2, remat_blocks: int = 1, fused=None,
                    inplace: bool = False, vmap_tape: Optional[bool] = None,
                    wavefield_sharding=None):
    """Leapfrog stepping with CPML memory-field boundaries; returns the
    receiver traces ``(nt, nrcv)``. The carry is ``(u_prev, u, psi_0..,
    zeta_0..)``; each step is the JAX package's XLA step, tree for tree.
    Plain only (``fused`` and ``inplace`` are accepted and ignored);
    ``remat_blocks`` and ``vmap_tape`` as for :func:`_propagate`.

    Under ``wavefield_sharding`` each rank steps its slab (:class:`_Slab`):
    the profiles are sliced to the slab's planes, the memory fields ψ and ζ
    stay local, and each derivative along a sharded dimension reads the
    neighbours' planes — ``u``'s for the first and second derivatives, the
    fresh ψ's for ``∂ψ`` (one more exchange per sharded dimension and step).
    Every point keeps its tree, so the traces (summed once over the
    wavefield's mesh axes) are the unsharded ones bit for bit on a world of
    one; the derived adjoint goes back through the exchanges."""
    shape, dtype, dev, nd = c.shape, c.dtype, c.device, c.ndim
    sl = _slab_of(c, src_idx, rcv_idx, None, order, wavefield_sharding)
    c2dt2 = (c * c) * (dt * dt)
    inv_dx2 = torch.tensor(1.0 / (dx * dx), dtype=dtype, device=dev)
    inv_dx = torch.tensor(1.0 / dx, dtype=dtype, device=dev)
    amp = torch.tensor(dt * dt, dtype=dtype, device=dev)
    if sl is None:
        mask = cuda_wave.source_mask(shape, src_idx, amp)
        along = lambda fn, u, ax: fn(u)  # noqa: E731
        record = functools.partial(_gather, idx=rcv_idx, vmapped=vmap_tape is not None)
    else:
        mask = sl.interior(sl.mask(amp))
        a_prof = tuple(sl.narrow(f, ax) for ax, f in enumerate(a_prof))
        b_prof = tuple(sl.narrow(f, ax) for ax, f in enumerate(b_prof))
        along, record = sl.along, sl.extract

    def body(carry, s_t, params, consts):
        (c2,), (inv_dx, inv_dx2, mask) = params, consts[:3]
        a_prof, b_prof = consts[3:3 + nd], consts[3 + nd:]
        u_prev, u, psis, zetas = carry
        new_psis, new_zetas, lap = [], [], None
        for ax in range(nd):
            d1 = along(lambda v: d1_axis(v, ax, inv_dx, order), u, ax)
            psi = b_prof[ax] * psis[ax] + a_prof[ax] * d1
            d2 = along(lambda v: d2_axis(v, ax, inv_dx2, order), u, ax)
            dpsi = along(lambda v: d1_axis(v, ax, inv_dx, order), psi, ax)
            zeta = b_prof[ax] * zetas[ax] + a_prof[ax] * (d2 + dpsi)
            new_psis.append(psi)
            new_zetas.append(zeta)
            term = d2 + dpsi + zeta
            lap = term if lap is None else lap + term
        u_next = 2.0 * u - u_prev + c2 * lap + s_t * mask
        return (u, u_next, tuple(new_psis), tuple(new_zetas)), record(u_next)

    def zero():
        return torch.zeros(shape, dtype=dtype, device=dev)

    carry = (zero(), zero(), tuple(zero() for _ in range(nd)),
             tuple(zero() for _ in range(nd)))
    traces = _time_loop(body, carry, src_wavelet, remat_blocks,
                        _records(c) if vmap_tape is None else vmap_tape, (c2dt2,),
                        (inv_dx, inv_dx2, mask, *a_prof, *b_prof), vmap_tape is not None)
    return traces if sl is None else sl.sum(traces)


def cpml_wave_propagator(
    grid_shape: Sequence[int],
    *,
    nt: int = 256,
    dt: float = 0.001,
    dx: float = 10.0,
    freq: float = 15.0,
    src_idx: int = 0,
    rcv_idx=None,
    pml_width: int = 12,
    cmax: float = 4000.0,
    space_order: int = 2,
    remat_blocks: int = 1,
    free_surface: bool = False,
    dtrec: Optional[float] = None,
    dtype: torch.dtype = torch.float32,
    device: torch.device | str | None = None,
) -> Operator:
    """Nonlinear forward modelling ``F: c → traces`` with CPML absorbing
    boundaries (Pasalic–McGarry second-order-form convolutional PML), on
    ``device`` (``None``: the CUDA card). The same jet contract as
    :func:`wave_propagator`; its boundary reflects orders of magnitude less
    than the cosine sponge at equal width. ``cmax`` is the static velocity
    that scales the damping profiles (constants, not functions of the
    model, so the linearization stays exact and the profiles stay out of
    the gradient). Plain PyTorch: the tangent is ``torch.func.jvp`` and the
    adjoint autograd through the time loop (:func:`_vjp_by_autograd`)."""
    grid_shape = tuple(int(s) for s in grid_shape)
    space_order = _check_space_order(space_order)
    sp = Space(grid_shape, dtype, device)
    a_prof, b_prof = _cpml_profiles(grid_shape, pml_width, dt, dx, cmax, freq,
                                    dtype=dtype, free_surface=free_surface)
    return _single_shot_operator(
        sp, sp, _propagate_cpml, None, nt=nt, dt=dt, dx=dx, freq=freq, src_idx=src_idx,
        rcv_idx=rcv_idx, dtrec=dtrec, store_adjoint=None, fused=False, order=space_order,
        remat_blocks=remat_blocks, boundary={"a_prof": a_prof, "b_prof": b_prof})


# ---------------------------------------------------------------------------
# Variable density: p_tt = κ·div(b·grad p) + κ·s with κ = c²/b and the
# buoyancy b = 1/ρ, in the self-adjoint staggered form −(D⁺)ᵀ·diag(b_{i+½})·D⁺
# per axis (zero flux outside the grid), so the pressure operator at a fixed
# b is symmetric. Model (c, b) on BlockSpace([grid, grid]), or (c, b, Q) with
# Kosloff constant-Q friction (the IsoDenQ physics of the JetPackWaveFD
# propagators). Plain PyTorch: the JAX package runs these as XLA only.
# ---------------------------------------------------------------------------


def _b_half(b):
    """The staggered buoyancies ``b_{i+½} = 0.5·(b[i+1] + b[i])`` of each
    axis, computed once per propagation (the same bits as once per step)."""
    return tuple(0.5 * (b.narrow(ax, 1, n - 1) + b.narrow(ax, 0, n - 1))
                 for ax, n in enumerate(b.shape))


def _zero_pad(x, ax, lo: int, hi: int):
    """``x`` with ``lo`` zeros before and ``hi`` after it along ``ax``."""
    z = torch.zeros_like(x.narrow(ax, 0, 1))
    return torch.cat([z] * lo + [x] + [z] * hi, dim=ax)


def _div_b_grad(u, bh, inv_dx2):
    """``Σ_ax D⁻(b_{i+½}·D⁺u)·(1/dx²)`` with zero flux outside the grid, at
    the staggered buoyancies ``bh`` (:func:`_b_half`); the per-axis sum
    ``out + dminus·inv_dx2`` in the JAX package's order."""
    out = None
    for ax, n in enumerate(u.shape):
        dplus = u.narrow(ax, 1, n - 1) - u.narrow(ax, 0, n - 1)   # at i+½
        fp = _zero_pad(bh[ax] * dplus, ax, 1, 1)
        dminus = fp.narrow(ax, 1, n) - fp.narrow(ax, 0, n)
        out = dminus * inv_dx2 if out is None else out + dminus * inv_dx2
    return out


def _div_b_grad_bbar(u, w, inv_dx2):
    """The cotangent on ``b`` of ``b ↦ ⟨w, div(b·grad u)⟩`` at a fixed ``u``:
    per axis ``(w̄[i] − w̄[i+1])·D⁺u`` (``w̄ = w·inv_dx2``), spread half and
    half onto the two cells the average ``b_{i+½}`` reads."""
    out = None
    wd = w * inv_dx2
    for ax, n in enumerate(u.shape):
        dplus = u.narrow(ax, 1, n - 1) - u.narrow(ax, 0, n - 1)
        half = 0.5 * ((wd.narrow(ax, 0, n - 1) - wd.narrow(ax, 1, n - 1)) * dplus)
        contrib = _zero_pad(half, ax, 0, 1) + _zero_pad(half, ax, 1, 0)
        out = contrib if out is None else out + contrib
    return out


def _propagate_vd(c, b, src_wavelet, src_idx, rcv_idx, *, dt, dx, sponge, g=None,
                  order: int = 2, fused=None, inplace: bool = False,
                  remat_blocks: int = 1):
    """Variable-density leapfrog ``p⁺ = ((2p − p⁻) + K·(L_b(p) + s·mask))·S``
    with ``K = (c²/b)·dt²`` and a source mask of amplitude 1 (``K`` scales
    it); with the friction ``g = γ·dt`` (from a Q block) the update is
    ``((2p − (1−g)·p⁻) + K·(...))·(1/(1+g))`` before the sponge, and
    ``g = 0`` is the lossless step bit for bit. Returns the traces
    ``(nt, nrcv)``. Plain only (``order`` and ``fused`` are accepted and
    ignored, as the JAX package has neither here); ``inplace`` and
    ``remat_blocks`` as for :func:`_propagate`."""
    shape, dtype, dev = c.shape, c.dtype, c.device
    kdt2 = ((c * c) / b) * (dt * dt)
    bh = _b_half(b)
    inv_dx2 = torch.tensor(1.0 / (dx * dx), dtype=dtype, device=dev)
    mask = cuda_wave.source_mask(shape, src_idx, torch.ones((), dtype=dtype, device=dev))
    S = _sponge_full(sponge)
    if g is not None:
        om1g, inv1pg = 1.0 - g, 1.0 / (1.0 + g)

    def step(pp, p, s_t):
        src = _div_b_grad(p, bh, inv_dx2) + s_t * mask
        if g is None:
            return ((2.0 * p - pp) + kdt2 * src) * S
        return (((2.0 * p - om1g * pp) + kdt2 * src) * inv1pg) * S

    tape = _records(*(t for t in (c, b, g) if t is not None))
    return _field_loop(step, 1, shape, dtype, dev, src_wavelet, rcv_idx,
                       inplace and not tape, remat_blocks, tape)


def _adjoint_stored_vd(c, b, qf, dd, src_wavelet, src_idx, rcv_idx, *, dt, dx, f0,
                       sponge, store: str = "int8", order: int = 2, fused=None):
    """Adjoint-state gradient of the variable-density (with ``qf``, the
    IsoDenQ) physics over a stored, encoded pressure history: the
    transposed recurrence of :func:`_propagate_vd`, reindexed as in the JAX
    package so that each reverse step reads one snapshot. With ``K = κ·dt²``,
    ``sē_k = S⊙a_{k+1}``, ``ē_k = ig⊙sē_k``::

        a_k  = Pᵀḡ + 2ē_k + L_b(K·ē_k) − og·ē_{k+1}
        gK  += (L_b(p_k) + s_k·mask)⊙ē_k
        gb  += b̄(p_k, K·ē_k)                  (:func:`_div_b_grad_bbar`)
        gig += sē_k·(2p_k + K·(L_b(p_k) + s_k·mask)) − og·p_k·sē_{k+1}
        gog += −p_k·ē_{k+1}

    then ``gc = gK·(2c/b)·dt²``, ``gb −= gK·(K/b)`` and, for finite Q,
    ``gg = −gog − ig²·gig``, ``gQ = −gg·(g/Q)``. Both sweeps are plain (no
    kernel in the JAX package either; ``order`` and ``fused`` are accepted
    and ignored). Returns ``(gc, gb)`` or ``(gc, gb, gQ)``."""
    shape, dtype, dev = c.shape, c.dtype, c.device
    size = math.prod(shape)
    K = ((c * c) / b) * (dt * dt)
    bh = _b_half(b)
    inv_dx2 = torch.tensor(1.0 / (dx * dx), dtype=dtype, device=dev)
    with_q = qf is not None
    if with_q:
        g = _q_friction(qf, dt, f0)
        ig, og = 1.0 / (1.0 + g), 1.0 - g
    mask = cuda_wave.source_mask(shape, src_idx, torch.ones((), dtype=dtype, device=dev))
    S = _sponge_full(sponge)
    enc, dec = _store_codec(store, dtype)
    dd = dd.to(dtype)
    nt = int(src_wavelet.shape[0])

    def zeros():
        return torch.zeros(shape, dtype=dtype, device=dev)

    def inject(row):
        return torch.zeros(size, dtype=dtype, device=dev).index_add(
            0, rcv_idx, row).reshape(shape)

    hist = []
    pp, p = zeros(), zeros()
    for k in range(nt):
        hist.append(enc(p))  # history entry k holds p_k
        src = _div_b_grad(p, bh, inv_dx2) + src_wavelet[k] * mask
        if with_q:
            p_next = (((2.0 * p - og * pp) + K * src) * ig) * S
        else:
            p_next = ((2.0 * p - pp) + K * src) * S
        pp, p = p, p_next
    del pp, p, p_next  # the history holds what the reverse sweep needs
    # ḡ_{k-1} aligned to reverse step k (rec_k samples p_{k+1})
    dd_shift = torch.cat([torch.zeros_like(dd[:1]), dd[:-1]])
    a_nxt = inject(dd[-1])
    ebar_nxt, sbar_nxt, gK, gb, gig, gog = (zeros() for _ in range(6))
    for k in range(nt - 1, -1, -1):
        qh, sc = hist[k]
        hist[k] = None  # release the snapshot as the sweep passes it
        p_k = dec(qh, sc)
        sbar = a_nxt * S
        ebar = ig * sbar if with_q else sbar
        src_k = _div_b_grad(p_k, bh, inv_dx2) + src_wavelet[k] * mask
        gK = gK + src_k * ebar
        gb = gb + _div_b_grad_bbar(p_k, K * ebar, inv_dx2)
        if with_q:
            gig = gig + (sbar * (2.0 * p_k + K * src_k) - og * (p_k * sbar_nxt))
            gog = gog - p_k * ebar_nxt
            a_nxt = ((2.0 * ebar + _div_b_grad(K * ebar, bh, inv_dx2) - og * ebar_nxt)
                     + inject(dd_shift[k]))
        else:
            a_nxt = ((2.0 * ebar + _div_b_grad(K * ebar, bh, inv_dx2) - ebar_nxt)
                     + inject(dd_shift[k]))
        ebar_nxt, sbar_nxt = ebar, sbar
    gc = gK * ((2.0 * c) / b) * torch.tensor(dt * dt, dtype=dtype, device=dev)
    gb = gb - gK * (K / b)
    if not with_q:
        return gc, gb
    gg = -gog - (ig * ig) * gig
    return gc, gb, -gg * (g / qf)


def _propagate_vd_m(m, *args, f0=None, **kw):
    """:func:`_propagate_vd` on a ``(c, b)`` or ``(c, b, Q)``
    :class:`BlockVector` (``g = π·f0·dt/Q`` from the Q block)."""
    c, b, *q = m.blocks
    g = _q_friction(q[0], kw["dt"], f0) if q else None
    return _propagate_vd(c, b, *args, g=g, **kw)


def _adjoint_stored_vd_m(m, dd, *args, **kw):
    """:func:`_adjoint_stored_vd` on a ``(c, b)`` or ``(c, b, Q)``
    :class:`BlockVector`, returning the gradient as one."""
    c, b, *q = m.blocks
    return BlockVector(_adjoint_stored_vd(c, b, q[0] if q else None, dd, *args, **kw),
                       m.space)


def _vd_operator(grid_shape, nblocks, *, nt, dt, dx, freq, f0, src_idx, rcv_idx,
                 sponge_width, remat_blocks, dtrec, store_adjoint, dtype, device):
    grid_shape = tuple(int(s) for s in grid_shape)
    _check_store(store_adjoint)
    gsp = Space(grid_shape, dtype, device)
    return _single_shot_operator(
        BlockSpace([gsp] * nblocks), gsp, functools.partial(_propagate_vd_m, f0=f0),
        functools.partial(_adjoint_stored_vd_m, f0=f0), nt=nt, dt=dt, dx=dx,
        freq=freq, src_idx=src_idx, rcv_idx=rcv_idx, dtrec=dtrec,
        store_adjoint=store_adjoint, fused=False, order=2, remat_blocks=remat_blocks,
        boundary={"sponge": _make_sponge(grid_shape, sponge_width, dtype=dtype)})


def vd_wave_propagator(
    grid_shape: Sequence[int],
    *,
    nt: int = 256,
    dt: float = 0.001,
    dx: float = 10.0,
    freq: float = 15.0,
    src_idx: int = 0,
    rcv_idx=None,
    sponge_width: int = 12,
    remat_blocks: int = 1,
    dtrec: Optional[float] = None,
    store_adjoint: Optional[str] = None,
    dtype: torch.dtype = torch.float32,
    device: torch.device | str | None = None,
) -> Operator:
    """Two-parameter variable-density forward modelling ``F: (c, b) →
    traces`` (velocity and buoyancy ``b = 1/ρ``, the JetPackWaveFD
    velocity-buoyancy physics). Domain: ``BlockSpace([grid, grid])`` on
    ``device`` (``None``: the CUDA card); range: ``(ntrec, nrcv)`` traces.
    The tangent is ``torch.func.jvp`` through the time loop, the adjoint
    autograd through it or, with ``store_adjoint`` ∈ {"f32", "bf16",
    "int8"}, the stored-history sweep (:func:`_adjoint_stored_vd`); either
    returns the ``(δc, δb)`` pair. Plain PyTorch (no TPU kernel takes this
    physics). ``remat_blocks`` as for :func:`wave_propagator`."""
    return _vd_operator(grid_shape, 2, nt=nt, dt=dt, dx=dx, freq=freq, f0=None,
                        src_idx=src_idx, rcv_idx=rcv_idx, sponge_width=sponge_width,
                        remat_blocks=remat_blocks, dtrec=dtrec,
                        store_adjoint=store_adjoint, dtype=dtype, device=device)


def vdq_wave_propagator(
    grid_shape: Sequence[int],
    *,
    nt: int = 256,
    dt: float = 0.001,
    dx: float = 10.0,
    freq: float = 15.0,
    f0: Optional[float] = None,
    src_idx: int = 0,
    rcv_idx=None,
    sponge_width: int = 12,
    remat_blocks: int = 1,
    dtrec: Optional[float] = None,
    store_adjoint: Optional[str] = None,
    dtype: torch.dtype = torch.float32,
    device: torch.device | str | None = None,
) -> Operator:
    """The full IsoDenQ physics ``F: (c, b, Q) → traces``: velocity,
    buoyancy and Kosloff constant-Q attenuation (reference frequency ``f0``,
    default the source ``freq``), the parameters of JetPackWaveFD's
    ``Prop*AcoIsoDenQ`` propagators. Domain: ``BlockSpace([grid, grid,
    grid])`` on ``device`` (``None``: the CUDA card); the adjoint returns
    the ``(δc, δb, δQ)`` triple, by autograd or by the stored-history sweep
    (``store_adjoint``) with the friction transposed. ``Q = ∞`` is
    :func:`vd_wave_propagator`'s physics, bit for bit."""
    return _vd_operator(grid_shape, 3, nt=nt, dt=dt, dx=dx, freq=freq,
                        f0=float(freq if f0 is None else f0), src_idx=src_idx,
                        rcv_idx=rcv_idx, sponge_width=sponge_width,
                        remat_blocks=remat_blocks, dtrec=dtrec,
                        store_adjoint=store_adjoint, dtype=dtype, device=device)


# ---------------------------------------------------------------------------
# Off-grid acquisition: Kaiser-windowed sinc (Hicks) source stamp and
# receiver interpolation (ops/sampling). The source's stamp is folded into a
# full-grid injection mask once; the in-loop extraction is one static depth
# window contracted with its 2r taps, then one banded matrix product per
# remaining axis. Plain PyTorch: no kernel takes a custom mask or extractor.
# ---------------------------------------------------------------------------


def _offgrid_src_mask(shape, src_pos, dt: float, radius: int, dtype):
    """The full-grid injection mask with the source's Kaiser-sinc stamp at
    its fractional position ``src_pos``, scaled by ``dt²``: built once in
    float64 numpy, then cast (on the CPU; the operator moves it)."""
    rows = [kaiser_sinc_matrix_np(n, [float(p)], radius)[0] for n, p in zip(shape, src_pos)]
    stamp = rows[0]
    for r in rows[1:]:
        stamp = np.multiply.outer(stamp, r)
    return torch.from_numpy(stamp * (dt * dt)).to(dtype)


def _offgrid_extract(u, wz, Wr, lo: int, hi: int):
    """The receiver line or plane of ``u``: the depth window ``u[lo:hi]``
    contracted with its taps ``wz``, then ``Wr[k]`` along each remaining
    axis."""
    line = torch.tensordot(wz, u[lo:hi], dims=([0], [0]))
    for k, W in enumerate(Wr):
        line = _axis_contract(W, line, k)
    return line


def _offgrid_inject(row, wz, Wr, lo: int, hi: int, shape):
    """The transpose of :func:`_offgrid_extract`: ``Wr[k]ᵀ`` along each
    receiver axis of ``row``, then the outer product with the depth taps
    written into the window ``[lo, hi)`` of a zero grid."""
    line = row
    for k, W in enumerate(Wr):
        line = _axis_contract(W.T, line, k)
    out = torch.zeros(shape, dtype=row.dtype, device=row.device)
    out[lo:hi] = wz.reshape((-1,) + (1,) * line.ndim) * line
    return out


def offgrid_wave_propagator(
    grid_shape: Sequence[int],
    *,
    src_pos: Sequence[float],
    rcv_depth: float,
    rcv_coords,
    nt: int = 256,
    dt: float = 0.001,
    dx: float = 10.0,
    freq: float = 15.0,
    sponge_width: int = 12,
    space_order: int = 2,
    radius: int = 4,
    remat_blocks: int = 1,
    dtrec: Optional[float] = None,
    store_adjoint: Optional[str] = None,
    dtype: torch.dtype = torch.float32,
    device: torch.device | str | None = None,
) -> Operator:
    """Nonlinear forward modelling ``F: c → traces`` with off-grid
    acquisition: the source at the fractional position ``src_pos`` (one
    float per axis) and a receiver line (2-D: ``rcv_coords`` one array) or
    separable plane (3-D: one array per non-depth axis) at the fractional
    depth ``rcv_depth`` along axis 0. Range: ``(ntrec,) + (len(coords), ...)``
    traces; the domain lives on ``device`` (``None``: the CUDA card).

    The isotropic physics of :func:`wave_propagator` on its plain step (no
    kernel takes a custom source mask or extractor). The tangent is
    ``torch.func.jvp``, the adjoint autograd through the time loop or, with
    ``store_adjoint`` ∈ {"f32", "bf16", "int8"}, the stored-history sweep
    with the off-grid source mask in its forward sweep and, as the receiver
    injection, the explicit transpose of the extraction
    (:func:`_offgrid_inject`). ``dtrec`` and ``remat_blocks`` as for
    :func:`wave_propagator`."""
    grid_shape = tuple(int(s) for s in grid_shape)
    space_order = _check_space_order(space_order)
    _check_store(store_adjoint)
    nd = len(grid_shape)
    sp = Space(grid_shape, dtype, device)
    # depth taps: the static window [iz0, iz0 + 2r) clamped to the grid
    n0 = grid_shape[0]
    iz0 = int(np.floor(rcv_depth)) - radius + 1
    lo, hi = max(iz0, 0), min(iz0 + 2 * radius, n0)
    wz = torch.from_numpy(kaiser_sinc_matrix_np(n0, [float(rcv_depth)], radius)[0][lo:hi])
    rcv_axes = ((np.asarray(rcv_coords, np.float64),) if nd == 2
                else tuple(np.asarray(c, np.float64) for c in rcv_coords))
    if len(rcv_axes) != nd - 1:
        raise ValueError("rcv_coords must cover every non-depth axis")
    Wr = tuple(kaiser_sinc_matrix(grid_shape[1 + k], rcv_axes[k], radius, dtype=dtype,
                                  device=sp.device) for k in range(nd - 1))
    out_shape = tuple(int(W.shape[0]) for W in Wr)
    ntrec, resample = _trace_resampler(nt, dt, dtrec, dtype)
    rt = (_resample_transpose(resample, (nt,) + out_shape, dtype)
          if resample is not None else None)
    cfg = dict(dt=dt, dx=dx, order=space_order)

    def _forward(c, state, inplace):
        traces = _propagate(
            c, state["wavelet"], 0, None, sponge=state["sponge"],
            src_mask=state["src_mask"], inplace=inplace, remat_blocks=remat_blocks,
            extract=lambda u: _offgrid_extract(u, state["wz"], state["Wr"], lo, hi), **cfg)
        return resample(traces) if resample is not None else traces

    def _f(c, state):
        return _forward(c, state, True)

    def _df(dc, m0, state):
        _, tangent = torch.func.jvp(lambda c: _forward(c, state, False), (m0,), (dc,))
        return tangent

    if store_adjoint is None:
        def _dft(dd, m0, state):
            return _vjp_by_autograd(lambda c: _forward(c, state, False), m0, dd)
    else:
        def _dft(dd, m0, state):
            if rt is not None:
                dd = rt(dd)
            return _adjoint_stored(
                m0, dd, state["wavelet"], 0, None, sponge=state["sponge"],
                store=store_adjoint, src_mask=state["src_mask"],
                inject=lambda row: _offgrid_inject(row, state["wz"], state["Wr"], lo, hi,
                                                   grid_shape), **cfg)

    j = Jet(dom=sp, rng=Space((ntrec,) + out_shape, dtype, sp.device), f=_f, df=_df,
            dft=_dft, state={
                "wavelet": _ricker(nt, dt, freq, dtype).to(sp.device),
                "sponge": _to_device(_make_sponge(grid_shape, sponge_width, dtype=dtype),
                                     sp.device),
                "src_mask": _offgrid_src_mask(grid_shape, src_pos, dt, radius,
                                              dtype).to(sp.device),
                "wz": wz.to(dtype=dtype, device=sp.device),
                "Wr": Wr,
            })
    return Operator(j)


# ---------------------------------------------------------------------------
# VTI anisotropy: the pseudo-acoustic coupled p/q system (axis 0 = z)
#     p_tt = c²[(1+2ε)·Lh(p) + √(1+2δ)·∂zz(q)] + s
#     q_tt = c²[√(1+2δ)·Lh(p) + ∂zz(q)] + s
# Model (c, ε, δ) on a BlockSpace([grid, grid, grid]). Each axis of Lh and
# ∂zz is scaled by 1/dx² on its own (stencil.d2_axis), not folded into c²dt²
# as the isotropic step folds it.
# ---------------------------------------------------------------------------


def _vti_coefficients(c, eps, delta, dt: float, dx: float):
    """``(C, ah, av, inv_dx2)``: ``C = (c·c)·(dt·dt)``, ``ah = 1 + 2ε``,
    ``av = √(1 + 2δ)`` and ``1/dx²`` as a 0-d tensor, rounded as the JAX
    package rounds them. PyTorch's vectorised float32 square root on the
    CPU is not correctly rounded (1 ulp off for ~0.6% of inputs), JAX's
    and CUDA's are; a float64 root rounded to float32 is, so ``av`` is
    taken that way and the CPU, the card and JAX agree bit for bit."""
    C = (c * c) * (dt * dt)
    ah = 1.0 + 2.0 * eps
    av = 1.0 + 2.0 * delta
    av = (torch.sqrt(av.double()).to(av.dtype) if av.dtype == torch.float32
          else torch.sqrt(av))
    return C, ah, av, torch.tensor(1.0 / (dx * dx), dtype=c.dtype, device=c.device)


class _VtiStep(torch.autograd.Function):
    """K8 under autodiff (the counterpart of the ``custom_jvp`` around the
    Pallas VTI step in ``jets_tpu/ops/wave.py``): the forward is the kernel,
    writing fresh tensors; the tangent is the plain expression
    ``dp_next = S⊙(2dp − dpp + dC·(ah·Lh(p) + av·∂zz(q)) + C·(dah·Lh(p) +
    ah·Lh(dp) + dav·∂zz(q) + av·∂zz(dq))) + dst·mask`` (and ``dq_next``
    likewise) and the backward its transpose, both plain PyTorch."""

    @staticmethod
    def forward(p_prev, p, q_prev, q, C, ah, av, s_t, spz, sy, sx, inv_dx2, src, amp,
                order):
        return cuda_vti.fused_vti_step(p_prev, p, q_prev, q, C, ah, av, spz, sy, sx,
                                       inv_dx2, s_t, src, amp, order=order)

    @staticmethod
    def setup_context(ctx, inputs, output):
        _, p, _, q, C, ah, av, _, spz, sy, sx, inv_dx2, src, amp, order = inputs
        ctx.save_for_backward(p, q, C, ah, av, spz, sy, sx, inv_dx2, amp)
        ctx.save_for_forward(p, q, C, ah, av, spz, sy, sx, inv_dx2, amp)
        ctx.src, ctx.order = src, order

    @staticmethod
    def jvp(ctx, dpp, dp, dqp, dq, dC, dah, dav, dst, *_):
        p, q, C, ah, av, spz, sy, sx, inv_dx2, amp = ctx.saved_tensors
        o = ctx.order
        zero = torch.zeros_like(p)
        dpp, dp, dqp, dq, dC, dah, dav = (zero if t is None else t
                                          for t in (dpp, dp, dqp, dq, dC, dah, dav))
        lhp, dzq = cuda_vti.lh(p, inv_dx2, o), cuda_vti.dzz(q, inv_dx2, o)
        dlh, ddz = cuda_vti.lh(dp, inv_dx2, o), cuda_vti.dzz(dq, inv_dx2, o)
        S = cuda_wave.sponge_product(spz, sy, sx)
        dpn = (2.0 * dp - dpp + dC * (ah * lhp + av * dzq)
               + C * (dah * lhp + ah * dlh + dav * dzq + av * ddz)) * S
        dqn = (2.0 * dq - dqp + dC * (av * lhp + dzq)
               + C * (dav * lhp + av * dlh + ddz)) * S
        if dst is not None:
            m = dst * cuda_wave.source_mask(p.shape, ctx.src, amp)
            dpn, dqn = dpn + m, dqn + m
        return dpn, dqn

    @staticmethod
    def backward(ctx, gpn, gqn):
        p, q, C, ah, av, spz, sy, sx, inv_dx2, amp = ctx.saved_tensors
        o = ctx.order
        S = cuda_wave.sponge_product(spz, sy, sx)
        gp, gq = gpn * S, gqn * S
        lhp, dzq = cuda_vti.lh(p, inv_dx2, o), cuda_vti.dzz(q, inv_dx2, o)
        d_p = (2.0 * gp + cuda_vti.lh(C * ah * gp, inv_dx2, o)
               + cuda_vti.lh(C * av * gq, inv_dx2, o))
        d_q = (2.0 * gq + cuda_vti.dzz(C * av * gp, inv_dx2, o)
               + cuda_vti.dzz(C * gq, inv_dx2, o))
        d_C = (ah * lhp + av * dzq) * gp + (av * lhp + dzq) * gq
        d_ah = C * lhp * gp
        d_av = C * (dzq * gp + lhp * gq)
        d_st = torch.sum((gpn + gqn) * cuda_wave.source_mask(p.shape, ctx.src, amp))
        return (-gp, d_p, -gq, d_q, d_C, d_ah, d_av, d_st) + (None,) * 7


_NO_STATIC_Q = {"VTI": "fused VTI step does not support static Q",
                "TTI": "fused TTI step does not support static Q"}


def _static_q(q, dt: float, f0: float, grid_shape, dtype):
    """The static Kosloff friction of a quality factor ``q`` (a scalar or a
    grid; a modelling parameter, not a model block): ``{"og": 1 − g, "ig":
    1/(1 + g)}`` on the grid, ``g = (π·f0·dt)/Q`` divided as the JAX
    package divides it (:func:`_q_friction`). ``Q = ∞`` gives ``g = 0`` and
    factors of exactly 1, the lossless step bit for bit."""
    g = _q_friction(torch.as_tensor(q, dtype=dtype), dt, f0)
    return {"og": (1.0 - g).expand(grid_shape).contiguous(),
            "ig": (1.0 / (1.0 + g)).expand(grid_shape).contiguous()}


def _same(u):
    return u


def _slab_of(c, src_idx, rcv_idx, sponge, order, ws):
    """The rank's :class:`_Slab` of a propagation under ``ws`` (``None``
    without one)."""
    if ws is None:
        return None
    return _Slab(_global_shape(c, ws), c.dtype, c.device, src_idx, rcv_idx, sponge=sponge,
                 order=order, ws=ws)


def _vti_slab_step(sl, C, ah, av, inv_dx2, amp, order, og=None, ig=None):
    """``step(p_prev, p, q_prev, q, s_t) -> (p_next, q_next)`` of a rank's
    slab (:class:`_Slab`): :func:`cuda_vti.vti_plain` on the halo-extended
    fields, the interior kept. The coefficients and the static-Q factors
    (global arrays, sliced) enter the step pointwise, so they are
    zero-extended once."""
    Ce, ahe, ave = sl.pad(C), sl.pad(ah), sl.pad(av)
    mask = sl.mask(amp)
    fr = () if og is None else (sl.pad(sl.local(og)), sl.pad(sl.local(ig)))

    def step(pp, p, qp, q, s_t):
        pn, qn = cuda_vti.vti_plain(sl.pad(pp), sl.ext(p), sl.pad(qp), sl.ext(q), Ce, ahe,
                                    ave, sl.S, inv_dx2, s_t, mask, order, *fr)
        return sl.interior(pn), sl.interior(qn)

    return step


def _propagate_vti(c, eps, delta, src_wavelet, src_idx, rcv_idx, *, dt, dx, sponge,
                   order: int = 2, fused=None, inplace: bool = False,
                   remat_blocks: int = 1, og=None, ig=None,
                   vmap_tape: Optional[bool] = None, wavefield_sharding=None):
    """Coupled VTI leapfrog; returns the p-field receiver traces
    ``(nt, nrcv)``. ``fused``, ``inplace``, ``remat_blocks`` and ``vmap_tape`` as for
    :func:`_propagate`: on the kernel route the step is K8, in place on
    sweeps no transform watches and inside :class:`_VtiStep` otherwise.
    The static-Q friction factors ``og``, ``ig`` (:func:`_static_q`) take
    the plain step, as K8 has no friction field. With ``wavefield_sharding``
    the fields are the rank's slabs and every step is :func:`_vti_slab_step`
    (both fields' halos exchanged), the traces summed over the wavefield's
    mesh axes, as :func:`_propagate_sharded` does for the isotropic step."""
    shape, dtype, dev = c.shape, c.dtype, c.device
    C, ah, av, inv_dx2 = _vti_coefficients(c, eps, delta, dt, dx)
    amp = torch.tensor(dt * dt, dtype=dtype, device=dev)
    if wavefield_sharding is not None:
        sl = _slab_of(c, src_idx, rcv_idx, sponge, order, wavefield_sharding)
        tape = _records(c, eps, delta)
        return sl.sum(_field_loop(_vti_slab_step(sl, C, ah, av, inv_dx2, amp, order, og, ig),
                                  2, shape, dtype, dev, src_wavelet, rcv_idx,
                                  inplace and not tape, remat_blocks, tape, sl.extract))
    kernel = _kernel_route(fused, c, sponge, order,
                           None if og is None else _NO_STATIC_Q["VTI"])
    tape = _records(c, eps, delta) if vmap_tape is None else vmap_tape
    inplace = inplace and not tape
    params = consts = ()

    if kernel:
        spz, sy, sx = _factors_1d(sponge)
        src = int(src_idx)
        if inplace:
            def step(pp, p, qp, q, s_t):
                return cuda_vti.fused_vti_step(pp, p, qp, q, C, ah, av, spz, sy, sx,
                                               inv_dx2, s_t, src, amp, order=order,
                                               out=(pp, qp))
        else:
            def step(pp, p, qp, q, s_t):
                return _VtiStep.apply(pp, p, qp, q, C, ah, av, s_t, spz, sy, sx,
                                      inv_dx2, src, amp, order)
    else:
        S = _sponge_full(sponge)
        mask = cuda_wave.source_mask(shape, src_idx, amp)

        def step(pp, p, qp, q, s_t, C, ah, av, S, inv_dx2, mask, *ogig):
            return cuda_vti.vti_plain(pp, p, qp, q, C, ah, av, S, inv_dx2, s_t, mask,
                                      order, *ogig)

        params, consts = (C, ah, av), (S, inv_dx2, mask, *_friction(og, ig))
    return _field_loop(step, 2, shape, dtype, dev, src_wavelet, rcv_idx, inplace,
                       remat_blocks, tape, None, params, consts, vmap_tape is not None)


def _adjoint_stored_vti(c, eps, delta, dd, src_wavelet, src_idx, rcv_idx, *, dt, dx,
                        sponge, order: int = 2, store: str = "int8", fused=None,
                        og=None, ig=None, wavefield_sharding=None):
    """Adjoint-state gradient ``(∂F/∂(c, ε, δ))ᵀ dd`` over a stored two-field
    forward history, encoded per snapshot (``store``: f32, bf16, int8).
    With ``ēp = S⊙ap₊``, ``ēq = S⊙aq₊``, ``C = c²dt²``::

        ap  = Pᵀḡ + 2ēp + Lh(C·ah·ēp) + Lh(C·av·ēq) − ēp₊
        aq  =       2ēq + ∂zz(C·av·ēp) + ∂zz(C·ēq)  − ēq₊
        gC  += (ah·Lh(p_k) + av·∂zz(q_k))⊙ēp + (av·Lh(p_k) + ∂zz(q_k))⊙ēq
        gah += C·Lh(p_k)⊙ēp
        gav += C·(∂zz(q_k)⊙ēp + Lh(p_k)⊙ēq)

    and the outer chain ``gc = gC·(2c)·dt²``, ``gε = 2·gah``,
    ``gδ = gav/av``. On the kernel route the forward sweep is K9 (in place;
    it encodes each input snapshot at the scale the previous step's
    partial maxima give) and the reverse sweep K10 (``ap``/``aq`` into the
    ``ap₊₊``/``aq₊₊`` buffers, the accumulators in place) followed by the
    receiver injection ``index_add_``. The plain route is the JAX package's
    XLA sweeps (``fstep``/``bstep``), tree for tree. With the static-Q
    factors ``og``, ``ig`` (Q not differentiated) both sweeps are plain:
    ``ig`` scales ``ēp``/``ēq`` after the sponge and ``og`` the carried
    ``ēp₊``/``ēq₊``. With ``wavefield_sharding`` both sweeps are plain on
    the rank's slab (:class:`_Slab`): the forward sweep is
    :func:`_vti_slab_step`, each snapshot's int8 scales global maxima; the
    reverse sweep exchanges the decoded ``p_k``, ``q_k`` and ``ēp``, ``ēq``
    and holds the coefficients' halos, exchanged once. Returns
    ``(gc, gε, gδ)``, the rank's slabs under a sharding."""
    shape, dtype, dev = c.shape, c.dtype, c.device
    size = math.prod(shape)
    nt = int(src_wavelet.shape[0])
    C, ah, av, inv_dx2 = _vti_coefficients(c, eps, delta, dt, dx)
    amp = torch.tensor(dt * dt, dtype=dtype, device=dev)
    dd = dd.to(dtype)

    def zeros():
        return torch.zeros(shape, dtype=dtype, device=dev)

    def inject(row):
        return torch.zeros(size, dtype=dtype, device=dev).index_add(
            0, rcv_idx, row).reshape(shape)

    def outer(gC, gah, gav):
        return (gC * (2.0 * c) * torch.tensor(dt * dt, dtype=dtype, device=dev),
                2.0 * gah, gav / av)

    if wavefield_sharding is None and _kernel_route(
            fused, c, sponge, order, None if og is None else _NO_STATIC_Q["VTI"]):
        spz, sy, sx = _factors_1d(sponge)
        src = int(src_idx)
        pp, p, qp, q = (zeros() for _ in range(4))
        scale = torch.full((2,), cuda_vti.SCALE_FLOOR, dtype=dtype, device=dev)
        one = torch.ones(2, dtype=dtype, device=dev)
        ph, qh, scales = [], [], []
        for k in range(nt):
            qf = torch.full_like(scale, 127.0) / scale if store == "int8" else one
            p_next, q_next, p_enc, q_enc, nxt = cuda_vti.fused_vti_hist_step(
                pp, p, qp, q, C, ah, av, spz, sy, sx, inv_dx2, src_wavelet[k], src, amp,
                qf[0], qf[1], store=store, order=order, out=(pp, qp))
            ph.append(p_enc)
            qh.append(q_enc)
            scales.append(scale)
            scale = nxt  # snapshot k+1's scales, from this step's partial maxima
            pp, p, qp, q = p, p_next, q, q_next
        del pp, p, qp, q, p_next, q_next  # the history holds what the sweep needs
        decs = (true_div(torch.stack(scales), 127.0) if store == "int8"
                else torch.ones((nt, 2), dtype=dtype, device=dev))
        ap1 = inject(dd[-1])
        aq1, ap2, aq2, gC, gah, gav = (zeros() for _ in range(6))
        for k in range(nt - 1, -1, -1):
            ap, aq, gC, gah, gav = cuda_vti.fused_vti_adjoint_step(
                ap1, aq1, ap2, aq2, gC, gah, gav, C, av, ah, ph[k], qh[k], decs[k, 0],
                decs[k, 1], inv_dx2, spz, sy, sx, order=order, inplace=True)
            ph[k] = qh[k] = None  # release the snapshots as the sweep passes them
            if k > 0:  # ḡ_{k-1}; the JAX sweep adds a zero row at k = 0
                ap.reshape(-1).index_add_(0, rcv_idx, dd[k - 1])
            ap1, aq1, ap2, aq2 = ap, aq, ap1, aq1
        return outer(gC, gah, gav)

    sl = _slab_of(c, src_idx, rcv_idx, sponge, order, wavefield_sharding)
    if sl is None:
        S = _sponge_full(sponge)
        mask = cuda_wave.source_mask(shape, src_idx, amp)
        enc, dec = _store_codec(store, dtype)
        X = I = _same
        Cx, ahx, avx = C, ah, av

        def fstep(pp, p, qp, q, s_t):
            return cuda_vti.vti_plain(pp, p, qp, q, C, ah, av, S, inv_dx2, s_t, mask,
                                      order, og, ig)
    else:
        S, (enc, dec), inject = sl.interior(sl.S), sl.codec(store, dtype), sl.inject
        fstep = _vti_slab_step(sl, C, ah, av, inv_dx2, amp, order, og, ig)
        og, ig = (None, None) if og is None else (sl.local(og), sl.local(ig))
        X, I = sl.ext, sl.interior
        Cx, ahx, avx = X(C), X(ah), X(av)
    pp, p, qp, q = (zeros() for _ in range(4))
    hist = []
    for k in range(nt):
        hist.append((enc(p), enc(q)))  # history entry k holds (p_k, q_k)
        p_next, q_next = fstep(pp, p, qp, q, src_wavelet[k])
        pp, p, qp, q = p, p_next, q, q_next
    # ḡ_{k-1} aligned to reverse step k (rec_k samples p_{k+1})
    dd_shift = torch.cat([torch.zeros_like(dd[:1]), dd[:-1]])
    ap1 = inject(dd[-1])
    aq1, ebp1, ebq1, gC, gah, gav = (zeros() for _ in range(6))
    for k in range(nt - 1, -1, -1):
        (pq, psv), (qq, qsv) = hist[k]
        hist[k] = None
        p_k, q_k = dec(pq, psv), dec(qq, qsv)
        ebp, ebq = ap1 * S, aq1 * S
        if og is not None:
            ebp, ebq = ebp * ig, ebq * ig
        lh_k = I(cuda_vti.lh(X(p_k), inv_dx2, order))
        dzz_k = I(cuda_vti.dzz(X(q_k), inv_dx2, order))
        gC = gC + ((ah * lh_k + av * dzz_k) * ebp + (av * lh_k + dzz_k) * ebq)
        gah = gah + (C * lh_k) * ebp
        gav = gav + C * (dzz_k * ebp + lh_k * ebq)
        ebp1s, ebq1s = (ebp1, ebq1) if og is None else (og * ebp1, og * ebq1)
        ebpx, ebqx = X(ebp), X(ebq)
        ap = (2.0 * ebp + I(cuda_vti.lh(Cx * ahx * ebpx, inv_dx2, order))
              + I(cuda_vti.lh(Cx * avx * ebqx, inv_dx2, order)) - ebp1s) + inject(dd_shift[k])
        aq = (2.0 * ebq + I(cuda_vti.dzz(Cx * avx * ebpx, inv_dx2, order))
              + I(cuda_vti.dzz(Cx * ebqx, inv_dx2, order))) - ebq1s
        ap1, aq1, ebp1, ebq1 = ap, aq, ebp, ebq
    return outer(gC, gah, gav)


def _propagate_vti_m(m, *args, **kw):
    """:func:`_propagate_vti` on a ``(c, ε, δ)`` :class:`BlockVector`."""
    return _propagate_vti(*m.blocks, *args, **kw)


def _adjoint_stored_vti_m(m, dd, *args, **kw):
    """:func:`_adjoint_stored_vti` on a ``(c, ε, δ)`` :class:`BlockVector`,
    returning the gradient as one."""
    return BlockVector(_adjoint_stored_vti(*m.blocks, dd, *args, **kw), m.space)


def vti_wave_propagator(
    grid_shape: Sequence[int],
    *,
    nt: int = 256,
    dt: float = 0.001,
    dx: float = 10.0,
    freq: float = 15.0,
    src_idx: int = 0,
    rcv_idx=None,
    sponge_width: int = 12,
    space_order: int = 2,
    remat_blocks: int = 1,
    fused=None,
    dtrec: Optional[float] = None,
    q=None,
    f0: Optional[float] = None,
    store_adjoint: Optional[str] = None,
    wavefield_sharding=None,
    dtype: torch.dtype = torch.float32,
    device: torch.device | str | None = None,
) -> Operator:
    """Three-parameter VTI forward modelling ``F: (c, ε, δ) → traces``.

    Domain: ``BlockSpace([grid, grid, grid])`` on ``device`` (vertical
    velocity and the Thomsen parameters); members are :class:`BlockVector`.
    Range: ``(ntrec, nrcv)`` traces of the p field. With ``ε = δ = 0`` the
    system reduces to :func:`wave_propagator`'s isotropic physics.
    ``fused``: ``None`` rides the kernels K8 (forward, tangent) and, with a
    stored adjoint, K9/K10 on a 3-D float32 grid on a CUDA card; ``True``
    insists; ``False`` takes the plain step. ``store_adjoint`` ∈ {None,
    "f32", "bf16", "int8"} switches the adjoint from autograd through the
    time loop to the stored two-field-history sweep
    (:func:`_adjoint_stored_vti`), which returns the ``(δc, δε, δδ)`` triple
    in one reverse pass. ``remat_blocks`` as for :func:`wave_propagator`.

    ``q=`` adds static Kosloff constant-Q friction to both fields (a scalar
    or a grid of quality factors at the reference frequency ``f0``, default
    the source ``freq``; a modelling parameter, not a block of the domain):
    the attenuating DenQ variant. No kernel takes friction fields, so a
    Q'ed propagator and its stored adjoint take the plain steps and
    ``fused=True`` raises.

    ``wavefield_sharding`` splits the grid as for :func:`wave_propagator`
    (every block of the domain is the rank's slab): both fields take the
    plain step on their halo-extended slabs, as in the JAX package, and
    ``fused=True`` raises.
    """
    grid_shape = tuple(int(s) for s in grid_shape)
    space_order = _check_space_order(space_order)
    _check_store(store_adjoint)
    ws = wavefield_sharding
    gsp = _sharded_grid(ws, grid_shape, dtype, space_order, fused, device)
    if fused and q is not None:
        raise ValueError(_NO_STATIC_Q["VTI"])
    if fused and not cuda_wave.fits_wave_kernel(grid_shape, dtype, space_order):
        raise ValueError("fused VTI step requires a 3-D float32 grid")
    dom = BlockSpace([gsp] * 3)
    friction = {} if q is None else _static_q(q, dt, float(freq if f0 is None else f0),
                                              grid_shape, dtype)
    return _single_shot_operator(
        dom, gsp, *_with_sharding(ws, _propagate_vti_m, _adjoint_stored_vti_m), nt=nt, dt=dt,
        dx=dx, freq=freq, src_idx=src_idx, rcv_idx=rcv_idx, dtrec=dtrec,
        store_adjoint=store_adjoint, fused=fused, order=space_order,
        remat_blocks=remat_blocks,
        boundary={"sponge": _make_sponge(grid_shape, sponge_width, dtype=dtype),
                  **friction})


def multishot_vti_wave_operator(
    grid_shape: Sequence[int],
    src_indices,
    *,
    nt: int = 128,
    dt: float = 0.001,
    dx: float = 10.0,
    freq: float = 15.0,
    rcv_idx=None,
    sponge_width: int = 12,
    space_order: int = 2,
    remat_blocks: int = 1,
    dtrec: Optional[float] = None,
    store_adjoint: Optional[str] = None,
    mesh=None,
    axis: str = "block",
    shot_map: str = "vmap",
    dtype: torch.dtype = torch.float32,
    device: torch.device | str | None = None,
) -> Operator:
    """Multi-shot VTI modelling ``F: (c, ε, δ) → (nshots, ntrec, nrcv)``
    through :func:`stacked_block_operator`, as :func:`multishot_wave_operator`
    does for the isotropic physics: ``shot_map="map"`` runs the shots one
    after another, each on the kernels K8/K9/K10 where they apply;
    ``"vmap"`` runs them as one batched plain program. The model is one
    :class:`BlockVector` shared by every shot; the adjoint returns the
    ``(δc, δε, δδ)`` triple summed over shots."""
    grid_shape = tuple(int(s) for s in grid_shape)
    space_order = _check_space_order(space_order)
    _check_store(store_adjoint)
    gsp = _multishot_grid(grid_shape, dtype, mesh, axis, device, space_order)
    dom = BlockSpace([gsp] * 3)
    return _multishot_operator(
        dom, gsp, _propagate_vti_m, _adjoint_stored_vti_m, src_indices,
        nt=nt, dt=dt, dx=dx, freq=freq, rcv_idx=rcv_idx, dtrec=dtrec,
        store_adjoint=store_adjoint, shot_map=shot_map, order=space_order,
        remat_blocks=remat_blocks, mesh=mesh, axis=axis,
        boundary={"sponge": _make_sponge(grid_shape, sponge_width, dtype=dtype)})


# ---------------------------------------------------------------------------
# TTI anisotropy: tilted transversely isotropic pseudo-acoustics, the VTI
# coupled system with its derivative operators rotated onto the symmetry
# axis. 3-D: n = (cosθ, sinθ·cosφ, sinθ·sinφ) in (z, y, x), model
# (c, ε, δ, θ, φ) on five blocks, V(u) = Σᵢ nᵢ²∂ᵢᵢu + Σ_{i<j} 2nᵢnⱼ∂ᵢⱼu and
# H = ∇² − V with explicit (1 − nᵢ²) and −2nᵢnⱼ coefficients
# (cuda_tti.h_of/v_of); 2-D: the tilt θ in the x-z plane, model (c, ε, δ, θ)
# on four blocks. θ = 0 reduces to the VTI system.
# ---------------------------------------------------------------------------


def _trig(fn, x):
    """``fn(x)`` (cos or sin) of a float32 tensor as a float64 result rounded
    to float32. Float32 cosines and sines are not correctly rounded on any
    of PyTorch's CPU kernels, JAX's or CUDA's (they differ by an ulp here and
    there); a float64 result rounded to float32 is the same on the CPU and
    the card, but for a value within a float64 error of a float32 rounding
    boundary."""
    return fn(x.double()).to(x.dtype) if x.dtype == torch.float32 else fn(x)


def _r16(x):
    """``x`` rounded to bfloat16 and back (``lax.reduce_precision(x, 8, 7)``),
    outside autodiff."""
    return x.detach().to(torch.bfloat16).to(x.dtype)


def _tti_coefficients(c, eps, delta, theta, phi, dt: float, dx: float,
                      coeff16: bool = False):
    """``(C, ah, av, nz, ny, nx, inv_dx2, inv_dx, av_raw, kc)`` of the 3-D
    TTI system: ``C = (c·c)·(dt·dt)``, ``ah = 1 + 2ε``, ``av = √(1 + 2δ)``
    (a float64 root rounded, as :func:`_vti_coefficients`), the axis
    ``(cosθ, sinθ·cosφ, sinθ·sinφ)`` (:func:`_trig`), ``1/dx²`` and ``1/dx``
    as 0-d tensors, the unrounded ``av_raw`` (the δ chain differentiates it)
    and ``kc``, the five fields the kernels stream. With ``coeff16`` the five
    fields are rounded to bfloat16 straight through: the primal is the
    rounded value, the tangent flows in float32 (``x + (r16(x) − x)`` with the
    difference detached), and ``kc`` holds the bfloat16 tensors themselves;
    otherwise ``kc`` is the five float32 fields."""
    C, ah, av_raw, inv_dx2 = _vti_coefficients(c, eps, delta, dt, dx)
    inv_dx = torch.tensor(1.0 / dx, dtype=c.dtype, device=c.device)
    st = _trig(torch.sin, theta)
    f5 = (ah, av_raw, _trig(torch.cos, theta), st * _trig(torch.cos, phi),
          st * _trig(torch.sin, phi))
    if coeff16:
        kc = tuple(x.detach().to(torch.bfloat16) for x in f5)
        f5 = tuple(x + (_r16(x) - x).detach() for x in f5)
    else:
        kc = f5
    return (C, *f5, inv_dx2, inv_dx, av_raw, kc)


class _PlainRuleStep(torch.autograd.Function):
    """A kernel step under autodiff whose tangent and backward are
    ``torch.func.jvp`` and ``torch.func.vjp`` of the plain step (the JAX
    rule's ``jax.jvp(xla_step, ...)``). A subclass saves its ``NPRIMALS``
    differentiable inputs first, in both ``save_for_backward`` and
    ``save_for_forward``, and ``_step(ctx, rest)`` rebuilds the plain step
    of those primals from what it saved after them (``rest``). The saved
    tensors are read once per rule: under a checkpointed segment each read
    unpacks them, and a second unpack is refused."""

    NPRIMALS: int

    @classmethod
    def jvp(cls, ctx, *tangents):
        saved = ctx.saved_tensors
        primals = saved[:cls.NPRIMALS]
        tans = tuple(torch.zeros_like(x) if t is None else t
                     for x, t in zip(primals, tangents))
        _, out = torch.func.jvp(cls._step(ctx, saved[cls.NPRIMALS:]), primals, tans)
        return out

    @classmethod
    def backward(cls, ctx, *gouts):
        saved = ctx.saved_tensors
        primals = saved[:cls.NPRIMALS]
        _, vjp = torch.func.vjp(cls._step(ctx, saved[cls.NPRIMALS:]), *primals)
        grads = vjp(gouts if len(gouts) > 1 else gouts[0])
        return grads + (None,) * (len(ctx.needs_input_grad) - cls.NPRIMALS)


class _TtiStep(_PlainRuleStep):
    """K11 under autodiff (the counterpart of the ``custom_jvp`` around the
    Pallas TTI step in ``jets_tpu/ops/wave.py``): the forward is the kernel
    on the streamed coefficient fields ``kc`` (float32 or bfloat16), writing
    fresh tensors; the tangent and the backward come from the plain step
    with respect to ``(p_prev, p, q_prev, q, C, ah, av, nz, ny, nx, s_t)``,
    the float32 fields equal to ``kc``."""

    NPRIMALS = 11

    @staticmethod
    def forward(pp, p, qp, q, C, ah, av, nz, ny, nx, s_t, ka, kb, kz, ky, kx, spz, sy,
                sx, inv_dx2, inv_dx, src, amp, order):
        return cuda_tti.fused_tti_step(pp, p, qp, q, C, ka, kb, kz, ky, kx, spz, sy, sx,
                                       inv_dx2, inv_dx, s_t, src, amp, order=order)

    @staticmethod
    def setup_context(ctx, inputs, output):
        primals = inputs[:11]
        spz, sy, sx, inv_dx2, inv_dx, src, amp, order = inputs[16:]
        ctx.save_for_backward(*primals, spz, sy, sx, inv_dx2, inv_dx, amp)
        ctx.save_for_forward(*primals, spz, sy, sx, inv_dx2, inv_dx, amp)
        ctx.src, ctx.order = src, order

    @staticmethod
    def _step(ctx, rest):
        spz, sy, sx, inv_dx2, inv_dx, amp = rest
        S = cuda_wave.sponge_product(spz, sy, sx)

        def step(pp, p, qp, q, C, ah, av, nz, ny, nx, s_t):
            mask = cuda_wave.source_mask(p.shape, ctx.src, amp)
            return cuda_tti.tti_plain(pp, p, qp, q, C, ah, av, nz, ny, nx, S, inv_dx2,
                                      inv_dx, s_t, mask, ctx.order)

        return step


def _tti_slab_step(sl, C, ah, av, nz, ny, nx, inv_dx2, inv_dx, amp, order, og=None,
                   ig=None):
    """:func:`_vti_slab_step` for the 3-D TTI step (:func:`cuda_tti.tti_plain`).
    One halo of ``order/2`` planes per sharded dimension is enough: every
    second derivative is one ``d2_axis`` and every mixed one (``_dij``) takes
    its two first derivatives along two different dimensions, the inner one
    at the outer one's halo points, whose planes the sequential exchange
    extended with the corners."""
    ce = tuple(sl.pad(t) for t in (C, ah, av, nz, ny, nx))
    mask = sl.mask(amp)
    fr = () if og is None else (sl.pad(sl.local(og)), sl.pad(sl.local(ig)))

    def step(pp, p, qp, q, s_t):
        pn, qn = cuda_tti.tti_plain(sl.pad(pp), sl.ext(p), sl.pad(qp), sl.ext(q), *ce,
                                    sl.S, inv_dx2, inv_dx, s_t, mask, order, *fr)
        return sl.interior(pn), sl.interior(qn)

    return step


def _propagate_tti3d(c, eps, delta, theta, phi, src_wavelet, src_idx, rcv_idx, *, dt,
                     dx, sponge, order: int = 2, fused=None, inplace: bool = False,
                     coeff16: bool = False, remat_blocks: int = 1, og=None, ig=None,
                     vmap_tape: Optional[bool] = None, wavefield_sharding=None):
    """Coupled 3-D TTI leapfrog; returns the p-field receiver traces
    ``(nt, nrcv)``. ``fused``, ``inplace``, ``remat_blocks``, ``vmap_tape`` and the
    static-Q factors ``og``, ``ig`` as for :func:`_propagate_vti`:
    on the kernel route the step is K11 on the streamed fields ``kc``, in
    place on sweeps no transform watches and inside :class:`_TtiStep`
    otherwise; the plain route is the JAX package's XLA step, tree for tree.
    ``wavefield_sharding`` as for :func:`_propagate_vti`, the step
    :func:`_tti_slab_step`."""
    shape, dtype, dev = c.shape, c.dtype, c.device
    C, ah, av, nz, ny, nx, inv_dx2, inv_dx, _, kc = _tti_coefficients(
        c, eps, delta, theta, phi, dt, dx, coeff16)
    amp = torch.tensor(dt * dt, dtype=dtype, device=dev)
    if wavefield_sharding is not None:
        sl = _slab_of(c, src_idx, rcv_idx, sponge, order, wavefield_sharding)
        tape = _records(c, eps, delta, theta, phi)
        step = _tti_slab_step(sl, C, ah, av, nz, ny, nx, inv_dx2, inv_dx, amp, order, og,
                              ig)
        return sl.sum(_field_loop(step, 2, shape, dtype, dev, src_wavelet, rcv_idx,
                                  inplace and not tape, remat_blocks, tape, sl.extract))
    kernel = _kernel_route(fused, c, sponge, order,
                           None if og is None else _NO_STATIC_Q["TTI"])
    tape = _records(c, eps, delta, theta, phi) if vmap_tape is None else vmap_tape
    inplace = inplace and not tape
    params = consts = ()

    if kernel:
        spz, sy, sx = _factors_1d(sponge)
        src = int(src_idx)
        if inplace:
            def step(pp, p, qp, q, s_t):
                return cuda_tti.fused_tti_step(pp, p, qp, q, C, *kc, spz, sy, sx,
                                               inv_dx2, inv_dx, s_t, src, amp,
                                               order=order, out=(pp, qp))
        else:
            def step(pp, p, qp, q, s_t):
                return _TtiStep.apply(pp, p, qp, q, C, ah, av, nz, ny, nx, s_t, *kc,
                                      spz, sy, sx, inv_dx2, inv_dx, src, amp, order)
    else:
        S = _sponge_full(sponge)
        mask = cuda_wave.source_mask(shape, src_idx, amp)

        def step(pp, p, qp, q, s_t, C, ah, av, nz, ny, nx, S, inv_dx2, inv_dx, mask,
                 *ogig):
            return cuda_tti.tti_plain(pp, p, qp, q, C, ah, av, nz, ny, nx, S, inv_dx2,
                                      inv_dx, s_t, mask, order, *ogig)

        params = (C, ah, av, nz, ny, nx)
        consts = (S, inv_dx2, inv_dx, mask, *_friction(og, ig))
    return _field_loop(step, 2, shape, dtype, dev, src_wavelet, rcv_idx, inplace,
                       remat_blocks, tape, None, params, consts, vmap_tape is not None)


def _propagate_tti(c, eps, delta, theta, src_wavelet, src_idx, rcv_idx, *, dt, dx,
                   sponge, order: int = 2, fused=None, inplace: bool = False,
                   remat_blocks: int = 1, og=None, ig=None,
                   vmap_tape: Optional[bool] = None):
    """The 2-D tilt (θ in the x-z plane): ``H = cos²θ·∂xx + sin²θ·∂zz −
    sin2θ·∂xz``, ``V = sin²θ·∂xx + cos²θ·∂zz + sin2θ·∂xz`` with ``∂xz =
    d1_x(d1_z(u))``, with the static-Q factors ``og``, ``ig`` as
    :func:`_propagate_vti` takes them; plain only, as in the JAX package
    (``fused`` and ``inplace`` are accepted and ignored). Returns the
    p-field traces."""
    shape, dtype, dev = c.shape, c.dtype, c.device
    C, ah, av, inv_dx2 = _vti_coefficients(c, eps, delta, dt, dx)
    inv_dx = torch.tensor(1.0 / dx, dtype=dtype, device=dev)
    ct, stt = _trig(torch.cos, theta), _trig(torch.sin, theta)
    ct2, st2, s2t = ct * ct, stt * stt, _trig(torch.sin, 2.0 * theta)
    amp = torch.tensor(dt * dt, dtype=dtype, device=dev)
    mask = cuda_wave.source_mask(shape, src_idx, amp)

    def step(pp, p, qp, q, s_t, C, ah, av, ct2, st2, s2t, sponge, inv_dx2, inv_dx, mask,
             *ogig):
        def dxz(u):
            return d1_axis(d1_axis(u, 0, inv_dx, order), 1, inv_dx, order)

        pxx, pzz = d2_axis(p, 1, inv_dx2, order), d2_axis(p, 0, inv_dx2, order)
        qxx, qzz = d2_axis(q, 1, inv_dx2, order), d2_axis(q, 0, inv_dx2, order)
        Hp = ct2 * pxx + st2 * pzz - s2t * dxz(p)
        Vq = st2 * qxx + ct2 * qzz + s2t * dxz(q)
        if not ogig:
            e_p = (2.0 * p - pp) + C * (ah * Hp + av * Vq)
            e_q = (2.0 * q - qp) + C * (av * Hp + Vq)
        else:
            og, ig = ogig
            e_p = ((2.0 * p - og * pp) + C * (ah * Hp + av * Vq)) * ig
            e_q = ((2.0 * q - og * qp) + C * (av * Hp + Vq)) * ig
        s = s_t * mask
        return e_p * sponge + s, e_q * sponge + s

    tape = _records(c, eps, delta, theta) if vmap_tape is None else vmap_tape
    return _field_loop(step, 2, shape, dtype, dev, src_wavelet, rcv_idx, False,
                       remat_blocks, tape, None, (C, ah, av, ct2, st2, s2t),
                       (sponge, inv_dx2, inv_dx, mask, *_friction(og, ig)),
                       vmap_tape is not None)


def _adjoint_stored_tti3d(c, eps, delta, theta, phi, dd, src_wavelet, src_idx, rcv_idx,
                          *, dt, dx, sponge, order: int = 2, store: str = "int8",
                          fused=None, coeff16: bool = False, og=None, ig=None,
                          wavefield_sharding=None):
    """Adjoint-state gradient ``(∂F/∂(c, ε, δ, θ, φ))ᵀ dd`` of the 3-D TTI
    system over a stored two-field forward history, encoded per snapshot
    (``store``: f32, bf16, int8). Every rotated derivative is self-adjoint
    under the zero boundary, so with ``ēp = S⊙ap₊``, ``ēq = S⊙aq₊``::

        ap = Pᵀḡ + 2ēp + Hᵀ(C·ah·ēp + C·av·ēq) − ēp₊
        aq =       2ēq + Vᵀ(C·av·ēp + C·ēq)     − ēq₊

    and the six accumulators of :func:`cuda_tti.fused_tti_adjoint_step_torch`;
    the outer chain gives ``gc = gC·(2c)·dt²``, ``gε = 2·gah``,
    ``gδ = gav/av_raw`` (the unrounded root) and, through
    ``n = (cosθ, sinθcosφ, sinθsinφ)``, ``gθ = −sinθ·gnz + cosθcosφ·gny +
    cosθsinφ·gnx`` and ``gφ = −sinθsinφ·gny + sinθcosφ·gnx``. On the kernel
    route the forward sweep is K12 (in place; it encodes each input snapshot
    at the scale the previous step's partial maxima give) and the reverse
    sweep K13 (``ap``/``aq`` into the ``ap₊₊``/``aq₊₊`` buffers, the
    accumulators in place) followed by the receiver injection
    ``index_add_``. The plain route is the JAX package's XLA sweeps
    (``fstep``/``bstep``), tree for tree. ``coeff16`` applies the forward's
    straight-through bfloat16 rounding; the static-Q factors ``og``, ``ig``
    take both sweeps plain, as in :func:`_adjoint_stored_vti`. With
    ``wavefield_sharding`` both sweeps are plain on the rank's slab, as in
    :func:`_adjoint_stored_vti`: the reverse sweep exchanges the decoded
    ``p_k``, ``q_k`` and the two arguments ``w`` of ``Hᵀ``/``Vᵀ``, and holds
    the halos of ``nz, ny, nx`` (exchanged once), so each ``Σ D_d(κ_d·w)``
    is one exchange of ``w`` where exchanging each product ``κ_d·w`` would
    be six. Returns ``(gc, gε, gδ, gθ, gφ)``, the rank's slabs under a
    sharding."""
    shape, dtype, dev = c.shape, c.dtype, c.device
    size = math.prod(shape)
    nt = int(src_wavelet.shape[0])
    C, ah, av, nz, ny, nx, inv_dx2, inv_dx, av_raw, kc = _tti_coefficients(
        c, eps, delta, theta, phi, dt, dx, coeff16)
    amp = torch.tensor(dt * dt, dtype=dtype, device=dev)
    dd = dd.to(dtype)

    def zeros():
        return torch.zeros(shape, dtype=dtype, device=dev)

    def inject(row):
        return torch.zeros(size, dtype=dtype, device=dev).index_add(
            0, rcv_idx, row).reshape(shape)

    def outer(gC, gah, gav, gnz, gny, gnx):
        cth, sth = _trig(torch.cos, theta), _trig(torch.sin, theta)
        cph, sph = _trig(torch.cos, phi), _trig(torch.sin, phi)
        return (gC * (2.0 * c) * torch.tensor(dt * dt, dtype=dtype, device=dev),
                2.0 * gah, gav / av_raw,
                -sth * gnz + (cth * cph) * gny + (cth * sph) * gnx,
                (-sth * sph) * gny + (sth * cph) * gnx)

    if wavefield_sharding is None and _kernel_route(
            fused, c, sponge, order, None if og is None else _NO_STATIC_Q["TTI"]):
        spz, sy, sx = _factors_1d(sponge)
        src = int(src_idx)
        pp, p, qp, q = (zeros() for _ in range(4))
        scale = torch.full((2,), cuda_vti.SCALE_FLOOR, dtype=dtype, device=dev)
        one = torch.ones(2, dtype=dtype, device=dev)
        ph, qh, scales = [], [], []
        for k in range(nt):
            qf = torch.full_like(scale, 127.0) / scale if store == "int8" else one
            p_next, q_next, p_enc, q_enc, nxt = cuda_tti.fused_tti_hist_step(
                pp, p, qp, q, C, *kc, spz, sy, sx, inv_dx2, inv_dx, src_wavelet[k], src,
                amp, qf[0], qf[1], store=store, order=order, out=(pp, qp))
            ph.append(p_enc)
            qh.append(q_enc)
            scales.append(scale)
            scale = nxt  # snapshot k+1's scales, from this step's partial maxima
            pp, p, qp, q = p, p_next, q, q_next
        del pp, p, qp, q, p_next, q_next  # the history holds what the sweep needs
        decs = (true_div(torch.stack(scales), 127.0) if store == "int8"
                else torch.ones((nt, 2), dtype=dtype, device=dev))
        ap1 = inject(dd[-1])
        aq1, ap2, aq2 = (zeros() for _ in range(3))
        accs = tuple(zeros() for _ in range(6))
        for k in range(nt - 1, -1, -1):
            ap, aq, *accs = cuda_tti.fused_tti_adjoint_step(
                ap1, aq1, ap2, aq2, *accs, C, *kc, ph[k], qh[k], decs[k, 0], decs[k, 1],
                inv_dx2, inv_dx, spz, sy, sx, order=order, inplace=True)
            ph[k] = qh[k] = None  # release the snapshots as the sweep passes them
            if k > 0:  # ḡ_{k-1}; the JAX sweep adds a zero row at k = 0
                ap.reshape(-1).index_add_(0, rcv_idx, dd[k - 1])
            ap1, aq1, ap2, aq2 = ap, aq, ap1, aq1
        return outer(*accs)

    cf = cuda_tti.directions(nz, ny, nx)
    sl = _slab_of(c, src_idx, rcv_idx, sponge, order, wavefield_sharding)
    if sl is None:
        S = _sponge_full(sponge)
        mask = cuda_wave.source_mask(shape, src_idx, amp)
        enc, dec = _store_codec(store, dtype)
        X = I = _same
        cfx = cf

        def fstep(pp, p, qp, q, s_t):
            return cuda_tti.tti_plain(pp, p, qp, q, C, ah, av, nz, ny, nx, S, inv_dx2,
                                      inv_dx, s_t, mask, order, og, ig)
    else:
        S, (enc, dec), inject = sl.interior(sl.S), sl.codec(store, dtype), sl.inject
        fstep = _tti_slab_step(sl, C, ah, av, nz, ny, nx, inv_dx2, inv_dx, amp, order, og,
                               ig)
        og, ig = (None, None) if og is None else (sl.local(og), sl.local(ig))
        X, I = sl.ext, sl.interior
        cfx = cuda_tti.directions(X(nz), X(ny), X(nx))
    pp, p, qp, q = (zeros() for _ in range(4))
    hist = []
    for k in range(nt):
        hist.append((enc(p), enc(q)))  # history entry k holds (p_k, q_k)
        p_next, q_next = fstep(pp, p, qp, q, src_wavelet[k])
        pp, p, qp, q = p, p_next, q, q_next
    # ḡ_{k-1} aligned to reverse step k (rec_k samples p_{k+1})
    dd_shift = torch.cat([torch.zeros_like(dd[:1]), dd[:-1]])
    ap1 = inject(dd[-1])
    aq1, ebp1, ebq1 = (zeros() for _ in range(3))
    gC, gah, gav, gnz, gny, gnx = (zeros() for _ in range(6))
    for k in range(nt - 1, -1, -1):
        (pq, psv), (qq, qsv) = hist[k]
        hist[k] = None
        dp6 = tuple(map(I, cuda_tti.derivs(X(dec(pq, psv)), inv_dx2, inv_dx, order)))
        dq6 = tuple(map(I, cuda_tti.derivs(X(dec(qq, qsv)), inv_dx2, inv_dx, order)))
        ebp, ebq = ap1 * S, aq1 * S
        if og is not None:
            ebp, ebq = ebp * ig, ebq * ig
        Hp, Vq = cuda_tti.h_of(dp6, cf), cuda_tti.v_of(dq6, cf)
        gC = gC + ((ah * Hp + av * Vq) * ebp + (av * Hp + Vq) * ebq)
        gah = gah + (C * Hp) * ebp
        gav = gav + C * (Vq * ebp + Hp * ebq)
        dczz, dcyy, dcxx, dczy, dczx, dcyx = (
            C * ((av * q_d - ah * p_d) * ebp + (q_d - av * p_d) * ebq)
            for p_d, q_d in zip(dp6, dq6))
        gnz = gnz + (2.0 * nz * dczz + 2.0 * ny * dczy + 2.0 * nx * dczx)
        gny = gny + (2.0 * ny * dcyy + 2.0 * nz * dczy + 2.0 * nx * dcyx)
        gnx = gnx + (2.0 * nx * dcxx + 2.0 * nz * dczx + 2.0 * ny * dcyx)
        ebp1s, ebq1s = (ebp1, ebq1) if og is None else (og * ebp1, og * ebq1)
        ap = (2.0 * ebp + I(cuda_tti.ht(X(C * ah * ebp + C * av * ebq), cfx, inv_dx2,
                                        inv_dx, order)) - ebp1s) + inject(dd_shift[k])
        aq = (2.0 * ebq + I(cuda_tti.vt(X(C * av * ebp + C * ebq), cfx, inv_dx2, inv_dx,
                                        order))) - ebq1s
        ap1, aq1, ebp1, ebq1 = ap, aq, ebp, ebq
    return outer(gC, gah, gav, gnz, gny, gnx)


def _propagate_tti_m(m, *args, coeff16=False, **kw):
    """The 3-D (five blocks) or 2-D (four blocks) TTI propagator on a model
    :class:`BlockVector`."""
    if m.nblocks == 5:
        return _propagate_tti3d(*m.blocks, *args, coeff16=coeff16, **kw)
    return _propagate_tti(*m.blocks, *args, **kw)


def _adjoint_stored_tti3d_m(m, dd, *args, **kw):
    """:func:`_adjoint_stored_tti3d` on a ``(c, ε, δ, θ, φ)`` BlockVector,
    returning the gradient as one."""
    return BlockVector(_adjoint_stored_tti3d(*m.blocks, dd, *args, **kw), m.space)


def _check_tti(grid_shape, store_adjoint, what):
    if len(grid_shape) not in (2, 3):
        raise ValueError(f"{what} supports 2-D and 3-D grids")
    _check_store(store_adjoint)
    if store_adjoint is not None and len(grid_shape) != 3:
        raise ValueError(f"store_adjoint on the {what} is 3-D only (the 2-D tilt path "
                         "keeps the autodiff adjoint)")


def tti_wave_propagator(
    grid_shape: Sequence[int],
    *,
    nt: int = 256,
    dt: float = 0.001,
    dx: float = 10.0,
    freq: float = 15.0,
    src_idx: int = 0,
    rcv_idx=None,
    sponge_width: int = 12,
    space_order: int = 2,
    remat_blocks: int = 1,
    fused=None,
    dtrec: Optional[float] = None,
    q=None,
    f0: Optional[float] = None,
    coeff_dtype=None,
    store_adjoint: Optional[str] = None,
    wavefield_sharding=None,
    dtype: torch.dtype = torch.float32,
    device: torch.device | str | None = None,
) -> Operator:
    """TTI forward modelling. 3-D: ``F: (c, ε, δ, θ, φ) → traces`` on
    ``BlockSpace([grid] * 5)`` (the symmetry axis ``n = (cosθ, sinθcosφ,
    sinθsinφ)``, angles in radians); 2-D: ``F: (c, ε, δ, θ) → traces`` on
    four blocks, the tilt θ in the x-z plane. The domain lives on ``device``
    (``None``: the CUDA card). ``θ = 0`` reduces to
    :func:`vti_wave_propagator`. Conditionally stable like every
    pseudo-acoustic TTI scheme: keep ``ε ≥ δ`` and the angle fields smooth.

    ``fused``: ``None`` rides the kernels K11 (forward, tangent) and, with a
    stored adjoint, K12/K13 on a 3-D float32 grid on a CUDA card; ``True``
    insists; ``False`` takes the plain step (2-D is plain only).
    ``coeff_dtype=torch.bfloat16`` (3-D only) rounds the five coefficient
    fields ``1+2ε, √(1+2δ), nz, ny, nx`` to bfloat16 for both routes, which
    the kernels stream at half width; tangents and gradients flow through
    the rounding in float32. ``store_adjoint`` ∈ {None, "f32", "bf16",
    "int8"} (3-D only) switches the adjoint from autograd through the time
    loop to the stored two-field-history sweep
    (:func:`_adjoint_stored_tti3d`), which returns ``(δc, δε, δδ, δθ, δφ)``
    in one reverse pass. ``remat_blocks`` as for :func:`wave_propagator`.
    ``q=``/``f0`` add static Kosloff friction as for
    :func:`vti_wave_propagator` (plain steps; ``fused=True`` raises); it
    composes with the stored adjoint, ``dtrec`` and bfloat16 coefficients.
    ``wavefield_sharding`` (3-D only; ``ValueError`` "3-D only" otherwise)
    splits the grid as for :func:`vti_wave_propagator`: the plain step on the
    halo-extended slabs, ``fused=True`` refused.
    """
    grid_shape = tuple(int(s) for s in grid_shape)
    space_order = _check_space_order(space_order)
    _check_tti(grid_shape, store_adjoint, "TTI propagator")
    three_d = len(grid_shape) == 3
    if coeff_dtype is not None and coeff_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError("coeff_dtype must be float32 or bfloat16")
    coeff16 = coeff_dtype == torch.bfloat16
    if coeff16 and not three_d:
        raise ValueError("bf16 coefficient mode is 3-D only")
    ws = wavefield_sharding
    if fused and ws is not None:
        raise ValueError("wavefield_sharding rides the plain step; fused=True is "
                         "incompatible")
    if ws is not None and not three_d:
        raise ValueError("wavefield_sharding on TTI is 3-D only")
    gsp = _sharded_grid(ws, grid_shape, dtype, space_order, fused, device)
    if fused and q is not None:
        raise ValueError(_NO_STATIC_Q["TTI"])
    if fused and not (three_d and cuda_wave.fits_wave_kernel(grid_shape, dtype,
                                                              space_order)):
        raise ValueError("fused TTI step requires a 3-D float32 grid")
    dom = BlockSpace([gsp] * (5 if three_d else 4))
    friction = {} if q is None else _static_q(q, dt, float(freq if f0 is None else f0),
                                              grid_shape, dtype)
    return _single_shot_operator(
        dom, gsp, *_with_sharding(ws, functools.partial(_propagate_tti_m, coeff16=coeff16),
                                  functools.partial(_adjoint_stored_tti3d_m, coeff16=coeff16)),
        nt=nt, dt=dt,
        dx=dx, freq=freq, src_idx=src_idx, rcv_idx=rcv_idx, dtrec=dtrec,
        store_adjoint=store_adjoint, fused=fused, order=space_order,
        remat_blocks=remat_blocks,
        boundary={"sponge": _make_sponge(grid_shape, sponge_width, dtype=dtype),
                  **friction})


def multishot_tti_wave_operator(
    grid_shape: Sequence[int],
    src_indices,
    *,
    nt: int = 128,
    dt: float = 0.001,
    dx: float = 10.0,
    freq: float = 15.0,
    rcv_idx=None,
    sponge_width: int = 12,
    space_order: int = 2,
    remat_blocks: int = 1,
    dtrec: Optional[float] = None,
    store_adjoint: Optional[str] = None,
    mesh=None,
    axis: str = "block",
    shot_map: str = "vmap",
    dtype: torch.dtype = torch.float32,
    device: torch.device | str | None = None,
) -> Operator:
    """Multi-shot TTI modelling ``F: (c, ε, δ, θ[, φ]) → (nshots, ntrec,
    nrcv)`` through :func:`stacked_block_operator`, as
    :func:`multishot_vti_wave_operator` does for VTI: ``shot_map="map"`` runs
    the shots one after another, each on the kernels K11/K12/K13 where they
    apply; ``"vmap"`` runs them as one batched plain program. The model is
    one :class:`BlockVector` shared by every shot; the stored adjoint (3-D
    only) returns the five-block gradient summed over shots."""
    grid_shape = tuple(int(s) for s in grid_shape)
    space_order = _check_space_order(space_order)
    _check_tti(grid_shape, store_adjoint, "TTI multishot")
    gsp = _multishot_grid(grid_shape, dtype, mesh, axis, device, space_order)
    if isinstance(gsp, ShardedSpace) and len(grid_shape) != 3:
        raise ValueError("wavefield_sharding on TTI is 3-D only")
    dom = BlockSpace([gsp] * (5 if len(grid_shape) == 3 else 4))
    return _multishot_operator(
        dom, gsp, _propagate_tti_m, _adjoint_stored_tti3d_m, src_indices,
        nt=nt, dt=dt, dx=dx, freq=freq, rcv_idx=rcv_idx, dtrec=dtrec,
        store_adjoint=store_adjoint, shot_map=shot_map, order=space_order,
        remat_blocks=remat_blocks, mesh=mesh, axis=axis,
        boundary={"sponge": _make_sponge(grid_shape, sponge_width, dtype=dtype)})


# ---------------------------------------------------------------------------
# Visco-acoustic Q attenuation: Kosloff constant-Q friction with rate
# gamma(x) = pi·f0/Q(x), u_tt + 2·gamma·u_t = c²·lap(u) + s, discretized with
# the centred-in-time damping term (g = gamma·dt):
#     u+ = (((2u − (1−g)·u−) + c²dt²·L(u))·(1/(1+g)))·S + s·mask
# Model (c, Q) on a BlockSpace([grid, grid]). Q → ∞ (g = 0) is the lossless
# leapfrog, bit for bit.
# ---------------------------------------------------------------------------


def _q_friction(q, dt: float, f0: float):
    """``g = (π·f0·dt)/Q`` as a true division (the dividend a 0-d tensor:
    PyTorch turns ``float / tensor`` into a multiply by the reciprocal,
    which rounds differently from JAX's division)."""
    return torch.tensor(math.pi * f0 * dt, dtype=q.dtype, device=q.device) / q


class _QStep(_PlainRuleStep):
    """K14 under autodiff (the counterpart of the ``custom_jvp`` around the
    Pallas Q step in ``jets_tpu/ops/wave.py``): the forward is the kernel on
    the friction field ``kg`` (float32 or bfloat16), writing a fresh tensor;
    the tangent and the backward come from the plain step with respect to
    ``(u_prev, u, c²dt², g, s_t)``, ``g`` the float32 field equal to
    ``kg``."""

    NPRIMALS = 5

    @staticmethod
    def forward(up, u, c2, g, s_t, kg, spz, sy, sx, src, amp, order):
        return cuda_wave.fused_q_step(up, u, c2, kg, spz, sy, sx, s_t, src, amp,
                                      order=order)

    @staticmethod
    def setup_context(ctx, inputs, output):
        primals = inputs[:5]
        spz, sy, sx, src, amp, order = inputs[6:]
        ctx.save_for_backward(*primals, spz, sy, sx, amp)
        ctx.save_for_forward(*primals, spz, sy, sx, amp)
        ctx.src, ctx.order = src, order

    @staticmethod
    def _step(ctx, rest):
        spz, sy, sx, amp = rest
        S = cuda_wave.sponge_product(spz, sy, sx)

        def step(up, u, c2, g, s_t):
            mask = cuda_wave.source_mask(u.shape, ctx.src, amp)
            return cuda_wave.q_plain(up, u, c2, 1.0 - g, 1.0 / (1.0 + g), S, s_t, mask,
                                     ctx.order)

        return step


def _propagate_q(c, q, src_wavelet, src_idx, rcv_idx, *, dt, dx, f0, sponge,
                 order: int = 2, fused=None, inplace: bool = False,
                 coeff16: bool = False, remat_blocks: int = 1,
                 vmap_tape: Optional[bool] = None):
    """Leapfrog with Kosloff constant-Q friction; returns the receiver
    traces ``(nt, nrcv)``. ``fused``, ``inplace``, ``remat_blocks`` and
    ``vmap_tape`` as for :func:`_propagate`: on the kernel route (a 3-D
    float32 grid on a CUDA card, with either g width) the step is K14, in
    place on sweeps no transform watches and inside :class:`_QStep`
    otherwise; 2-D grids and ``fused=False`` take the plain step (the JAX
    package's XLA step, tree for tree, with its full-grid ``1 − g`` and
    ``1/(1 + g)`` handed to the loop beside ``c²dt²`` as the model's
    coefficients, as :func:`_propagate`'s plain step hands it). With ``coeff16``
    the friction field is rounded to bfloat16 straight through (the primal
    is the rounded value, the tangent flows in float32) and K14 streams the
    bfloat16 field itself."""
    shape, dtype, dev = c.shape, c.dtype, c.device
    c2dt2 = _c2dt2(c, dt, dx)
    g = _q_friction(q, dt, f0)
    kg = g
    if coeff16:
        kg = g.detach().to(torch.bfloat16)
        g = g + (_r16(g) - g).detach()
    amp = torch.tensor(dt * dt, dtype=dtype, device=dev)
    kernel = _kernel_route(fused, c, sponge, order)
    tape = _records(c, q) if vmap_tape is None else vmap_tape
    inplace = inplace and not tape
    params = consts = ()

    if kernel:
        spz, sy, sx = _factors_1d(sponge)
        src = int(src_idx)
        if inplace:
            def step(up, uu, s_t):
                return cuda_wave.fused_q_step(up, uu, c2dt2, kg, spz, sy, sx, s_t, src,
                                              amp, order=order, out=up)
        else:
            def step(up, uu, s_t):
                return _QStep.apply(up, uu, c2dt2, g, s_t, kg, spz, sy, sx, src, amp,
                                    order)
    else:
        S = _sponge_full(sponge)
        mask = cuda_wave.source_mask(shape, src_idx, amp)

        def step(up, uu, s_t, c2, om1g, inv1pg, S, mask):
            return cuda_wave.q_plain(up, uu, c2, om1g, inv1pg, S, s_t, mask, order)

        params, consts = (c2dt2, 1.0 - g, 1.0 / (1.0 + g)), (S, mask)
    return _field_loop(step, 1, shape, dtype, dev, src_wavelet, rcv_idx, inplace,
                       remat_blocks, tape, None, params, consts, vmap_tape is not None)


def _adjoint_stored_q(c, qf, dd, src_wavelet, src_idx, rcv_idx, *, dt, dx, f0, sponge,
                      order: int = 2, store: str = "int8", fused=None,
                      coeff16: bool = False):
    """Adjoint-state gradient ``(∂F/∂(c, Q))ᵀ dd`` of the constant-Q physics
    over a stored, encoded forward history (``store``: f32, bf16, int8): the
    transpose of :func:`_propagate_q`'s friction recurrence, hand-derived in
    the JAX package. The friction is diagonal, so with ``og = 1 − g``,
    ``ig = 1/(1 + g)``, ``C = c²dt²/dx²``, ``sē_k = S⊙a_{k+1}``, ``ē_k =
    ig⊙sē_k``::

        a_k  = Pᵀḡ + 2ē_k + L(C·ē_k) − og·ē_{k+1}
        gC  += L(u_k)⊙ē_k
        gig += sē_k·(2u_k + C·L(u_k)) − og·u_k·sē_{k+1}
        gog += −u_k·ē_{k+1}

    then ``gc = gC·2c·dt²/dx²``, ``gg = −gog − ig²·gig`` and ``gQ =
    −gg·g/Q`` with the unrounded ``g``. With ``coeff16`` the sweeps use the
    bfloat16-rounded ``g``, as the forward does. A reverse step carries
    ``(a_{k+1}, a_{k+2})`` and forms ``sē`` and ``ē`` of both from them
    (:func:`cuda_wave.q_adjoint_plain`'s tree). On the kernel route (a 3-D
    float32 grid on a CUDA card) the forward sweep that writes the history
    is K14 (in place, except for an f32 history, which keeps the fields
    themselves) and the reverse sweep K15 (``a_k`` into ``a_{k+2}``'s
    buffer, ``gC``, ``gig``, ``gog`` in place), where no autograd tape
    records ``c``, ``Q`` or ``dd`` (K15 has no backward: a taped call
    reverses with the plain step); 2-D grids and ``fused=False`` take the
    plain steps, the same trees, so the routes agree bit for bit (the JAX
    package has no reverse-Q kernel: its sweep is XLA). The receiver
    injection is an ``index_add_``. The forward sweep is a span
    ``sweep.history``, the reverse one a span ``sweep.reverse``, both with
    ``physics="q"``, and each counts its steps (``steps.history``,
    ``steps.reverse``). Returns ``(gc, gQ)``."""
    shape, dtype, dev = c.shape, c.dtype, c.device
    nt = int(src_wavelet.shape[0])
    C = _c2dt2(c, dt, dx)
    g_raw = _q_friction(qf, dt, f0)
    g = _r16(g_raw) if coeff16 else g_raw
    amp = torch.tensor(dt * dt, dtype=dtype, device=dev)
    enc, dec = _store_codec(store, dtype)
    dd = dd.to(dtype)

    def zeros():
        return torch.zeros(shape, dtype=dtype, device=dev)

    kernel = _kernel_route(fused, c, sponge, order)
    k15 = kernel and not _records(c, qf, dd)
    if not k15:
        ig, og = 1.0 / (1.0 + g), 1.0 - g
        S = _sponge_full(sponge)
    if kernel:
        spz, sy, sx = _factors_1d(sponge)
        src = int(src_idx)
        kg = g.to(torch.bfloat16) if coeff16 else g

        def step(up, uu, s_t):
            return cuda_wave.fused_q_step(up, uu, C, kg, spz, sy, sx, s_t, src, amp,
                                          order=order, out=None if store == "f32" else up)
    else:
        mask = cuda_wave.source_mask(shape, src_idx, amp)

        def step(up, uu, s_t):
            return cuda_wave.q_plain(up, uu, C, og, ig, S, s_t, mask, order)

    if k15:
        def rev(a1, a2, gC, gig, gog, q, sc):
            return cuda_wave.fused_q_adjoint_step(a1, a2, gC, gig, gog, C, kg, q, sc, spz,
                                                  sy, sx, order=order, inplace=True)
    else:
        def rev(a1, a2, gC, gig, gog, q, sc):
            return cuda_wave.q_adjoint_plain(a1, a2, gC, gig, gog, C, og, ig, S, dec(q, sc),
                                             order)

    hist, scales = [], []
    count("steps.history", nt)
    count("steps.reverse", nt)
    with span("sweep.history", physics="q"):
        u_prev, u = zeros(), zeros()
        for k in range(nt):
            q, s = enc(u)  # history entry k holds u_k
            hist.append(q)
            scales.append(s)
            u_next = step(u_prev, u, src_wavelet[k])
            u_prev, u = u, u_next
        del u_prev, u, u_next  # the history holds what the reverse sweep needs
    with span("sweep.reverse", physics="q"):
        if k15:  # K15 decodes q·sc itself: the int8 scales divided by 127 at once
            scales = (true_div(torch.stack(scales), 127.0) if store == "int8"
                      else torch.ones(nt, dtype=dtype, device=dev))
        # out of place: under vmap the zeros are not batched and the row is
        a1 = zeros().reshape(-1).index_add(0, rcv_idx, dd[-1]).reshape(shape)
        a2, gC, gig, gog = (zeros() for _ in range(4))
        for k in range(nt - 1, -1, -1):
            core, gC, gig, gog = rev(a1, a2, gC, gig, gog, hist[k], scales[k])
            hist[k] = None  # release the snapshot as the sweep passes it
            if k > 0:  # ḡ_{k-1}; the JAX sweep adds a zero row at k = 0
                core.reshape(-1).index_add_(0, rcv_idx, dd[k - 1])
            a1, a2 = core, a1
    gc = gC * (2.0 * c) * torch.tensor((dt * dt) / (dx * dx), dtype=dtype, device=dev)
    if k15:
        ig = 1.0 / (1.0 + g)
    gg = -gog - (ig * ig) * gig
    return gc, -gg * (g_raw / qf)


def _propagate_q_m(m, *args, **kw):
    """:func:`_propagate_q` on a ``(c, Q)`` :class:`BlockVector`."""
    return _propagate_q(*m.blocks, *args, **kw)


def _adjoint_stored_q_m(m, dd, *args, **kw):
    """:func:`_adjoint_stored_q` on a ``(c, Q)`` :class:`BlockVector`,
    returning the gradient as one."""
    return BlockVector(_adjoint_stored_q(*m.blocks, dd, *args, **kw), m.space)


def _q_coeff16(coeff_dtype) -> bool:
    """Whether the friction field is rounded to bfloat16 (``coeff_dtype``
    None or float32: no)."""
    if coeff_dtype is not None and coeff_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError("coeff_dtype must be float32 or bfloat16")
    return coeff_dtype == torch.bfloat16


def _q_sweeps(freq: float, f0, coeff16: bool):
    """``(propagate, adjoint)`` of the Q operators on ``(c, Q)`` members, at
    the reference frequency ``f0`` (default: the source ``freq``)."""
    f0 = float(freq if f0 is None else f0)
    return (functools.partial(_propagate_q_m, f0=f0, coeff16=coeff16),
            functools.partial(_adjoint_stored_q_m, f0=f0, coeff16=coeff16))


def q_wave_propagator(
    grid_shape: Sequence[int],
    *,
    nt: int = 256,
    dt: float = 0.001,
    dx: float = 10.0,
    freq: float = 15.0,
    f0: Optional[float] = None,
    src_idx: int = 0,
    rcv_idx=None,
    sponge_width: int = 12,
    space_order: int = 2,
    remat_blocks: int = 1,
    free_surface: bool = False,
    fused=None,
    dtrec: Optional[float] = None,
    coeff_dtype=None,
    store_adjoint: Optional[str] = None,
    dtype: torch.dtype = torch.float32,
    device: torch.device | str | None = None,
) -> Operator:
    """Two-parameter visco-acoustic forward modelling ``F: (c, Q) → traces``
    (the attenuation physics of JetPackWaveFD's DenQ propagators).

    Domain: ``BlockSpace([grid, grid])`` on ``device`` (``None``: the CUDA
    card) holding the velocity ``c`` and the quality factor ``Q``
    (dimensionless; smaller Q absorbs more); members are
    :class:`BlockVector`. ``f0`` is the reference frequency of Q (default:
    the source ``freq``). Range: ``(ntrec, nrcv)`` traces. ``Q → ∞`` is
    :func:`wave_propagator`'s physics, bit for bit.

    ``fused``: ``None`` rides the kernel K14 (forward, tangent, and the
    forward sweep of the stored adjoint) and K15 (the stored adjoint's
    reverse sweep, where no autograd tape records the model) on a 3-D
    float32 grid on a CUDA card, with either friction width; ``True``
    insists; ``False`` takes the plain steps (2-D is plain only). ``coeff_dtype=torch.bfloat16`` rounds
    the friction field ``g = π·f0·dt/Q`` to bfloat16 for both routes, which
    K14 streams at half width; tangents and gradients flow through the
    rounding in float32. ``store_adjoint`` ∈ {None, "f32", "bf16", "int8"}
    switches the adjoint from autograd through the time loop to the
    stored-history sweep (:func:`_adjoint_stored_q`), which returns the
    ``(δc, δQ)`` pair. ``remat_blocks`` as for :func:`wave_propagator`.
    ``free_surface=True`` leaves the top edge of axis 0 undamped, as for
    :func:`multishot_wave_operator`."""
    grid_shape = tuple(int(s) for s in grid_shape)
    space_order = _check_space_order(space_order)
    _check_store(store_adjoint)
    coeff16 = _q_coeff16(coeff_dtype)
    if fused and not cuda_wave.fits_wave_kernel(grid_shape, dtype, space_order):
        raise ValueError("fused Q step requires a 3-D float32 grid")
    gsp = Space(grid_shape, dtype, device)
    return _single_shot_operator(
        BlockSpace([gsp, gsp]), gsp, *_q_sweeps(freq, f0, coeff16), nt=nt, dt=dt,
        dx=dx, freq=freq, src_idx=src_idx, rcv_idx=rcv_idx, dtrec=dtrec,
        store_adjoint=store_adjoint, fused=fused, order=space_order,
        remat_blocks=remat_blocks,
        boundary={"sponge": _make_sponge(grid_shape, sponge_width,
                                         free_surface=free_surface, dtype=dtype)})


def multishot_q_wave_operator(
    grid_shape: Sequence[int],
    src_indices,
    *,
    nt: int = 128,
    dt: float = 0.001,
    dx: float = 10.0,
    freq: float = 15.0,
    f0: Optional[float] = None,
    rcv_idx=None,
    sponge_width: int = 12,
    space_order: int = 2,
    window_corners=None,
    window_shape: Optional[Sequence[int]] = None,
    dtrec: Optional[float] = None,
    store_adjoint: Optional[str] = None,
    free_surface: bool = False,
    coeff_dtype=None,
    shot_map: str = "vmap",
    dtype: torch.dtype = torch.float32,
    device: torch.device | str | None = None,
) -> Operator:
    """Multi-shot visco-acoustic modelling ``F: (c, Q) → (nshots, ntrec,
    nrcv)`` through :func:`stacked_block_operator`, as
    :func:`multishot_wave_operator` does for the isotropic physics and with
    the same windows and boundaries. The model is one :class:`BlockVector`
    ``(c, Q)`` on ``BlockSpace([grid, grid])`` shared by every shot (``f0``
    and ``coeff_dtype`` as for :func:`q_wave_propagator`).
    ``shot_map="map"`` runs the shots one after another, each on the kernels
    where they apply (K14 in its sweeps and the stored adjoint's forward
    sweep, K15 in the reverse sweep); ``"vmap"`` runs them as one batched
    plain program. ``store_adjoint`` switches the per-shot adjoint to the
    stored-history sweep, which returns the ``(δc, δQ)`` pair; with
    ``window_shape``/``window_corners`` each shot propagates in its Ginsu
    window of both blocks and its pair is scatter-added into the full grid."""
    grid_shape = tuple(int(s) for s in grid_shape)
    space_order = _check_space_order(space_order)
    _check_store(store_adjoint)
    coeff16 = _q_coeff16(coeff_dtype)
    windows = _ginsu_windows(grid_shape, src_indices, window_shape, window_corners)
    prop_shape = grid_shape if windows is None else windows[0]
    gsp = Space(grid_shape, dtype, device)
    return _multishot_operator(
        BlockSpace([gsp, gsp]), gsp if windows is None else Space(prop_shape, dtype, gsp.device),
        *_q_sweeps(freq, f0, coeff16), src_indices, nt=nt, dt=dt, dx=dx, freq=freq,
        rcv_idx=rcv_idx, dtrec=dtrec, store_adjoint=store_adjoint, shot_map=shot_map,
        order=space_order, windows=windows,
        boundary={"sponge": _make_sponge(prop_shape, sponge_width,
                                         free_surface=free_surface, dtype=dtype)})


def with_wave_arrays(op: Operator, *, wavelet, sponge, src_idx, rcv_idx) -> Operator:
    """``op`` (from :func:`wave_propagator`, :func:`multishot_wave_operator`,
    their VTI and TTI counterparts or :func:`q_wave_propagator`, whose state
    keys are the same) with
    its wavelet, sponge, source and receiver indices replaced by the given
    arrays (numpy or tensors; ``sponge`` one array or a tuple of
    per-axis factors), moved to the operator's device and dtype. This
    carries a JAX wave operator's state across, so both packages run on the
    same wavelet and sponge even where ``exp`` rounds differently."""
    dev, dtype = op.dom.device, op.dom.dtype

    def arr(a):
        return torch.as_tensor(np.array(a)).to(device=dev, dtype=dtype)

    wav = arr(wavelet)
    sp = tuple(arr(f) for f in sponge) if isinstance(sponge, (tuple, list)) else arr(sponge)
    src = torch.as_tensor(np.array(src_idx), dtype=torch.int64)
    rcv = _index_tensor(rcv_idx, dev)
    st = op.jet.state
    if "sstate" in st:
        return with_state(op, sstate={**st["sstate"], "wavelet": wav, "sponge": sp,
                                      "rcv": rcv},
                          bstate={**st["bstate"], "src": src.reshape(-1)})
    return with_state(op, wavelet=wav, sponge=sp, src_idx=src.reshape(()),
                      rcv_idx=rcv)
