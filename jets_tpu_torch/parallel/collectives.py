"""Collectives with the autograd of the sharded operators (the port's
counterparts of ``lax.psum`` and ``lax.ppermute`` inside ``shard_map``).

* :class:`_SumReplicated` — ``all_reduce(SUM)`` of per-rank partials into a
  value that is the same on every rank (an adjoint's model, a trace row, an
  inner product). Its backward is the identity: the cotangent of a
  replicated output is already the same on every rank, and each rank pulls
  it back through its own partial only. ``torch.distributed.nn``'s
  ``all_reduce`` all-reduces the cotangent again and would count every
  rank's contribution ``n`` times — the double count the JAX package probes
  for in ``_pvary_transpose_psums``.
* :class:`_HaloExchange` — the ``hw`` boundary planes of a slab from each
  neighbour along one mesh axis, on any tensor dimension; edge ranks
  receive zeros, which is the global zero boundary. Its backward sends the halo cotangents back and
  adds them into the neighbours' boundary planes (the transpose of
  ``ppermute``); its tangent exchanges the tangent's planes.

Each takes the mesh axis (or axes) it works along: on a 2-D mesh a sum
over ``"block"`` meets the ranks of one column, a halo over ``"grid"`` the
neighbours of one row. Both are autograd Functions in the ``setup_context`` style, so they run
under :func:`torch.func.jvp` and ``torch.func.vjp``. The halo transport
follows the group's backend: ``batch_isend_irecv`` on device tensors with
NCCL and on CPU tensors with gloo; with gloo and CUDA tensors (gloo has no
CUDA send/recv) the planes are staged through pinned host buffers.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from ..utils.profiling import count, counters, span
from ..utils.tree import tmap

__all__ = ["sum_replicated", "max_replicated", "gather_blocks", "halo_exchange",
           "halo_transport", "halo_counts", "reset_halo_counts"]


def _all_reduce(x, op, mesh, axis=None):
    if mesh.axis_size(axis) > 1:
        dist.all_reduce(x, op=op, group=mesh.group(axis))
    return x


class _SumReplicated(torch.autograd.Function):
    @staticmethod
    def forward(x, mesh, axis):
        return _all_reduce(x.clone(), dist.ReduceOp.SUM, mesh, axis)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.mesh, ctx.axis = inputs[1], inputs[2]

    @staticmethod
    def backward(ctx, g):
        return g, None, None

    @staticmethod
    def jvp(ctx, dx, *_):
        return _all_reduce(dx.clone(), dist.ReduceOp.SUM, ctx.mesh, ctx.axis)


def sum_replicated(x, mesh, axis=None):
    """The sum over the ranks of ``mesh`` along ``axis`` (a mesh axis, a
    tuple of them, ``None``: all) of each rank's ``x`` (a tensor or a pytree
    such as a ``BlockVector``), the same on every rank of that group; its
    backward is the identity (:class:`_SumReplicated`)."""
    return tmap(lambda t: _SumReplicated.apply(t, mesh, axis), x)


def max_replicated(x, mesh, axis=None):
    """The elementwise max over the ranks of ``mesh`` along ``axis`` (not
    differentiated)."""
    return _all_reduce(x.detach().clone(), dist.ReduceOp.MAX, mesh, axis)


def gather_blocks(x, nblocks: int, mesh, axis: str = "block"):
    """The whole stacked array of ``nblocks`` blocks on every rank, from
    each rank's slab ``x`` along ``axis``: the slabs placed into zeros, then
    one ``all_reduce`` over ``axis`` (adding zeros is exact, and every
    backend has it)."""
    from .runner import local_block_range

    lo, hi = local_block_range(nblocks, mesh, axis)
    out = torch.zeros((nblocks,) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
    out[lo:hi] = x
    return _all_reduce(out, dist.ReduceOp.SUM, mesh, axis)


def halo_transport(mesh) -> str:
    """How :func:`halo_exchange` moves planes on ``mesh``."""
    if mesh.backend == "gloo" and mesh.device.type == "cuda":
        return "gloo send/recv through pinned host buffers"
    return f"{mesh.backend} batch_isend_irecv"


_HALO = "halo_exchanges.dim"  # the registry's counters, one per tensor dimension


def halo_counts() -> dict:
    """The exchanges :func:`halo_exchange` made with a neighbour on this
    rank since :func:`reset_halo_counts`, by tensor dimension (forward,
    tangent and backward exchanges alike): a view of the counters
    ``halo_exchanges.dim<d>`` of :mod:`~jets_tpu_torch.utils.profiling`."""
    return {int(k[len(_HALO):]): n for k, n in counters().items() if k.startswith(_HALO)}


def reset_halo_counts() -> None:
    counters([k for k in counters() if k.startswith(_HALO)], reset=True)


def _exchange(lo_send, hi_send, mesh, dim, axis):
    """Send ``lo_send`` to the rank below and ``hi_send`` to the rank above
    along the mesh axis ``axis``; returns ``(from_lo, from_hi)``: the rank
    below's ``hi_send`` and the rank above's ``lo_send``, zeros at the
    edges. The messages go over the default group, to the ranks
    :meth:`~.sharded.BlockMesh.peer` names."""
    from_lo, from_hi = torch.zeros_like(hi_send), torch.zeros_like(lo_send)
    r, n = mesh.index(axis), mesh.axis_size(axis)
    if n == 1:
        return from_lo, from_hi
    staged = mesh.backend == "gloo" and lo_send.device.type == "cuda"

    def host(t):
        if not staged:
            return t.contiguous()
        buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        return buf.copy_(t)

    count(_HALO + str(dim))
    with span("halo_exchange", dim=dim):
        recvs, ops = [], []
        for peer, send, recv in ((r - 1, lo_send, from_lo), (r + 1, hi_send, from_hi)):
            if 0 <= peer < n:
                s, t = host(send), host(recv)
                g = mesh.peer(axis, peer)
                ops += [dist.P2POp(dist.isend, s, g), dist.P2POp(dist.irecv, t, g)]
                recvs.append((recv, t))
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        if staged:
            for dst, t in recvs:
                dst.copy_(t)
    return from_lo, from_hi


class _HaloExchange(torch.autograd.Function):
    @staticmethod
    def forward(u, hw, mesh, dim, axis):
        n = u.shape[dim]
        above, below = _exchange(u.narrow(dim, 0, hw), u.narrow(dim, n - hw, hw), mesh,
                                 dim, axis)
        return torch.cat([above, u, below], dim)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.hw, ctx.mesh, ctx.dim, ctx.axis = inputs[1:]

    @staticmethod
    def backward(ctx, g):
        hw, d = ctx.hw, ctx.dim
        n = g.shape[d]
        from_lo, from_hi = _exchange(g.narrow(d, 0, hw), g.narrow(d, n - hw, hw), ctx.mesh,
                                     d, ctx.axis)
        gu = g.narrow(d, hw, n - 2 * hw).clone()
        gu.narrow(d, 0, hw).add_(from_lo)
        gu.narrow(d, n - 3 * hw, hw).add_(from_hi)
        return gu, None, None, None, None

    @staticmethod
    def jvp(ctx, du, *_):
        hw, d = ctx.hw, ctx.dim
        n = du.shape[d]
        above, below = _exchange(du.narrow(d, 0, hw), du.narrow(d, n - hw, hw), ctx.mesh,
                                 d, ctx.axis)
        return torch.cat([above, du, below], d)


def halo_exchange(u, hw: int, mesh, dim: int = 0, axis=None):
    """``u`` (a rank's slab of tensor dimension ``dim``, split over mesh
    axis ``axis``: a name, a tuple of names taken row-major, ``None``: all)
    extended by ``hw`` planes from the rank below and ``hw`` from the rank
    above: ``u.shape[dim] + 2·hw`` planes along ``dim``, zeros beyond the
    first and last ranks."""
    return _HaloExchange.apply(u, hw, mesh, dim, axis)
