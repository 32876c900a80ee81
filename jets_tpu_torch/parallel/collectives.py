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
* :class:`_HaloExchange` — the ``hw`` boundary planes of a z-slab from each
  neighbour along the leading axis; edge ranks receive zeros, which is the
  global zero boundary. Its backward sends the halo cotangents back and
  adds them into the neighbours' boundary planes (the transpose of
  ``ppermute``); its tangent exchanges the tangent's planes.

Both are autograd Functions in the ``setup_context`` style, so they run
under :func:`torch.func.jvp` and ``torch.func.vjp``. The halo transport
follows the group's backend: ``batch_isend_irecv`` on device tensors with
NCCL and on CPU tensors with gloo; with gloo and CUDA tensors (gloo has no
CUDA send/recv) the planes are staged through pinned host buffers.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from ..utils.tree import tmap

__all__ = ["sum_replicated", "max_replicated", "gather_blocks", "halo_exchange",
           "halo_transport"]


def _all_reduce(x, op, mesh):
    dist.all_reduce(x, op=op, group=mesh.group)
    return x


class _SumReplicated(torch.autograd.Function):
    @staticmethod
    def forward(x, mesh):
        return _all_reduce(x.clone(), dist.ReduceOp.SUM, mesh)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.mesh = inputs[1]

    @staticmethod
    def backward(ctx, g):
        return g, None

    @staticmethod
    def jvp(ctx, dx, _):
        return _all_reduce(dx.clone(), dist.ReduceOp.SUM, ctx.mesh)


def sum_replicated(x, mesh):
    """The sum over the ranks of ``mesh`` of each rank's ``x`` (a tensor or
    a pytree such as a ``BlockVector``), the same on every rank; its
    backward is the identity (:class:`_SumReplicated`)."""
    return tmap(lambda t: _SumReplicated.apply(t, mesh), x)


def max_replicated(x, mesh):
    """The elementwise max over the ranks of ``mesh`` (not differentiated)."""
    return _all_reduce(x.detach().clone(), dist.ReduceOp.MAX, mesh)


def gather_blocks(x, nblocks: int, mesh, axis: str = "block"):
    """The whole stacked array of ``nblocks`` blocks on every rank, from
    each rank's slab ``x``: the slabs placed into zeros, then one
    ``all_reduce`` (adding zeros is exact, and every backend has it)."""
    from .runner import local_block_range

    lo, hi = local_block_range(nblocks, mesh, axis)
    out = torch.zeros((nblocks,) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
    out[lo:hi] = x
    return _all_reduce(out, dist.ReduceOp.SUM, mesh)


def halo_transport(mesh) -> str:
    """How :func:`halo_exchange` moves planes on ``mesh``."""
    if mesh.backend == "gloo" and mesh.device.type == "cuda":
        return "gloo send/recv through pinned host buffers"
    return f"{mesh.backend} batch_isend_irecv"


def _exchange(lo_send, hi_send, mesh):
    """Send ``lo_send`` to the rank below and ``hi_send`` to the rank above
    along the mesh axis; returns ``(from_lo, from_hi)``: the rank below's
    ``hi_send`` and the rank above's ``lo_send``, zeros at the edges."""
    from_lo, from_hi = torch.zeros_like(hi_send), torch.zeros_like(lo_send)
    r, n = mesh.rank, mesh.size
    if n == 1:
        return from_lo, from_hi
    staged = mesh.backend == "gloo" and lo_send.device.type == "cuda"

    def host(t):
        if not staged:
            return t.contiguous()
        buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        return buf.copy_(t)

    with torch.profiler.record_function("jets_tpu_torch::halo_exchange"):
        recvs, ops = [], []
        for peer, send, recv in ((r - 1, lo_send, from_lo), (r + 1, hi_send, from_hi)):
            if 0 <= peer < n:
                s, t = host(send), host(recv)
                g = mesh.global_rank(peer)
                ops += [dist.P2POp(dist.isend, s, g, mesh.group),
                        dist.P2POp(dist.irecv, t, g, mesh.group)]
                recvs.append((recv, t))
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        if staged:
            for dst, t in recvs:
                dst.copy_(t)
    return from_lo, from_hi


class _HaloExchange(torch.autograd.Function):
    @staticmethod
    def forward(u, hw, mesh):
        above, below = _exchange(u[:hw], u[-hw:], mesh)
        return torch.cat([above, u, below])

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.hw, ctx.mesh = inputs[1], inputs[2]

    @staticmethod
    def backward(ctx, g):
        hw = ctx.hw
        from_lo, from_hi = _exchange(g[:hw], g[-hw:], ctx.mesh)
        gu = g[hw:-hw].clone()
        gu[:hw] += from_lo
        gu[-hw:] += from_hi
        return gu, None, None

    @staticmethod
    def jvp(ctx, du, *_):
        above, below = _exchange(du[:ctx.hw], du[-ctx.hw:], ctx.mesh)
        return torch.cat([above, du, below])


def halo_exchange(u, hw: int, mesh):
    """``u`` (a rank's slab of the leading axis) extended by ``hw`` planes
    from the rank below and ``hw`` from the rank above: shape
    ``(len(u) + 2·hw, ...)``, zeros beyond the first and last ranks."""
    return _HaloExchange.apply(u, hw, mesh)
