"""Multi-process runner (counterpart of ``jets_tpu/parallel/runner.py``).

The JAX package runs one process per host of a pod slice, a global mesh
over every chip and the stacked block (shot) axis sharded across it, each
host reading only the shot gathers whose blocks live on its chips. The
port runs one process per CUDA card (``torchrun`` or any launcher that sets
``RANK``/``WORLD_SIZE``/``LOCAL_RANK``/``MASTER_ADDR``/``MASTER_PORT``),
joined by one :mod:`torch.distributed` process group; each rank holds its
contiguous slab of the block axis. No global tensor exists: a sharded
stack is the rank's slab, checked against the global shape.

A plain single-process session works unchanged: :func:`init_distributed`
makes a world of one, so :func:`~jets_tpu_torch.parallel.sharded.make_block_mesh`
and the sharded operators run in one process as they do on many.

Typical entry point (one process per card)::

    from jets_tpu_torch.parallel import runner, sharded

    runner.init_distributed()                    # NCCL on this rank's card
    mesh = sharded.make_block_mesh()             # every rank, "block" axis
    lo, hi = runner.local_block_range(nshots, mesh)
    d_local = store.read_shots(lo, hi)           # host-local IO
    d = runner.assemble_global(d_local, (nshots, *shot_shape), mesh)
    res = lsqr(A, d, ...)                        # unchanged solver
"""
from __future__ import annotations

import datetime
import os
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..core.spaces import as_tensor, resolve_device

__all__ = [
    "init_distributed",
    "local_block_range",
    "assemble_global",
    "distribute_blocks",
    "replicate_global",
]


def _int_env(name: str) -> Optional[int]:
    v = os.environ.get(name)
    return int(v) if v is not None else None


def rank_device(device=None) -> torch.device:
    """This rank's device: ``device`` as given, a CUDA device without an
    index (and ``None``) becoming ``cuda:{LOCAL_RANK % device_count}``.
    ``None`` without a card raises, as :func:`resolve_device` does."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", (_int_env("LOCAL_RANK") or 0) % torch.cuda.device_count())
    return dev


def init_distributed(backend: Optional[str] = None, *, device=None,
                     init_method: Optional[str] = None, rank: Optional[int] = None,
                     world_size: Optional[int] = None,
                     timeout: Optional[float] = None) -> int:
    """Join (or make) the default process group; returns this process's
    rank. A group that already exists is kept.

    ``rank``/``world_size`` default to ``RANK``/``WORLD_SIZE`` and the
    rendezvous to ``init_method`` or ``env://`` (``MASTER_ADDR``/
    ``MASTER_PORT``); with none of them set, the group is a world of one
    over an in-memory store. The backend follows the device: NCCL on the
    card (``device=None``, which needs a card), gloo for ``device="cpu"``;
    gloo on the card only when ``backend="gloo"`` is asked for. ``timeout``
    (seconds) bounds every collective of the group, so a lost peer fails a
    call instead of hanging it."""
    dev = rank_device(device)
    if dist.is_initialized():
        return dist.get_rank()
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    rank = rank if rank is not None else _int_env("RANK")
    world_size = world_size if world_size is not None else _int_env("WORLD_SIZE")
    kw = {} if timeout is None else {"timeout": datetime.timedelta(seconds=timeout)}
    if init_method is None and rank is None and world_size is None \
            and "MASTER_ADDR" not in os.environ:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1, **kw)
    else:
        dist.init_process_group(
            backend, init_method=init_method or "env://",
            rank=-1 if rank is None else rank,
            world_size=-1 if world_size is None else world_size, **kw)
    return dist.get_rank()


def local_block_range(nblocks: int, mesh, axis: str = "block") -> Tuple[int, int]:
    """The contiguous ``[lo, hi)`` range of block indices this rank holds —
    the shot gathers this process must load. Blocks are laid out
    contiguously over the mesh axis (a name, or a tuple of names taken
    row-major), which must divide ``nblocks``; on the other axes of the mesh
    the ranges repeat."""
    n = mesh.axis_size(axis)
    if nblocks % n:
        raise ValueError(f"nblocks {nblocks} not divisible by mesh axis {n}")
    per = nblocks // n
    i = mesh.index(axis)
    return i * per, (i + 1) * per


def distribute_blocks(x, mesh, axis: str = "block") -> torch.Tensor:
    """This rank's slab of a FULL stacked block array (the same on every
    process) along its leading axis, on the mesh's device — the
    counterpart of :func:`~jets_tpu_torch.parallel.sharded.shard_blocks`
    (they are one function in the port). Use :func:`assemble_global` when
    each process only has its own slab."""
    x = as_tensor(x)
    lo, hi = local_block_range(int(x.shape[0]), mesh, axis)
    return x[lo:hi].to(mesh.device)


def replicate_global(x, mesh) -> torch.Tensor:
    """An array that is the same on every process, on the mesh's device."""
    return as_tensor(x).to(mesh.device)


def assemble_global(local_blocks, global_shape: Sequence[int], mesh,
                    axis: str = "block") -> torch.Tensor:
    """This rank's slab (``local_blocks``, the ``[lo, hi)`` range of
    :func:`local_block_range`) as the rank's part of a stacked array of
    ``global_shape``, on the mesh's device: checked against the global
    shape; no data moves between ranks."""
    global_shape = tuple(int(s) for s in global_shape)
    lo, hi = local_block_range(global_shape[0], mesh, axis)
    x = as_tensor(local_blocks).to(mesh.device)
    if tuple(x.shape) != (hi - lo,) + global_shape[1:]:
        raise ValueError(f"local slab of shape {tuple(x.shape)} does not fit rank "
                         f"{mesh.rank}'s blocks [{lo}, {hi}) of {global_shape}")
    return x
