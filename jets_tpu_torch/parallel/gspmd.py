"""The block × grid mesh (counterpart of ``jets_tpu/parallel/gspmd.py``):
shots over one mesh axis, the model grid over the other — ``BASELINE.json``
config 5's layout.

The JAX package builds a 2-D device mesh, places data with
``NamedSharding`` and lets GSPMD partition the unchanged program. PyTorch
has no GSPMD: a tensor carries no sharding that an unchanged operator could
follow, and ``torch.distributed.tensor`` redistributes a stencil's pad,
shift and slice to a replicated tensor. So the port keeps its explicit
design: one process per rank, a :class:`~.sharded.BlockMesh` with named
axes that the operators take as ``mesh=`` (``make_seismic_problem``, the
multishot wave operators) or inside ``wavefield_sharding=``, halos moved by
:func:`~.collectives.halo_exchange` and reductions done by
:func:`~.collectives.sum_replicated`, each over its own axis. The functions
here place data on such a mesh: each rank holds its slab, never the
global array.

The Krylov solvers run unchanged; only data placement differs::

    mesh2 = make_mesh_2d(2, 2)                        # 4 ranks
    A, m, d = make_seismic_problem(grid, nshots, nrecv, mesh=mesh2)
    res = lsqr(A, d, maxiter=50)                      # x: the rank's grid slab
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from ..core.spaces import as_tensor
from ..utils.tree import tmap
from .sharded import BlockMesh, local_slices, make_mesh

__all__ = [
    "make_mesh_2d",
    "shard_data",
    "shard_model",
    "constrain_model",
]


def make_mesh_2d(
    n_block: int,
    n_grid: int,
    *,
    axes: Tuple[str, str] = ("block", "grid"),
    device=None,
) -> BlockMesh:
    """A (block × grid) mesh over the ranks of the default process group,
    laid out row-major (rank ``r`` at ``(r // n_grid, r % n_grid)``, as
    ``jax.make_mesh`` lays out devices): shots shard over ``axes[0]``, the
    model's leading grid dimension over ``axes[1]``. The group is made if
    there is none (a world of one in a plain process; ``device`` as for
    :func:`~.sharded.make_mesh`). ``n_block·n_grid`` must be the world
    size: above it there are too few ranks, below it a rank would sit
    outside the mesh with nothing to run."""
    import torch.distributed as dist

    from .runner import init_distributed

    init_distributed(device=device)
    world = dist.get_world_size()
    if n_block * n_grid > world:
        raise ValueError(
            f"mesh {n_block}x{n_grid} needs {n_block * n_grid} devices, have {world}")
    return make_mesh({axes[0]: n_block, axes[1]: n_grid}, device=device)


def _slab(x, mesh: BlockMesh, axis: str):
    x = as_tensor(x) if not isinstance(x, torch.Tensor) else x
    return x[local_slices(tuple(x.shape), mesh, (axis,))].to(mesh.device)


def shard_data(x, mesh: BlockMesh, *, axis: str = "block"):
    """This rank's slab of a stacked ``(nshots, ...)`` array (or a pytree of
    them) over the block axis, replicated over the grid axis, on the mesh's
    device."""
    return tmap(lambda t: _slab(t, mesh, axis), x)


def shard_model(m, mesh: BlockMesh, *, axis: str = "grid"):
    """This rank's slab of a model grid's leading dimension (or of each
    tensor of a pytree) over the grid axis, replicated over the block axis,
    on the mesh's device."""
    return tmap(lambda t: _slab(t, mesh, axis), m)


def constrain_model(m, mesh: BlockMesh, *, axis: str = "grid",
                    shape: Optional[Sequence[int]] = None):
    """``m`` itself, after checking that it is this rank's slab of the
    leading dimension over ``axis``: a tensor on the mesh's device and, when
    the global ``shape`` is given, of the slab's shape; ``ValueError``
    otherwise. In the JAX package this is an in-graph sharding hint that
    GSPMD may act on. The port has no partitioner to hint: a value already
    is a slab or it is not, so a check is the only honest counterpart."""
    def check(t):
        if not isinstance(t, torch.Tensor) or t.device != mesh.device:
            raise ValueError(f"constrain_model: expected a tensor on {mesh.device}, got "
                             f"{type(t).__name__} on {getattr(t, 'device', None)}")
        if shape is not None:
            want = tuple(s.stop - s.start for s in local_slices(tuple(shape), mesh, (axis,)))
            if tuple(t.shape) != want:
                raise ValueError(f"constrain_model: shape {tuple(t.shape)} is not rank "
                                 f"{mesh.rank}'s slab {want} of {tuple(shape)} over "
                                 f"{axis!r}")
        return t

    return tmap(check, m)
