"""Stacked block operators, on one device or sharded over ranks
(counterpart of ``jets_tpu/parallel/sharded.py``).

A tall block column: every block (shot) maps the SAME model ``m`` to its
own data block, with per-block parameters stacked along a leading axis::

    d[b] = f(m, bstate[b])               forward
    m'   = Σ_b f'(d[b], bstate[b])        adjoint

Where the JAX package ``vmap``s an unbatched per-block kernel, the port
writes the batch dimension out: child kernels receive the WHOLE stacked
``bstate`` (every entry with its leading ``nblocks`` axis) merged with the
shared ``sstate``, and return stacked results. Block-invariant work (the
flagship's sampled stencil) is therefore computed once, not once per shot.
``shot_map="map"`` instead runs the kernels in a Python loop over shots,
each call seeing a one-block slice (leading axis of length 1).

**The mesh.** Where the JAX package shards the stacked axis over a device
mesh with ``shard_map``, the port runs one process per card and shards it
over the ranks of a :mod:`torch.distributed` group (:class:`BlockMesh`,
:func:`make_block_mesh`). Each rank holds the contiguous slab of blocks
:func:`~jets_tpu_torch.parallel.runner.local_block_range` gives it; the
model is replicated. The forward and tangent are local; the adjoint sums
the rank's blocks, then one ``all_reduce`` (:func:`sum_replicated`) — the
reference's cross-worker accumulation loop as one collective. The range is
a :class:`ShardedSpace`, whose ``dot``/``norm`` reduce locally, then
``all_reduce`` once, so the Krylov solvers run unchanged.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..core.jet import Jet, LinearOperator, Operator
from ..core.spaces import Space, _canon_shape, as_tensor
from ..utils.tree import tmap
from .collectives import max_replicated, sum_replicated
from .runner import distribute_blocks, init_distributed, local_block_range, rank_device

__all__ = [
    "stacked_block_operator",
    "block_sharding",
    "shard_blocks",
    "replicate",
    "make_block_mesh",
    "BlockMesh",
    "BlockSharding",
    "ShardedSpace",
]


class BlockMesh:
    """A 1-D mesh over the ranks of a process group: ``shape`` is
    ``{axis: size}`` (so ``mesh.shape[axis]`` reads as it does on a JAX
    mesh), ``rank`` this process's position on it, ``group`` the process
    group (``None``: the default group), ``device`` this rank's device and
    ``backend`` the group's backend."""

    __slots__ = ("shape", "axis", "rank", "group", "device", "backend")

    def __init__(self, axis: str, size: int, rank: int, group, device, backend: str):
        for k, v in (("shape", {axis: int(size)}), ("axis", axis), ("rank", int(rank)),
                     ("group", group), ("device", torch.device(device)),
                     ("backend", str(backend))):
            object.__setattr__(self, k, v)

    def __setattr__(self, *a):  # pragma: no cover - defensive
        raise AttributeError("BlockMesh is immutable")

    @property
    def size(self) -> int:
        return self.shape[self.axis]

    def global_rank(self, r: int) -> int:
        """The default group's rank of mesh position ``r``."""
        return r if self.group is None else dist.get_global_rank(self.group, r)

    def __repr__(self) -> str:
        return (f"BlockMesh({self.shape}, rank={self.rank}, device={self.device}, "
                f"backend={self.backend})")


def make_block_mesh(n_devices: Optional[int] = None, axis: str = "block", *,
                    device=None) -> BlockMesh:
    """A 1-D mesh over every rank of the default process group, which
    :func:`~jets_tpu_torch.parallel.runner.init_distributed` makes if there
    is none (a world of one in a plain process). ``device=None`` is this
    rank's card (``cuda:{LOCAL_RANK % device_count}``); ``"cpu"`` builds
    on the CPU (gloo). ``n_devices``, if given, must be the world size."""
    init_distributed(device=device)
    world = dist.get_world_size()
    if n_devices is not None and int(n_devices) != world:
        raise ValueError(f"make_block_mesh({n_devices}) in a group of {world} ranks: "
                         "the mesh spans every rank of the group")
    return BlockMesh(axis, world, dist.get_rank(), None, rank_device(device),
                     dist.get_backend())


class BlockSharding:
    """The counterpart of ``NamedSharding(mesh, P(*spec))``: what
    ``wavefield_sharding=`` takes."""

    __slots__ = ("mesh", "spec")

    def __init__(self, mesh: BlockMesh, spec: Sequence):
        object.__setattr__(self, "mesh", mesh)
        object.__setattr__(self, "spec", tuple(spec))

    def __setattr__(self, *a):  # pragma: no cover - defensive
        raise AttributeError("BlockSharding is immutable")


def block_sharding(mesh: BlockMesh, axis: str = "block") -> BlockSharding:
    """The sharding that splits the leading axis over the mesh."""
    return BlockSharding(mesh, (axis,))


def shard_blocks(x, mesh: BlockMesh, axis: str = "block") -> torch.Tensor:
    """This rank's slab of the leading axis of a global stacked array (the
    same on every rank), on the mesh's device."""
    return distribute_blocks(x, mesh, axis)


def replicate(x, mesh: BlockMesh):
    """A model-space value (a tensor, an array or a pytree of tensors) on
    the mesh's device; it is the same on every rank."""
    if isinstance(x, np.ndarray):
        x = as_tensor(x)
    return tmap(lambda t: t.to(mesh.device), x)


class ShardedSpace(Space):
    """A space whose members are split along their leading axis over a
    mesh: ``shape`` is the global shape, and each rank's tensors hold its
    slab (``local_shape``). ``dot``/``norm`` reduce locally, then
    ``all_reduce`` once; ``randn``/``rand`` draw the global member and take
    the rank's slab, so one seed gives the same global vector on any mesh.
    The block axis of a stacked operator's range (shots) and the z-slabs of
    a grid-sharded model both split the leading axis."""

    __slots__ = ("_mesh", "_axis", "_local_shape", "_lo")

    def __init__(self, shape, dtype: torch.dtype, mesh: BlockMesh, axis: str = "block"):
        super().__init__(shape, dtype, mesh.device)
        shape = _canon_shape(shape)
        lo, hi = local_block_range(shape[0], mesh, axis)
        object.__setattr__(self, "_mesh", mesh)
        object.__setattr__(self, "_axis", axis)
        object.__setattr__(self, "_local_shape", (hi - lo,) + shape[1:])
        object.__setattr__(self, "_lo", lo)

    @property
    def mesh(self) -> BlockMesh:
        return self._mesh

    @property
    def axis(self) -> str:
        return self._axis

    @property
    def local_shape(self):
        return self._local_shape

    def local(self, x) -> torch.Tensor:
        """The rank's slab of a global member."""
        return x[self._lo:self._lo + self._local_shape[0]]

    def __eq__(self, other) -> bool:
        return (super().__eq__(other) and self._mesh is other._mesh
                and self._axis == other._axis)

    def __hash__(self) -> int:
        return hash((super().__hash__(), id(self._mesh), self._axis))

    def __repr__(self) -> str:
        return (f"ShardedSpace({self.shape}, {self.dtype}, local {self._local_shape} on "
                f"{self.device}, axis {self._axis!r} of {self._mesh.size})")

    def zeros(self) -> torch.Tensor:
        return torch.zeros(self._local_shape, dtype=self.dtype, device=self.device)

    def ones(self) -> torch.Tensor:
        return torch.ones(self._local_shape, dtype=self.dtype, device=self.device)

    def _draw(self, fn, generator: torch.Generator) -> torch.Tensor:
        return self.local(super()._draw(fn, generator)).contiguous()

    def reshape(self, x) -> torch.Tensor:
        """``x`` as a member: a local slab as it is, a global member's slab."""
        x = torch.as_tensor(x, device=self.device)
        if x.numel() == self.size:
            return self.local(x.reshape(self.shape)).to(self.dtype)
        if x.numel() != int(np.prod(self._local_shape)):
            raise ValueError(f"cannot reshape size-{x.numel()} tensor into {self}")
        return x.reshape(self._local_shape).to(self.dtype)

    def dot(self, x, y):
        return sum_replicated(torch.vdot(x.reshape(-1), y.reshape(-1)), self._mesh)

    def norm(self, x, p: float = 2):
        xf = x.reshape(-1)
        if p == 2:
            return torch.sqrt(sum_replicated(torch.real(torch.vdot(xf, xf)), self._mesh))
        a = torch.abs(xf)
        if p == float("inf"):
            return max_replicated(torch.max(a), self._mesh)
        if p == float("-inf"):
            return -max_replicated(-torch.min(a), self._mesh)
        if p == 0:
            return sum_replicated(torch.sum(a != 0).to(a.dtype), self._mesh)
        return sum_replicated(torch.sum(a**p), self._mesh) ** (1.0 / p)


def _blocks(state):
    """The (bstate, sstate) pairs a kernel is called with: the whole stack
    once (``vmap``), or one single-block slice per shot (``map``)."""
    bstate, sstate = state["bstate"], state["sstate"]
    if state["shot_map"] == "map":
        for b in range(state["nblocks"]):
            yield {**{k: v[b:b + 1] for k, v in bstate.items()}, **sstate}
    else:
        yield {**bstate, **sstate}


def _cat(parts):
    return parts[0] if len(parts) == 1 else torch.cat(parts)


def _stacked_f(m, state):
    return _cat([state["child_f"](m, bs) for bs in _blocks(state)])


def _stacked_df(dm, m0, state):
    return _cat([state["child_df"](dm, m0, bs) for bs in _blocks(state)])


def _local_adjoint(dd, m0, state):
    """The adjoint of this rank's blocks. ``stack_dft(dd, m0, state) ->
    model`` consumes the whole stack at once (in both shot modes, as in the
    JAX package); ``child_dft(dd, m0, state)`` returns stacked per-block
    model-space contributions (a tensor or a pytree such as a
    ``BlockVector``), summed over the block axis; with neither, the vjp of
    the stacked tangent."""
    child_dft, stack_dft = state["child_dft"], state["stack_dft"]
    if stack_dft is not None:
        return stack_dft(dd, m0, {**state["bstate"], **state["sstate"]})
    if child_dft is None:
        _, vjp = torch.func.vjp(lambda dm: _stacked_df(dm, m0, state), state["dom"].zeros())
        return tmap(torch.Tensor.contiguous, vjp(dd)[0])
    if state["shot_map"] == "map":
        parts = [dd[b:b + 1] for b in range(state["nblocks"])]
    else:
        parts = [dd]
    acc = None
    for d_b, bs in zip(parts, _blocks(state)):
        term = tmap(lambda t: torch.sum(t, dim=0), child_dft(d_b, m0, bs))
        acc = term if acc is None else acc + term
    return acc


def _stacked_dft(dd, m0, state):
    """Adjoint accumulation: the rank's blocks summed locally, then, on a
    mesh, one ``all_reduce`` whose backward does not reduce again."""
    out = _local_adjoint(dd, m0, state)
    return out if state["mesh"] is None else sum_replicated(out, state["mesh"])


def _stacked_upstate(m0, state):
    # the model is shared across blocks; nothing block-local to refresh
    return {}


def stacked_block_operator(
    *,
    nblocks: int,
    dom: Space,
    rng_block: Space,
    bstate: Dict[str, Any],
    df: Callable,
    f: Optional[Callable] = None,
    dft: Optional[Callable] = None,
    stack_dft: Optional[Callable] = None,
    sstate: Optional[Dict[str, Any]] = None,
    mesh: Optional[BlockMesh] = None,
    axis: str = "block",
    shot_map: str = "vmap",
) -> Operator:
    """Homogeneous tall block-column operator over a stacked block axis.

    ``bstate``: stacked per-block tensors (leading dim ``nblocks``).
    ``sstate``: shared tensors, merged into every kernel's state; keys must
    not collide with ``bstate``. ``df``/``f``/``dft`` are batched child
    kernels (see the module docstring); ``dft=None`` and ``stack_dft=None``
    derive the adjoint with ``torch.func.vjp`` of the tangent: of the whole
    stack (``vmap``), or of each block's in turn (``map``). The wave stacks
    give their own (``ops/wave._multishot_operator``: autograd of the
    forward, which their remat segments need). The range is
    ``(nblocks,) + rng_block.shape``.

    ``mesh``/``axis``: shard the blocks over the mesh axis, which must
    divide ``nblocks``. Each ``bstate`` entry may be given whole (the rank
    keeps its slab) or as the rank's slab already; the range is then a
    :class:`ShardedSpace` and the adjoint sums locally, then all-reduces
    once (the derived one too: the local vjp, then one ``all_reduce``).
    """
    if shot_map not in ("vmap", "map"):
        raise ValueError(f"shot_map must be 'vmap' or 'map', got {shot_map!r}")
    sstate = dict(sstate or {})
    nlocal = nblocks
    if mesh is not None:
        if nblocks % mesh.shape[axis]:
            raise ValueError(f"nblocks {nblocks} not divisible by mesh axis {axis!r} "
                             f"size {mesh.shape[axis]}")
        lo, hi = local_block_range(nblocks, mesh, axis)
        nlocal = hi - lo
    for k, v in bstate.items():
        if k in sstate:
            raise ValueError(f"state key {k!r} appears in both bstate and sstate")
        if v.shape[0] not in (nblocks, nlocal):
            raise ValueError(
                f"bstate[{k!r}] leading dim {v.shape[0]} != nblocks {nblocks}"
            )
    if mesh is not None:  # the rank's slab, on the device each entry was given on
        bstate = {k: v[lo:hi] if v.shape[0] == nblocks else v for k, v in bstate.items()}
        rng = ShardedSpace((nblocks,) + rng_block.shape, rng_block.dtype, mesh, axis)
    else:
        rng = Space((nblocks,) + rng_block.shape, rng_block.dtype, rng_block.device)
    state = {
        "child_f": f if f is not None else (lambda m, bs, __df=df: __df(m, None, bs)),
        "child_df": df,
        "child_dft": dft,
        "stack_dft": stack_dft,
        "bstate": dict(bstate),
        "sstate": sstate,
        "nblocks": nlocal,
        "shot_map": shot_map,
        "mesh": mesh,
        "dom": dom,
    }
    have_adjoint = dft is not None or stack_dft is not None or mesh is not None
    if dft is None and stack_dft is None and shot_map == "map":
        # sequential mode: derive the adjoint per block (vjp of that block's
        # tangent), so one shot's tape is held at a time, as the JAX
        # package's _auto_child_dft does
        def _auto_child_dft(d_b, m0, bs, __df=df):
            prim = m0 if m0 is not None else dom.zeros()
            _, vjp = torch.func.vjp(lambda dm: __df(dm, m0, bs), prim)
            (out,) = vjp(d_b)
            return tmap(lambda t: t[None], out)

        state["child_dft"] = _auto_child_dft
        have_adjoint = True
    j = Jet(
        dom=dom,
        rng=rng,
        f=_stacked_f,
        df=_stacked_df,
        dft=_stacked_dft if have_adjoint else None,
        upstate=_stacked_upstate if f is not None else None,
        state=state,
    )
    return (Operator if f is not None else LinearOperator)(j)
