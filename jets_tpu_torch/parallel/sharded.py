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
:func:`make_block_mesh`; a 2-D block × grid mesh from :func:`make_mesh` or
``gspmd.make_mesh_2d``, with one process group per row and per column).
Each rank holds the contiguous slab of blocks
:func:`~jets_tpu_torch.parallel.runner.local_block_range` gives it along
the block axis; the model is replicated over that axis (and, on a 2-D mesh,
split over the grid axis by the operators that take one). The forward and
tangent are local; the adjoint sums the rank's blocks, then one
``all_reduce`` over the block axis only (:func:`sum_replicated`) — the
reference's cross-worker accumulation loop as one collective. The range is
a :class:`ShardedSpace`, whose ``dot``/``norm`` reduce locally, then
``all_reduce`` once over the axes it is split on, so the Krylov solvers run
unchanged: on a 2-D mesh the shots' range reduces over ``"block"`` and a
grid-sharded model over ``"grid"``, never over the axis whose ranks hold
replicas.
"""
from __future__ import annotations

import itertools
import math
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

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
    "make_mesh",
    "BlockMesh",
    "BlockSharding",
    "ShardedSpace",
    "grid_axis",
    "local_slices",
]


class BlockMesh:
    """A mesh over the ranks of a process group: named axes laid out
    row-major over the ranks, as ``jax.make_mesh`` lays out devices.
    ``shape`` is ``{axis: size}`` (so ``mesh.shape[axis]`` reads as it does
    on a JAX mesh), ``axes`` the names in order, ``coords`` this rank's
    position on each axis, ``rank`` its rank in the default group,
    ``device`` this rank's device and ``backend`` the group's backend.

    An axis argument (``axis=`` of :meth:`index`, :meth:`axis_size`,
    :meth:`peer`, :meth:`group` and of the collectives) is one name, a tuple
    of names (their row-major product, as in ``P(("block", "grid"))``) or
    ``None`` (every axis). :meth:`group` is the process group of the ranks
    that share this rank's coordinates on the other axes: one per row and
    one per column of a 2-D mesh, made once by :func:`make_mesh` on every
    rank in the same order (``dist.new_group`` is collective)."""

    __slots__ = ("shape", "axes", "coords", "rank", "groups", "device", "backend",
                 "_device_mesh")

    def __init__(self, shape, rank: int, groups, device, backend: str):
        shape = {str(a): int(n) for a, n in dict(shape).items()}
        axes, coords, r = tuple(shape), {}, int(rank)
        for a in reversed(axes):
            r, coords[a] = divmod(r, shape[a])
        for k, v in (("shape", shape), ("axes", axes),
                     ("coords", {a: coords[a] for a in axes}), ("rank", int(rank)),
                     ("groups", dict(groups)), ("device", torch.device(device)),
                     ("backend", str(backend)), ("_device_mesh", None)):
            object.__setattr__(self, k, v)

    def __setattr__(self, *a):  # pragma: no cover - defensive
        raise AttributeError("BlockMesh is immutable")

    def device_mesh(self):
        """The :class:`torch.distributed.device_mesh.DeviceMesh` of this mesh's
        layout on the CPU (made once, on every rank: its groups are
        collective), over which :meth:`ShardedSpace.to_dtensor` places host
        copies of slabs."""
        if self._device_mesh is None:
            from torch.distributed.device_mesh import DeviceMesh

            # no process groups: a DTensor that is only written and read runs
            # no collective, and its coordinates follow from the default
            # group's rank, which is this mesh's
            object.__setattr__(self, "_device_mesh", DeviceMesh(
                "cpu", torch.arange(self.size).reshape(tuple(self.shape.values())),
                mesh_dim_names=self.axes, _init_backend=False))
        return self._device_mesh

    @property
    def size(self) -> int:
        """The number of ranks of the mesh."""
        return math.prod(self.shape.values())

    def names(self, axis=None) -> Tuple[str, ...]:
        """``axis`` as a tuple of this mesh's axis names."""
        if axis is None:
            return self.axes
        names = (axis,) if isinstance(axis, str) else tuple(axis)
        for a in names:
            if a not in self.shape:
                raise ValueError(f"mesh axis {a!r} is not one of {self.axes}")
        if len(set(names)) != len(names):
            raise ValueError(f"mesh axes {names} repeat an axis")
        return names

    def axis_size(self, axis=None) -> int:
        return math.prod(self.shape[a] for a in self.names(axis))

    def index(self, axis=None) -> int:
        """This rank's row-major position over ``axis``."""
        i = 0
        for a in self.names(axis):
            i = i * self.shape[a] + self.coords[a]
        return i

    def peer(self, axis, index: int) -> int:
        """The default group's rank at position ``index`` over ``axis``,
        with this rank's coordinates on the other axes."""
        coords = dict(self.coords)
        for a in reversed(self.names(axis)):
            index, coords[a] = divmod(index, self.shape[a])
        r = 0
        for a in self.axes:
            r = r * self.shape[a] + coords[a]
        return r

    def group(self, axis=None):
        """The process group over ``axis`` this rank belongs to (``None``:
        the default group)."""
        names = frozenset(self.names(axis))
        return None if names == frozenset(self.axes) else self.groups[names]

    def __repr__(self) -> str:
        return (f"BlockMesh({self.shape}, rank={self.rank}, device={self.device}, "
                f"backend={self.backend})")


def make_mesh(shape, *, device=None) -> BlockMesh:
    """A mesh of named axes ``shape`` (``{axis: size}``, in order) over every
    rank of the default process group, which
    :func:`~jets_tpu_torch.parallel.runner.init_distributed` makes if there
    is none (a world of one in a plain process). The sizes must multiply to
    the world size: one process runs one rank, so a rank outside the mesh
    would have nothing to do. Every rank makes, in the same order, the
    process group of each proper subset of the axes and each value of the
    other coordinates. ``device=None`` is this rank's card
    (``cuda:{LOCAL_RANK % device_count}``); ``"cpu"`` builds on the CPU
    (gloo)."""
    init_distributed(device=device)
    shape = {str(a): int(n) for a, n in dict(shape).items()}
    world = dist.get_world_size()
    if math.prod(shape.values()) != world:
        raise ValueError(f"a mesh of {shape} in a group of {world} ranks: the mesh spans "
                         "every rank of the group")
    axes = tuple(shape)
    groups = {}
    for k in range(1, len(axes)):
        for sub in itertools.combinations(axes, k):
            others = [a for a in axes if a not in sub]
            members = {}
            for r in range(world):
                key, rest = [], r
                for a in reversed(axes):
                    rest, c = divmod(rest, shape[a])
                    if a in others:
                        key.append(c)
                members.setdefault(tuple(key), []).append(r)
            mine = None
            for key in sorted(members):
                g = dist.new_group(members[key])
                if dist.get_rank() in members[key]:
                    mine = g
            groups[frozenset(sub)] = mine
    return BlockMesh(shape, dist.get_rank(), groups, rank_device(device),
                     dist.get_backend())


def make_block_mesh(n_devices: Optional[int] = None, axis: str = "block", *,
                    device=None) -> BlockMesh:
    """A 1-D mesh over every rank of the default process group
    (:func:`make_mesh`). ``n_devices``, if given, must be the world size."""
    init_distributed(device=device)
    world = dist.get_world_size()
    if n_devices is not None and int(n_devices) != world:
        raise ValueError(f"make_block_mesh({n_devices}) in a group of {world} ranks: "
                         "the mesh spans every rank of the group")
    return make_mesh({axis: world}, device=device)


class BlockSharding:
    """The counterpart of ``NamedSharding(mesh, P(*spec))``: what
    ``wavefield_sharding=`` takes. ``spec`` has one entry per leading
    tensor dimension (the rest are whole): ``None``, a mesh axis name, or a
    tuple of names (their row-major product). :meth:`axes` checks the names
    against the mesh."""

    __slots__ = ("mesh", "spec")

    def __init__(self, mesh: BlockMesh, spec: Sequence):
        spec = tuple(None if e is None else e if isinstance(e, str) else tuple(e)
                     for e in spec)
        object.__setattr__(self, "mesh", mesh)
        object.__setattr__(self, "spec", spec)

    def __setattr__(self, *a):  # pragma: no cover - defensive
        raise AttributeError("BlockSharding is immutable")

    @property
    def axes(self) -> Tuple[str, ...]:
        """The mesh axes the spec shards over, in the mesh's order;
        ``ValueError`` for a name the mesh lacks or an axis used twice."""
        used = [a for e in self.spec if e is not None for a in self.mesh.names(e)]
        if len(set(used)) != len(used):
            raise ValueError(f"sharding spec {self.spec} uses a mesh axis twice")
        return tuple(a for a in self.mesh.axes if a in used)

    def __repr__(self) -> str:
        return f"BlockSharding({self.mesh!r}, {self.spec})"


def block_sharding(mesh: BlockMesh, axis: str = "block") -> BlockSharding:
    """The sharding that splits the leading axis over the mesh axis."""
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


def local_slices(shape, mesh: BlockMesh, spec) -> Tuple[slice, ...]:
    """The rank's slab of a global array of ``shape`` split by ``spec``
    (entries as :class:`BlockSharding` takes them), one slice per
    dimension; every split must divide its dimension."""
    out = []
    for d, n in enumerate(shape):
        e = spec[d] if d < len(spec) else None
        if e is None:
            out.append(slice(0, n))
            continue
        k = mesh.axis_size(e)
        if n % k:
            raise ValueError(f"dimension {d} of {tuple(shape)} does not split into "
                             f"{k} slabs over mesh axes {mesh.names(e)}")
        lo = mesh.index(e) * (n // k)
        out.append(slice(lo, lo + n // k))
    return tuple(out)


class ShardedSpace(Space):
    """A space whose members are split over a mesh: ``shape`` is the global
    shape, and each rank's tensors hold its slab (``local_shape``). ``spec``
    (default ``(axis,)``: the leading axis over ``axis``) splits dimensions
    as :class:`BlockSharding` does. ``dot``/``norm`` reduce locally, then
    ``all_reduce`` once over the mesh axes the spec names, and only those:
    on the other axes of a 2-D mesh the members are replicas, and summing
    there would count each ``n`` times. ``randn``/``rand`` draw the global
    member and take the rank's slab, so one seed gives the same global
    vector on any mesh. The block axis of a stacked operator's range
    (shots) and the slabs of a grid-sharded model are both such spaces."""

    __slots__ = ("_mesh", "_spec", "_slices", "_local_shape", "_axes")

    def __init__(self, shape, dtype: torch.dtype, mesh: BlockMesh, axis="block", *,
                 spec=None):
        super().__init__(shape, dtype, mesh.device)
        shape = _canon_shape(shape)
        spec = BlockSharding(mesh, (axis,) if spec is None else spec)
        slices = local_slices(shape, mesh, spec.spec)
        object.__setattr__(self, "_mesh", mesh)
        object.__setattr__(self, "_spec", spec.spec)
        object.__setattr__(self, "_slices", slices)
        object.__setattr__(self, "_local_shape", tuple(s.stop - s.start for s in slices))
        object.__setattr__(self, "_axes", spec.axes)

    @property
    def mesh(self) -> BlockMesh:
        return self._mesh

    @property
    def spec(self) -> tuple:
        return self._spec

    @property
    def axes(self) -> Tuple[str, ...]:
        """The mesh axes ``dot`` and ``norm`` reduce over."""
        return self._axes

    @property
    def local_shape(self):
        return self._local_shape

    @property
    def slices(self) -> Tuple[slice, ...]:
        """The rank's slab of a global member, one slice per dimension."""
        return self._slices

    def local(self, x) -> torch.Tensor:
        """The rank's slab of a global member."""
        return x[self._slices]

    def to_dtensor(self, x):
        """A host copy of the rank's slab ``x`` as a
        :class:`torch.distributed.tensor.DTensor` of the global member, on
        :meth:`BlockMesh.device_mesh`: what a checkpoint writes for a sharded
        leaf (:func:`~jets_tpu_torch.utils.checkpoint.save_checkpoint_orbax`)
        and what sets the layout it loads into. A tuple entry of the spec
        must name its axes in the mesh's order (a DTensor splits a dimension
        over mesh dimensions in their order)."""
        from torch.distributed.tensor import DTensor, Replicate, Shard

        placements = [Replicate()] * len(self._mesh.axes)
        for d, e in enumerate(self._spec):
            if e is None:
                continue
            names = self._mesh.names(e)
            if list(names) != [a for a in self._mesh.axes if a in names]:
                raise ValueError(f"spec entry {e} does not follow the mesh's axis order "
                                 f"{self._mesh.axes}")
            for a in names:
                placements[self._mesh.axes.index(a)] = Shard(d)
        x = self.reshape(x).detach().cpu().contiguous()
        stride = tuple(math.prod(self.shape[i + 1:]) for i in range(len(self.shape)))
        return DTensor.from_local(x, self._mesh.device_mesh(), placements, run_check=False,
                                  shape=self.shape, stride=stride)

    def from_dtensor(self, t) -> torch.Tensor:
        """The rank's slab of a DTensor laid out as :meth:`to_dtensor` lays
        it, on this space's device."""
        return t.to_local().to(device=self.device, dtype=self.dtype)

    def __eq__(self, other) -> bool:
        return (super().__eq__(other) and self._mesh is other._mesh
                and self._spec == other._spec)

    def __hash__(self) -> int:
        return hash((super().__hash__(), id(self._mesh), self._spec))

    def __repr__(self) -> str:
        return (f"ShardedSpace({self.shape}, {self.dtype}, local {self._local_shape} on "
                f"{self.device}, spec {self._spec} of {self._mesh.shape})")

    def zeros(self) -> torch.Tensor:
        return torch.zeros(self._local_shape, dtype=self.dtype, device=self.device)

    def ones(self) -> torch.Tensor:
        return torch.ones(self._local_shape, dtype=self.dtype, device=self.device)

    def _draw(self, fn, generator: torch.Generator) -> torch.Tensor:
        return self.local(super()._draw(fn, generator)).contiguous()

    def reshape(self, x) -> torch.Tensor:
        """``x`` as a member: a local slab as it is, a global member's slab."""
        x = torch.as_tensor(x, device=self.device)
        if x.numel() == self.size and self.size != math.prod(self._local_shape):
            return self.local(x.reshape(self.shape)).to(self.dtype)
        if x.numel() != math.prod(self._local_shape):
            raise ValueError(f"cannot reshape size-{x.numel()} tensor into {self}")
        return x.reshape(self._local_shape).to(self.dtype)

    def _sum(self, x):
        return sum_replicated(x, self._mesh, self._axes) if self._axes else x

    def _max(self, x):
        return max_replicated(x, self._mesh, self._axes) if self._axes else x

    def dot(self, x, y):
        return self._sum(torch.vdot(x.reshape(-1), y.reshape(-1)))

    def norm(self, x, p: float = 2):
        xf = x.reshape(-1)
        if p == 2:
            return torch.sqrt(self._sum(torch.real(torch.vdot(xf, xf))))
        a = torch.abs(xf)
        if p == float("inf"):
            return self._max(torch.max(a))
        if p == float("-inf"):
            return -self._max(-torch.min(a))
        if p == 0:
            return self._sum(torch.sum(a != 0).to(a.dtype))
        return self._sum(torch.sum(a**p)) ** (1.0 / p)


def grid_axis(mesh: Optional[BlockMesh], axis: str = "block") -> Optional[str]:
    """The axis a 2-D mesh shards the model grid over: the one that is not
    the shot axis ``axis``; ``None`` for no mesh or a 1-D mesh."""
    if mesh is None or len(mesh.axes) == 1:
        return None
    others = [a for a in mesh.axes if a != axis]
    if len(others) != 1:
        raise ValueError(f"a mesh with axes {mesh.axes} has no one grid axis beside {axis!r}")
    return others[0]


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
    if state["mesh"] is None:
        return out
    return sum_replicated(out, state["mesh"], state["axis"])


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
        if nblocks % mesh.axis_size(axis):
            raise ValueError(f"nblocks {nblocks} not divisible by mesh axis {axis!r} "
                             f"size {mesh.axis_size(axis)}")
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
        "axis": axis,
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
