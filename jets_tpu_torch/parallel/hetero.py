"""Heterogeneous block distribution — mixed-shape block rows on a mesh
(counterpart of ``jets_tpu/parallel/hetero.py``).

DistributedJets.jl distributes ARBITRARY ``@blockop`` rows over workers;
rows there can differ in shape and kernel. As in the JAX package, the rows
are **group-stacked**:

1. the tall block column is partitioned into groups of STRUCTURALLY
   IDENTICAL rows (same kernel functions, same domain/range spaces, same
   state-tensor shapes — only the state *values* differ);
2. each group's per-row state tensors are stacked along a leading block
   axis and the group becomes one :func:`stacked_block_operator`, its
   unbatched row kernels mapped over the stack with ``torch.func.vmap``
   and, when the mesh axis divides the group's size, sharded over the
   mesh's ranks (forward local, adjoint one ``all_reduce``);
3. the groups are recombined with :func:`block_operator`, whose adjoint
   sums the groups' (replicated) model contributions.

Groups whose size the mesh axis does not divide stay unsharded: every rank
computes them whole. On a card the rows are built on the mesh's device
(a :class:`BlockSpace` takes subspaces of one device).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.block import block_operator
from ..core.blockspace import BlockVector
from ..core.jet import AdjointOperator, LinearOperator, Operator
from ..core.spaces import Space, as_tensor
from .collectives import gather_blocks
from .sharded import BlockMesh, shard_blocks, stacked_block_operator

__all__ = ["distribute_block_rows", "HeteroBlockLayout"]


def _is_array(v) -> bool:
    return isinstance(v, (torch.Tensor, np.ndarray))


def _is_static_value(v) -> bool:
    """True for configuration that is not tensor data: scalars, strings,
    spaces, dtypes, kernels (callables that are not operators), and tuples
    of them."""
    if v is None or isinstance(v, (bool, int, float, complex, str, bytes, Space,
                                   torch.dtype)):
        return True
    if callable(v) and not isinstance(v, Operator):
        return True
    if isinstance(v, tuple):
        return all(_is_static_value(e) for e in v)
    return False


def _structure_key(op: Operator):
    """Rows stack together iff everything except their state-tensor VALUES
    matches: kernels (by identity), spaces, state keys, tensor shapes.
    Other state (operator children of combinators, nested containers)
    cannot be stacked along a block axis — such entries key by object
    identity, so those rows form singleton groups and still compute
    correctly (unsharded)."""
    jet = op.jet
    arr_sig, static_sig = [], []
    for k in sorted(jet.state):
        v = jet.state[k]
        if _is_array(v):
            arr_sig.append((k, tuple(v.shape), str(v.dtype)))
        elif _is_static_value(v):
            static_sig.append(k)
        else:
            static_sig.append((k, id(v)))  # unstackable: singleton group
    # a linear jet's forward and a self-adjoint dft are fresh closures per
    # construction; what matters is the kernel they derive from
    f_key = ("<linear-from-df>" if getattr(jet.f, "__wrapped_df__", None) is jet.df
             else jet.f)
    df_key = ("<tangent-from-f>" if getattr(jet.df, "__wrapped_f__", None) is jet.f
              else jet.df)
    dft_key = ("<self-adjoint>" if getattr(jet.dft, "__self_adjoint_from__", None) is jet.df
               else jet.dft)
    return (f_key, df_key, dft_key, jet.upstate, op.dom, op.rng,
            tuple(arr_sig), tuple(static_sig), type(op))


def _statics_equal(a, b) -> bool:
    if callable(a) or callable(b):
        return a is b
    try:
        return bool(a == b)
    except (TypeError, ValueError, RuntimeError):  # incomparable config: identity
        return a is b


class HeteroBlockLayout:
    """The result of :func:`distribute_block_rows`.

    ``operator``: a :func:`block_operator` over one stacked (and, where
    possible, sharded) operator per group. ``groups``: per group, the list
    of ORIGINAL row indices it holds (rows are regrouped; :meth:`pack` and
    :meth:`unpack` convert data). ``sharded``: per group, whether its rows
    are split over the mesh.
    """

    def __init__(self, operator: Operator, groups: List[List[int]],
                 group_spaces: List[Space], mesh: Optional[BlockMesh], axis: str,
                 sharded: List[bool]):
        self.operator = operator
        self.groups = groups
        self._group_spaces = group_spaces
        self._mesh = mesh
        self._axis = axis
        self.sharded = sharded

    def pack(self, blocks: Sequence[Any]) -> BlockVector:
        """Stack per-row data blocks (in ORIGINAL row order) into the
        operator's grouped range layout; a sharded group keeps this rank's
        slab of its stack."""
        out = []
        for gi, rows in enumerate(self.groups):
            sp = self._group_spaces[gi]
            stack = torch.stack([as_tensor(blocks[i]) for i in rows]).to(sp.device, sp.dtype)
            if self.sharded[gi]:
                stack = shard_blocks(stack, self._mesh, self._axis)
            out.append(stack)
        return BlockVector(out, self.operator.rng)

    def unpack(self, bv: BlockVector) -> List[Any]:
        """Split a grouped range vector back into per-row blocks in ORIGINAL
        row order, on every rank (a sharded group's slabs are gathered)."""
        n = sum(len(g) for g in self.groups)
        blocks: List[Any] = [None] * n
        for gi, rows in enumerate(self.groups):
            stack = bv.getblock(gi)
            if self.sharded[gi]:
                stack = gather_blocks(stack, len(rows), self._mesh, self._axis)
            for k, i in enumerate(rows):
                blocks[i] = stack[k]
        return blocks


def _make_group_operator(ops: Sequence[LinearOperator], mesh: Optional[BlockMesh],
                         axis: str) -> Tuple[Operator, bool]:
    """Stack structurally identical rows into ONE stacked block operator:
    per-row state tensors gain a leading block dim, and the row kernels are
    mapped over it with ``torch.func.vmap``; static state is checked equal
    and closed over."""
    proto = ops[0].jet
    keys = sorted(proto.state)
    arr_keys = [k for k in keys if _is_array(proto.state[k])]
    static = {k: proto.state[k] for k in keys if k not in arr_keys}
    for op in ops[1:]:
        for k, v in static.items():
            if not _statics_equal(op.jet.state[k], v):
                raise ValueError(f"group rows disagree on static state {k!r}")
    bstate: Dict[str, Any] = {
        k: torch.stack([as_tensor(op.jet.state[k]) for op in ops]) for k in arr_keys
    }
    child_df = proto.df
    child_dft = proto.dft if callable(proto.dft) else None

    def df(dm, m0, bs):
        return torch.func.vmap(lambda st: child_df(dm, m0, {**st, **static}))(bs)

    dft = None
    if child_dft is not None:
        def dft(dd, m0, bs):  # noqa: E306
            return torch.func.vmap(lambda d, st: child_dft(d, m0, {**st, **static}))(dd, bs)

    use_mesh = mesh is not None and len(ops) % mesh.shape[axis] == 0
    stacked = stacked_block_operator(
        nblocks=len(ops), dom=ops[0].dom, rng_block=ops[0].rng, bstate=bstate, df=df,
        dft=dft, mesh=mesh if use_mesh else None, axis=axis)
    return stacked, use_mesh


def distribute_block_rows(rows: Sequence[Operator], mesh: Optional[BlockMesh] = None,
                          axis: str = "block") -> HeteroBlockLayout:
    """Distribute a HETEROGENEOUS tall block column over a mesh.

    ``rows[i]`` maps the SHARED model space to its own data block (the
    reference's N×1 ``@blockop``); rows may mix shapes and kernels freely.
    Rows are grouped by structure, each group stacked into one operator
    and — when the mesh axis divides its size — sharded over it; the
    grouped operator's forward and adjoint are those of
    ``block_operator([[r] for r in rows])`` up to the regrouping of rows
    (:meth:`HeteroBlockLayout.pack`). All rows must be linear.
    """
    rows = list(rows)
    if not rows:
        raise ValueError("no rows")
    dom = rows[0].dom
    for op in rows:
        if not isinstance(op, LinearOperator):
            raise TypeError("distribute_block_rows requires linear rows (linearize "
                            "nonlinear operators first)")
        if isinstance(op, AdjointOperator):
            raise TypeError("adjoint-wrapped rows cannot be stacked directly; "
                            "materialize the adjoint kernel in a plain operator first")
        if op.dom != dom:
            raise ValueError("rows must share one model domain")

    by_key: Dict[Any, List[int]] = {}
    for i, op in enumerate(rows):
        by_key.setdefault(_structure_key(op), []).append(i)
    groups = list(by_key.values())
    group_ops, sharded = [], []
    for idx in groups:
        gop, used = _make_group_operator([rows[i] for i in idx], mesh, axis)
        group_ops.append(gop)
        sharded.append(used)
    # a 1-column block operator over the group-stacked rows: the range is a
    # BlockSpace (one block per group) whichever way the grouping fell out
    op = block_operator([[gop] for gop in group_ops])
    return HeteroBlockLayout(op, groups, [g.rng for g in group_ops], mesh, axis, sharded)
