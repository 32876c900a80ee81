"""Block operators (counterpart of ``jets_tpu/core/block.py``).

A block operator is a block matrix of operators. Forward and tangent walk
the row blocks, summing over columns; the adjoint walks the columns,
summing over rows. Structural zeros (:func:`zero_block`) are skipped, so
they cost nothing. A single-column block operator keeps its child's
(non-block) domain unless ``dadom=True``.
"""
from __future__ import annotations

from typing import Sequence

from .algebra import _device_of, _wrap, compose, is_composite
from .blockspace import BlockSpace, BlockVector
from .jet import AdjointOperator, Jet, LinearOperator, Operator
from .spaces import Space

__all__ = [
    "block_operator",
    "zero_block",
    "is_zero_block",
    "is_block_op",
    "nblocks",
    "getblock",
]


# -- structural zero block ---------------------------------------------------------


def _zero_df(dm, m0, state):
    return state["rng"].zeros()


def _zero_dft(dd, m0, state):
    return state["dom"].zeros()


def zero_block(dom: Space, rng: Space) -> LinearOperator:
    """The structural zero ``dom -> rng``, skipped inside block operators."""
    j = Jet(dom=dom, rng=rng, df=_zero_df, dft=_zero_dft,
            state={"dom": dom, "rng": rng})
    return LinearOperator(j)


def is_zero_block(op: Operator) -> bool:
    return isinstance(op, Operator) and op.jet.df is _zero_df


# -- block operator kernels --------------------------------------------------------


def _col(m, j, block_dom: bool):
    return m.getblock(j) if block_dom else m


def _rows(m, state, apply):
    """``d_i = Σ_j apply(op_ij, m_j)`` over the non-zero blocks."""
    ops, rng, block_dom = state["ops"], state["rng"], state["block_dom"]
    rows = []
    for i, row in enumerate(ops):
        acc = None
        for j, op in enumerate(row):
            if is_zero_block(op):
                continue
            term = apply(op, _col(m, j, block_dom))
            acc = term if acc is None else acc + term
        rows.append(rng.subspace(i).zeros() if acc is None else acc)
    return BlockVector(rows, rng)


def _block_f(m, state):
    return _rows(m, state, lambda op, x: op(x))


def _linear_apply(op, x):
    if not isinstance(op, LinearOperator):
        raise ValueError("tangent of a nonlinear block operator requires linearize first")
    return op(x)


def _block_df(dm, m0, state):
    return _rows(dm, state, _linear_apply)


def _block_dft(dd, m0, state):
    """Adjoint: column-major accumulation ``m_j += op_ij^H d_i``."""
    ops, dom, block_dom = state["ops"], state["dom"], state["block_dom"]
    cols = []
    for j in range(len(ops[0])):
        acc = None
        for i, row in enumerate(ops):
            if is_zero_block(row[j]):
                continue
            term = row[j].adjoint_apply(dd.getblock(i))
            acc = term if acc is None else acc + term
        if acc is None:
            acc = (dom.subspace(j) if block_dom else dom).zeros()
        cols.append(acc)
    return BlockVector(cols, dom) if block_dom else cols[0]


def _block_upstate(m0, state):
    """Pin every child at its domain block of ``m0``."""
    block_dom = state["block_dom"]
    return {"ops": tuple(
        tuple(op if is_zero_block(op) else op.linearize(_col(m0, j, block_dom))
              for j, op in enumerate(row))
        for row in state["ops"])}


def is_block_op(op: Operator) -> bool:
    return isinstance(op, Operator) and op.jet.f is _block_f


# -- construction --------------------------------------------------------------------


def block_operator(rows: Sequence[Sequence], *, dadom: bool = False) -> Operator:
    """A block-matrix operator from a 2-D nest: ``rows[i][j]`` maps domain
    block ``j`` to range block ``i``. Entries may be operators, raw 2-D
    tensors or arrays (wrapped as matrix operators; an array goes to the
    device of the nest's first operator, or to the card with none), or
    :func:`zero_block` instances. A :class:`LinearOperator` iff every child
    is linear."""
    dev = _device_of(e for row in rows for e in row)
    ops = tuple(tuple(_wrap(e, dev) for e in row) for row in rows)
    if not ops or not ops[0]:
        raise ValueError("block_operator needs a non-empty 2-D nest of operators")
    ncols = len(ops[0])
    if any(len(row) != ncols for row in ops):
        raise ValueError("ragged block rows")
    for j in range(ncols):
        doms = {row[j].dom for row in ops}
        if len(doms) != 1:
            raise ValueError(f"column {j}: inconsistent child domains {doms}")
    for i, row in enumerate(ops):
        rngs = {op.rng for op in row}
        if len(rngs) != 1:
            raise ValueError(f"row {i}: inconsistent child ranges {rngs}")

    block_dom = ncols > 1 or dadom
    dom = BlockSpace([op.dom for op in ops[0]]) if block_dom else ops[0][0].dom
    rng = BlockSpace([row[0].rng for row in ops])
    j = Jet(dom=dom, rng=rng, f=_block_f, df=_block_df, dft=_block_dft,
            upstate=_block_upstate,
            state={"ops": ops, "dom": dom, "rng": rng, "block_dom": block_dom})
    all_linear = all(isinstance(op, LinearOperator) for row in ops for op in row)
    return (LinearOperator if all_linear else Operator)(j)


# -- block introspection ---------------------------------------------------------------


def nblocks(op: Operator):
    """``(nrows, ncols)`` of a block operator; ``(1, 1)`` for any other.

    The adjoint check comes first: an :class:`AdjointOperator` shares its
    block jet, so ``is_block_op`` is true for it too. A composition counts
    the most rows and columns among its blocky factors."""
    if isinstance(op, AdjointOperator):
        r, c = nblocks(op.op)
        return (c, r)
    if is_block_op(op):
        ops = op.jet.state["ops"]
        return (len(ops), len(ops[0]))
    if is_composite(op):
        rows = cols = 1
        for child in op.jet.state["ops"]:
            if is_block_op(child) or isinstance(child, AdjointOperator):
                r, c = nblocks(child)
                rows, cols = max(rows, r), max(cols, c)
        return (rows, cols)
    return (1, 1)


def getblock(op: Operator, i: int, j: int = 0) -> Operator:
    """The ``(i, j)`` block of a block operator. An adjoint block operator
    gives the adjoint of its ``(j, i)`` child; through a composition, the
    ``(i, j)`` blocks of the blocky factors are composed."""
    if isinstance(op, AdjointOperator):
        # adjoint first: it shares the block jet, so is_block_op is true
        inner = getblock(op.op, j, i)
        if not isinstance(inner, LinearOperator):
            raise TypeError("adjoint block of a nonlinear child")
        return inner.H
    if is_block_op(op):
        return op.jet.state["ops"][i][j]
    if is_composite(op):
        return compose(*(
            getblock(child, i, j)
            if is_block_op(child) or (isinstance(child, AdjointOperator)
                                      and is_block_op(child.op))
            else child
            for child in op.jet.state["ops"]))
    if i == 0 and j == 0:
        return op
    raise IndexError("not a block operator")
