"""Linear interpolation operator (counterpart of ``jets_tpu/ops/interp.py``):
sample a gridded signal at fractional positions along one axis.

The forward is two ``index_select``\\ s blended by the fractional weights.
The adjoint is a scatter-add with duplicate target bins, which on the card
(``index_add_``) would add in an order that changes from run to run. So it
is a gather instead: a numpy table lists, for each target bin, the
positions that add into it (the ``i0`` contributions in position order,
then the ``i1`` ones, the order of the JAX package's two scatter-adds),
padded with a zero slot, and the gathered slices are added one after
another. The same bits come out on every call.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.jet import Jet, LinearOperator
from ..core.spaces import Space, np_dtype

__all__ = ["interp_operator", "gather_table"]


def gather_table(targets, n: int) -> np.ndarray:
    """The ``(K, n)`` int64 table of a scatter-add ``out[targets[i]] +=
    src[i]`` as a gather: row ``k`` holds the ``k``-th source index of each
    target bin, in source order, and ``len(targets)`` (a zero slot) where a
    bin has fewer than ``K`` sources. ``out = Σ_k src_padded[table[k]]``."""
    targets = np.asarray(targets, dtype=np.int64)
    order = np.argsort(targets, kind="stable")
    counts = np.bincount(targets, minlength=n)
    K = max(int(counts.max()) if counts.size else 0, 1)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    rank = np.arange(order.size) - np.repeat(starts, counts)
    table = np.full((K, n), targets.size, dtype=np.int64)
    table[rank, targets[order]] = order
    return table


def _interp_df(dm, m0, state):
    ax = state["axis"]
    a = torch.index_select(dm, ax, state["i0"])
    b = torch.index_select(dm, ax, state["i1"])
    w = state["w"].reshape([-1 if i == ax else 1 for i in range(dm.ndim)])
    return (1.0 - w) * a + w * b


def _interp_dft(dd, m0, state):
    ax = state["axis"]
    w = state["w"].reshape([-1 if i == ax else 1 for i in range(dd.ndim)])
    zero = torch.zeros_like(dd.narrow(ax, 0, 1))
    src = torch.cat([(1.0 - w) * dd, w * dd, zero], dim=ax)
    table = state["table"]
    out = torch.index_select(src, ax, table[0])
    for k in range(1, table.shape[0]):
        out = out + torch.index_select(src, ax, table[k])
    return out


def interp_operator(space: Space, positions, axis: int = -1) -> LinearOperator:
    """Linear interpolation of ``space`` onto fractional sample positions
    (in units of the grid index, clipped to ``[0, n-1]``) along ``axis``.
    The range swaps that axis's length for ``len(positions)``."""
    axis = int(axis) % space.ndim
    n = space.shape[axis]
    pos = np.clip(np.asarray(positions, dtype=np.float64), 0.0, n - 1.0)
    if pos.ndim != 1:
        raise ValueError("positions must be 1-D")
    i0 = (np.minimum(np.floor(pos).astype(np.int32), n - 2) if n > 1
          else np.zeros(pos.shape, np.int32))
    i0 = np.maximum(i0, 0)
    w = (pos - i0).astype(np_dtype(space.dtype) if space.dtype.is_floating_point
                          else np.float32)
    i1 = np.minimum(i0 + 1, n - 1)
    # the adjoint's sources: (1-w)·dd at i0 (slots 0..P-1), then w·dd at
    # i1 (slots P..2P-1)
    table = gather_table(np.concatenate([i0, i1]), n)
    rng_shape = list(space.shape)
    rng_shape[axis] = pos.shape[0]
    dev = space.device

    def t(a, dtype=torch.int64):
        return torch.from_numpy(np.asarray(a)).to(dtype=dtype, device=dev)

    j = Jet(dom=space, rng=Space(tuple(rng_shape), space.dtype, dev), df=_interp_df,
            dft=_interp_dft,
            state={"i0": t(i0), "i1": t(i1), "w": t(w, space.dtype), "table": t(table),
                   "axis": axis, "n": n})
    return LinearOperator(j)
