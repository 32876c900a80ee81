"""Block vector spaces (counterpart of ``jets_tpu/core/blockspace.py``).

A :class:`BlockSpace` concatenates subspaces into one logical 1-D space
with per-block index ranges; a :class:`BlockVector` is its member type — an
immutable tuple of per-block tensors, registered with
:mod:`torch.utils._pytree`, so ``torch.func.jvp``/``vjp``/``vmap`` and
:func:`jets_tpu_torch.utils.tree.tmap` see it as a node whose leaves are the
blocks. The space rides in the node's context, so a primal and its tangent
have equal tree structures exactly when they belong to the same space.

Random members take one :class:`torch.Generator` and draw the blocks in
order from it (the counterpart of splitting a ``jax.random`` key).
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch
from torch.utils import _pytree as pytree

from .spaces import Space

__all__ = ["BlockSpace", "BlockVector"]


class BlockVector:
    """Member of a :class:`BlockSpace`: a tuple of per-block tensors with
    blockwise arithmetic, ``dot``/``norm`` (delegated to the space, so each
    block is weighted by its own subspace), functional
    ``getblock``/``setblock``, ``ravel``, ``extrema`` and ``fill``."""

    __slots__ = ("blocks", "space")

    def __init__(self, blocks: Sequence[torch.Tensor], space: "BlockSpace"):
        object.__setattr__(self, "blocks", tuple(blocks))
        object.__setattr__(self, "space", space)

    def __setattr__(self, *a):  # pragma: no cover - defensive
        raise AttributeError("BlockVector is immutable; use setblock()")

    # -- block access ----------------------------------------------------------
    @property
    def nblocks(self) -> int:
        return len(self.blocks)

    def getblock(self, i: int) -> torch.Tensor:
        return self.blocks[i]

    def setblock(self, i: int, value) -> "BlockVector":
        sub = self.space.spaces[i]
        v = torch.as_tensor(value)
        if tuple(v.shape) != sub.local_shape:
            raise ValueError(f"block {i}: shape {tuple(v.shape)} != {sub.local_shape}")
        new = list(self.blocks)
        new[i] = v.to(device=sub.device, dtype=sub.dtype)
        return BlockVector(new, self.space)

    def __getitem__(self, i: int) -> torch.Tensor:
        return self.blocks[i]

    def __iter__(self):
        return iter(self.blocks)

    def __len__(self) -> int:
        return self.space.size

    # -- conversion --------------------------------------------------------------
    def ravel(self) -> torch.Tensor:
        return torch.cat([b.reshape(-1) for b in self.blocks])

    # -- blockwise arithmetic ----------------------------------------------------
    def _zip(self, other, fn):
        if isinstance(other, BlockVector):
            if other.space != self.space:
                raise ValueError("BlockVector space mismatch")
            return BlockVector([fn(a, b) for a, b in zip(self.blocks, other.blocks)],
                               self.space)
        return BlockVector([fn(a, other) for a in self.blocks], self.space)

    def __add__(self, other):
        return self._zip(other, lambda a, b: a + b)

    def __radd__(self, other):
        return self._zip(other, lambda a, b: b + a)

    def __sub__(self, other):
        return self._zip(other, lambda a, b: a - b)

    def __rsub__(self, other):
        return self._zip(other, lambda a, b: b - a)

    def __mul__(self, other):
        return self._zip(other, lambda a, b: a * b)

    def __rmul__(self, other):
        return self._zip(other, lambda a, b: b * a)

    def __truediv__(self, other):
        return self._zip(other, lambda a, b: a / b)

    def __neg__(self):
        return BlockVector([-a for a in self.blocks], self.space)

    # -- reductions ----------------------------------------------------------------
    def dot(self, other: "BlockVector"):
        return self.space.dot(self, other)

    def norm(self, p: float = 2):
        return self.space.norm(self, p)

    def extrema(self) -> Tuple[torch.Tensor, torch.Tensor]:
        lo = torch.min(torch.stack([torch.min(torch.real(b)) for b in self.blocks]))
        hi = torch.max(torch.stack([torch.max(torch.real(b)) for b in self.blocks]))
        return lo, hi

    def fill(self, value) -> "BlockVector":
        return BlockVector([torch.full_like(b, value) for b in self.blocks], self.space)

    def __repr__(self) -> str:
        return f"BlockVector(nblocks={self.nblocks}, space={self.space})"


class BlockSpace(Space):
    """Concatenation of subspaces (same dtype and device) into one logical
    1-D space."""

    __slots__ = ("_spaces", "_offsets")

    def __init__(self, spaces: Sequence[Space]):
        spaces = tuple(spaces)
        if not spaces:
            raise ValueError("BlockSpace needs at least one subspace")
        dt, dev = spaces[0].dtype, spaces[0].device
        for s in spaces:
            if s.dtype != dt:
                raise TypeError(
                    f"BlockSpace subspaces must share a dtype; got {s.dtype} vs {dt}")
            if s.device != dev:
                raise ValueError(
                    f"BlockSpace subspaces must share a device; got {s.device} vs {dev}")
        super().__init__((sum(s.size for s in spaces),), dt, dev)
        object.__setattr__(self, "_spaces", spaces)
        offs = np.cumsum([0] + [s.size for s in spaces])
        object.__setattr__(self, "_offsets", tuple(int(o) for o in offs))

    @property
    def spaces(self) -> Tuple[Space, ...]:
        return self._spaces

    @property
    def nblocks(self) -> int:
        return len(self._spaces)

    def indices(self, i: int) -> range:
        """Linear index range of block ``i``."""
        return range(self._offsets[i], self._offsets[i + 1])

    def subspace(self, i: int) -> Space:
        return self._spaces[i]

    # -- identity --------------------------------------------------------------------
    def __eq__(self, other) -> bool:
        return type(self) is type(other) and self._spaces == other._spaces

    def __hash__(self) -> int:
        return hash(("BlockSpace", self._spaces))

    def __repr__(self) -> str:
        return (f"BlockSpace(nblocks={self.nblocks}, size={self.size}, {self.dtype}, "
                f"{self.device})")

    # -- allocators --------------------------------------------------------------------
    def zeros(self) -> BlockVector:
        return BlockVector([s.zeros() for s in self._spaces], self)

    def ones(self) -> BlockVector:
        return BlockVector([s.ones() for s in self._spaces], self)

    def rand(self, generator: torch.Generator) -> BlockVector:
        return BlockVector([s.rand(generator) for s in self._spaces], self)

    def randn(self, generator: torch.Generator) -> BlockVector:
        return BlockVector([s.randn(generator) for s in self._spaces], self)

    # -- membership ----------------------------------------------------------------------
    def reshape(self, x) -> BlockVector:
        if isinstance(x, BlockVector):
            if x.space != self:
                raise ValueError("BlockVector belongs to a different BlockSpace")
            return x
        x = torch.as_tensor(x, device=self.device).reshape(-1)
        if x.numel() != self.size:
            raise ValueError(f"cannot reshape size-{x.numel()} tensor into {self}")
        return BlockVector(
            [x[self._offsets[i]:self._offsets[i + 1]].reshape(s.shape).to(s.dtype)
             for i, s in enumerate(self._spaces)], self)

    def ravel(self, x) -> torch.Tensor:
        if isinstance(x, BlockVector):
            return x.ravel()
        return x.reshape(-1)

    # -- reductions: per-block partials ------------------------------------------------
    def dot(self, x, y):
        xb, yb = self.reshape(x).blocks, self.reshape(y).blocks
        return torch.sum(torch.stack([s.dot(a, b)
                                      for s, a, b in zip(self._spaces, xb, yb)]))

    def norm(self, x, p: float = 2):
        parts = torch.stack([s.norm(b, p)
                             for s, b in zip(self._spaces, self.reshape(x).blocks)])
        if p == 2:
            return torch.sqrt(torch.sum(parts**2))
        if p == float("inf"):
            return torch.max(parts)
        if p == float("-inf"):
            return torch.min(parts)
        if p == 0:
            return torch.sum(parts)
        return torch.sum(parts**p) ** (1.0 / p)


# -- pytree registration ---------------------------------------------------------------


def _bv_flatten(v: BlockVector):
    return list(v.blocks), v.space


def _bv_unflatten(blocks, space):
    return BlockVector(blocks, space)


pytree.register_pytree_node(
    BlockVector, _bv_flatten, _bv_unflatten,
    serialized_type_name="jets_tpu_torch.core.blockspace.BlockVector")
