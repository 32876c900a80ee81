"""Vector spaces — the L0 layer (counterpart of ``jets_tpu/core/spaces.py``).

A *space* is a static description ``(shape, dtype, device)`` of where model
or data vectors live. Spaces are immutable and hashable. Unlike the JAX
package, a space names its device explicitly, and its members are created
there.

A constructor that is given no device builds on the CUDA card
(:func:`resolve_device`); there is no fallback to the CPU, which a caller
asks for with ``device="cpu"``.

Random members take an explicit :class:`torch.Generator` (the counterpart
of ``jax.random`` keys). The generator may live on another device than the
space; the draw is made on the generator's device and moved, so a CPU
generator gives the same numbers whatever the space's device.

``BlockSpace`` lives in :mod:`jets_tpu_torch.core.blockspace`.
``SymmetricSpace`` and ``MappedSymmetricSpace`` are not ported yet.
"""
from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np
import torch

__all__ = ["Space", "space_of", "zeros", "ones", "rand", "randn", "resolve_device"]


def resolve_device(device=None) -> torch.device:
    """``device`` as a :class:`torch.device`; ``None`` is the CUDA card.
    Without a card, ``None`` raises: nothing builds on the CPU unless the
    caller asks for it with ``device="cpu"``."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: jets_tpu_torch builds on the card "
                           "unless asked otherwise; pass device='cpu' to build "
                           "on the CPU")
    return torch.device("cuda")


def as_tensor(x) -> torch.Tensor:
    """``x`` as a tensor: a tensor as it is, an array (or a nested list)
    copied into a new CPU tensor of its dtype."""
    return x if isinstance(x, torch.Tensor) else torch.tensor(np.asarray(x))


def true_div(x, v: float):
    """``x / v`` as a true division on every device (PyTorch turns a
    division by a Python float on CUDA into a multiply by its reciprocal,
    which rounds differently from JAX's weak-typed scalar division)."""
    return x / torch.tensor(v, dtype=x.dtype, device=x.device)


def _canon_shape(shape: Sequence[int] | int) -> Tuple[int, ...]:
    if isinstance(shape, int):
        return (int(shape),)
    return tuple(int(s) for s in shape)


class Space:
    """A dense n-D vector space: ``(shape, dtype, device)``; ``device=None``
    is the CUDA card (:func:`resolve_device`)."""

    __slots__ = ("_shape", "_dtype", "_device")

    def __init__(self, shape: Sequence[int] | int, dtype: torch.dtype = torch.float32,
                 device: torch.device | str | None = None):
        object.__setattr__(self, "_shape", _canon_shape(shape))
        object.__setattr__(self, "_dtype", dtype)
        object.__setattr__(self, "_device", resolve_device(device))

    def __setattr__(self, *a):  # pragma: no cover - defensive
        raise AttributeError("Space is immutable")

    @property
    def shape(self) -> Tuple[int, ...]:
        return self._shape

    @property
    def dtype(self) -> torch.dtype:
        return self._dtype

    @property
    def device(self) -> torch.device:
        return self._device

    @property
    def ndim(self) -> int:
        return len(self._shape)

    @property
    def size(self) -> int:
        return int(math.prod(self._shape))

    def __len__(self) -> int:
        return self.size

    def __eq__(self, other) -> bool:
        return (
            type(self) is type(other)
            and self._shape == other._shape
            and self._dtype == other._dtype
            and self._device == other._device
        )

    def __hash__(self) -> int:
        return hash((type(self).__name__, self._shape, str(self._dtype),
                     str(self._device)))

    def __repr__(self) -> str:
        return f"Space({self._shape}, {self._dtype}, {self._device})"

    # -- allocators ----------------------------------------------------------
    def zeros(self) -> torch.Tensor:
        return torch.zeros(self._shape, dtype=self._dtype, device=self._device)

    def ones(self) -> torch.Tensor:
        return torch.ones(self._shape, dtype=self._dtype, device=self._device)

    def _draw(self, fn, generator: torch.Generator) -> torch.Tensor:
        out = fn(self._shape, generator=generator, dtype=self._dtype,
                 device=generator.device)
        return out.to(self._device)

    def rand(self, generator: torch.Generator) -> torch.Tensor:
        """Uniform [0, 1) member (complex spaces: both parts uniform)."""
        return self._draw(torch.rand, generator)

    def randn(self, generator: torch.Generator) -> torch.Tensor:
        """Standard normal member (complex spaces: unit variance in total)."""
        return self._draw(torch.randn, generator)

    # -- membership / reshape ------------------------------------------------
    def reshape(self, x) -> torch.Tensor:
        """View ``x`` as a member of this space."""
        x = torch.as_tensor(x, device=self._device)
        if x.numel() != self.size:
            raise ValueError(f"cannot reshape size-{x.numel()} tensor into {self}")
        return x.reshape(self._shape).to(self._dtype)

    def ravel(self, x) -> torch.Tensor:
        return x.reshape(-1)

    # -- inner products / norms (conjugate-linear in x) ----------------------
    def dot(self, x, y):
        return torch.vdot(x.reshape(-1), y.reshape(-1))

    def norm(self, x, p: float = 2):
        xf = x.reshape(-1)
        if p == 2:
            return torch.sqrt(torch.real(torch.vdot(xf, xf)))
        a = torch.abs(xf)
        if p == float("inf"):
            return torch.max(a)
        if p == float("-inf"):
            return torch.min(a)
        if p == 0:
            return torch.sum(a != 0).to(a.dtype)
        return torch.sum(a**p) ** (1.0 / p)


def space_of(x: torch.Tensor, *, dtype=None) -> Space:
    """The space a tensor belongs to."""
    return Space(x.shape, dtype or x.dtype, x.device)


def zeros(space: Space) -> torch.Tensor:
    return space.zeros()


def ones(space: Space) -> torch.Tensor:
    return space.ones()


def rand(generator: torch.Generator, space: Space) -> torch.Tensor:
    return space.rand(generator)


def randn(generator: torch.Generator, space: Space) -> torch.Tensor:
    return space.randn(generator)
