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

``SymmetricSpace`` (the stored half of an rfft range) and
``MappedSymmetricSpace`` (any Hermitian index map, built by :func:`symspace`)
weight their inner products by each stored element's multiplicity in the
logical array; their weight tables live on the space's device, in its real
dtype. ``BlockSpace`` lives in :mod:`jets_tpu_torch.core.blockspace`.
"""
from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np
import torch

__all__ = ["Space", "SymmetricSpace", "MappedSymmetricSpace", "symspace", "space_of",
           "zeros", "ones", "rand", "randn", "randperm", "resolve_device"]


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


def real_dtype(dtype: torch.dtype) -> torch.dtype:
    """The real dtype of ``dtype``'s values (itself for a real dtype)."""
    return torch.empty((), dtype=dtype).real.dtype


def complex_dtype(dtype: torch.dtype) -> torch.dtype:
    """The complex dtype of the spectra of real ``dtype`` data: complex128
    only for float64."""
    return torch.complex128 if dtype == torch.float64 else torch.complex64


def np_dtype(dtype: torch.dtype) -> np.dtype:
    """The numpy dtype of a torch dtype."""
    return torch.empty((), dtype=dtype).numpy().dtype


def check_real_floating(space, name: str) -> None:
    """Raise unless ``space`` holds real floating-point members."""
    if space.dtype.is_complex or not space.dtype.is_floating_point:
        raise TypeError(f"{name} needs a real floating space")


def _canon_shape(shape: Sequence[int] | int) -> Tuple[int, ...]:
    if isinstance(shape, (int, np.integer)):
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


class SymmetricSpace(Space):
    """Space with Hermitian symmetry along one axis: the range of an rfft.

    Members are complex tensors of the *stored* (``torch.fft.rfftn``
    output) shape; ``logical_shape`` is the full real-transform shape. Inner
    products weight each stored element by its multiplicity in the logical
    array (1 for self-conjugate bins, 2 otherwise), so adjoints built
    against this space pass the dot-product test as full-spectrum operators
    would. The weights are built once, on the space's device and in its
    real dtype.
    """

    __slots__ = ("_logical_shape", "_axis", "_w")

    def __init__(self, stored_shape: Sequence[int] | int,
                 logical_shape: Sequence[int] | int,
                 dtype: torch.dtype = torch.complex64, axis: int = -1,
                 device: torch.device | str | None = None):
        super().__init__(stored_shape, dtype, device)
        object.__setattr__(self, "_logical_shape", _canon_shape(logical_shape))
        ax = axis % len(self._shape)
        object.__setattr__(self, "_axis", ax)
        n_log = self._logical_shape[ax]
        n_sto = self._shape[ax]
        if n_sto != n_log // 2 + 1:
            raise ValueError(
                f"stored axis {ax} has {n_sto} elements; expected "
                f"{n_log // 2 + 1} for logical length {n_log}")
        # bin 0 and (for an even logical length) the Nyquist bin are
        # self-conjugate
        w = torch.full((n_sto,), 2.0, dtype=real_dtype(dtype), device=self._device)
        w[0] = 1.0
        if n_log % 2 == 0:
            w[-1] = 1.0
        shape = [1] * len(self._shape)
        shape[ax] = n_sto
        object.__setattr__(self, "_w", w.reshape(shape))

    @property
    def logical_shape(self) -> Tuple[int, ...]:
        return self._logical_shape

    @property
    def axis(self) -> int:
        return self._axis

    def _weights(self) -> torch.Tensor:
        """Per-element multiplicity of each stored bin in the logical array."""
        return self._w

    def dot(self, x, y):
        """The full logical-spectrum dot for Hermitian-symmetric members,
        a 0-d tensor of the space's complex dtype: each doubled bin pair
        contributes ``2·Re(conj(x)·y)`` (the pair's imaginary parts cancel in
        the logical array), self-conjugate bins contribute fully."""
        w = self._w
        z = torch.conj(x) * y
        re = torch.sum(w * torch.real(z))
        im = torch.sum(torch.where(w == 1.0, torch.imag(z), 0.0))
        return torch.complex(re, im).to(self._dtype)

    def norm(self, x, p: float = 2):
        w = self._w
        a = torch.abs(x)
        if p == 2:
            return torch.sqrt(torch.sum(w * a**2))
        if p == float("inf"):
            return torch.max(a)
        if p == float("-inf"):
            return torch.min(a)
        if p == 0:
            return torch.sum(w * (a != 0))
        return torch.sum(w * a**p) ** (1.0 / p)

    def __eq__(self, other) -> bool:
        return (super().__eq__(other) and self._logical_shape == other._logical_shape
                and self._axis == other._axis)

    def __hash__(self) -> int:
        return hash((super().__hash__(), self._logical_shape, self._axis))

    def __repr__(self) -> str:
        return (f"SymmetricSpace(stored={self._shape}, logical={self._logical_shape}, "
                f"{self._dtype}, {self._device})")

    def to_logical(self, x) -> torch.Tensor:
        """Expand a stored member to the FULL logical spectrum: the missing
        bins ``k > n//2`` on the symmetric axis are ``conj`` of the stored
        bins with every axis modularly reflected (``i -> (n - i) % n``),
        the n-D DFT Hermitian symmetry, so ``to_logical(rfftn(x)) ==
        fftn(x)`` for real ``x``."""
        ax = self._axis
        n_log = self._logical_shape[ax]
        h = n_log // 2
        # mirrored source bins on the symmetric axis: 1..h-1 (even n) or
        # 1..h (odd n), read in reverse
        jhi = h if n_log % 2 == 0 else h + 1
        tail = torch.flip(torch.conj(x.narrow(ax, 1, jhi - 1)), (ax,))
        for oax in range(self.ndim):
            if oax != ax:
                tail = torch.roll(torch.flip(tail, (oax,)), 1, oax)
        return torch.cat([x, tail], dim=ax)

    def from_logical(self, y) -> torch.Tensor:
        """Crop a full logical spectrum back to the stored half (left
        inverse of :meth:`to_logical`)."""
        return y.narrow(self._axis, 0, self._shape[self._axis]).to(self._dtype).contiguous()


class MappedSymmetricSpace(Space):
    """Space with an arbitrary Hermitian-redundancy index map.

    Members are tensors of the *stored* shape, an axes-aligned prefix box
    of the logical shape. ``index_map`` is a vectorized callable: given a
    tuple of numpy index arrays of logical positions OUTSIDE the stored
    box, it returns the tuple of stored indices whose conjugates live there.

    Inner products and norms weight each stored element by its multiplicity
    in the logical array, so ``dot(x, y)`` equals the full logical-spectrum
    ``vdot(to_logical(x), to_logical(y))``. The symmetry tables are computed
    once with numpy and moved to the space's device (the mirror counts in
    the space's real dtype): meant for author-defined transform ranges, not
    multi-GB grids, for which :class:`SymmetricSpace` needs no tables.
    """

    __slots__ = ("_logical_shape", "_map_fn", "_src", "_c", "_mask")

    def __init__(self, stored_shape: Sequence[int] | int,
                 logical_shape: Sequence[int] | int,
                 dtype: torch.dtype = torch.complex64, index_map=None,
                 device: torch.device | str | None = None):
        super().__init__(stored_shape, dtype, device)
        sset = object.__setattr__
        sset(self, "_logical_shape", _canon_shape(logical_shape))
        if len(self._logical_shape) != len(self._shape):
            raise ValueError("stored/logical ndim mismatch")
        if any(s > m for s, m in zip(self._shape, self._logical_shape)):
            raise ValueError("stored box must fit inside the logical shape")
        if index_map is None:
            raise ValueError("index_map is required (the symspace hook)")
        sset(self, "_map_fn", index_map)
        grids = np.meshgrid(*[np.arange(M) for M in self._logical_shape], indexing="ij")
        inside = np.ones(self._logical_shape, bool)
        for g, s in zip(grids, self._shape):
            inside &= g < s
        src = np.empty(self._logical_shape, np.int64)
        src[inside] = np.ravel_multi_index(tuple(g[inside] for g in grids), self._shape)
        out_idx = tuple(g[~inside] for g in grids)
        if out_idx[0].size:
            mapped = tuple(np.asarray(m) for m in index_map(out_idx))
            for m, s in zip(mapped, self._shape):
                if np.any((m < 0) | (m >= s)):
                    raise ValueError("index_map must land inside the stored box")
            src[~inside] = np.ravel_multi_index(mapped, self._shape)
        # per-stored-element count of mirrored logical positions
        nmirror = np.bincount(src[~inside].ravel(), minlength=self.size).reshape(self._shape)
        dev = self._device
        sset(self, "_src", torch.from_numpy(src.ravel()).to(dev))
        sset(self, "_c", torch.from_numpy(nmirror).to(dtype=real_dtype(dtype), device=dev))
        sset(self, "_mask", torch.from_numpy(inside.ravel()).to(dev))

    @property
    def logical_shape(self) -> Tuple[int, ...]:
        return self._logical_shape

    # <x, y>_logical = sum_stored z + sum_mirror conj(z_src) with
    # z = conj(x) y, so each stored element contributes
    # (1 + c) Re(z) + i (1 - c) Im(z) for c mirrored copies
    def dot(self, x, y):
        c = self._c
        z = torch.conj(x) * y
        re = torch.sum((1.0 + c) * torch.real(z))
        im = torch.sum((1.0 - c) * torch.imag(z))
        return torch.complex(re, im).to(self._dtype)

    def norm(self, x, p: float = 2):
        w = 1.0 + self._c
        a = torch.abs(x)
        if p == 2:
            return torch.sqrt(torch.sum(w * a**2))
        if p == float("inf"):
            return torch.max(a)
        if p == float("-inf"):
            return torch.min(a)
        if p == 0:
            return torch.sum(w * (a != 0))
        return torch.sum(w * a**p) ** (1.0 / p)

    def to_logical(self, x) -> torch.Tensor:
        """The full logical array: each logical position gathered from its
        stored source, the mirrored ones conjugated."""
        flat = torch.take(x.reshape(-1), self._src)
        flat = torch.where(self._mask, flat, torch.conj(flat))
        return flat.reshape(self._logical_shape)

    def from_logical(self, y) -> torch.Tensor:
        """Crop a logical array back to the stored box."""
        return y[tuple(slice(0, s) for s in self._shape)].to(self._dtype).contiguous()

    def __eq__(self, other) -> bool:
        return (super().__eq__(other) and self._logical_shape == other._logical_shape
                and self._map_fn is other._map_fn)

    def __hash__(self) -> int:
        return hash((super().__hash__(), self._logical_shape, id(self._map_fn)))

    def __repr__(self) -> str:
        return (f"MappedSymmetricSpace(stored={self._shape}, "
                f"logical={self._logical_shape}, {self._dtype}, {self._device})")


def symspace(stored_shape: Sequence[int] | int, logical_shape: Sequence[int] | int,
             dtype: torch.dtype = torch.complex64, index_map=None,
             device: torch.device | str | None = None) -> MappedSymmetricSpace:
    """The author hook for a custom Hermitian-redundant space: operator
    authors whose ranges store only the non-redundant half of a symmetric
    transform build their range space here by supplying the index map."""
    return MappedSymmetricSpace(stored_shape, logical_shape, dtype, index_map, device)


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


def randperm(generator: torch.Generator, space: Space, k: int | None = None):
    """A random permutation of the linear indices of ``space``, on its
    device (drawn on the generator's device); with ``k``, the SORTED first
    ``k`` draws, as downstream masking and restriction take monotone index
    lists."""
    p = torch.randperm(space.size, generator=generator, device=generator.device)
    p = p.to(space.device)
    return p if k is None else torch.sort(p[:k]).values
