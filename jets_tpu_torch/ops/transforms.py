"""Transform and structural operators (counterpart of
``jets_tpu/ops/transforms.py``): the orthonormal DCT, identity,
zero-padding and restriction, reshape, real and imaginary parts,
transpose, flip, flat permutation, circular shift and orthogonal
projection. All are linear with hand-written adjoints. Outputs are
contiguous tensors, so they can feed the solver kernels.

PyTorch has no DCT: :func:`dct` and :func:`idct` compute the orthonormal
DCT-II and its inverse along one axis through ``torch.fft`` (Makhoul's
reordering: one complex FFT of the even samples followed by the reversed
odd ones, and a quarter-sample phase ramp), with the ramp built in numpy
float64 and cast to the data's complex dtype.
"""
from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..core.jet import Jet, LinearOperator
from ..core.spaces import Space, as_tensor, check_real_floating, complex_dtype, real_dtype

__all__ = [
    "circshift_operator",
    "projection_operator",
    "dct_operator",
    "identity_operator",
    "pad_operator",
    "restriction_operator",
    "reshape_operator",
    "real_operator",
    "imag_operator",
    "transpose_operator",
    "flip_operator",
    "permutation_operator",
]


def _dct_tables(n, dtype, device):
    """The orthonormal scales ``s_0 = 1/√n``, ``s_k = √(2/n)`` in ``dtype``
    and the quarter-sample ramp ``exp(-iπk/(2n))`` in its complex dtype,
    both built in numpy float64."""
    s = np.full(n, math.sqrt(2.0 / n))
    s[0] = math.sqrt(1.0 / n)
    ramp = np.exp(-1j * np.pi * np.arange(n) / (2 * n))
    return (torch.from_numpy(s).to(dtype=dtype, device=device),
            torch.from_numpy(ramp).to(dtype=complex_dtype(dtype), device=device))


def dct(x, dim: int):
    """Orthonormal DCT-II of ``x`` along ``dim``: ``X[k] = s_k Σ_n x[n]
    cos(πk(2n+1)/(2N))``, by one FFT of the reordered samples."""
    x = x.movedim(dim, -1)
    s, ramp = _dct_tables(x.shape[-1], x.dtype, x.device)
    v = torch.cat([x[..., ::2], x[..., 1::2].flip(-1)], dim=-1)
    X = s * torch.real(torch.fft.fft(v, dim=-1) * ramp)
    return X.movedim(-1, dim).contiguous()


def idct(X, dim: int):
    """The inverse of :func:`dct` (the orthonormal DCT-III) along ``dim``.
    With ``c_k = X[k]/s_k = Re(W[k])`` and ``W[k] = ramp_k·V[k]`` (``V`` the
    FFT of the reordered samples), the Hermitian symmetry of ``V`` gives
    ``W[k] = c[k] - i·c[N-k]`` (``c[N] = 0``), so ``V = conj(ramp)·W``."""
    X = X.movedim(dim, -1)
    n = X.shape[-1]
    s, ramp = _dct_tables(n, X.dtype, X.device)
    c = X / s
    c_ref = torch.cat([torch.zeros_like(c[..., :1]), c[..., 1:].flip(-1)], dim=-1)
    v = torch.real(torch.fft.ifft(torch.complex(c, -c_ref) * torch.conj(ramp), dim=-1))
    h = (n + 1) // 2
    x = torch.empty_like(X)
    x[..., ::2] = v[..., :h]
    x[..., 1::2] = v[..., h:].flip(-1)
    return x.movedim(-1, dim).contiguous()


def _dct_df(dm, m0, state):
    out = dm
    for ax in range(dm.ndim):
        out = dct(out, ax)
    return out


def _dct_dft(dd, m0, state):
    out = dd
    for ax in range(dd.ndim):
        out = idct(out, ax)
    return out


def dct_operator(space: Space) -> LinearOperator:
    """Orthonormal type-II DCT over every axis; the adjoint is the inverse
    DCT (the transform is unitary)."""
    check_real_floating(space, "dct_operator")
    return LinearOperator(Jet(dom=space, rng=space, df=_dct_df, dft=_dct_dft))


def _id_df(dm, m0, state):
    return dm


def identity_operator(space: Space) -> LinearOperator:
    return LinearOperator(Jet(dom=space, rng=space, df=_id_df, dft="self"))


def _torch_pads(pads):
    """Per-axis ``(lo, hi)`` pairs as ``F.pad``'s flat list, last axis first."""
    return [p for lo_hi in reversed(pads) for p in lo_hi]


def _crop(x, window):
    return x[tuple(slice(a, b) for a, b in window)].contiguous()


def _pad_df(dm, m0, state):
    return F.pad(dm, _torch_pads(state["pads"]))


def _pad_dft(dd, m0, state):
    return _crop(dd, [(lo, dd.shape[i] - hi) for i, (lo, hi) in enumerate(state["pads"])])


def pad_operator(space: Space, pads: Sequence[Tuple[int, int]]) -> LinearOperator:
    """Zero-padding ``dom -> padded range``; the adjoint is the restriction
    (crop) back."""
    pads = tuple((int(lo), int(hi)) for lo, hi in pads)
    if len(pads) != space.ndim:
        raise ValueError(f"need {space.ndim} pad pairs, got {len(pads)}")
    out_shape = tuple(s + lo + hi for s, (lo, hi) in zip(space.shape, pads))
    j = Jet(dom=space, rng=Space(out_shape, space.dtype, space.device), df=_pad_df,
            dft=_pad_dft, state={"pads": pads})
    return LinearOperator(j)


def _r_df(dm, m0, state):
    return _crop(dm, state["window"])


def _r_dft(dd, m0, state):
    return F.pad(dd, _torch_pads(state["pads"]))


def restriction_operator(space: Space, window: Sequence[Tuple[int, int]]) -> LinearOperator:
    """Crop to ``window`` (per-axis ``(start, stop)``); the adjoint zero-pads
    back: the data-windowing operator of inversion workflows."""
    window = tuple((int(a), int(b)) for a, b in window)
    if len(window) != space.ndim:
        raise ValueError(f"need {space.ndim} window pairs, got {len(window)}")
    for (a, b), s in zip(window, space.shape):
        if not (0 <= a < b <= s):
            raise ValueError(f"window {window} out of bounds for {space.shape}")
    out_shape = tuple(b - a for a, b in window)
    pads = tuple((a, s - b) for (a, b), s in zip(window, space.shape))
    j = Jet(dom=space, rng=Space(out_shape, space.dtype, space.device), df=_r_df,
            dft=_r_dft, state={"window": window, "pads": pads})
    return LinearOperator(j)


def _reshape_df(dm, m0, state):
    return dm.reshape(state["out"])


def _reshape_dft(dd, m0, state):
    return dd.reshape(state["in"])


def reshape_operator(space: Space, new_shape: Sequence[int]) -> LinearOperator:
    """Shape-changing identity ``dom(shape) -> rng(new_shape)`` (the same
    number of elements); the adjoint reshapes back."""
    new_shape = tuple(int(s) for s in new_shape)
    if math.prod(new_shape) != space.size:
        raise ValueError(f"cannot reshape {space.shape} -> {new_shape}")
    j = Jet(dom=space, rng=Space(new_shape, space.dtype, space.device), df=_reshape_df,
            dft=_reshape_dft, state={"out": new_shape, "in": space.shape})
    return LinearOperator(j)


def _real_space(space: Space) -> Space:
    if not space.dtype.is_complex:
        raise TypeError(f"expected complex space, got {space.dtype}")
    return Space(space.shape, real_dtype(space.dtype), space.device)


def _real_df(dm, m0, state):
    return torch.real(dm).contiguous()


def _real_dft(dd, m0, state):
    return torch.complex(dd, torch.zeros_like(dd))


def real_operator(space: Space) -> LinearOperator:
    """``d = Re(m)``: complex dom → real rng. R-linear; the adjoint (for
    the real inner product ``Re⟨·,·⟩``) embeds ``dd ↦ dd + 0i``."""
    return LinearOperator(Jet(dom=space, rng=_real_space(space), df=_real_df, dft=_real_dft))


def _imag_df(dm, m0, state):
    return torch.imag(dm).contiguous()


def _imag_dft(dd, m0, state):
    return torch.complex(torch.zeros_like(dd), dd)


def imag_operator(space: Space) -> LinearOperator:
    """``d = Im(m)``: complex dom → real rng. R-linear; the adjoint embeds
    ``dd ↦ i·dd``."""
    return LinearOperator(Jet(dom=space, rng=_real_space(space), df=_imag_df, dft=_imag_dft))


def _transpose_df(dm, m0, state):
    return dm.permute(state["axes"]).contiguous()


def _transpose_dft(dd, m0, state):
    return dd.permute(state["inv"]).contiguous()


def transpose_operator(space: Space, axes: Sequence[int]) -> LinearOperator:
    """Axis permutation ``m -> m.permute(axes)`` (orthogonal; the adjoint is
    the inverse permutation)."""
    axes = tuple(int(a) % space.ndim for a in axes)
    if sorted(axes) != list(range(space.ndim)):
        raise ValueError(f"{axes} is not a permutation of axes")
    inv = tuple(sorted(range(space.ndim), key=lambda k: axes[k]))
    out_shape = tuple(space.shape[a] for a in axes)
    j = Jet(dom=space, rng=Space(out_shape, space.dtype, space.device), df=_transpose_df,
            dft=_transpose_dft, state={"axes": axes, "inv": inv})
    return LinearOperator(j)


def _flip_df(dm, m0, state):
    return torch.flip(dm, state["axes"])


def flip_operator(space: Space, axes: Sequence[int]) -> LinearOperator:
    """Reverse the given axes (involutive and orthogonal: self-adjoint)."""
    axes = tuple(sorted(int(a) % space.ndim for a in axes))
    return LinearOperator(Jet(dom=space, rng=space, df=_flip_df, dft="self",
                              state={"axes": axes}))


def _perm_df(dm, m0, state):
    return dm.reshape(-1)[state["perm"]].reshape(dm.shape)


def _perm_dft(dd, m0, state):
    return dd.reshape(-1)[state["inv"]].reshape(dd.shape)


def permutation_operator(space: Space, perm) -> LinearOperator:
    """Permute the FLAT elements of the space by the index vector ``perm``
    (``d.flat[i] = m.flat[perm[i]]``); the adjoint applies the inverse
    permutation. Orthogonal."""
    perm = as_tensor(perm).to(dtype=torch.int64, device=space.device)
    if tuple(perm.shape) != (space.size,):
        raise ValueError(f"perm must have {space.size} entries")
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(space.size, device=space.device)
    return LinearOperator(Jet(dom=space, rng=space, df=_perm_df, dft=_perm_dft,
                              state={"perm": perm, "inv": inv}))


def _circshift_df(dm, m0, state):
    return torch.roll(dm, state["shifts"], state["axes"])


def _circshift_dft(dd, m0, state):
    return torch.roll(dd, tuple(-s for s in state["shifts"]), state["axes"])


def circshift_operator(space: Space, shifts: Sequence[int]) -> LinearOperator:
    """Circular shift by ``shifts[ax]`` per axis: a pure permutation, so
    unitary; the adjoint rolls back."""
    shifts = tuple(int(s) for s in shifts)
    if len(shifts) != space.ndim:
        raise ValueError(f"need {space.ndim} shifts, got {len(shifts)}")
    return LinearOperator(Jet(dom=space, rng=space, df=_circshift_df, dft=_circshift_dft,
                              state={"shifts": shifts, "axes": tuple(range(space.ndim))}))


def _proj_df(dm, m0, state):
    Q = state["Q"]  # (k, n), orthonormal rows
    out = ((torch.conj(Q) @ dm.reshape(-1)) @ Q).reshape(dm.shape)
    return dm - out if state["complement"] else out


def projection_operator(vectors, complement: bool = False, *,
                        device: torch.device | str | None = None) -> LinearOperator:
    """Orthogonal projection onto ``span(vectors)``: ``P = Q Q^H`` after a
    numpy QR orthonormalization of the ``(k, *shape)`` stack (directions
    lost to rank deficiency dropped), built on ``device`` (``None``: the
    CUDA card). ``complement=True`` gives ``I - P``. Idempotent and
    self-adjoint; the apply is two small products, never the n×n
    projector."""
    V = vectors.detach().cpu().numpy() if isinstance(vectors, torch.Tensor) else np.asarray(vectors)
    V = np.ascontiguousarray(V)
    if V.ndim < 2:
        V = V[None]
    k = V.shape[0]
    q, r = np.linalg.qr(V.reshape(k, -1).T)  # (n, k)
    diag = np.abs(np.diagonal(r))
    q = q[:, diag > 1e-12 * max(diag.max(), 1e-300)]
    sp = Space(V.shape[1:], torch.from_numpy(V).dtype, device)
    Q = torch.from_numpy(np.ascontiguousarray(q.T)).to(sp.device)
    return LinearOperator(Jet(dom=sp, rng=sp, df=_proj_df, dft="self",
                              state={"Q": Q, "complement": bool(complement)}))
