"""Off-grid sampling operators with Kaiser-windowed sinc weights (counterpart
of ``jets_tpu/ops/sampling.py``, with the same names): the source and
receiver interpolation of the JetPackWaveFD propagators (Hicks 2002).

Each axis's fractional sampling is a dense banded ``(npts_ax, n_ax)``
matrix, built once in float64 numpy and cast; separable (tensor-product)
sampling contracts one axis at a time (``torch.tensordot``), scattered
points contract per-point rows (``torch.einsum``). These are plain matrix
products, as the JAX package computes them outside any Pallas kernel.
Float32 products keep full precision on the card as long as TF32 stays
off (PyTorch's default). The adjoints are derived with
``torch.func.vjp``: transposed products.

Weights: ``w(x) = sinc(x) · I0(β √(1 − (x/r)²)) / I0(β)`` over the ``2r``
taps around each fractional coordinate (Hicks' β ≈ 6.31 for r = 4); taps
outside the grid are dropped (the zero exterior of the stencils). On-grid
coordinates give point sampling (the sinc collapses to a delta, up to the
float64 rounding of ``sin(πk)``).
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..core.jet import Jet, LinearOperator
from ..core.spaces import Space, resolve_device

__all__ = [
    "kaiser_sinc_matrix",
    "sinc_sampling_operator",
    "sinc_point_sampling_operator",
]

_HICKS_BETA = {1: 1.24, 2: 2.94, 3: 4.53, 4: 6.31, 5: 7.91, 6: 9.42,
               7: 10.88, 8: 12.31}


def kaiser_sinc_matrix_np(n: int, coords, radius: int = 4,
                          beta: float | None = None) -> np.ndarray:
    """The float64 numpy ``(len(coords), n)`` matrix of
    :func:`kaiser_sinc_matrix` (host-side geometry construction)."""
    coords = np.asarray(coords, np.float64)
    if beta is None:
        beta = _HICKS_BETA[radius]
    i0b = np.i0(beta)
    W = np.zeros((coords.shape[0], n), np.float64)
    base = np.floor(coords).astype(np.int64)
    for t in range(-radius + 1, radius + 1):
        j = base + t
        x = coords - j                       # in (-radius, radius]
        arg = 1.0 - (x / radius) ** 2
        win = np.where(arg > 0, np.i0(beta * np.sqrt(np.maximum(arg, 0.0))),
                       0.0) / i0b
        w = np.sinc(x) * win
        ok = (j >= 0) & (j < n)
        np.add.at(W, (np.arange(coords.shape[0])[ok], j[ok]), w[ok])
    return W


def kaiser_sinc_matrix(n: int, coords, radius: int = 4, beta: float | None = None,
                       dtype: torch.dtype = torch.float32,
                       device: torch.device | str | None = None) -> torch.Tensor:
    """Dense ``(len(coords), n)`` Kaiser-windowed-sinc sampling matrix for
    fractional coordinates on a length-``n`` axis, built in float64 numpy,
    cast to ``dtype`` and placed on ``device`` (``None``: the CUDA card)."""
    W = kaiser_sinc_matrix_np(n, coords, radius, beta)
    return torch.from_numpy(W).to(dtype=dtype, device=resolve_device(device))


def _axis_contract(W, u, ax):
    """``W`` ``(m, n_ax)`` applied along axis ``ax`` of ``u`` (that axis
    becomes length ``m``)."""
    return torch.movedim(torch.tensordot(W, u, dims=([1], [ax])), 0, ax)


def sinc_sampling_operator(space: Space, coords_per_axis: Sequence,
                           radius: int = 4) -> LinearOperator:
    """Separable off-grid resampling: axis ``k`` of the output grid lies at
    the fractional coordinates ``coords_per_axis[k]`` of the input's axis
    ``k``. The forward is one banded matrix product per axis; the adjoint
    is derived (the transposed products). For model regridding and
    separable receiver lines and planes."""
    if len(coords_per_axis) != space.ndim:
        raise ValueError("need one coordinate array per axis")
    Ws = tuple(kaiser_sinc_matrix(space.shape[ax], coords_per_axis[ax], radius,
                                  dtype=space.dtype, device=space.device)
               for ax in range(space.ndim))
    out_shape = tuple(int(np.asarray(c).shape[0]) for c in coords_per_axis)

    def _df(dm, m0, state):
        u = dm
        for ax, W in enumerate(state["Ws"]):
            u = _axis_contract(W, u, ax)
        return u

    j = Jet(dom=space, rng=Space(out_shape, space.dtype, space.device), df=_df,
            state={"Ws": Ws})
    return LinearOperator(j)


def sinc_point_sampling_operator(space: Space, points, radius: int = 4) -> LinearOperator:
    """Scattered off-grid point sampling: ``points`` is ``(npts, ndim)``
    fractional coordinates, the output the ``(npts,)`` sampled values. A
    matrix product contracts axis 0 with each point's row, then per-point
    weighted reductions the remaining axes (``npts · n_0 · Π n_rest``
    multiply-adds: for acquisition geometry and QC, not for time loops,
    whose off-grid receivers take the separable form)."""
    points = np.asarray(points, np.float64)
    if points.ndim != 2 or points.shape[1] != space.ndim:
        raise ValueError("points must be (npts, ndim)")
    Ws = tuple(kaiser_sinc_matrix(space.shape[ax], points[:, ax], radius,
                                  dtype=space.dtype, device=space.device)
               for ax in range(space.ndim))

    def _df(dm, m0, state):
        Ws = state["Ws"]
        t = torch.tensordot(Ws[0], dm, dims=([1], [0]))  # t[p, rest...]
        for W in Ws[1:]:
            t = torch.einsum("pi,pi...->p...", W, t)
        return t

    j = Jet(dom=space, rng=Space((points.shape[0],), space.dtype, space.device), df=_df,
            state={"Ws": Ws})
    return LinearOperator(j)
