"""Convolution and derivative operators (counterpart of
``jets_tpu/ops/conv.py``): the deconvolution chain ``A = D ∘ S`` of BASELINE
config 2, the n-D forward-difference gradient and the n-D 'same'-shape
convolution.

Forwards are ``torch.nn.functional.conv{1,2,3}d`` on an explicitly
zero-padded input (the padding pair is asymmetric for even kernel lengths,
which the convolutions' own ``padding`` cannot express); ``F.conv*`` is a
correlation, as ``lax.conv_general_dilated`` is, so a convolution flips its
kernel. The adjoints of :func:`conv1d_operator`, :func:`derivative_operator`
and :func:`gradient_operator` are derived with :func:`torch.func.vjp`, as
the JAX package derives them with ``jax.linear_transpose``;
:func:`convnd_operator` keeps its hand-written adjoint.
"""
from __future__ import annotations

import torch

from ..core.jet import Jet, LinearOperator
from ..core.spaces import Space, as_tensor, true_div
from .stencil import _correlate

__all__ = ["conv1d_operator", "convnd_operator", "derivative_operator",
           "gradient_operator"]


def _conv1d_df(dm, m0, state):
    # the 'same' crop of the full convolution is full[(L-1)//2 : (L-1)//2 + n]
    # (the scipy/numpy convention); a correlation with the flipped kernel
    # reaches it when low-padded by the complement L//2 — for even L the
    # pair is asymmetric
    k = state["kernel"]
    L = k.shape[0]
    return _correlate(dm, k.flip(0), [(L // 2, L - 1 - L // 2)])


def conv1d_operator(kernel, n: int, dtype: torch.dtype = torch.float32,
                    device: torch.device | str | None = None) -> LinearOperator:
    """Same-length convolution with ``kernel`` on 1-D signals of length ``n``
    (e.g. a source wavelet ``S`` in seismic deconvolution), built on
    ``device`` (``None``: the CUDA card)."""
    sp = Space((n,), dtype, device)
    j = Jet(dom=sp, rng=sp, df=_conv1d_df,
            state={"kernel": as_tensor(kernel).to(dtype=dtype, device=sp.device)})
    return LinearOperator(j)


def _deriv_df(dm, m0, state):
    # forward difference with a zero boundary: d[i] = (m[i+1] - m[i]) / dx,
    # a true division (a Python float divisor is a reciprocal multiply on CUDA)
    d = true_div(dm[1:] - dm[:-1], state["dx"])
    return torch.cat([d, torch.zeros((1,), dtype=dm.dtype, device=dm.device)])


def derivative_operator(n: int, dx: float = 1.0, dtype: torch.dtype = torch.float32,
                        device: torch.device | str | None = None) -> LinearOperator:
    """First-difference derivative ``D`` on 1-D signals of length ``n``
    (zero at the right boundary), built on ``device`` (``None``: the CUDA
    card); the adjoint, the negative backward difference, is derived."""
    sp = Space((n,), dtype, device)
    j = Jet(dom=sp, rng=sp, df=_deriv_df, state={"dx": float(dx)})
    return LinearOperator(j)


def _gradient_df(dm, m0, state):
    inv = state["inv"]
    outs = []
    for ax in range(dm.ndim):
        d = (torch.roll(dm, -1, dims=ax) - dm) * inv
        # zero the wrapped trailing face, out of place so vjp can derive it
        n = d.shape[ax]
        outs.append(torch.cat([d.narrow(ax, 0, n - 1),
                               torch.zeros_like(d.narrow(ax, n - 1, 1))], dim=ax))
    return torch.stack(outs, dim=0)


def gradient_operator(space: Space, dx: float = 1.0) -> LinearOperator:
    """n-D forward-difference gradient ``dom(shape) -> rng((nd,) + shape)``
    with ``(∇m)[ax, ..., i, ...] = (m[i+1] - m[i]) / dx`` along each axis
    (zero at the trailing face), on the space's device. The adjoint
    (negative divergence with boundary terms) is derived."""
    j = Jet(dom=space,
            rng=Space((space.ndim,) + space.shape, space.dtype, space.device),
            df=_gradient_df, state={"inv": 1.0 / float(dx)})
    return LinearOperator(j)


def _convnd_df(dm, m0, state):
    return _correlate(dm, state["kflip"], state["pads"])


def _convnd_dft(dd, m0, state):
    # transpose of the zero-padded 'same' convolution: correlate with the
    # un-flipped conjugate kernel and the lo/hi padding swapped — exact for
    # even and odd kernel lengths alike
    return _correlate(dd, torch.conj(state["k"]), state["pads_t"])


def convnd_operator(kernel, space: Space) -> LinearOperator:
    """General n-D (n ≤ 3) 'same'-shape convolution with an arbitrary
    kernel and a zero boundary, on the space's device; the adjoint is the
    hand-written correlation with swapped asymmetric padding."""
    k = as_tensor(kernel).to(dtype=space.dtype, device=space.device)
    if k.ndim != space.ndim:
        raise ValueError(f"kernel ndim {k.ndim} != space ndim {space.ndim}")
    if not 1 <= k.ndim <= 3:
        raise ValueError("convnd_operator supports up to 3 spatial dims")
    pads, pads_t = [], []
    for L in k.shape:
        lo = (L - 1) // 2
        hi = L - 1 - lo
        # cropping the full convolution at offset lo requires LOW-padding the
        # correlation with the flipped kernel by hi (and the transpose by lo)
        pads.append((hi, lo))
        pads_t.append((lo, hi))
    j = Jet(dom=space, rng=space, df=_convnd_df, dft=_convnd_dft,
            state={"k": k, "kflip": k.flip(tuple(range(k.ndim))), "pads": tuple(pads),
                   "pads_t": tuple(pads_t)})
    return LinearOperator(j)
