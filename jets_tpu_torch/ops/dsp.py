"""Signal-processing operators (counterpart of ``jets_tpu/ops/dsp.py``):
edge tapers, band-pass filters, fractional time shifts, Fourier
resampling, mutes, box smoothing ('mix') and roughness, the n-D
translation, and the nonlinear envelope.

Each is a real diagonal in the sample domain (taper, mute), a diagonal in
the Fourier domain applied through the rFFT (bandpass, shift), a windowed
sum (mix, roughness) or a composition of those. Every table (weights,
masks, phase ramps, the Hilbert multiplier) is built in numpy float64 as
the JAX package builds it, then cast to the space's dtype (its complex
dtype for phases) on the space's device, so every operator returns its
range space's dtype. Resampling's adjoint is derived with
:func:`torch.func.vjp`, as the JAX package derives it.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..core.jet import Jet, LinearOperator, Operator
from ..core.spaces import Space, check_real_floating, complex_dtype, np_dtype, real_dtype
from .diagonal import diagonal_operator
from .fft import irfft

__all__ = [
    "taper_operator",
    "translation_operator",
    "mix_operator",
    "roughness_operator",
    "envelope_operator",
    "bandpass_operator",
    "shift_operator",
    "resample_operator",
    "mute_operator",
]


def _along(t, ax, ndim):
    """A 1-D table shaped to broadcast along axis ``ax`` of ``ndim`` axes."""
    shape = [1] * ndim
    shape[ax] = t.shape[0]
    return t.reshape(shape)


def _cosine_ramp(n, width, dtype):
    """Edge weights for one axis: a cosine ramp of ``width`` samples at each
    end, flat 1 in between."""
    w = np.ones(n, dtype=dtype)
    if width > 0:
        r = 0.5 * (1.0 - np.cos(np.pi * (np.arange(width) + 0.5) / width))
        w[:width] = r
        w[n - width:] = r[::-1]
    return w


def taper_operator(space: Space, widths: Sequence[int]) -> LinearOperator:
    """Cosine edge taper: multiply by a separable weight that ramps from 0
    at each boundary over ``widths[ax]`` samples. A real diagonal, so
    self-adjoint."""
    widths = tuple(int(w) for w in widths)
    if len(widths) != space.ndim:
        raise ValueError(f"need {space.ndim} widths, got {len(widths)}")
    rdtype = np_dtype(real_dtype(space.dtype))
    w = np.ones(space.shape, dtype=rdtype)
    for ax, (n, width) in enumerate(zip(space.shape, widths)):
        if 2 * width > n:
            raise ValueError(f"taper width {width} too large for axis {ax}")
        shape = [1] * space.ndim
        shape[ax] = n
        w = w * _cosine_ramp(n, width, rdtype).reshape(shape)
    return diagonal_operator(w.astype(np_dtype(space.dtype)), device=space.device)


def _bandpass_mask(n, dt, f_lo, f_hi, f_taper, dtype):
    f = np.fft.rfftfreq(n, d=dt)
    m = np.zeros(f.shape, dtype=dtype)
    m[(f >= f_lo) & (f <= f_hi)] = 1.0
    if f_taper > 0.0:
        lo_ramp = (f >= f_lo - f_taper) & (f < f_lo)
        m[lo_ramp] = 0.5 * (1.0 - np.cos(np.pi * (f[lo_ramp] - (f_lo - f_taper)) / f_taper))
        hi_ramp = (f > f_hi) & (f <= f_hi + f_taper)
        m[hi_ramp] = 0.5 * (1.0 + np.cos(np.pi * (f[hi_ramp] - f_hi) / f_taper))
    return m


def _spectral(x, table, ax):
    """``irfft(rfft(x) · table)`` along ``ax``: a diagonal in the Fourier
    domain."""
    D = torch.fft.rfft(x, dim=ax) * _along(table, ax, x.ndim)
    return irfft(D, x.shape[ax], ax).contiguous()


def _bp_df(dm, m0, state):
    return _spectral(dm, state["mask"], state["axis"])


def bandpass_operator(space: Space, dt: float, f_lo: float, f_hi: float,
                      f_taper: float = 0.0, axis: int = -1) -> LinearOperator:
    """Zero-phase band-pass along ``axis`` (sample interval ``dt``): rFFT →
    real cosine-tapered mask on [f_lo, f_hi] → irFFT. A real even filter,
    so self-adjoint."""
    check_real_floating(space, "bandpass_operator")
    axis = int(axis) % space.ndim
    mask = _bandpass_mask(space.shape[axis], dt, f_lo, f_hi, f_taper, np_dtype(space.dtype))
    j = Jet(dom=space, rng=space, df=_bp_df, dft="self",
            state={"mask": torch.from_numpy(mask).to(space.device), "axis": axis})
    return LinearOperator(j)


def _shift_df(dm, m0, state):
    return _spectral(dm, state["phase"], state["axis"])


def _shift_dft(dd, m0, state):
    return _spectral(dd, torch.conj(state["phase"]), state["axis"])


def shift_operator(space: Space, shift: float, dt: float = 1.0,
                   axis: int = -1) -> LinearOperator:
    """Periodic (possibly fractional) shift by ``shift`` time units along
    ``axis``: a unimodular phase ramp in the Fourier domain. Unitary; the
    hand-written adjoint is the conjugate phase (the shift back)."""
    check_real_floating(space, "shift_operator")
    axis = int(axis) % space.ndim
    n = space.shape[axis]
    ph = np.exp(-2j * np.pi * np.fft.rfftfreq(n, d=dt) * shift)
    # keep irfft exactly real for even n: the Nyquist bin must stay real
    if n % 2 == 0:
        ph[-1] = np.real(ph[-1])
    ph[0] = 1.0
    phase = torch.from_numpy(ph).to(dtype=complex_dtype(space.dtype), device=space.device)
    j = Jet(dom=space, rng=space, df=_shift_df, dft=_shift_dft,
            state={"phase": phase, "axis": axis})
    return LinearOperator(j)


def _resample_df(dm, m0, state):
    ax, k, k_out, n_out = state["axis"], state["k"], state["k_out"], state["n_out"]
    D = torch.fft.rfft(dm, dim=ax).narrow(ax, 0, k)
    if k_out > k:
        pad = list(D.shape)
        pad[ax] = k_out - k
        D = torch.cat([D, D.new_zeros(pad)], dim=ax)
    return (state["scale"] * irfft(D, n_out, ax)).contiguous()


def resample_operator(space: Space, n_out: int, axis: int = -1) -> LinearOperator:
    """Fourier (sinc) resampling along ``axis`` from ``n`` to ``n_out``
    samples: rFFT, truncate or zero-pad the spectrum, irFFT at the new
    length, amplitude-preserving scale ``n_out/n``. The adjoint is derived
    by :func:`torch.func.vjp`."""
    check_real_floating(space, "resample_operator")
    axis = int(axis) % space.ndim
    n, n_out = space.shape[axis], int(n_out)
    k_out = n_out // 2 + 1
    rng_shape = list(space.shape)
    rng_shape[axis] = n_out
    j = Jet(dom=space, rng=Space(tuple(rng_shape), space.dtype, space.device),
            df=_resample_df,
            state={"axis": axis, "k": min(n // 2 + 1, k_out), "k_out": k_out,
                   "n_out": n_out, "scale": float(n_out) / float(n)})
    return LinearOperator(j)


def mute_operator(space: Space, mask) -> LinearOperator:
    """Binary (or soft) mute: a diagonal multiply by ``mask``. A real mask
    is self-adjoint."""
    mask = (mask.detach().cpu().numpy() if isinstance(mask, torch.Tensor)
            else np.asarray(mask)).astype(np_dtype(space.dtype))
    if mask.shape != space.shape:
        raise ValueError(f"mask shape {mask.shape} != space {space.shape}")
    return diagonal_operator(mask, device=space.device)


def _box_sum(x, widths):
    """The zero-padded 'same' box-window sum, separable: along each axis of
    odd width ``w``, the sum of the ``w`` shifted slices of the padded
    array, added in order (exact sums of the window, no running-sum
    cancellation)."""
    for ax, w in enumerate(widths):
        if w == 1:
            continue
        h = w // 2
        pad = list(x.shape)
        pad[ax] = h
        z = x.new_zeros(pad)
        p = torch.cat([z, x, z], dim=ax)
        n = x.shape[ax]
        acc = p.narrow(ax, 0, n)
        for i in range(1, w):
            acc = acc + p.narrow(ax, i, n)
        x = acc
    return x.contiguous()


def _mix_df(dm, m0, state):
    return state["scale"] * _box_sum(dm, state["widths"])


def _check_widths(space, widths, kind):
    widths = tuple(int(w) for w in widths)
    if len(widths) != space.ndim:
        raise ValueError(f"need {space.ndim} widths, got {len(widths)}")
    if any(w < 1 or w % 2 == 0 for w in widths):
        raise ValueError(f"{kind} widths must be odd and >= 1")
    check_real_floating(space, f"{kind}_operator")
    return widths


def mix_operator(space: Space, widths: Sequence[int]) -> LinearOperator:
    """Box moving average ('mix'): separable odd-length box windows per
    axis, zero boundary, normalized by the full window size. A symmetric
    kernel with zero padding, so self-adjoint."""
    widths = _check_widths(space, widths, "mix")
    scale = torch.tensor(1.0 / float(np.prod(widths)), dtype=space.dtype, device=space.device)
    return LinearOperator(Jet(dom=space, rng=space, df=_mix_df, dft="self",
                              state={"widths": widths, "scale": scale}))


def _rough_df(dm, m0, state):
    return dm - state["scale"] * _box_sum(dm, state["widths"])


def roughness_operator(space: Space, widths: Sequence[int]) -> LinearOperator:
    """Roughness: the residual after box smoothing, ``R = I - Mix``.
    Self-adjoint because Mix is; penalizing ``||R m||`` regularizes toward
    smooth models."""
    widths = _check_widths(space, widths, "roughness")
    scale = torch.tensor(1.0 / float(np.prod(widths)), dtype=space.dtype, device=space.device)
    return LinearOperator(Jet(dom=space, rng=space, df=_rough_df, dft="self",
                              state={"widths": widths, "scale": scale}))


def _hilbert(x, h, axis):
    """The Hilbert transform of a real signal: the imaginary part of the
    analytic signal, by a full FFT with the one-sided multiplier ``h``."""
    X = torch.fft.fft(x, dim=axis)
    return torch.imag(torch.fft.ifft(X * _along(h, axis, x.ndim), dim=axis)).contiguous()


def _hilbert_multiplier(n):
    h = np.zeros(n)
    if n % 2 == 0:
        h[0] = h[n // 2] = 1.0
        h[1:n // 2] = 2.0
    else:
        h[0] = 1.0
        h[1:(n + 1) // 2] = 2.0
    return h


def _env_f(m, state):
    h = _hilbert(m, state["h"], state["axis"])
    return torch.sqrt(m * m + h * h + state["eps"])


def _env_upstate(m0, state):
    h0 = _hilbert(m0, state["h"], state["axis"])
    return {"h0": h0, "e0": torch.sqrt(m0 * m0 + h0 * h0 + state["eps"])}


def _env_df(dm, m0, state):
    h0, e0 = state["h0"], state["e0"]
    return (m0 * dm + h0 * _hilbert(dm, state["h"], state["axis"])) / e0


def _env_dft(dd, m0, state):
    # H is skew-adjoint (H^T = -H for real signals), so the transpose of
    # dm -> (m0*dm + h0*H(dm))/e0 is dd -> m0/e0*dd - H(h0/e0*dd).
    h0, e0 = state["h0"], state["e0"]
    return (m0 / e0) * dd - _hilbert((h0 / e0) * dd, state["h"], state["axis"])


def envelope_operator(space: Space, axis: int = -1, eps: float = 1e-20) -> Operator:
    """Instantaneous-amplitude envelope ``e = sqrt(m^2 + H(m)^2 + eps)``
    with the Hilbert transform ``H`` along ``axis``. Nonlinear; the
    tangent and its adjoint use the linearization point's envelope,
    computed by the ``upstate`` hook. The Hilbert multiplier is built in
    the space's dtype, so a float32 space stays float32 throughout."""
    check_real_floating(space, "envelope_operator")
    axis = int(axis) % space.ndim
    h = torch.from_numpy(_hilbert_multiplier(space.shape[axis])).to(
        dtype=space.dtype, device=space.device)
    j = Jet(dom=space, rng=space, f=_env_f, df=_env_df, dft=_env_dft, upstate=_env_upstate,
            state={"axis": axis, "h": h,
                   "eps": torch.tensor(eps, dtype=space.dtype, device=space.device),
                   "h0": None, "e0": None})
    return Operator(j)


def translation_operator(space: Space, shifts: Sequence[float],
                         dts: Sequence[float] | None = None):
    """n-D (possibly fractional) periodic translation: the composition of
    per-axis Fourier :func:`shift_operator`\\ s. ``shifts[ax]`` is in the
    units of ``dts[ax]`` (samples if omitted)."""
    shifts = tuple(float(s) for s in shifts)
    if len(shifts) != space.ndim:
        raise ValueError(f"need {space.ndim} shifts, got {len(shifts)}")
    dts = (1.0,) * space.ndim if dts is None else tuple(float(d) for d in dts)
    op = None
    for ax, (s, dt) in enumerate(zip(shifts, dts)):
        if s == 0.0:
            continue
        nxt = shift_operator(space, s, dt=dt, axis=ax)
        op = nxt if op is None else (nxt @ op)
    if op is None:
        from .transforms import identity_operator
        return identity_operator(space)
    return op
