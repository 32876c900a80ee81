"""Acquisition-geometry operators (counterpart of
``jets_tpu/ops/acquisition.py``): simultaneous-source blending, linear
moveout, and the receiver ghost.

Blending adds each shot's trace into one continuous record at its firing
time. The JAX package rolls a ``(nshots, T)`` padded stack, which at a
full-size record (a thousand shots of a few thousand samples into a record
of over a million) is gigabytes per application; here the forward is a
gather instead: a numpy table lists, for each record sample, the shot
samples that land on it in shot order, and the gathered rows are added one
after another (deterministic, no atomics). The adjoint is a strided
gather of each shot's ``nt``-long window. LMO is a per-trace rFFT phase
ramp; the ghost a 2-D FFT multiplier.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.jet import Jet, LinearOperator
from ..core.spaces import Space, check_real_floating, complex_dtype
from .fft import irfft
from .interp import gather_table

__all__ = ["blend_operator", "lmo_operator", "reghost_operator"]


def _blend_df(dm, m0, state):
    src = torch.cat([dm.reshape(-1), dm.new_zeros(1)])
    table = state["table"]
    out = src[table[0]]
    for k in range(1, table.shape[0]):
        out = out + src[table[k]]
    return out


def _blend_dft(dd, m0, state):
    return dd.unfold(0, state["nt"], 1)[state["t0"]]


def blend_operator(nshots: int, nt: int, firing_times, T: int,
                   dtype: torch.dtype = torch.float32, *,
                   device: torch.device | str | None = None) -> LinearOperator:
    """Simultaneous-source blending, built on ``device`` (``None``: the CUDA
    card): the domain is the unblended shot gather ``(nshots, nt)``, the
    range the continuous record ``(T,)`` with shot ``s`` added at integer
    sample ``firing_times[s]``. Requires ``0 <= firing_times`` and
    ``max(firing_times) + nt <= T``."""
    t0 = np.asarray(firing_times, dtype=np.int64)
    if t0.shape != (nshots,):
        raise ValueError(f"need {nshots} firing times, got {t0.shape}")
    if t0.min() < 0 or int(t0.max()) + nt > T:
        raise ValueError("firing_times must satisfy 0 <= t0 and t0 + nt <= T")
    dom = Space((nshots, nt), dtype, device)
    # record sample of each flat shot sample, in shot order
    targets = (t0[:, None] + np.arange(nt)[None, :]).ravel()
    table = torch.from_numpy(gather_table(targets, int(T))).to(dom.device)
    j = Jet(dom=dom, rng=Space((int(T),), dtype, dom.device), df=_blend_df, dft=_blend_dft,
            state={"t0": torch.from_numpy(t0).to(dom.device), "table": table,
                   "T": int(T), "nt": int(nt)})
    return LinearOperator(j)


def _lmo_df(dm, m0, state):
    D = torch.fft.rfft(dm, dim=-1) * state["phase"]
    return irfft(D, dm.shape[-1], -1).contiguous()


def _lmo_dft(dd, m0, state):
    D = torch.fft.rfft(dd, dim=-1) * torch.conj(state["phase"])
    return irfft(D, dd.shape[-1], -1).contiguous()


def lmo_operator(space: Space, dt: float, offsets, slowness: float) -> LinearOperator:
    """Linear moveout on a ``(ntrace, nt)`` gather: trace ``i`` is advanced
    by ``slowness * offsets[i]`` seconds (fractional, circular) by an rFFT
    phase ramp along the last axis. A unimodular phase, so the adjoint is
    the conjugate ramp (the reverse moveout)."""
    if space.ndim != 2:
        raise ValueError("lmo_operator expects a (ntrace, nt) space")
    check_real_floating(space, "lmo_operator")
    ntrace, nt = space.shape
    offs = np.asarray(offsets, dtype=np.float64)
    if offs.shape != (ntrace,):
        raise ValueError(f"need {ntrace} offsets, got {offs.shape}")
    tau = slowness * offs  # seconds to ADVANCE each trace by
    f = np.fft.rfftfreq(nt, d=dt)
    # x(t + tau) has spectrum X(f) e^{+2πi f τ} (advance = moveout removal)
    phase = np.exp(+2j * np.pi * f[None, :] * tau[:, None])
    j = Jet(dom=space, rng=space, df=_lmo_df, dft=_lmo_dft,
            state={"phase": torch.from_numpy(phase).to(dtype=complex_dtype(space.dtype),
                                                       device=space.device)})
    return LinearOperator(j)


def _reghost_df(dm, m0, state):
    return torch.real(torch.fft.ifft2(torch.fft.fft2(dm) * state["G"])).contiguous()


def _reghost_dft(dd, m0, state):
    # the adjoint of an FK multiplier is the conjugate-reflected filter; G
    # is built Hermitian (a real impulse response), so conj(G) suffices
    return torch.real(torch.fft.ifft2(torch.fft.fft2(dd) * torch.conj(state["G"]))).contiguous()


def reghost_operator(space: Space, dt: float, dx: float, depth: float, c: float = 1500.0,
                     sea_surface_reflectivity: float = -1.0) -> LinearOperator:
    """Receiver-side ghost model in the FK domain: a ghost-free ``(nx, nt)``
    gather acquires the surface ghost, ``G(f, k) = 1 + R exp(-4πi k_z
    depth)`` with ``k_z = sqrt((f/c)² - k²)`` for propagating waves (signed
    by ``f``, so ``G`` is Hermitian) and an exponential decay beyond the
    critical wavenumber. Diagonal in FK: one 2-D FFT each way; the adjoint
    is the conjugate multiplier."""
    if space.ndim != 2:
        raise ValueError("reghost_operator expects a (nx, nt) space")
    check_real_floating(space, "reghost_operator")
    nx, nt = space.shape
    F = np.broadcast_to(np.fft.fftfreq(nt, d=dt).reshape(1, nt), (nx, nt))
    K = np.broadcast_to(np.fft.fftfreq(nx, d=dx).reshape(nx, 1), (nx, nt))
    kz2 = (F / c) ** 2 - K ** 2
    kz = np.sqrt(np.abs(kz2))
    phase = np.where(kz2 >= 0.0, np.exp(-4j * np.pi * np.sign(F) * kz * depth),
                     np.exp(-4.0 * np.pi * kz * depth))
    G = 1.0 + sea_surface_reflectivity * phase
    j = Jet(dom=space, rng=space, df=_reghost_df, dft=_reghost_dft,
            state={"G": torch.from_numpy(G).to(dtype=complex_dtype(space.dtype),
                                               device=space.device)})
    return LinearOperator(j)
