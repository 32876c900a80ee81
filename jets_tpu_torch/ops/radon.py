"""Linear Radon (slant-stack) transform operator (counterpart of
``jets_tpu/ops/radon.py``): the time-shift stack evaluated in the temporal
Fourier domain, where it is a per-frequency complex product with a phase
tensor,

    d(t, x) = Σ_p m(t - p·x, p)  ⇔  D(f, x) = Σ_p M(f, p) · exp(-2πi f p x).

The adjoint is the conjugate-phase stack (hand-written). Periodic in time
(FFT); taper the model in τ if wrap matters.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..core.jet import Jet, LinearOperator
from ..core.spaces import Space, complex_dtype
from .fft import irfft

__all__ = ["radon_operator"]


def _radon_df(dm, m0, state):
    M = torch.fft.rfft(dm, dim=0)  # (nf, np)
    D = torch.einsum("fp,fpx->fx", M, state["phase"])
    return irfft(D, state["nt"], 0).contiguous()


def _radon_dft(dd, m0, state):
    D = torch.fft.rfft(dd, dim=0)  # (nf, nx)
    M = torch.einsum("fx,fpx->fp", D, torch.conj(state["phase"]))
    return irfft(M, state["nt"], 0).contiguous()


def radon_operator(nt: int, offsets: Sequence[float], slownesses: Sequence[float],
                   dt: float = 1.0, dtype: torch.dtype = torch.float32, *,
                   device: torch.device | str | None = None) -> LinearOperator:
    """Slant stack ``m(τ, p) → d(t, x)`` over receiver ``offsets`` (x) and
    ``slownesses`` (p), periodic in time, built on ``device`` (``None``: the
    CUDA card).

    Domain ``(nt, len(slownesses))``, range ``(nt, len(offsets))``. The
    phase tensor ``exp(-2πi f p x)``, ``(nt//2+1, np, nx)``, is built once
    in numpy float64 and stored in the complex dtype of ``dtype``.
    """
    offsets = np.asarray(offsets, dtype=np.float64)
    slownesses = np.asarray(slownesses, dtype=np.float64)
    dom = Space((int(nt), len(slownesses)), dtype, device)
    f = np.fft.rfftfreq(int(nt), d=float(dt))  # (nf,)
    px = slownesses[:, None] * offsets[None, :]  # (np, nx)
    ph = np.exp(-2j * np.pi * f[:, None, None] * px[None, :, :])
    # the self-conjugate Nyquist bin (even nt) carries a real coefficient
    if nt % 2 == 0:
        ph[-1] = np.real(ph[-1])
    phase = torch.from_numpy(ph).to(dtype=complex_dtype(dtype), device=dom.device)
    j = Jet(dom=dom, rng=Space((int(nt), len(offsets)), dtype, dom.device), df=_radon_df,
            dft=_radon_dft, state={"phase": phase, "nt": int(nt)})
    return LinearOperator(j)
