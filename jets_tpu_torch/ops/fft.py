"""FFT operators (counterpart of ``jets_tpu/ops/fft.py``): the unitary n-D
FFT on a complex space, and the real n-D FFT onto a :class:`SymmetricSpace`
of the stored half-spectrum, whose weighted inner product makes the
orthonormal inverse real transform its exact adjoint. Both adjoints are
hand-written; all transforms use ``norm="ortho"``.

:func:`irfft` is the inverse real transform of every operator in the port
that goes back from a half-spectrum (bandpass, shift, resample, Radon,
LMO). A half-spectrum that is not Hermitian (a random member of the
symmetric space, or a phase ramp whose Nyquist bin is complex) has
imaginary parts at its self-conjugate bins that the real result cannot
hold. NumPy's pocketfft drops them; cuFFT's complex-to-real transform
assumes they are zero and gives no defined answer otherwise. So they are
set to zero before every complex-to-real transform, on every device.
"""
from __future__ import annotations

import torch

from ..core.jet import Jet, LinearOperator
from ..core.spaces import Space, SymmetricSpace, check_real_floating, complex_dtype

__all__ = ["fft_operator", "rfft_operator", "irfft"]


def irfft(D, n: int, dim: int = -1, norm=None):
    """``torch.fft.irfft(D, n, dim, norm)`` of a half-spectrum ``D`` of
    ``n // 2 + 1`` bins along ``dim``, with the imaginary parts of the
    self-conjugate bins (bin 0 and, for even ``n``, the Nyquist bin) zeroed
    first. ``D`` must be a temporary of the caller: it is written in place."""
    im = D.imag
    im.select(dim, 0).zero_()
    if n % 2 == 0:
        im.select(dim, n // 2).zero_()
    return torch.fft.irfft(D, n=n, dim=dim, norm=norm)


def _fft_df(dm, m0, state):
    return torch.fft.fftn(dm, norm="ortho")


def _fft_dft(dd, m0, state):
    return torch.fft.ifftn(dd, norm="ortho")


def fft_operator(space: Space) -> LinearOperator:
    """Unitary n-D FFT on a complex space; the adjoint is the inverse."""
    if not space.dtype.is_complex:
        raise TypeError("fft_operator needs a complex space; use rfft_operator")
    return LinearOperator(Jet(dom=space, rng=space, df=_fft_df, dft=_fft_dft))


def _rfft_df(dm, m0, state):
    return torch.fft.rfftn(dm, norm="ortho")


def _rfft_dft(dd, m0, state):
    # irfftn as NumPy composes it: the complex inverse over the leading
    # axes, then the complex-to-real one over the last
    shape = state["logical_shape"]
    lead = tuple(range(len(shape) - 1))
    y = torch.fft.ifftn(dd, dim=lead, norm="ortho") if lead else dd.clone()
    return irfft(y, shape[-1], -1, norm="ortho")


def rfft_operator(space: Space) -> LinearOperator:
    """Real n-D FFT: real ``space`` → :class:`SymmetricSpace` of the stored
    half-spectrum on the same device. The adjoint is ``irfftn``, exact with
    respect to the symmetric space's multiplicity-weighted inner product."""
    check_real_floating(space, "rfft_operator")
    cdt = complex_dtype(space.dtype)
    stored = space.shape[:-1] + (space.shape[-1] // 2 + 1,)
    rng = SymmetricSpace(stored, space.shape, cdt, axis=-1, device=space.device)
    j = Jet(dom=space, rng=rng, df=_rfft_df, dft=_rfft_dft,
            state={"logical_shape": space.shape})
    return LinearOperator(j)
