"""Diagonal operator (counterpart of ``jets_tpu/ops/diagonal.py``):
``d = w ⊙ m`` with adjoint ``m = conj(w) ⊙ d``, over the space of ``w``."""
from __future__ import annotations

import torch

from ..core.jet import Jet, LinearOperator
from ..core.spaces import Space, as_tensor

__all__ = ["diagonal_operator"]


def _diag_df(dm, m0, state):
    return state["w"] * dm


def _diag_dft(dd, m0, state):
    return torch.conj(state["w"]) * dd


def diagonal_operator(w, *, device: torch.device | str | None = None) -> LinearOperator:
    """Diagonal (elementwise multiply) operator over the space of ``w`` (a
    tensor or an array), built on ``device`` (``None``: the CUDA card)."""
    w = as_tensor(w)
    sp = Space(w.shape, w.dtype, device)
    j = Jet(dom=sp, rng=sp, df=_diag_df, dft=_diag_dft, state={"w": w.to(sp.device)})
    return LinearOperator(j)
