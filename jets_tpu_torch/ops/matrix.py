"""Dense-matrix operator (counterpart of ``jets_tpu/ops/matrix.py``).

A plain 2-D tensor or array takes part in the operator algebra by being
wrapped into a linear operator whose forward is a matrix-vector product
(``torch.matmul``) and whose adjoint is the product with the conjugate
transpose. The operator algebra wraps raw matrices with it
(:func:`jets_tpu_torch.core.algebra._wrap`).
"""
from __future__ import annotations

import torch

from ..core.jet import Jet, LinearOperator
from ..core.spaces import Space, as_tensor

__all__ = ["matrix_operator"]


def _matmul_df(dm, m0, state):
    return state["A"] @ dm


def _matmul_dft(dd, m0, state):
    return torch.conj(state["A"]).T @ dd


def matrix_operator(A, *, device: torch.device | str | None = None) -> LinearOperator:
    """Wrap a dense ``(m, n)`` matrix (a tensor or an array) as a linear
    operator ``R^n -> R^m`` built on ``device`` (``None``: the CUDA card)."""
    A = as_tensor(A)
    if A.ndim != 2:
        raise ValueError(f"matrix_operator needs a 2-D array, got ndim={A.ndim}")
    m, n = A.shape
    dom = Space((n,), A.dtype, device)
    j = Jet(dom=dom, rng=Space((m,), A.dtype, dom.device), df=_matmul_df,
            dft=_matmul_dft, state={"A": A.to(dom.device)})
    return LinearOperator(j)
