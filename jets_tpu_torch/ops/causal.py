"""Causal (scan) operators (counterpart of ``jets_tpu/ops/causal.py``):
leaky integration, the first difference, and the normalized integration
('nim').

PyTorch has no associative scan. ``y[t] = α·y[t-1] + x[t]`` is
``torch.cumsum`` for ``α = 1``; for any other ``α`` :func:`leaky_scan`
takes a blocked form with a fixed number of launches: within blocks of
``B`` samples, a product with the ``B × B`` lower-triangular matrix of
powers ``α^(i-j)``, then the carry across blocks, a product of the block
ends with the ``nb × nb`` matrix of powers ``(α^B)^(b-c)``, added back with
the ramp ``α^(i+1)``. Only non-negative powers of ``α`` are formed, which
underflow to 0 (the recurrence's own limit) and never overflow for
``|α| ≤ 1``. The adjoint of a causal integration is the anticausal one:
flip, the same scan, flip.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.jet import Jet, LinearOperator, Operator
from ..core.spaces import Space, check_real_floating

__all__ = ["integration_operator", "difference_operator", "nim_operator", "leaky_scan"]

_BLOCK = 64  # samples per block of the blocked scan


def _powers(alpha, n, dtype, device):
    """The lower-triangular ``n × n`` matrix ``α^(i-j)`` (0 above the
    diagonal), built in numpy float64."""
    d = np.subtract.outer(np.arange(n), np.arange(n))
    L = np.where(d >= 0, float(alpha) ** np.maximum(d, 0), 0.0)
    return torch.from_numpy(L).to(dtype=dtype, device=device)


def leaky_scan(x, alpha: float, axis: int):
    """``y[t] = α·y[t-1] + x[t]`` along ``axis`` (``y[-1] = 0``)."""
    if alpha == 1.0:
        return torch.cumsum(x, dim=axis)
    x = x.movedim(axis, -1)
    n = x.shape[-1]
    B = min(_BLOCK, n)
    nb = -(-n // B)
    if nb * B != n:
        x = torch.cat([x, x.new_zeros(x.shape[:-1] + (nb * B - n,))], dim=-1)
    xb = x.reshape(x.shape[:-1] + (nb, B))
    # within each block, from a zero start
    y = xb @ _powers(alpha, B, x.dtype, x.device).T
    if nb > 1:
        # the block ends with the carry: Y_end[b] = Σ_c (α^B)^(b-c) y_end[c]
        ends = y[..., -1] @ _powers(float(alpha) ** B, nb, x.dtype, x.device).T
        carry = torch.cat([torch.zeros_like(ends[..., :1]), ends[..., :-1]], dim=-1)
        ramp = torch.from_numpy(float(alpha) ** np.arange(1, B + 1)).to(
            dtype=x.dtype, device=x.device)
        y = y + carry[..., None] * ramp
    y = y.reshape(x.shape)[..., :n]
    return y.movedim(-1, axis).contiguous()


def _integ_df(dm, m0, state):
    return leaky_scan(dm, state["alpha"], state["axis"])


def _integ_dft(dd, m0, state):
    ax = state["axis"]
    return torch.flip(leaky_scan(torch.flip(dd, (ax,)), state["alpha"], ax), (ax,))


def integration_operator(space: Space, alpha: float = 1.0, axis: int = -1) -> LinearOperator:
    """Causal (leaky) integration along ``axis``: ``d[t] = alpha * d[t-1] +
    m[t]`` (``alpha=1`` is the running sum, the inverse of
    :func:`difference_operator`). The adjoint is the anticausal
    integration."""
    axis = int(axis) % space.ndim
    check_real_floating(space, "integration_operator")
    return LinearOperator(Jet(dom=space, rng=space, df=_integ_df, dft=_integ_dft,
                              state={"alpha": float(alpha), "axis": axis}))


def _diff_df(dm, m0, state):
    ax = state["axis"]
    n = dm.shape[ax]
    return torch.cat([dm.narrow(ax, 0, 1), dm.narrow(ax, 1, n - 1) - dm.narrow(ax, 0, n - 1)],
                     dim=ax)


def _diff_dft(dd, m0, state):
    ax = state["axis"]
    n = dd.shape[ax]
    return torch.cat([dd.narrow(ax, 0, n - 1) - dd.narrow(ax, 1, n - 1), dd.narrow(ax, n - 1, 1)],
                     dim=ax)


def difference_operator(space: Space, axis: int = -1) -> LinearOperator:
    """First difference along ``axis`` with ``d[0] = m[0]`` (so the operator
    is square and exactly inverted by ``integration_operator(alpha=1)``).
    ``D = I - S`` for the one-sample causal shift ``S``; the hand-written
    adjoint is ``I - S^T``."""
    axis = int(axis) % space.ndim
    return LinearOperator(Jet(dom=space, rng=space, df=_diff_df, dft=_diff_dft,
                              state={"axis": axis}))


def _nonzero(S):
    return torch.where(torch.abs(S) > 0, S, torch.ones_like(S))


def _nim_f(m, state):
    ax, p = state["axis"], state["p"]
    u = m ** p
    return torch.cumsum(u, dim=ax) / _nonzero(torch.sum(u, dim=ax, keepdim=True))


def _nim_upstate(m0, state):
    ax, p = state["axis"], state["p"]
    u0 = m0 ** p
    return {"du_dm": p * m0 ** (p - 1), "U0": torch.cumsum(u0, dim=ax),
            "S0": _nonzero(torch.sum(u0, dim=ax, keepdim=True))}


def _nim_df(dm, m0, state):
    ax = state["axis"]
    du = state["du_dm"] * dm
    dU = torch.cumsum(du, dim=ax)
    dS = torch.sum(du, dim=ax, keepdim=True)
    return dU / state["S0"] - state["U0"] * dS / state["S0"] ** 2


def _nim_dft(dd, m0, state):
    ax = state["axis"]
    S0, U0 = state["S0"], state["U0"]
    # the transpose of cumsum is the anticausal cumsum; of sum, a broadcast
    acc = torch.flip(torch.cumsum(torch.flip(dd / S0, (ax,)), dim=ax), (ax,))
    corr = torch.sum(dd * U0 / S0 ** 2, dim=ax, keepdim=True)
    return state["du_dm"] * (acc - corr)


def nim_operator(space: Space, p: float = 2.0, axis: int = -1) -> Operator:
    """Normalized integration: the cumulative sum of ``m^p`` along ``axis``
    normalized by its total, a monotone [0, 1] profile per trace (even
    ``p``). Nonlinear; the tangent and its adjoint are hand-written with
    the linearization point's quantities computed by ``upstate``."""
    axis = int(axis) % space.ndim
    check_real_floating(space, "nim_operator")
    j = Jet(dom=space, rng=space, f=_nim_f, df=_nim_df, dft=_nim_dft, upstate=_nim_upstate,
            state={"axis": axis, "p": float(p), "du_dm": None, "U0": None, "S0": None})
    return Operator(j)
