"""Elementwise nonlinear operators (counterpart of
``jets_tpu/ops/elementwise.py``): the square, the power whose tangent
diagonal the ``upstate`` hook refreshes at linearization, the general
elementwise operator from ``f`` and its derivative, and the named ones
(exp, log, sqrt, tanh, sigmoid, atan, sin, cos)."""
from __future__ import annotations

from typing import Callable

import torch

from ..core.jet import Jet, Operator
from ..core.spaces import Space

__all__ = [
    "square_operator",
    "power_operator",
    "nonlinear_elementwise",
    "exp_operator",
    "log_operator",
    "sqrt_operator",
    "tanh_operator",
    "sigmoid_operator",
    "atan_operator",
    "sin_operator",
    "cos_operator",
]


def _square_f(m, state):
    return m * m


def _square_df(dm, m0, state):
    return 2.0 * m0 * dm


def square_operator(space: Space) -> Operator:
    """Elementwise square ``d = m.^2``; self-adjoint tangent."""
    return Operator(Jet(dom=space, rng=space, f=_square_f, df=_square_df, dft="self"))


def _power_upstate(m0, state):
    """The tangent diagonal, refreshed when the linearization point moves."""
    p = state["p"]
    return {"diag": p * m0 ** (p - 1)}


def _power_f(m, state):
    return m ** state["p"]


def _power_df(dm, m0, state):
    return state["diag"] * dm


def _power_dft(dd, m0, state):
    return torch.conj(state["diag"]) * dd


def power_operator(space: Space, p: float) -> Operator:
    """Elementwise power ``d = m.^p`` whose tangent diagonal is refreshed by
    the ``upstate`` hook at ``linearize`` time."""
    j = Jet(dom=space, rng=space, f=_power_f, df=_power_df, dft=_power_dft,
            upstate=_power_upstate, state={"p": float(p), "diag": space.zeros()})
    return Operator(j)


def nonlinear_elementwise(space: Space, f: Callable, dfdm: Callable) -> Operator:
    """A general elementwise nonlinear operator from ``f(m)`` and its
    elementwise derivative ``dfdm(m)``; the tangent's adjoint is the
    conjugate diagonal."""

    def _f(m, state):
        return f(m)

    def _df(dm, m0, state):
        return dfdm(m0) * dm

    def _dft(dd, m0, state):
        return torch.conj(dfdm(m0)) * dd

    return Operator(Jet(dom=space, rng=space, f=_f, df=_df, dft=_dft))


def exp_operator(space: Space) -> Operator:
    """``d = exp(m)``; tangent diagonal ``exp(m0)``."""
    return nonlinear_elementwise(space, torch.exp, torch.exp)


def log_operator(space: Space) -> Operator:
    """``d = log(m)`` (positive models); tangent diagonal ``1/m0``."""
    return nonlinear_elementwise(space, torch.log, lambda m: 1.0 / m)


def sqrt_operator(space: Space) -> Operator:
    """``d = sqrt(m)``; tangent diagonal ``1/(2*sqrt(m0))``."""
    return nonlinear_elementwise(space, torch.sqrt, lambda m: 0.5 / torch.sqrt(m))


def tanh_operator(space: Space) -> Operator:
    """``d = tanh(m)``; tangent diagonal ``1 - tanh(m0)^2``."""
    return nonlinear_elementwise(space, torch.tanh, lambda m: 1.0 - torch.tanh(m) ** 2)


def sigmoid_operator(space: Space) -> Operator:
    """Logistic ``d = 1/(1+exp(-m))``; tangent diagonal ``d*(1-d)``."""
    return nonlinear_elementwise(space, torch.sigmoid,
                                 lambda m: torch.sigmoid(m) * (1.0 - torch.sigmoid(m)))


def atan_operator(space: Space) -> Operator:
    """``d = atan(m)``; tangent diagonal ``1/(1+m0^2)``."""
    return nonlinear_elementwise(space, torch.atan, lambda m: 1.0 / (1.0 + m * m))


def sin_operator(space: Space) -> Operator:
    """``d = sin(m)``; tangent diagonal ``cos(m0)``."""
    return nonlinear_elementwise(space, torch.sin, torch.cos)


def cos_operator(space: Space) -> Operator:
    """``d = cos(m)``; tangent diagonal ``-sin(m0)``."""
    return nonlinear_elementwise(space, torch.cos, lambda m: -torch.sin(m))
