"""Least work of the isotropic acoustic wave steps, per grid cell, in 2-D
and 3-D.

A step is counted by what its function needs, whatever implements it:
every input field read once and every output field written once
(``float32`` fields 4 bytes, an ``int8`` snapshot 1 byte), the sponge
as its 1-D factors (``ndim - 1`` products a cell, no bytes), and the
Laplacian with symmetric taps: one multiply for the centre, one for
each tap pair whose coefficient is not 1, and two adds for each pair
(the pair's sum and the accumulation). The bytes a cell are the same in
2-D and 3-D.

* forward: ``u' = S*((2u - u_prev) + C*L(u)) + src``: reads ``u_prev``,
  ``u``, ``c``; writes ``u'``: 16 B.
* forward with an int8 history: the same, and ``u`` written as its
  int8 code (the scale is a number a step): 17 B.
* reverse: ``a = (2e + L(C*e)) - S*a2``, ``g += L(dec(q))*e`` with
  ``e = S*a1``: reads ``a1``, ``a2``, ``g``, ``c`` and ``q``; writes
  ``a`` and ``g``: 25 B.

Receivers add 4 bytes each per step: the forward writes its trace
sample; the gradient's reverse sweep reads the residual's sample and its
forward sweep reads the observed one. An objective-and-gradient
evaluation needs one forward sweep with the history (it records the
traces too) and one reverse sweep; what a program spends beyond that is
not counted.
"""
from __future__ import annotations

from math import prod

F32, I8 = 4, 1
_HALF = {2: 1, 4: 2, 8: 4}

__all__ = ["laplacian_flops", "step_bytes", "step_flops", "unit_work"]


def laplacian_flops(order: int, ndim: int = 3) -> int:
    """Operations of one cell of the order-``order`` Laplacian."""
    pairs = ndim * _HALF[order]
    return 1 + (pairs if order != 2 else 0) + 2 * pairs


def step_bytes(kind: str) -> int:
    """Bytes a cell of one step of ``kind`` moves."""
    return {"forward": 4 * F32, "forward_hist": 4 * F32 + I8,
            "reverse": 6 * F32 + I8}[kind]


def step_flops(kind: str, order: int, ndim: int = 3) -> int:
    """Operations a cell of one step of ``kind`` needs at ``order`` on an
    ``ndim``-dimensional grid."""
    lap = laplacian_flops(order, ndim)
    # 2u, -, C*L, +, the sponge's factor products, *S
    fwd = lap + 5 + (ndim - 1)
    if kind == "forward":
        return fwd
    if kind == "forward_hist":
        return fwd + 3  # |u| against the running max, the scale, the rounding
    if kind == "reverse":
        # e = S*a1 (ndim), 2e, C*e, +, S*a2, -, q*sc, *e, g + : 2 Laplacians + 8 + ndim
        return 2 * lap + 8 + ndim
    raise ValueError(f"unknown step kind {kind!r}")


def unit_work(unit: str, *, shots: int, nt: int, window_shape, nreceivers: int,
              order: int) -> dict:
    """``{"bytes", "flops"}`` of one unit of ``shots`` shots: ``"forward"``
    (the traces) or ``"gradient"`` (objective and gradient)."""
    cells = prod(int(s) for s in window_shape)
    kinds = {"forward": ("forward",), "gradient": ("forward_hist", "reverse")}[unit]
    rcv_bytes = {"forward": F32, "gradient": 3 * F32}[unit] * nreceivers
    per_step_b = sum(step_bytes(k) for k in kinds) * cells + rcv_bytes
    per_step_f = sum(step_flops(k, order, len(window_shape)) for k in kinds) * cells
    return {"bytes": shots * nt * per_step_b, "flops": shots * nt * per_step_f}
