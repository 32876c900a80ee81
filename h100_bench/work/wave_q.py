"""Least work of the constant-Q visco-acoustic wave steps, per grid cell,
counted by ``work/wave.py``'s rule: every input field read once and every
output field written once (``float32`` fields 4 bytes, an ``int8``
snapshot 1 byte), the sponge as its 1-D factors, the Laplacian as there.
The friction field ``g = pi f0 dt / Q`` is a float32 field; ``1 - g`` and
``1/(1 + g)`` are operations, not bytes.

* forward: ``u' = S*(((2u - (1-g) u_prev) + C*L(u)) / (1+g)) + src``:
  reads ``u_prev``, ``u``, ``C``, ``g``; writes ``u'``: 20 B.
* forward with an int8 history: the same, and ``u`` written as its int8
  code: 21 B.
* reverse: ``sbar = S*a1``, ``ebar = sbar/(1+g)``, ``a = 2 ebar +
  L(C*ebar) - (1-g) ebar_next``, ``gC += L(u)*ebar``, ``gig += sbar*(2u +
  C*L(u)) - (1-g) u*sbar_next``, ``gog -= u*ebar_next``: reads ``a1``,
  ``a2`` (``ebar_next``, ``sbar_next`` are ``a2``'s), ``C``, ``g``, the
  int8 snapshot, ``gC``, ``gig``, ``gog``; writes ``a``, ``gC``, ``gig``,
  ``gog``: 45 B.

Receivers as in ``work/wave.py``: 4 bytes each per step in a forward, 12
in a gradient. A gradient is one forward sweep with the history and one
reverse sweep: 66 B a cell-step. K14 alone is one forward step a launch.
"""
from __future__ import annotations

from math import prod

from .wave import F32, I8, laplacian_flops

__all__ = ["step_bytes", "step_flops", "unit_work", "q_step_work"]


def step_bytes(kind: str) -> int:
    """Bytes a cell of one Q step of ``kind`` moves."""
    return {"forward": 5 * F32, "forward_hist": 5 * F32 + I8,
            "reverse": 11 * F32 + I8}[kind]


def step_flops(kind: str, order: int, ndim: int = 3) -> int:
    """Operations a cell of one Q step of ``kind`` needs at ``order`` on an
    ``ndim``-dimensional grid."""
    lap = laplacian_flops(order, ndim)
    # 2u, 1-g, (1-g)*u_prev, -, C*L, +, 1+g, 1/(1+g), *, *S, the sponge's products
    fwd = lap + 9 + (ndim - 1)
    if kind == "forward":
        return fwd
    if kind == "forward_hist":
        return fwd + 3  # |u| against the running max, the scale, the rounding
    if kind == "reverse":
        # q*sc; S*a1 (ndim); 1+g, 1/(1+g), *; L(u), *ebar, gC +; 2u, C*L, +, *sbar,
        # 1-g, u*sbar_next, *, -, gig +; u*ebar_next, gog -; 2 ebar, C*ebar, L,
        # +, (1-g)*ebar_next, -
        return 2 * lap + 1 + ndim + 3 + 2 + 9 + 2 + 5
    raise ValueError(f"unknown step kind {kind!r}")


def unit_work(unit: str, *, shots: int, nt: int, window_shape, nreceivers: int,
              order: int) -> dict:
    """``{"bytes", "flops"}`` of one unit of ``shots`` shots: ``"forward"``
    (the traces) or ``"gradient"`` (objective and ``(c, Q)`` gradient)."""
    cells = prod(int(s) for s in window_shape)
    kinds = {"forward": ("forward",), "gradient": ("forward_hist", "reverse")}[unit]
    rcv_bytes = {"forward": F32, "gradient": 3 * F32}[unit] * nreceivers
    per_step_b = sum(step_bytes(k) for k in kinds) * cells + rcv_bytes
    per_step_f = sum(step_flops(k, order, len(window_shape)) for k in kinds) * cells
    return {"bytes": shots * nt * per_step_b, "flops": shots * nt * per_step_f}


def q_step_work(window_shape, order: int) -> dict:
    """``{"bytes", "flops"}`` of one launch of K14 (one forward Q step) on
    a window."""
    cells = prod(int(s) for s in window_shape)
    return {"bytes": step_bytes("forward") * cells,
            "flops": step_flops("forward", order, len(window_shape)) * cells}
