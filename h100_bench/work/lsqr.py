"""Least work of an LSQR solve on the multi-shot seismic operator
``A = S o L`` (order-2 Laplacian sampled at the receivers, per-shot
receiver weights ``wr``).

Dense model-space vectors (``float32``, 4 bytes a cell), each read once
and written once:

* an iteration: reads ``v``, ``x``, ``w``; writes ``v_hat = A^T u' + s v``
  (stored for the next iteration), ``x`` and ``w``: 24 B a cell. ``A^T u'``
  is nonzero only at the stencil taps of the receivers, so it moves no
  dense bytes of its own, and ``||v_hat||`` is taken as it is written.
  Data space: ``wr`` and ``u`` read and ``u'`` written once each
  (``3 * nshots * nreceivers * 4`` bytes).
* the start of a solve: writes ``v_hat = A^T u``, ``w`` and ``x = 0``:
  12 B a cell, and reads ``b`` and ``wr`` and writes ``u``.

Operations: an iteration needs ``s v + A^T u'`` (2), the norm (2), ``x``
(2) and ``w`` (3) a cell; the start ``A^T u`` (the deposit, none dense),
the norm (2) and ``w`` (1). The receivers' sampled stencils are counted as
7 taps each (13 operations) per shot's weighted sample.
"""
from __future__ import annotations

from math import prod

F32 = 4

__all__ = ["iteration_work", "solve_work"]


def iteration_work(grid_shape, nshots: int, nreceivers: int) -> dict:
    cells = prod(int(s) for s in grid_shape)
    data = nshots * nreceivers
    return {"bytes": 6 * F32 * cells + 3 * F32 * data,
            "flops": 9 * cells + 13 * nreceivers + 2 * data}


def solve_work(grid_shape, nshots: int, nreceivers: int, iterations: int) -> dict:
    """One solve of ``iterations`` iterations, its start included."""
    cells = prod(int(s) for s in grid_shape)
    data = nshots * nreceivers
    it = iteration_work(grid_shape, nshots, nreceivers)
    return {"bytes": iterations * it["bytes"] + 3 * F32 * cells + 3 * F32 * data,
            "flops": iterations * it["flops"] + 3 * cells + 2 * data}
