"""Observability — per-operator perf metrics and profiler traces
(counterpart of ``jets_tpu/utils/profiling.py``).

The reference's only observability hooks are ``perfstat`` (author-overridable
per-operator metric object, ``src/Jets.jl:281``) and the PkgBenchmark
workflow. The port's equivalents:

* :func:`instrument` — attach a perfstat function reporting an analytic
  cost model (FLOPs, bytes moved) to any operator; combinators surface it
  through :func:`jets_tpu_torch.perfstat` exactly like the reference;
* :func:`trace` — context manager around :class:`torch.profiler.profile`
  (CPU activity, plus CUDA activity when a card is present) writing a
  Chrome trace (``chrome://tracing``, Perfetto) of the wrapped region;
* :func:`op_cost` — analytic cost estimate from the operator's spaces
  (bandwidth-bound default: bytes in + bytes out).
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Optional

import torch

from ..core.jet import AdjointOperator, Operator

__all__ = ["op_cost", "instrument", "trace"]


def _itemsize(dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def op_cost(op: Operator, *, flops_per_elem: float = 1.0) -> dict:
    """Analytic cost model from the operator's spaces: a bandwidth-bound
    apply reads the domain and writes the range once."""
    in_bytes = op.dom.size * _itemsize(op.dom.dtype)
    out_bytes = op.rng.size * _itemsize(op.rng.dtype)
    return {
        "bytes_in": int(in_bytes),
        "bytes_out": int(out_bytes),
        "bytes_total": int(in_bytes + out_bytes),
        "flops": float(flops_per_elem * max(op.dom.size, op.rng.size)),
    }


def instrument(op: Operator, stat_fn: Optional[Callable] = None) -> Operator:
    """Return a copy of ``op`` whose ``perfstat`` reports ``stat_fn(jet)``
    (default: the analytic :func:`op_cost`)."""
    if isinstance(op, AdjointOperator):
        raise TypeError("instrument the underlying operator, not its adjoint")
    cost = op_cost(op)
    fn = stat_fn if stat_fn is not None else (lambda jet, _c=cost: _c)
    return type(op)(op.jet.replace(perfstat=fn))


@contextlib.contextmanager
def trace(logdir: str):
    """Profile a region into a Chrome trace file under ``logdir``
    (``jets_trace_<time>_<pid>.json``), with CUDA kernel events when a card
    is present; the :class:`torch.profiler.profile` object is yielded for
    ``key_averages()`` and the like:

    >>> with trace("traces"):
    ...     res = lsqr(A, b, maxiter=100)
    ...     torch.cuda.synchronize()
    """
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    try:
        yield prof
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(os.path.join(
            logdir, f"jets_trace_{time.time_ns()}_{os.getpid()}.json"))
