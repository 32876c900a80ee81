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

The port's own spans and counters (no counterpart in the JAX package) live
here too, in one registry per process:

* :func:`span` — ``with span("sweep.reverse"): ...`` records the name, the
  start and end on ``time.time_ns()`` (the Unix-epoch clock on which
  ``torch.profiler`` stamps its events), the ids of the span that was open
  around it and of the outermost one (the objective or operator call the
  work belongs to), the thread and the keyword attributes. Spans are off
  by default; off, a span costs one flag check and records nothing.
  :func:`set_spans` turns them on or off, :func:`spans` reads them.
  A span never synchronises the device: the device's time comes from
  joining the spans to a profiler trace on that shared clock.
* :func:`count` — ``count("steps.reverse", nt)`` adds to a named counter;
  counters always count. :func:`counters` reads (and resets) them. The
  CUDA wrappers' launch counts (``ops.cuda_*.launch_counts()``) and the
  halo exchanges (``parallel.collectives.halo_counts()``) are views of it.
"""
from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time
from typing import Callable, Iterable, Optional

import torch

from ..core.jet import AdjointOperator, Operator

__all__ = ["op_cost", "instrument", "trace", "span", "set_spans", "spans", "count",
           "counters"]

_SPANS_ON = False
_SPANS = []  # (name, start_ns, end_ns, id, parent, root, tid, attrs), in order of ending
_COUNTS = {}
_OPEN = threading.local()  # .stack: the spans open on this thread, outermost first; .tid
_IDS = itertools.count(1)
_OFF = contextlib.nullcontext()  # the span of a process whose spans are off


class _Span:
    __slots__ = ("name", "attrs", "id", "parent", "root", "start")

    def __init__(self, name, attrs):
        self.name, self.attrs = name, attrs

    def __enter__(self):
        stack = getattr(_OPEN, "stack", None)
        if stack is None:
            stack = _OPEN.stack = []
            # once a thread: in a sandboxed kernel the call is a slow syscall
            _OPEN.tid = threading.get_native_id()
        self.id = next(_IDS)
        self.parent, self.root = (stack[-1].id, stack[-1].root) if stack else (0, self.id)
        stack.append(self)
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        _OPEN.stack.pop()
        _SPANS.append((self.name, self.start, end, self.id, self.parent, self.root, _OPEN.tid,
                       self.attrs))
        return False


def span(name: str, **attrs):
    """A context manager that records the region it wraps as a span named
    ``name`` with ``attrs`` (numbers or strings), when spans are on
    (:func:`set_spans`); otherwise it does nothing."""
    if not _SPANS_ON:
        return _OFF
    return _Span(name, attrs)


def set_spans(on: bool) -> bool:
    """Turn the recording of spans on or off; returns the previous setting."""
    global _SPANS_ON
    was, _SPANS_ON = _SPANS_ON, bool(on)
    return was


def spans(reset: bool = False) -> list:
    """The spans recorded (in the order they ended), each a dict: ``name``,
    ``start_ns``, ``end_ns`` (``time.time_ns()``), ``id``, ``parent`` (0 for
    an outermost span), ``root``, ``tid`` (``threading.get_native_id()``),
    ``attrs``; ``reset`` forgets them."""
    out = [dict(name=n, start_ns=a, end_ns=b, id=i, parent=p, root=r, tid=t, attrs=at)
           for n, a, b, i, p, r, t, at in _SPANS]
    if reset:
        _SPANS.clear()
    return out


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name``."""
    _COUNTS[name] = _COUNTS.get(name, 0) + n


def counters(names: Optional[Iterable[str]] = None, reset: bool = False) -> dict:
    """``{name: value}`` of the counters ``names`` (0 for one never
    counted), or of every counter; ``reset`` sets them back to 0."""
    names = list(_COUNTS) if names is None else list(names)
    out = {k: _COUNTS.get(k, 0) for k in names}
    if reset:
        for k in names:
            _COUNTS.pop(k, None)
    return out


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
    ``key_averages()`` and the like. Spans are on inside the region: the
    program's spans of the region are written into the same file, on the
    profiler's clock and threads, as complete events of the category
    ``jets_tpu_torch`` (their ids and attributes under ``args``):

    >>> with trace("traces"):
    ...     res = lsqr(A, b, maxiter=100)
    ...     torch.cuda.synchronize()
    """
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = torch.profiler.profile(activities=acts)
    first, was = len(_SPANS), set_spans(True)
    prof.start()
    try:
        yield prof
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        set_spans(was)
        mine = spans()[first:]
        if not was:
            del _SPANS[first:]
        path = os.path.join(logdir, f"jets_trace_{time.time_ns()}_{os.getpid()}.json")
        prof.export_chrome_trace(path)
        _add_spans(path, mine)


def _add_spans(path: str, recorded: list) -> None:
    """Append ``recorded`` spans to the Chrome trace at ``path`` (whose
    timestamps are microseconds after its ``baseTimeNanoseconds``)."""
    with open(path) as f:
        doc = json.load(f)
    base, pid = doc.get("baseTimeNanoseconds", 0), os.getpid()
    doc["traceEvents"] += [
        {"ph": "X", "cat": "jets_tpu_torch", "name": s["name"], "pid": pid, "tid": s["tid"],
         "ts": (s["start_ns"] - base) / 1e3, "dur": (s["end_ns"] - s["start_ns"]) / 1e3,
         "args": {"id": s["id"], "parent": s["parent"], "root": s["root"], **s["attrs"]}}
        for s in recorded]
    with open(path, "w") as f:
        json.dump(doc, f)
