"""The traced run: ``torch.profiler`` over whole units, reduced to what the
per-layer metrics and the breakdown read.

The profiler records the device's activity alone (CUPTI: the kernels,
copies and sets, and the CUDA runtime calls that issue them), not the
host's PyTorch operations: under ``torch.func.vmap`` a 2-D step issues
some 1,500 of those, and recording them would slow the host-bound cells
several-fold and give tens of millions of events. It starts recording in
a step of its own that keeps nothing, then runs ``active`` units; the
set-up's warm-up is the discarded unit. ``window_s`` is the host-clock
length of those units, each ending in a synchronize.
``busy_s`` is the union of the device intervals (not the spans,
``is_span``) in them; ``device_ops`` counts those intervals. An idle gap,
between two device intervals, is named by the innermost runtime call of
the main thread that covers its middle, or as the host between calls.
"""
from __future__ import annotations

import bisect
import sys
import time
from collections import defaultdict

__all__ = ["profile_units", "is_span"]


def profile_units(run_unit, first: int, active: int, sync, on_card: bool = True,
                  log=sys.stderr):
    """Run units ``first .. first + active - 1`` under the profiler, after
    a step of its own in which it starts recording and keeps nothing (the
    set-up has warmed the units' shapes); returns ``(summary, counts)``
    with ``counts`` the summed counts of the units. Off the card (the CPU
    tests) the host's operations stand in for the device's."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    sched = schedule(wait=0, warmup=1, active=1, repeat=1)
    counts = defaultdict(int)
    activity = ProfilerActivity.CUDA if on_card else ProfilerActivity.CPU
    with profile(activities=[activity], schedule=sched) as prof:
        torch.zeros(1, device="cuda" if on_card else "cpu").add_(1)
        sync()
        prof.step()
        t0 = time.perf_counter()
        for k in range(active):
            for key, v in run_unit(first + k).items():
                counts[key] += v
        sync()
        t1 = time.perf_counter()
        prof.step()
    t2 = time.perf_counter()
    events = prof.profiler.kineto_results.events()
    dev, cpu = [], []
    for e in events:
        start, dur = e.start_ns() * 1e-9, e.duration_ns() * 1e-9
        if e.device_type() == DeviceType.CUDA:
            if is_span(e):
                continue
            dev.append((start, start + dur, e.name()))
        elif e.device_type() == DeviceType.CPU:
            cpu.append((start, start + dur, e.name(), e.start_thread_id()))
    del events, prof
    t3 = time.perf_counter()
    summary = _reduce(dev, cpu, t1 - t0)
    print(f"trace: {len(dev)} device and {len(cpu)} host events; stopping the profiler "
          f"{t2 - t1:.1f} s, reading its events {t3 - t2:.1f} s, reducing them "
          f"{time.perf_counter() - t3:.1f} s", file=log)
    return summary, dict(counts)


def is_span(e) -> bool:
    """True for a span (the profiler's steps, a ``record_function`` of the
    program or of the harness), which the trace shows on the device's
    timeline too; false for device work (kernels, copies, sets)."""
    return e.is_user_annotation() or e.name().startswith("ProfilerStep#")


def _reduce(dev, cpu, window_s: float) -> dict:
    dev.sort()
    by_name = defaultdict(float)
    busy, end, gaps = 0.0, None, []
    for a, b, name in dev:
        by_name[name] += b - a
        if end is None or a > end:
            if end is not None:
                gaps.append((end, a))
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {"busy_s": busy, "window_s": window_s, "device_ops": len(dev),
            "top_device_ops": [[n[:160], s] for n, s in top],
            "idle_gaps": _name_gaps(gaps, cpu)}


def _name_gaps(gaps, cpu):
    """Idle seconds by the host's runtime call that covered each gap's
    middle, the ten largest sums."""
    if not gaps:
        return []
    threads = defaultdict(int)
    for ev in cpu:
        threads[ev[3]] += 1
    main = max(threads, key=threads.get) if threads else None
    evs = sorted(((a, b, n) for a, b, n, t in cpu if t == main),
                 key=lambda e: (e[0], -e[1]))  # an outer operation before its first child
    parent, stack = [], []
    for i, (a, b, _) in enumerate(evs):  # host operations nest within a thread
        while stack and evs[stack[-1]][1] < a:
            stack.pop()
        parent.append(stack[-1] if stack else -1)
        stack.append(i)
    starts = [a for a, _, _ in evs]
    idle = defaultdict(float)
    for g0, g1 in gaps:
        mid = 0.5 * (g0 + g1)
        i = bisect.bisect_right(starts, mid) - 1
        while i >= 0 and evs[i][1] < mid:
            i = parent[i]
        name = "(host, between calls)" if i < 0 else evs[i][2][:160]
        if name.startswith("ProfilerStep#"):  # inside a unit, between calls
            name = "(host, between calls)"
        idle[name] += g1 - g0
    return [[n, s] for n, s in sorted(idle.items(), key=lambda kv: -kv[1])[:10]]
