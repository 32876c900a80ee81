#!/usr/bin/env python3
"""The program's spans and counters joined to the device trace.

    python3 h100_bench/spans.py --workload <name> --seed <n> [--untraced <units>]

run from the root of a checkout, sets a cell of ``BENCHMARK.json`` up as
``run.py`` does, then profiles its traced units (``trace_units`` of its
traffic) three times, with the program's spans off, on and off again,
and, with ``--untraced n``, times ``n`` pairs of the same units without
the profiler, spans off then on. It prints the span table of the spans-on run to standard
error and one JSON line last on standard output (also written to
``h100_bench/out/spans_<cell>_<seed>.json``): the table, the program's
counters over the traced units, the readings below, the clock check, and
what the spans cost (and the device operations, by name, that the spans-on
run had more or fewer of than each other). The correctness check is ``run.py``'s; this run makes
none, but it holds the outputs of the traced runs bitwise equal.

The join: each device operation is put down to the innermost program span
open, on the thread that launched it, when its runtime call (the host call
with the operation's correlation id) started; off the card, where the
host's operations stand in for the device's, at the operation's own start.
Each idle gap between device operations is put down to the innermost span
of the program's main thread that covers its middle. The span table holds
per span name its count, host seconds (and self: less its child spans),
device seconds and operations launched, and idle seconds, each whole (in
the span or a span inside it) and self (with no span of the program nested
deeper). The clock check runs ``PROBES`` spans before the units and
``PROBES`` after them, 1 ms apart, each around one small device
operation, and gives the offsets of the trace's clock from the spans'
that keep every probe's runtime call inside its span: they contain 0
where the two share a clock; where they do not, the join moves the
trace's times by the least offsets the probes allow, drawn as a line from
the first probes to the last.

Readings (``readings``): ``encode_ms_per_step`` (device ms launched in
``codec.encode`` over ``snapshots.encoded``), ``window_ms_per_shot``
(``window.take`` and ``window.place`` over ``shots``),
``window_take_ms_per_shot`` (``window.take`` alone),
``sweep_idle_us_per_step`` (idle inside ``sweep.*`` over the sum of the
``steps.*`` counters) and ``launches_per_step`` and ``idle_pct`` as the
benchmark's readers compute them. ``run.py``'s traced run does not join
spans yet (``PERF.md``, Open questions, names the edits it needs).
"""
from __future__ import annotations

import bisect
import sys
import time
from collections import Counter, defaultdict
from pathlib import Path

if __package__ in (None, ""):
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

__all__ = ["registry", "profile_units", "join", "clock_offsets", "readings", "run", "main",
           "OUTSIDE", "PROBES", "PROBE_OP"]

OUTSIDE = "(outside any span)"
PROBES = 20
PROBE_OP = "i0e"  # the clock probes' operation, torch.special.i0e: the program has none
_KEYS = ("device_s", "ops", "idle_s")


def registry():
    """The program's span and counter registry
    (``jets_tpu_torch.utils.profiling``), or ``None`` for a program without
    one."""
    from jets_tpu_torch.utils import profiling

    return profiling if hasattr(profiling, "set_spans") else None


def profile_units(run_unit, first: int, active: int, sync, on_card: bool = True,
                  spans_on: bool = True, probe=None) -> dict:
    """Run units ``first .. first + active - 1`` under ``torch.profiler``
    (CUPTI only on the card, the host's operations off it) after a step of
    its own that keeps nothing, with the program's spans on around the
    units alone if ``spans_on``; before and after them, still recorded,
    ``PROBES`` clock probes: ``probe()`` (a small device operation whose
    name holds ``PROBE_OP``, which the program never runs) inside a span
    ``clock.probe`` each, 1 ms apart. The probes' operations are left out
    of the rest. Returns the joined trace: ``summary`` (as the benchmark's
    traced run reduces it), ``counts`` (the units'), ``program`` (the
    program's counters over the units), ``table``, ``clock``, ``wall_s``
    and ``op_names``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    from h100_bench import tracing

    def events(p):
        """``(device operations, {correlation: runtime call})``."""
        dev, calls = [], {}
        for e in p.profiler.kineto_results.events():
            if tracing.is_span(e):
                continue
            start, end = e.start_ns(), e.start_ns() + e.duration_ns()
            if e.device_type() == DeviceType.CUDA:
                dev.append((start, end, e.name(), e.correlation_id(), None))
            elif e.device_type() == DeviceType.CPU:
                if on_card:
                    calls[e.correlation_id()] = (start, end, e.start_thread_id())
                else:
                    dev.append((start, end, e.name(), e.correlation_id(),
                                e.start_thread_id()))
        return dev, calls

    prog = registry()
    prog.spans(reset=True)
    activity = ProfilerActivity.CUDA if on_card else ProfilerActivity.CPU
    counts = defaultdict(int)
    with profile(activities=[activity],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        torch.zeros(1, device="cuda" if on_card else "cpu").add_(1)
        sync()
        prof.step()
        was = prog.set_spans(True)
        try:
            _probes(prog, probe, sync)
            before = prog.counters()
            prog.set_spans(spans_on)
            t0 = time.perf_counter()
            for k in range(active):
                for key, v in run_unit(first + k).items():
                    counts[key] += v
            sync()
            t1 = time.perf_counter()
            program = {k: v - before.get(k, 0) for k, v in prog.counters().items()
                       if v != before.get(k, 0)}
            prog.set_spans(True)
            _probes(prog, probe, sync)
        finally:
            prog.set_spans(was)
        prof.step()
    dev, calls = events(prof)
    del prof
    probes = [op for op in dev if PROBE_OP in op[2]]
    dev = [op for op in dev if PROBE_OP not in op[2]]
    recorded = prog.spans(reset=True)
    clock = clock_offsets([_launch(op, calls)[0] for op in probes], recorded)
    clock["probe_ops"] = len(probes)
    clock["span_threads"] = sorted({s["tid"] for s in recorded})
    clock["launch_threads"] = sorted({_launch(op, calls)[1] for op in dev} - {None})[:8]
    table, _ = join(dev, calls, recorded, clock["shift"])
    kept = [(a * 1e-9, b * 1e-9, name) for a, b, name, _, _ in dev]
    summary = tracing._reduce(kept, [], t1 - t0)
    del summary["idle_gaps"]  # named by the join's table here
    return {"summary": summary, "counts": dict(counts), "program": program, "table": table,
            "clock": clock, "wall_s": t1 - t0, "op_names": Counter(n for _, _, n in kept)}


def _probes(prog, probe, sync):
    for _ in range(PROBES):
        with prog.span("clock.probe"):
            probe()
        spin = time.perf_counter()
        while time.perf_counter() - spin < 1e-3:  # far apart, the thread kept busy
            pass
    sync()


def _launch(op, calls):
    """``(time, thread)`` at which device operation ``op`` was launched: its
    runtime call's start, or off the card its own."""
    start, _, _, corr, tid = op
    if tid is None and corr in calls:
        return calls[corr][0], calls[corr][2]
    return start, tid


class _Index:
    """The spans of each thread, for the innermost one covering a time."""

    def __init__(self, recorded):
        by_tid = defaultdict(list)
        for s in recorded:
            by_tid[s["tid"]].append(s)
        self.threads = {}
        for tid, ss in by_tid.items():
            ss.sort(key=lambda s: (s["start_ns"], -s["end_ns"]))
            at = {s["id"]: i for i, s in enumerate(ss)}
            parent = [at.get(s["parent"], -1) for s in ss]
            self.threads[tid] = ([s["start_ns"] for s in ss], ss, parent)
        self.main = max(by_tid, key=lambda t: len(by_tid[t])) if by_tid else None

    def innermost(self, t, tid):
        """The chain of spans of thread ``tid`` covering ``t``, innermost
        first (empty if none)."""
        if tid not in self.threads:
            return []
        starts, ss, parent = self.threads[tid]
        i = bisect.bisect_right(starts, t) - 1
        while i >= 0 and ss[i]["end_ns"] < t:
            i = parent[i]
        chain = []
        while i >= 0:
            chain.append(ss[i])
            i = parent[i]
        return chain


def join(dev, calls, recorded, shift=()):
    """``(table, names)``: the span table of the device operations ``dev``
    (``(start_ns, end_ns, name, correlation, thread or None)``), launched by
    the runtime ``calls`` (``{correlation: (start_ns, end_ns, thread)}``),
    against the ``recorded`` spans, the trace's times moved onto the spans'
    clock by ``shift`` (:func:`clock_offsets`); ``names`` gives each operation's
    innermost span name (``OUTSIDE`` for none). A thread of the trace that
    recorded no span stands for the main thread of the spans (the host's
    operations off the card carry the profiler's own thread numbers)."""
    idx = _Index(recorded)
    table = defaultdict(lambda: dict.fromkeys(
        ("count", "host_s", "host_self_s") + _KEYS + tuple(k + "_self" for k in _KEYS), 0))
    children = defaultdict(int)
    for s in recorded:
        children[s["parent"]] += s["end_ns"] - s["start_ns"]
    for tid, (_, ss, parent) in idx.threads.items():
        for i, s in enumerate(ss):
            row, dur = table[s["name"]], s["end_ns"] - s["start_ns"]
            row["count"] += 1
            row["host_self_s"] += (dur - children[s["id"]]) * 1e-9
            j = parent[i]
            while j >= 0 and ss[j]["name"] != s["name"]:
                j = parent[j]
            if j < 0:  # not inside a span of its own name
                row["host_s"] += dur * 1e-9

    def put(chain, key, v):
        if not chain:
            table[OUTSIDE][key] += v
            table[OUTSIDE][key + "_self"] += v
            return
        table[chain[0]["name"]][key + "_self"] += v
        for name in {s["name"] for s in chain}:
            table[name][key] += v

    names = []
    for op in dev:
        t, tid = _launch(op, calls)
        chain = idx.innermost(_shifted(t, shift), tid if tid in idx.threads else idx.main)
        put(chain, "device_s", (op[1] - op[0]) * 1e-9)
        put(chain, "ops", 1)
        names.append(chain[0]["name"] if chain else OUTSIDE)
    end = None
    for a, b, *_ in sorted(dev):
        if end is not None and a > end:
            put(idx.innermost(_shifted((end + a) // 2, shift), idx.main), "idle_s",
                (a - end) * 1e-9)
        end = b if end is None else max(end, b)
    return {k: dict(v) for k, v in table.items()}, names


def clock_offsets(launches, recorded) -> dict:
    """For the clock probes before the units and those after (each half of
    the ``clock.probe`` spans), each met by the probe operation launched
    nearest its middle (``launches``: the probe operations' launch times;
    a probe none meets within half the probes' least spacing is left out): the
    offsets (ns, added to the trace's times) that keep every met probe's
    launch inside its span, whether they include 0 (``shared``), and the
    bound they put on the two clocks' distance there. ``shift`` gives the
    join its correction: at each end the offset nearest 0 that its probes
    allow, drawn as a line through the two ends (``[[trace time, offset],
    ...]``; empty where both allow 0)."""
    probes = sorted((s["start_ns"], s["end_ns"]) for s in recorded
                    if s["name"] == "clock.probe")
    launches = sorted(launches)
    reach = min((b[0] - a[0] for a, b in zip(probes, probes[1:])), default=0) // 2
    out, shift, half = {"probes": len(probes)}, [], len(probes) // 2
    for end, group in (("start", probes[:half]), ("end", probes[half:])):
        lo, hi, met = -float("inf"), float("inf"), []
        for s0, s1 in group:
            mid = (s0 + s1) // 2
            k = bisect.bisect_left(launches, mid)
            near = launches[max(k - 1, 0):k + 1]
            c = min(near, key=lambda x: abs(x - mid)) if near else None
            if c is None or abs(c - mid) > reach:
                continue
            met.append((s0 <= c <= s1, c))
            lo, hi = max(lo, s0 - c), min(hi, s1 - c)
        if not met:
            return {**out, "shared": None, "shift": []}
        d = (lo + hi) // 2 if lo > hi else min(max(0, lo), hi)
        shift.append([sum(c for _, c in met) // len(met), int(d)])
        out[end] = {"inside": sum(i for i, _ in met), "of": len(group), "met": len(met),
                    "offset_lo_us": lo * 1e-3, "offset_hi_us": hi * 1e-3,
                    "shared": lo <= 0 <= hi,
                    "skew_bound_us": max(abs(lo), abs(hi)) * 1e-3 if lo <= hi else None}
    out["shared"] = out["start"]["shared"] and out["end"]["shared"]
    out["shift"] = [] if out["shared"] else shift
    return out


def _shifted(t, shift):
    """Trace time ``t`` on the spans' clock: ``t`` plus the line through
    ``shift``'s points."""
    if not shift:
        return t
    (ta, da), (tb, db) = shift
    return t + (da if tb == ta else da + (db - da) * (t - ta) // (tb - ta))


def readings(table: dict, program: dict, summary: dict, counts: dict) -> dict:
    """The per-layer readings of one joined traced run (``None`` where the
    run has nothing to read)."""
    def dev(*names):
        if not any(n in table for n in names):
            return None
        return sum(table.get(n, {}).get("device_s", 0.0) for n in names)

    def per(v, n, scale):
        return scale * v / n if n and v is not None else None

    steps = sum(program.get(k, 0) for k in ("steps.forward", "steps.history", "steps.reverse"))
    idle = (sum(r["idle_s"] for n, r in table.items() if n.startswith("sweep."))
            if any(n.startswith("sweep.") for n in table) else None)
    busy, window = summary["busy_s"], summary["window_s"]
    return {
        "encode_ms_per_step": per(dev("codec.encode"), program.get("snapshots.encoded"), 1e3),
        "window_ms_per_shot": per(dev("window.take", "window.place"), program.get("shots"),
                                  1e3),
        "window_take_ms_per_shot": per(dev("window.take"), program.get("shots"), 1e3),
        "sweep_idle_us_per_step": per(idle, steps, 1e6),
        "launches_per_step": per(summary["device_ops"], counts.get("steps"), 1.0),
        "idle_pct": 100.0 * (1.0 - busy / window) if window > 0 else None,
        "idle_named_pct": (100.0 * (1.0 - table.get(OUTSIDE, {}).get("idle_s", 0.0)
                                    / sum(r["idle_s_self"] for r in table.values()))
                           if any(r["idle_s_self"] for r in table.values()) else None),
    }


def _print_table(table, log):
    cols = ("count", "host_s", "host_self_s", "device_s", "device_s_self", "ops", "ops_self",
            "idle_s", "idle_s_self")
    print("span".ljust(20) + "".join(c.rjust(14) for c in cols), file=log)
    for name, row in sorted(table.items(), key=lambda kv: -kv[1]["device_s"]):
        print(name[:20].ljust(20) + "".join(
            (f"{row[c]:14d}" if isinstance(row[c], int) else f"{row[c]:14.6f}") for c in cols),
            file=log)


def run(manifest: dict, workload: str, seed: int, *, device, untraced: int = 0,
        config: dict = None, traffic: dict = None, log=sys.stderr) -> dict:
    """Set the cell up, profile its traced units with spans off, on and off
    again, and time ``untraced`` pairs of the same units without the
    profiler, spans off then on; returns the result's dict.
    ``config``/``traffic`` replace the files' (the CPU tests' small
    sizes)."""
    import torch

    from h100_bench import generator, harness

    cell, centry = harness.find_cell(manifest, workload)
    cfg = config if config is not None else harness.load_json(harness.ROOT / centry["file"])
    trf = traffic if traffic is not None else harness.load_json(
        harness.HERE / "traffic" / f"{cell['traffic']}.json")
    drv = harness.driver(cfg["driver"])
    on_card = torch.device(device).type == "cuda"
    system = drv.System(cfg, trf, generator.schedule(trf, seed, drv.positions(cfg)), device)
    n = int(trf["trace_units"])
    x, y = torch.zeros(1, device=device), torch.zeros(1, device=device)
    torch.special.i0e(x, out=y)  # built before any trace
    res, outputs = {}, {}
    for mode in ("off", "on", "off_again"):
        res[mode] = profile_units(system.run_unit, 0, n, system._sync, on_card,
                                  spans_on=mode == "on",
                                  probe=lambda: torch.special.i0e(x, out=y))
        outputs[mode] = system.last
    same = all(torch.equal(outputs["on"][k], outputs[m][k]) for m in ("off", "off_again")
               for k in outputs["on"] if torch.is_tensor(outputs["on"][k]))
    on = res["on"]
    out = {"workload": workload, "seed": seed, "device": torch.cuda.get_device_name()
           if on_card else "cpu", "outputs_equal": same, "clock": on["clock"],
           "counts": on["counts"], "program": on["program"], "table": on["table"]}
    for mode, r in res.items():
        more = Counter(on["op_names"])
        more.subtract(r["op_names"])
        out[f"spans_{mode}"] = {"wall_s": r["wall_s"], **readings(
            r["table"], r["program"], r["summary"], r["counts"]), "device_ops":
            r["summary"]["device_ops"], "busy_s": r["summary"]["busy_s"],
            "program_same": r["program"] == on["program"],
            "ops_on_less_these": {k[:120]: v for k, v in more.items() if v}}
    prog = registry()
    walls = defaultdict(list)
    for _ in range(untraced):  # the traced units again, so each pair runs one batch
        for spans_on in (False, True):
            prog.set_spans(spans_on)
            t0 = time.perf_counter()
            system.run_unit(0)
            walls["on" if spans_on else "off"].append(time.perf_counter() - t0)
            prog.set_spans(False)
            prog.spans(reset=True)
    if untraced:
        out["untraced_unit_s"] = dict(walls)
    _print_table(on["table"], log)
    print(f"{workload}: clock {out['clock']}", file=log)
    return out


def main(argv=None) -> int:
    import argparse
    import json

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--untraced", type=int, default=0)
    a = p.parse_args(argv)
    import torch

    from h100_bench import harness, run as bench_run

    bench_run._caches()
    if registry() is None:
        print("the program records no spans (jets_tpu_torch.utils.profiling has no "
              "set_spans)", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    out = run(harness.load_manifest(), a.workload, a.seed, device="cuda",
              untraced=a.untraced)
    path = harness.HERE / "out" / f"spans_{a.workload}_{a.seed}.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(out, indent=1))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
