"""The join of the program's spans to the profiler's events
(``h100_bench/spans.py``), on made-up events and on traced runs of each
cell on the CPU: where the program's counters meet the driver's
``counts()`` (the divisor of ``launches_per_step``), and what each cell's
readings read."""
import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
sys.path.insert(0, str(Path(__file__).resolve().parent))

from _small import SMALL, manifest  # noqa: E402
from h100_bench import spans  # noqa: E402

MS = 1_000_000  # ns


def _span(i, name, a, b, parent=0, root=None, tid=7):
    return {"name": name, "start_ns": a * MS, "end_ns": b * MS, "id": i, "parent": parent,
            "root": root or (parent and 1) or i, "tid": tid, "attrs": {}}


def test_join_puts_work_and_gaps_down_to_the_innermost_span():
    recorded = [_span(1, "objective", 0, 100), _span(2, "sweep.history", 10, 60, 1),
                _span(3, "codec.encode", 20, 30, 2), _span(4, "codec.encode", 40, 45, 2),
                _span(5, "sweep.reverse", 60, 95, 1)]
    # (device start, end, name, correlation, thread): on the card the thread
    # comes from the launching runtime call
    dev = [(21 * MS, 25 * MS, "abs", 1, None), (26 * MS, 31 * MS, "mul", 2, None),
           (35 * MS, 36 * MS, "k4", 3, None), (61 * MS, 90 * MS, "k5", 4, None),
           (101 * MS, 102 * MS, "fill", 5, None)]
    calls = {1: (20.5 * MS, 20.6 * MS, 99), 2: (22 * MS, 22.1 * MS, 99),
             3: (33 * MS, 33.1 * MS, 99), 4: (60.5 * MS, 60.6 * MS, 99),
             5: (100.5 * MS, 100.6 * MS, 99)}
    table, names = spans.join(dev, calls, recorded)
    assert names == ["codec.encode", "codec.encode", "sweep.history", "sweep.reverse",
                     spans.OUTSIDE]
    enc, hist, obj = table["codec.encode"], table["sweep.history"], table["objective"]
    assert enc["count"] == 2 and enc["ops"] == enc["ops_self"] == 2
    assert enc["device_s"] == pytest.approx(9e-3)
    assert hist["ops"] == 3 and hist["ops_self"] == 1
    assert hist["device_s"] == pytest.approx(10e-3)
    assert hist["device_s_self"] == pytest.approx(1e-3)
    assert obj["ops"] == 4 and obj["ops_self"] == 0
    assert table[spans.OUTSIDE]["ops"] == 1
    # gaps: 25-26 (middle 25.5: codec.encode), 31-35 (33: sweep.history),
    # 36-61 (48.5: sweep.history), 90-101 (95.5: objective, as sweep.reverse
    # ended at 95)
    assert enc["idle_s"] == enc["idle_s_self"] == pytest.approx(1e-3)
    assert hist["idle_s_self"] == pytest.approx(29e-3) and hist["idle_s"] == pytest.approx(30e-3)
    assert obj["idle_s_self"] == pytest.approx(11e-3) and obj["idle_s"] == pytest.approx(41e-3)
    assert hist["host_s"] == pytest.approx(50e-3) and hist["host_self_s"] == pytest.approx(35e-3)
    assert enc["host_s"] == pytest.approx(15e-3)


def test_clock_offsets_hold_the_probes_launches():
    # two probes before the units, two after; each launched 1 ms into its 2 ms span
    at = (1, 2, 8, 9)
    recorded = [_span(i, "clock.probe", 10 * i, 10 * i + 2) for i in at]
    c = spans.clock_offsets([(10 * i + 1) * MS for i in at], recorded)
    assert c["shared"] and c["shift"] == []
    assert c["start"]["inside"] == c["end"]["inside"] == c["end"]["met"] == 2
    assert c["end"]["offset_lo_us"] == pytest.approx(-1000)
    assert c["end"]["offset_hi_us"] == pytest.approx(1000)
    # the trace's clock runs 3 ms late by the last probes: the join moves
    # its times by the least the probes allow, along a line from the first
    c = spans.clock_offsets([(10 * i + 1 + 3 * (i > 2)) * MS for i in at], recorded)
    assert c["start"]["shared"] and not c["end"]["shared"] and not c["shared"]
    assert c["end"]["inside"] == 0 and c["end"]["skew_bound_us"] == pytest.approx(4000)
    assert c["shift"] == [[16 * MS, 0], [89 * MS, -2 * MS]]
    assert spans._shifted(int(52.5 * MS), c["shift"]) == int(52.5 * MS) - MS
    # a probe whose operation the trace lost is left out
    c = spans.clock_offsets([(10 * i + 1) * MS for i in at[1:]], recorded)
    assert c["shared"] and c["start"]["met"] == 1 and c["end"]["met"] == 2


READS = {"overthrust-iso-grad": ("encode_ms_per_step", "window_ms_per_shot",
                                 "sweep_idle_us_per_step"),
         "marmousi-iso-grad": ("encode_ms_per_step", "sweep_idle_us_per_step"),
         "overthrust-iso-model": ("window_take_ms_per_shot",)}


@pytest.mark.parametrize("workload", sorted(READS))
def test_joined_run_of_each_cell_on_the_cpu(workload):
    cfg = SMALL[workload]()
    out = spans.run(manifest(), workload, 2**31 + 7, device="cpu", config=cfg)
    assert out["outputs_equal"]
    on, off = out["spans_on"], out["spans_off"]
    for name in READS[workload]:
        assert on[name] is not None and on[name] > 0, name
        assert off[name] is None, name
    assert on["device_ops"] == off["device_ops"]  # spans launch nothing
    assert on["launches_per_step"] == off["launches_per_step"]
    assert off["program_same"] and out["spans_off_again"]["program_same"]
    assert on["idle_named_pct"] >= 95.0
    for end in ("start", "end"):
        assert out["clock"][end]["met"] == out["clock"][end]["of"] == spans.PROBES
    # the program's counters against the driver's counts(), whose steps
    # divide the device operations in launches_per_step
    counts, prog = out["counts"], out["program"]
    assert prog["shots"] == counts["shots"]
    batch = counts["shots"] if cfg["shot_map"] == "vmap" else 1  # a vmapped step counts once
    sweeps = (("steps.forward", "steps.history", "steps.reverse") if "grad" in workload
              else ("steps.forward",))
    for k in sweeps:
        assert prog[k] * batch == counts["steps"], k
    assert ("steps.history" in prog) == ("objective" in out["table"]) == ("grad" in workload)
