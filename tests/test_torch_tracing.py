"""The port's span and counter registry (``jets_tpu_torch.utils.profiling``)
and the spans and counters the wave path records, on the CPU: nothing is
recorded with spans off while the counters count; a multishot gradient's
spans form the tree objective → multishot.adjoint → shot → sweep.history →
codec.encode, with parents and root ids; the counters count what the
sweeps did; spans change no bit of φ, the gradient or the traces; the
spans share the profiler's clock; the counter views return what they
returned before the registry; ``trace`` writes the spans into its Chrome
trace."""
import json
import os
from collections import Counter

import pytest
import torch

from jets_tpu_torch.ops import cuda_solver, cuda_tti, cuda_vti, cuda_wave
from jets_tpu_torch.ops.diagonal import diagonal_operator
from jets_tpu_torch.ops.wave import multishot_wave_operator
from jets_tpu_torch.parallel import collectives
from jets_tpu_torch.solvers.nonlinear import least_squares_objective
from jets_tpu_torch.utils import profiling as tp

CPU = torch.device("cpu")
NT = 16
GRID, WINDOW = (10, 14, 14), (10, 10, 10)
SRC = [3 * 196 + 5 * 14 + 5, 3 * 196 + 5 * 14 + 6, 3 * 196 + 6 * 14 + 5]
CORNERS = [[0, 0, 0], [0, 2, 2], [0, 4, 4]]


@pytest.fixture(autouse=True)
def _fresh_registry():
    tp.set_spans(False)
    tp.spans(reset=True)
    yield
    tp.set_spans(False)
    tp.spans(reset=True)


def _problem(mode):
    F = multishot_wave_operator(GRID, SRC, nt=NT, dt=0.001, dx=10.0, space_order=4,
                                sponge_width=3, window_shape=WINDOW, window_corners=CORNERS,
                                store_adjoint="int8", shot_map=mode, device=CPU)
    c0 = torch.full(GRID, 2000.0)
    d = F(c0 * 1.03)
    return F, c0, least_squares_objective(F, d)


def _gradient(mode, on):
    """``(phi, grad, traces, spans, counters)`` of one objective-and-gradient
    evaluation with spans ``on``."""
    F, c0, fg = _problem(mode)
    before = tp.counters()
    was = tp.set_spans(on)
    try:
        phi, g = fg(c0)
    finally:
        tp.set_spans(was)
    delta = {k: v - before.get(k, 0) for k, v in tp.counters().items()
             if v != before.get(k, 0)}
    return phi, g, F(c0), tp.spans(reset=True), delta


def test_spans_off_record_nothing_and_counters_count():
    assert tp.set_spans(False) is False
    with tp.span("anything", index=1):
        pass
    *_, recorded, counted = _gradient("map", on=False)
    assert recorded == [] and tp.spans() == []
    assert counted["shots"] == 3 and counted["steps.history"] == 3 * NT
    tp.count("tests.counter", 2)
    tp.count("tests.counter")
    assert tp.counters(["tests.counter", "tests.never"]) == {"tests.counter": 3,
                                                              "tests.never": 0}
    assert tp.counters(["tests.counter"], reset=True) == {"tests.counter": 3}
    assert "tests.counter" not in tp.counters()


def test_span_records_parent_root_thread_and_attrs():
    tp.set_spans(True)
    with tp.span("outer"):
        with tp.span("inner", index=4):
            pass
        with tp.span("sibling"):
            pass
    with tp.span("next"):
        pass
    outer, inner, sibling, nxt = sorted(tp.spans(), key=lambda s: s["id"])
    assert [s["name"] for s in (outer, inner, sibling, nxt)] == ["outer", "inner", "sibling",
                                                                 "next"]
    assert outer["parent"] == 0 and outer["root"] == outer["id"]
    assert inner["parent"] == sibling["parent"] == outer["id"]
    assert inner["root"] == sibling["root"] == outer["id"]
    assert nxt["parent"] == 0 and nxt["root"] == nxt["id"]
    assert inner["attrs"] == {"index": 4} and outer["attrs"] == {}
    assert outer["start_ns"] <= inner["start_ns"] <= inner["end_ns"] <= sibling["start_ns"]
    assert sibling["end_ns"] <= outer["end_ns"] <= nxt["start_ns"]
    assert len({s["tid"] for s in (outer, inner, sibling, nxt)}) == 1


@pytest.mark.parametrize("mode", ["map", "vmap"])
def test_gradient_span_tree_and_counters(mode):
    *_, recorded, counted = _gradient(mode, on=True)
    by_id = {s["id"]: s for s in recorded}
    name = {i: s["name"] for i, s in by_id.items()}
    (root,) = [s for s in recorded if s["parent"] == 0]
    assert root["name"] == "objective"
    assert all(s["root"] == root["id"] for s in recorded)
    edges = Counter((s["name"], name.get(s["parent"])) for s in recorded)
    per = 3 if mode == "map" else 1  # a vmapped batch runs each span once
    stack = "shot" if mode == "map" else "multishot.adjoint"
    assert edges[("multishot.f", "objective")] == 1
    assert edges[("multishot.adjoint", "objective")] == 1
    assert edges[("sweep.history", stack)] == per
    assert edges[("sweep.reverse", stack)] == per
    assert edges[("window.place", stack)] == per
    assert edges[("codec.encode", "sweep.history")] == per * NT
    if mode == "map":
        assert edges[("shot", "multishot.f")] == edges[("shot", "multishot.adjoint")] == 3
        assert edges[("sweep.forward", "shot")] == 3
        shots = [s["attrs"]["index"] for s in sorted(recorded, key=lambda s: s["start_ns"])
                 if s["name"] == "shot"]
        assert shots == [0, 1, 2, 0, 1, 2]
    else:
        assert not edges[("shot", "multishot.f")]
        assert edges[("sweep.forward", "multishot.f")] == 1
    for s in recorded:  # children lie inside their parents
        if s["parent"]:
            p = by_id[s["parent"]]
            assert p["start_ns"] <= s["start_ns"] <= s["end_ns"] <= p["end_ns"]
    assert counted["shots"] == 3  # the forward's shots, in both modes
    for k in ("steps.forward", "steps.history", "steps.reverse", "snapshots.encoded"):
        assert counted[k] == per * NT, k
    assert counted["windows.take"] == 2 * per and counted["windows.place"] == per
    cells = WINDOW[0] * WINDOW[1] * WINDOW[2]
    # an int8 code and a float32 scale a snapshot; under vmap the first
    # snapshot is the shots' shared zero field, stored once
    want = 3 * NT * (cells + 4) if mode == "map" else (cells + 4) + (NT - 1) * 3 * (cells + 4)
    assert counted["history.bytes"] == want


@pytest.mark.parametrize("mode", ["map", "vmap"])
def test_spans_change_no_bit(mode):
    phi0, g0, d0, *_ = _gradient(mode, on=False)
    phi1, g1, d1, recorded, _ = _gradient(mode, on=True)
    assert recorded
    assert torch.equal(phi0, phi1) and torch.equal(g0, g1) and torch.equal(d0, d1)


def test_spans_share_the_profilers_clock():
    from torch.profiler import ProfilerActivity, profile

    x = torch.ones(128, 128)
    tp.set_spans(True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(5):
            with tp.span("region"):
                x @ x
    regions = sorted((s["start_ns"], s["end_ns"]) for s in tp.spans())
    mms = sorted((e.start_ns(), e.start_ns() + e.duration_ns())
                 for e in prof.profiler.kineto_results.events() if e.name() == "aten::mm")
    assert len(regions) == len(mms) == 5
    for (s0, s1), (a, b) in zip(regions, mms):
        assert s0 <= a <= b <= s1


def test_counter_views_return_what_they_did():
    views = {cuda_solver: ["xw_update", "lap3d_axpy_norm2", "laplacian3d", "cg_update",
                           "p_update", "lsmr_update"],
             cuda_wave: ["fused_leapfrog_step", "fused_adjoint_step", "fused_q_step"],
             cuda_vti: ["fused_vti_step", "fused_vti_hist_step", "fused_vti_adjoint_step"],
             cuda_tti: ["fused_tti_step", "fused_tti_hist_step", "fused_tti_adjoint_step"]}
    for mod, names in views.items():
        mod.reset_launch_counts()
        assert mod.launch_counts() == dict.fromkeys(names, 0)
        tp.count(f"launches.{names[0]}", 3)
        assert mod.launch_counts() == {**dict.fromkeys(names, 0), names[0]: 3}
        mod.reset_launch_counts()
        assert mod.launch_counts() == dict.fromkeys(names, 0)
    collectives.reset_halo_counts()
    assert collectives.halo_counts() == {}
    tp.count("halo_exchanges.dim0")
    tp.count("halo_exchanges.dim2", 2)
    assert collectives.halo_counts() == {0: 1, 2: 2}
    collectives.reset_halo_counts()
    assert collectives.halo_counts() == {}


def test_trace_writes_the_spans_into_its_chrome_trace(tmp_path):
    D = diagonal_operator(torch.arange(1.0, 9.0, dtype=torch.float64), device=CPU)
    with tp.trace(str(tmp_path)):
        with tp.span("apply", index=7):
            D(torch.ones(8, dtype=torch.float64))
    assert tp.spans() == [] and tp.set_spans(False) is False  # off again, nothing kept
    (name,) = os.listdir(tmp_path)
    with open(tmp_path / name) as f:
        events = json.load(f)["traceEvents"]
    (mine,) = [e for e in events if e.get("cat") == "jets_tpu_torch"]
    assert mine["name"] == "apply" and mine["args"]["index"] == 7
    (mul,) = [e for e in events if e.get("name") == "aten::mul"]
    assert mine["tid"] == mul["tid"]
    assert mine["ts"] <= mul["ts"] and mul["ts"] + mul["dur"] <= mine["ts"] + mine["dur"]
