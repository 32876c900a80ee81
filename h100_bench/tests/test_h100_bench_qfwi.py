"""The visco-acoustic cell ``overthrust-visco-grad`` on the CPU at a small
size: the program against the plain reference ``reference/wave_qfwi.py``,
that reference against ``reference/wave_fwi.py`` at Q = infinity, the
cell's files found by name, a run of the cell through the harness, a fault
planted under the timed path, and the new readers on synthetic traces."""
import json
import sys
import time
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
sys.path.insert(0, str(Path(__file__).resolve().parent))

from _small import load  # noqa: E402
from h100_bench import generator, harness, peaks  # noqa: E402
from h100_bench.reference import wave_fwi, wave_qfwi  # noqa: E402
from h100_bench.work import wave_q  # noqa: E402

CELL = "overthrust-visco-grad"
SEEDS = [2**31 + 977, 5, 123456789012]
# the accepted gradient cell's readers, which read this cell as they read
# that one, and the one metric new with it
PER_LAYER = ["launches_per_step.grad", "wave_step_roofline.grad", "idle_pct.grad",
             "q_step_roofline.gradq"]

# Set as the full size's are: above the program's readings on the seeds
# here (traces_rel <= 3.4e-7, phi_rel <= 9.8e-6, grad_rel <= 6.3e-4,
# gradq_rel <= 2.4e-4) and below the controls' (the bfloat16 fields'
# traces_rel >= 5.4e-3 and phi_rel >= 0.012, the int4 history's grad_rel
# >= 0.047 and gradq_rel >= 0.042). The bfloat16 friction moves nothing
# past the program's own rounding in 60 steps (g nt <= 0.03 here), so it
# is not a control at this size.
SMALL_LIMITS = {"traces_rel": 1e-4, "phi_rel": 1e-3, "grad_rel": 1e-2, "gradq_rel": 1e-2}


def small():
    cfg = load("configs/overthrust3d-visco.json")
    return dict(cfg, grid_shape=[16, 41, 41], window_shape=[16, 21, 21], nt=60,
                source_grid={"start": 6, "step": 4, "count": 8}, sponge_width=4,
                starting_model_smoothing={"box_cells": 3, "passes": 2}, limits=SMALL_LIMITS)


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)


def _system(seed, cfg=None):
    cfg = small() if cfg is None else cfg
    trf = load("traffic/fwi-gradient-2.json")
    drv = harness.driver("wave_qfwi")
    return drv.System(cfg, trf, generator.schedule(trf, seed, drv.positions(cfg)), "cpu")


@pytest.mark.parametrize("seed", SEEDS)
def test_program_agrees_with_the_reference(seed):
    """The traces to float32 rounding over 60 steps (the reference's
    Laplacian is a matrix product, the program's a stencil: 1e-5); phi,
    a small residual's square, to 1e-4; the gradient's blocks to 5e-3, as
    the two int8 histories differ by one level wherever the two fields
    straddle a rounding boundary."""
    system = _system(seed)
    counts = system.run_unit(0)
    assert counts["steps.reverse"] == counts["steps"] == 2 * 60
    system.release()
    got = system.check()
    tol = {"traces_rel": 1e-5, "phi_rel": 1e-4, "grad_rel": 5e-3, "gradq_rel": 5e-3}
    assert all(got[k] <= tol[k] for k in tol), got
    for k in ("grad", "gradq", "traces"):
        assert float(torch.max(torch.abs(system.last[k]))) > 0.0, k


def test_reference_at_q_infinite_is_the_isotropic_one():
    cfg = small()
    system = _system(SEEDS[0], cfg)
    shots, rcv = system.batches[0], system.rcv
    inf = torch.full_like(system.c0, float("inf"))
    q = wave_qfwi.batch(cfg, shots, rcv, system.c0, inf, c_true=system.c_true, q_true=inf,
                        device="cpu")
    iso = wave_fwi.batch(cfg, shots, rcv, system.c0, c_true=system.c_true, device="cpu")
    assert float(torch.max(torch.abs(iso["grad"]))) > 0.0
    assert torch.equal(q["traces"], iso["traces"]) and q["phi"] == iso["phi"]
    assert torch.equal(q["grad"], iso["grad"])
    assert float(torch.max(torch.abs(q["gradq"]))) == 0.0


def test_cell_and_readers_resolve_by_name():
    m = harness.load_manifest()
    cell, centry = harness.find_cell(m, CELL)
    assert (cell["config"], cell["traffic"], cell["chips"]) == (
        "overthrust3d-visco", "fwi-gradient-2", 1)
    cfg = harness.load_json(harness.ROOT / centry["file"])
    assert cfg["driver"] == "wave_qfwi" and centry["reduced"] == []
    assert [e["name"] for e in harness.metrics_of(m, "end_to_end", CELL)] == [
        "grad_shot_s", "setup_s"]
    assert [e["name"] for e in harness.metrics_of(m, "per_layer", CELL)] == PER_LAYER
    for name in PER_LAYER:
        assert callable(harness.reader("layer_metrics", name))
    iso = load("configs/overthrust3d-iso.json")
    for k, v in iso.items():  # the iso deployment, key for key, but its own
        if k not in ("name", "driver", "source", "deployment", "control", "limits",
                     "assumed"):
            assert cfg[k] == v, k


@pytest.mark.parametrize("trace", [False, True])
def test_a_run_of_the_cell_is_correct(trace):
    res = harness.run_cell(harness.load_manifest(), CELL, SEEDS[0], 0.2, trace,
                           device="cpu", t_start=time.perf_counter(), config=small())
    assert res["correct"], res["checks"]
    assert set(res["checks"]) == set(SMALL_LIMITS)
    if trace:  # a CPU trace has no device time: the readers read nothing, and raise not
        assert res["metrics"] == {} and res["device"]["busy_s"] == 0
    else:
        assert set(res["metrics"]) == {"grad_shot_s", "setup_s"}


def test_q_off_by_a_tenth_is_not_correct(monkeypatch):
    from jets_tpu_torch.ops import wave

    q0 = wave._q_friction
    monkeypatch.setattr(wave, "_q_friction", lambda q, dt, f0: q0(q * 1.1, dt, f0))
    res = harness.run_cell(harness.load_manifest(), CELL, SEEDS[0], 0.2, False,
                           device="cpu", t_start=time.perf_counter(), config=small())
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("control", ["int4", "bfloat16"])
def test_control_is_not_correct(control):
    system = _system(SEEDS[0])
    system.run_unit(0)
    system.release()
    vals = system.check(system.control(control))
    assert any(v > SMALL_LIMITS[k] for k, v in vals.items()), vals


def _ctx(counts, kernels):
    return {"trace": {"busy_s": 2.0, "window_s": 2.5, "device_ops": 1200,
                      "top_device_ops": kernels, "idle_gaps": []},
            "counts": counts, "work": {}, "least_s": 0.5}


def test_readers_on_synthetic_traces():
    k14 = wave_q.q_step_work((187, 401, 401), 8)
    counts = {"shots": 2, "steps": 400, "steps.reverse": 400, "launches.fused_q_step": 800,
              "q_step_bytes": 800 * k14["bytes"], "q_step_flops": 800 * k14["flops"]}
    kernels = [["void (anonymous namespace)::q_step_kernel<8, float>(float const*, ...)", 0.4],
               ["void at::native::vectorized_elementwise_kernel<4, ...>", 1.0]]

    def read(name, ctx):
        return harness.reader("layer_metrics", name)(ctx)

    ctx = _ctx(counts, kernels)
    assert read("launches_per_step.grad", ctx) == 1200 / 400  # per shots x nt
    assert read("wave_step_roofline.grad", ctx) == 100.0 * 0.5 / 2.0
    assert read("idle_pct.grad", ctx) == pytest.approx(20.0)
    least = 800 * 20 * 187 * 401 * 401 / peaks.HBM_BYTES_PER_S  # 179.5 us a launch
    assert read("q_step_roofline.gradq", ctx) == pytest.approx(100.0 * least / 0.4)
    assert abs(least / 800 - 179.5e-6) < 0.1e-6
    # a program with neither the counters nor the kernel: no K14 share
    bare = _ctx({"shots": 2, "steps": 400}, kernels[1:])
    assert read("q_step_roofline.gradq", bare) is None
    assert read("q_step_roofline.gradq", _ctx(counts, kernels[1:])) is None
    empty = _ctx({}, [])
    assert all(read(n, empty) is None for n in PER_LAYER)


def test_work_counts():
    assert wave_q.step_bytes("forward") == 20  # u_prev, u, C, g read; u' written
    assert wave_q.step_bytes("forward_hist") == 21
    assert wave_q.step_bytes("reverse") == 45  # a1, a2, C, g, q, gC, gig, gog; 4 written
    cells = 187 * 401 * 401
    g = wave_q.unit_work("gradient", shots=2, nt=2000, window_shape=(187, 401, 401),
                         nreceivers=201 * 201, order=8)
    assert g["bytes"] == 2 * 2000 * (66 * cells + 12 * 201 * 201)
    assert peaks.least_seconds(g) == g["bytes"] / peaks.HBM_BYTES_PER_S
    # 592 us a shot-step at 3.35 TB/s
    assert abs(peaks.least_seconds(g) / 4000 - 592.5e-6) < 1e-6
    assert wave_q.step_flops("reverse", 8) == 2 * 37 + 3 + 22
    json.dumps(g)
