"""A run of each cell on the CPU at a small size, past the harness's look
for a card: sound, it comes out correct; with the timed path broken
underneath, or with the control (the reference at the precision below
the configuration's) in the program's place, it does not."""
import sys
import time
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
sys.path.insert(0, str(Path(__file__).resolve().parent))

from _small import SMALL, manifest  # noqa: E402
from h100_bench import generator, harness  # noqa: E402

SEED = 2**31 + 977


def _run(workload, seed=SEED):
    return harness.run_cell(manifest(), workload, seed, 0.2, False,
                            device="cpu", t_start=time.perf_counter(),
                            config=SMALL[workload]())


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)


WAVE = ["overthrust-iso-grad", "marmousi-iso-grad", "overthrust-iso-model"]


# not the flagship: its float32 LSQR drifts from the float64 reference once
# it has converged, at this size too on some seeds (PERF.md, Open questions)
@pytest.mark.parametrize("workload", WAVE)
def test_sound_run_is_correct(workload):
    res = _run(workload)
    assert res["correct"], res["checks"]
    assert list(res)[-1] == "checks"


@pytest.mark.parametrize("workload,control", [
    (w, c) for w in sorted(SMALL) for c in SMALL[w]()["control"][
        "solve" if w == "flagship-lsqr" else "gradient" if w.endswith("grad") else "forward"]])
def test_control_is_not_correct(workload, control):
    cfg = SMALL[workload]()
    cell, _ = harness.find_cell(manifest(), workload)
    trf = harness.load_json(harness.HERE / "traffic" / f"{cell['traffic']}.json")
    drv = harness.driver(cfg["driver"])
    system = drv.System(cfg, trf, generator.schedule(trf, SEED, drv.positions(cfg)), "cpu")
    system.run_unit(0)
    system.release()
    vals = system.check(system.control(control))
    assert any(v > cfg["limits"][k] for k, v in vals.items()), vals


# -- faults planted under the timed path -------------------------------------


def _wave_unchanged(mp):
    from jets_tpu_torch.ops import cuda_wave

    mp.setattr(cuda_wave, "leapfrog_plain", lambda u_prev, u, *a: u)


def _wave_half_batch(mp):
    """Half of the shots left out, the mean of the rest in their place."""
    from jets_tpu_torch.parallel import sharded

    def half(state):
        k = max(1, state["nblocks"] // 2)  # the one-shot warm-up stays whole
        return k, dict(state, nblocks=k, bstate={n: v[:k] for n, v in state["bstate"].items()})

    f0, a0 = sharded._stacked_f, sharded._local_adjoint

    def f(m, state):
        k, st = half(state)
        out = f0(m, st)
        if k == state["nblocks"]:
            return out
        rest = out.mean(0, keepdim=True).expand(state["nblocks"] - k, *out.shape[1:])
        return torch.cat([out, rest])

    def adj(dd, m0, state):
        k, st = half(state)
        return a0(dd[:k], m0, st) * (state["nblocks"] / k)

    mp.setattr(sharded, "_stacked_f", f)
    mp.setattr(sharded, "_local_adjoint", adj)


def _wave_altered(mp):
    """Each shot's traces and gradient 1% off where they are made."""
    from jets_tpu_torch.ops import wave

    p0, a0 = wave._propagate, wave._adjoint_stored
    mp.setattr(wave, "_propagate", lambda *a, **k: p0(*a, **k) * 1.01)
    mp.setattr(wave, "_adjoint_stored", lambda *a, **k: a0(*a, **k) * 1.01)


def _lsqr_unchanged(mp):
    from jets_tpu_torch.solvers import krylov

    mp.setattr(krylov, "_xw_update", lambda x, w, *a: (x, w))


def _lsqr_half_batch(mp):
    """The operator of half of the shots, their weights doubled."""
    from jets_tpu_torch.models import seismic

    s0 = seismic.seismic_operator_from_arrays

    def half(*a, wr, **k):
        wr = wr.clone()
        n = wr.shape[0] // 2
        wr[:n] *= 2.0
        wr[n:] = 0.0
        return s0(*a, wr=wr, **k)

    mp.setattr(seismic, "seismic_operator_from_arrays", half)


def _lsqr_altered(mp):
    import jets_tpu_torch.solvers as solvers

    l0 = solvers.lsqr

    def lsqr(*a, **k):
        res = l0(*a, **k)
        return res._replace(x=res.x * 1.01)

    mp.setattr(solvers, "lsqr", lsqr)


FAULTS = {**{w: [_wave_unchanged, _wave_half_batch, _wave_altered] for w in WAVE},
          "flagship-lsqr": [_lsqr_unchanged, _lsqr_half_batch, _lsqr_altered]}


@pytest.mark.parametrize("workload,fault", [(w, f) for w, fs in sorted(FAULTS.items())
                                            for f in fs],
                         ids=lambda v: v if isinstance(v, str) else v.__name__)
def test_fault_is_not_correct(workload, fault, monkeypatch):
    fault(monkeypatch)
    res = _run(workload)
    assert not res["correct"], res["checks"]
    assert res["failed"] >= 1


@pytest.mark.parametrize("trace", [False, True])
def test_on_the_card(trace):
    """The forward cell as the driver runs it, at its full size, untraced
    and traced; needs a CUDA card."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: run.py refuses to run without one")
    res = harness.run_cell(harness.load_manifest(), "overthrust-iso-model", SEED, 1.0,
                           trace, device="cuda", t_start=time.perf_counter())
    assert res["correct"], res["checks"]
    if trace:
        assert 0 < res["device"]["busy_s"] <= res["device"]["window_s"]
        assert res["metrics"]["idle_pct.model"]["value"] >= 0
