"""The traced run's reading of the profiler's events, on the CPU: spans are
told from device work by what every PyTorch the benchmark meets offers,
and a traced run of each cell goes through to its result."""
import sys
import time
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
sys.path.insert(0, str(Path(__file__).resolve().parent))

from _small import SMALL, manifest  # noqa: E402
from h100_bench import harness, tracing  # noqa: E402


def test_spans_are_not_device_work():
    from torch.profiler import ProfilerActivity, profile, record_function, schedule

    x = torch.ones(64, 64)
    with profile(activities=[ProfilerActivity.CPU],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        x @ x
        prof.step()
        with record_function("bench_span"):
            x @ x
        prof.step()
    kinds = {e.name(): tracing.is_span(e) for e in prof.profiler.kineto_results.events()}
    assert kinds["bench_span"] and kinds["ProfilerStep#1"]
    assert not kinds["aten::mm"]


@pytest.mark.parametrize("workload", ["overthrust-iso-grad", "marmousi-iso-grad",
                                      "overthrust-iso-model"])
def test_traced_run_on_the_cpu(workload):
    res = harness.run_cell(manifest(), workload, 2**31 + 5, 0.2, True, device="cpu",
                           t_start=time.perf_counter(), config=SMALL[workload]())
    assert res["correct"], res["checks"]
    assert {"busy_s", "window_s"} <= set(res["device"]) and res["device"]["window_s"] > 0
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    assert list(res)[-1] == "checks"
