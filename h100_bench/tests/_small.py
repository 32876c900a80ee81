"""Small sizes of the benchmark's configurations for the CPU tests."""
import json
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


def load(name):
    return json.loads((HERE / name).read_text())


# The limits at these sizes, set as the full sizes' are: above the
# program's readings on the tests' seeds (traces_rel <= 1.5e-6, phi_rel <=
# 3.1e-5, grad_rel <= 1.4e-4) and below the controls' (the bfloat16 fields'
# traces_rel >= 5e-3 and phi_rel >= 0.07, the int4 history's grad_rel >=
# 0.038). A small window's residual is a larger share of its traces' rounding
# than a full window's, so phi_rel reads higher here.
SMALL_LIMITS = {"traces_rel": 1e-4, "phi_rel": 1e-3, "grad_rel": 1e-2}


def overthrust():
    cfg = load("configs/overthrust3d-iso.json")
    return dict(cfg, grid_shape=[16, 41, 41], window_shape=[16, 21, 21], nt=60,
                source_grid={"start": 6, "step": 4, "count": 8}, sponge_width=4,
                starting_model_smoothing={"box_cells": 3, "passes": 2}, limits=SMALL_LIMITS)


def marmousi():
    cfg = load("configs/marmousi2d-iso.json")
    return dict(cfg, grid_shape=[30, 120], spacing_m=20.0, water_depth_m=40.0,
                survey=dict(cfg["survey"], nshots=30, first_shot_m=300.0, shot_spacing_m=20.0,
                            nreceivers=12, receiver_spacing_m=20.0, near_offset_m=40.0),
                window_margin_m=100.0, window_shape=[30, 24], source_depth_m=20.0,
                receiver_depth_m=40.0, dt_s=0.0013, nt=60, sponge_width=4,
                starting_model_smoothing={"box_cells": 3, "passes": 2}, limits=SMALL_LIMITS)


def flagship():
    cfg = load("configs/flagship3d-lsqr.json")
    # more receivers than 4x the iterations: 50 iterations stay far from
    # convergence, as at the full size
    return dict(cfg, grid_shape=[32, 32, 32], nshots=8, nreceivers=512,
                receiver_subgrid={"start": [5, 5, 5], "stride": [3, 3, 3],
                                  "count": [8, 8, 8]},
                illumination_sigma_cells=8.0)


SMALL = {"overthrust-iso-grad": overthrust, "overthrust-iso-model": overthrust,
         "marmousi-iso-grad": marmousi, "flagship-lsqr": flagship}


def manifest():
    """``BENCHMARK.json`` with the flagship's candidate cell, which is not in
    it (its float32 LSQR drifts once it has converged: ``PERF.md``, Open
    questions), so that the tests reach its driver."""
    import sys
    sys.path.insert(0, str(HERE.parent))
    from h100_bench import harness

    m = harness.load_manifest()
    m["configs"].append({"name": "flagship3d-lsqr",
                         "file": "h100_bench/configs/flagship3d-lsqr.json"})
    m["workloads"].append({"name": "flagship-lsqr", "config": "flagship3d-lsqr",
                           "traffic": "lsqr-50", "chips": 1})
    on = {"workloads": ["flagship-lsqr"]}
    m["end_to_end"] += [dict(on, name="lsqr_iter_ms", unit="ms/iter"),
                        dict(on, name="lsqr_solve_p95_ms", unit="ms")]
    m["per_layer"] += [dict(on, name=n, unit=u) for n, u in (
        ("launches_per_iter.lsqr", "launches/iter"), ("lsqr_iter_roofline", "%"),
        ("idle_pct.lsqr", "%"))]
    return m
