"""Everything a run does between the command line and its last line: find
the cell, its configuration, traffic, driver and metric readers by name,
set the system up, run the window, read the metrics, check the outputs
against the plain reference, and build the result.

What belongs to one configuration, traffic mix or metric sits in files of
its own under this folder, found by the names in ``BENCHMARK.json``:

* ``configs/<file>`` (the manifest's ``file``) names its ``driver``:
  ``drivers/<driver>.py`` builds the program's objects and runs a unit;
  ``reference/<driver>.py`` is its plain reference;
* ``traffic/<traffic>.json``: the parameters ``generator.py`` reads;
* ``end_to_end/<metric>.py`` and ``layer_metrics/<metric>.py``: one
  ``read(ctx) -> float | None`` each; ``None`` leaves the metric out.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import sys
import time
from pathlib import Path

from . import generator, peaks, tracing

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "jets_tpu")

__all__ = ["load_manifest", "find_cell", "load_json", "reader", "driver", "run_cell",
           "forbidden_modules", "HERE", "ROOT"]


def load_json(path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_manifest(path=None) -> dict:
    return load_json(ROOT / "BENCHMARK.json" if path is None else path)


def find_cell(manifest: dict, workload: str):
    """``(cell, config entry)`` of the workload named ``workload``."""
    for cell in manifest["workloads"]:
        if cell["name"] == workload:
            for c in manifest["configs"]:
                if c["name"] == cell["config"]:
                    return cell, c
            raise KeyError(f"workload {workload!r} names no configuration {cell['config']!r}")
    raise KeyError(f"no workload named {workload!r} in BENCHMARK.json")


def _load_file(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _find(bases, rel: str) -> Path:
    for b in bases:
        if (Path(b) / rel).is_file():
            return Path(b) / rel
    raise FileNotFoundError(f"no {rel} under {', '.join(str(b) for b in bases)}")


def reader(kind: str, name: str, bases=(HERE,)):
    """The ``read`` function of ``<base>/<kind>/<name>.py``, the first base
    that has it."""
    path = _find(bases, f"{kind}/{name}.py")
    return _load_file(path, f"h100_bench_{kind}_{name.replace('.', '_')}").read


def driver(name: str):
    """The module ``drivers/<name>.py`` of this package."""
    return importlib.import_module(f"{__package__}.drivers.{name}")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one of ``FORBIDDEN``."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


def metrics_of(manifest: dict, kind: str, workload: str) -> list:
    """The ``kind`` (``end_to_end`` or ``per_layer``) metrics the cell
    reports: those without ``workloads`` and those that list it."""
    return [m for m in manifest[kind] if workload in m.get("workloads", [workload])]


def _sync(device):
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def run_cell(manifest: dict, workload: str, seed: int, seconds: float, trace: bool, *,
             device, t_start: float, config: dict = None, traffic: dict = None,
             bases=(HERE,), sampler=None, log=sys.stderr) -> dict:
    """One run of the cell ``workload``; returns the result's dict, its
    ``checks`` last. ``config``/``traffic`` replace the files' dicts (the
    CPU tests' small sizes); ``bases`` are the folders searched for the
    traffic and the metric readers; ``sampler`` (``clocks.Sampler``)
    samples the card through the window."""
    import torch

    cell, centry = find_cell(manifest, workload)
    cfg = config if config is not None else load_json(ROOT / centry["file"])
    trf = traffic if traffic is not None else load_json(
        _find(bases, f"traffic/{cell['traffic']}.json"))
    drv = driver(cfg["driver"])
    sched = generator.schedule(trf, seed, drv.positions(cfg))
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    t_sys = time.perf_counter()
    system = drv.System(cfg, trf, sched, device)

    units, i = [], 0
    if sampler is not None:
        sampler.start(getattr(torch.cuda.get_device_properties(0), "uuid", None)
                      if on_card else None)
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    stages = {"start": t_sys - t_start, **system.stages}
    print(f"{workload}: set-up " + ", ".join(f"{k} {v:.3f}" for k, v in stages.items())
          + " s", file=log)
    if trace:
        n = int(trf["trace_units"])
        summary, counts = tracing.profile_units(system.run_unit, 0, n, lambda: _sync(device),
                                                on_card, log)
        i = n
        window_s = summary["window_s"]
        work = {k: v * n for k, v in system.work().items()}
    else:
        while time.perf_counter() - t0 < seconds:
            u0 = time.perf_counter()
            rec = dict(system.run_unit(i))
            rec["wall_s"] = time.perf_counter() - u0
            units.append(rec)
            i += 1
        window_s = time.perf_counter() - t0
    if sampler is not None:
        sampler.stop()
    peak = torch.cuda.max_memory_allocated() if on_card else 0

    metrics = {}
    if trace:
        ctx = {"trace": summary, "counts": counts, "work": work,
               "least_s": peaks.least_seconds(work)}
        for m in metrics_of(manifest, "per_layer", workload):
            v = reader("layer_metrics", m["name"], bases)(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        ctx = {"units": units, "window_s": window_s, "setup_s": setup_s}
        for m in metrics_of(manifest, "end_to_end", workload):
            v = reader("end_to_end", m["name"], bases)(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        solves = sum(u.get("solves", 0) for u in units)
        if solves:
            print(f"solves in the window: {solves}", file=log)
    system.release()
    tc = time.perf_counter()
    values = system.check()
    print(f"{workload}: set-up {setup_s:.3f} s, window {window_s:.3f} s, {i} units, "
          f"check {time.perf_counter() - tc:.1f} s", file=log)
    limits = cfg["limits"]
    checks = {k: {"value": v, "limit": limits[k]} for k, v in values.items()}
    failed = sum(1 for c in checks.values() if not c["value"] <= c["limit"])
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name() if on_card else "cpu",
           "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": failed == 0, "attempted": i, "failed": failed,
              "metrics": metrics, "device": dev}
    if trace:
        dev["busy_s"] = summary["busy_s"]
        dev["window_s"] = summary["window_s"]
        result["breakdown"] = {"device_ops": summary["top_device_ops"],
                               "idle_gaps": summary["idle_gaps"]}
    result["checks"] = checks
    return result
