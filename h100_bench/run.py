#!/usr/bin/env python3
"""The benchmark of ``jets_tpu_torch`` on NVIDIA H100 cards.

    python3 h100_bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

run from the root of a checkout. Runs the cell ``<name>`` of
``BENCHMARK.json`` on the card it finds: set-up from the seed, a closed
loop of units for ``--seconds`` (end-to-end metrics), or with
``--trace 1`` a profiled run of whole units (per-layer metrics), then the
comparison of the last outputs with the plain reference. Prints the
card's clocks, power, temperature and throttle reasons through the window
(``clocks.py``) on the line before the last of standard output, each
number compared beside its limit as the last lines of standard error,
and one JSON line last on standard output. Exits non-zero, printing no
result, without enough CUDA cards, or if JAX or the JAX package is
loaded once the window has closed.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _caches():
    """Every build and kernel cache inside the checkout, at fixed paths."""
    cache = ROOT / "h100_bench" / "out" / "cache"
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_ext"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(cache / sub)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    _caches()
    sys.path.insert(0, str(ROOT))
    import torch

    from h100_bench import clocks, harness

    manifest = harness.load_manifest()
    cell, _ = harness.find_cell(manifest, a.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        print(f"{a.workload} needs {cell['chips']} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    out = Path(ROOT / "h100_bench" / "out")
    sampler = clocks.Sampler(out / "clocks" / f"{a.workload}_{a.seed}_trace{a.trace}.csv")
    try:
        res = harness.run_cell(manifest, a.workload, a.seed, a.seconds, bool(a.trace),
                               device="cuda", t_start=T_START, sampler=sampler)
    finally:
        sampler.stop()
    found = harness.forbidden_modules()
    if found:
        print(f"refused: the process has loaded {', '.join(found)}", file=sys.stderr)
        return 3
    out.mkdir(parents=True, exist_ok=True)
    if a.trace:
        (out / f"trace_{a.workload}_{a.seed}.json").write_text(json.dumps(
            {"device": res["device"], "breakdown": res.get("breakdown"),
             "metrics": res["metrics"]}, indent=1))
    for k, c in res["checks"].items():
        print(f"check {k}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(sampler.summary())
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
