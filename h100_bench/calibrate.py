#!/usr/bin/env python3
"""Readings that the limits of ``correct`` are set from, many seeds in one
process (the benchmark's own runs do not run this).

    python3 h100_bench/calibrate.py --workload <name> --seeds 1,2,3 \
        [--control-seeds 4,5,6] [--units 1]

For each seed: the cell's set-up, ``--units`` units of the program, and
its numbers against the reference (the lower readings; none with
``--units 0``). For each control seed besides: each control of the
configuration's ``control`` list for the unit's kind (the reference in
the precision below the configuration's, in the program's place) and its
numbers against the reference (the upper readings). One JSON line per
reading on standard output.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _seeds(s):
    return [int(v) for v in s.split(",") if v]


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=_seeds, default=[])
    p.add_argument("--control-seeds", type=_seeds, default=[])
    p.add_argument("--units", type=int, default=1)
    a = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    # several references in one process: a 3-D shot's history takes most of
    # the card, and the fixed segments an earlier one left split cannot hold
    # the next (the benchmark's runs check once and keep the default)
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    import torch

    from h100_bench import generator, harness

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    manifest = harness.load_manifest()
    cell, centry = harness.find_cell(manifest, a.workload)
    cfg = harness.load_json(ROOT / centry["file"])
    trf = harness.load_json(harness.HERE / "traffic" / f"{cell['traffic']}.json")
    drv = harness.driver(cfg["driver"])
    controls = cfg["control"][trf["unit"]]
    for seed in dict.fromkeys(a.seeds + a.control_seeds):
        t0 = time.perf_counter()
        system = drv.System(cfg, trf, generator.schedule(trf, seed, drv.positions(cfg)),
                            "cuda", warm=False)
        for i in range(a.units):
            system.run_unit(i)
        system.release()
        if a.units:
            row = {"workload": a.workload, "seed": seed, "kind": "program",
                   "values": system.check()}
            print(json.dumps(row), flush=True)
        for control in controls if seed in a.control_seeds else ():
            t1 = time.perf_counter()
            row = {"workload": a.workload, "seed": seed, "kind": f"control:{control}",
                   "values": system.check(system.control(control)),
                   "control_s": time.perf_counter() - t1}
            print(json.dumps(row), flush=True)
        del system
        gc.collect()
        torch.cuda.empty_cache()
        print(f"seed {seed}: {time.perf_counter() - t0:.1f} s", file=sys.stderr, flush=True)
    print(f"total {time.perf_counter() - T_START:.1f} s", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
