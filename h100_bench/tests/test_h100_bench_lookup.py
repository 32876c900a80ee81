"""A configuration, a traffic mix and metrics added as new files alone are
found by their names: nothing of the harness is edited."""
import json
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
sys.path.insert(0, str(Path(__file__).resolve().parent))

from _small import overthrust  # noqa: E402
from h100_bench import harness  # noqa: E402


def test_new_files_alone(tmp_path):
    cfg = dict(overthrust(), name="tiny-iso", space_order=4, nt=40)
    (tmp_path / "configs").mkdir()
    (tmp_path / "configs" / "tiny-iso.json").write_text(json.dumps(cfg))
    (tmp_path / "traffic").mkdir()
    (tmp_path / "traffic" / "one-shot-forward.json").write_text(json.dumps(
        {"loop": "closed", "unit": "forward", "shots_per_unit": 1, "pool": 3,
         "trace_units": 1}))
    for kind, name, body in (
            ("end_to_end", "shots_per_s", "return sum(u['shots'] for u in ctx['units'])"
                                          " / ctx['window_s']"),
            ("layer_metrics", "traced_steps", "return ctx['counts'].get('steps')")):
        (tmp_path / kind).mkdir()
        (tmp_path / kind / f"{name}.py").write_text(f"def read(ctx):\n    {body}\n")
    manifest = {
        "configs": [{"name": "tiny-iso", "file": str(tmp_path / "configs" / "tiny-iso.json")}],
        "workloads": [{"name": "tiny-iso.one", "config": "tiny-iso",
                       "traffic": "one-shot-forward", "chips": 1}],
        "end_to_end": [{"name": "shots_per_s", "unit": "shots/s"},
                       {"name": "setup_s", "unit": "s"}],
        "per_layer": [{"name": "traced_steps", "unit": "steps"}],
    }
    bases = (tmp_path, harness.HERE)
    res = harness.run_cell(manifest, "tiny-iso.one", 7, 0.1, False, device="cpu",
                           t_start=time.perf_counter(), bases=bases)
    assert set(res["metrics"]) == {"shots_per_s", "setup_s"}
    assert res["correct"], res["checks"]
    res = harness.run_cell(manifest, "tiny-iso.one", 7, 0.1, True, device="cpu",
                           t_start=time.perf_counter(), bases=bases)
    if torch.cuda.is_available():  # a CPU trace has no device time to read
        assert res["metrics"]["traced_steps"]["value"] == 40
    assert res["correct"], res["checks"]
