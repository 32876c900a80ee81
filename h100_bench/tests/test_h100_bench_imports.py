"""Nothing of the benchmark loads JAX or the JAX package, and the plain
reference loads nothing of the program."""
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "h100_bench"

# blocks jax, jaxlib and jets_tpu (an import of them raises), imports run.py,
# every module and reader of the benchmark and what its drivers load of the
# program, loads every data file, and prints the top-level names of the loaded modules
_ALL = r"""
import importlib, json, runpy, sys
from pathlib import Path
for name in ("jax", "jaxlib", "jets_tpu"):
    sys.modules[name] = None
root = Path(sys.argv[1]); bench = root / "h100_bench"
sys.path.insert(0, str(root))
runpy.run_path(str(bench / "run.py"), run_name="bench_run")
from h100_bench import harness
for p in sorted(bench.rglob("*.py")):
    rel = p.relative_to(bench)
    if rel.parts[0] in ("tests", "out") or p.name == "run.py":
        continue
    if rel.parts[0] in ("layer_metrics", "end_to_end"):
        harness.reader(rel.parts[0], p.stem)
    else:
        importlib.import_module("h100_bench." + ".".join(rel.with_suffix("").parts))
for p in sorted(bench.rglob("*.json")):
    if "out" not in p.relative_to(bench).parts:
        json.loads(p.read_text())
harness.load_manifest()
harness.driver("wave_fwi")._program()  # what the drivers load of the program
import jets_tpu_torch.models.seismic, jets_tpu_torch.solvers
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules if sys.modules[m] is not None})))
"""

_REFERENCE = r"""
import importlib, json, sys
from pathlib import Path
root = Path(sys.argv[1]); sys.path.insert(0, str(root))
for p in sorted((root / "h100_bench" / "reference").glob("*.py")):
    importlib.import_module("h100_bench.reference." + p.stem)
from h100_bench import compare, inputs
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def _loaded(code):
    out = subprocess.run([sys.executable, "-c", code, str(ROOT)], capture_output=True,
                         text=True, timeout=300, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_no_jax_anywhere():
    names = _loaded(_ALL)
    assert not names & {"jax", "jaxlib", "flax", "jets_tpu"}, names


def test_reference_loads_nothing_of_the_program():
    names = _loaded(_REFERENCE)
    assert "jets_tpu_torch" not in names and "jets_tpu" not in names, names


def test_forbidden_compares_whole_top_level_names(monkeypatch):
    sys.path.insert(0, str(ROOT))
    from h100_bench import harness

    monkeypatch.setitem(sys.modules, "jets_tpu_torch_probe.x", object())
    monkeypatch.setitem(sys.modules, "jets_tpu_torch.probe", object())
    assert not any(m.startswith("jets_tpu_torch") for m in harness.forbidden_modules())
    monkeypatch.setitem(sys.modules, "jets_tpu.probe", object())
    assert "jets_tpu.probe" in harness.forbidden_modules()
