"""The code of the port's user guide runs: every ```python block of
``docs_torch/index.md``, in order, in one namespace, on the CPU (its one
``device = "cuda"`` line set to ``"cpu"``), in a process with ``jax``,
``jaxlib`` and ``jets_tpu`` blocked from import. ``docs_torch/reference.md``
names only what the port exports."""
import importlib
import os
import re
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GUIDE = os.path.join(REPO, "docs_torch", "index.md")


def _blocks():
    with open(GUIDE) as f:
        return re.findall(r"```python\n(.*?)```", f.read(), re.S)


def test_guide_names_its_device_once():
    lines = [ln for b in _blocks() for ln in b.splitlines() if ln.startswith("device =")]
    assert lines == ['device = "cuda"']


def test_guide_code_runs_on_the_cpu():
    code = "\n".join(b.replace('device = "cuda"', 'device = "cpu"') for b in _blocks())
    script = ("import sys\n"
              "for name in ('jax', 'jaxlib', 'jets_tpu'):\n"
              "    sys.modules[name] = None\n"
              + code + "\nprint('GUIDE OK')\n")
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    p = subprocess.run([sys.executable, "-c", script], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0 and p.stdout.strip().endswith("GUIDE OK"), p.stdout + p.stderr


def test_reference_names_exist():
    """Each ``module.name`` pair the reference tables list is importable."""
    with open(os.path.join(REPO, "docs_torch", "reference.md")) as f:
        text = f.read()
    pairs = re.findall(r"<!-- (jets_tpu_torch[\w.]*): ([\w, ]+) -->", text)
    assert pairs, "the reference lists no names"
    for mod, names in pairs:
        m = importlib.import_module(mod)
        for name in (n.strip() for n in names.split(",")):
            assert hasattr(m, name), f"{mod}.{name}"
