"""Every example of ``examples_torch/`` runs end to end, as a user runs it:
its own process, ``--device cpu``, with ``jax``, ``jaxlib`` and
``jets_tpu`` blocked from import (the counterpart of
tests/test_examples.py). Example 02 also runs on 2 gloo ranks through the
port's runner (``RANK``/``WORLD_SIZE`` and a ``file://`` rendezvous under
pytest's ``tmp_path``), and without ``--device`` on a machine with no card
an example fails instead of running on the CPU.
"""
import importlib.util
import os
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = sorted(f for f in os.listdir(os.path.join(REPO, "examples_torch"))
                  if f.endswith(".py"))
_BLOCKED = ("import runpy, sys\n"
            "for name in ('jax', 'jaxlib', 'jets_tpu'):\n"
            "    sys.modules[name] = None\n"
            "sys.argv = sys.argv[1:]\n"
            "runpy.run_path(sys.argv[0], run_name='__main__')\n")


def _run(name, *args, env=None, timeout=600):
    env = dict(os.environ if env is None else env)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = env.get("OMP_NUM_THREADS", "1")
    return subprocess.Popen([sys.executable, "-c", _BLOCKED,
                             os.path.join(REPO, "examples_torch", name), *args],
                            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def _done(p, name, timeout=600):
    try:
        out, err = p.communicate(timeout=timeout)
    finally:
        if p.poll() is None:
            p.kill()
            p.wait()
    assert p.returncode == 0, (f"{name} exited {p.returncode}\n--- stdout ---\n"
                               f"{out[-2000:]}\n--- stderr ---\n{err[-2000:]}")
    return out


def test_thirteen_examples():
    assert EXAMPLES == sorted(f for f in os.listdir(os.path.join(REPO, "examples"))
                              if f.endswith(".py"))


def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_runs(name):
    """The example runs and prints as many numbers as ``chip_smoke.py``'s
    example phase holds the card's run to the CPU's."""
    out = _done(_run(name, "--device", "cpu"), name)
    assert out.strip(), f"{name} printed nothing"
    smoke = _smoke()
    assert len(smoke.EXAMPLE_NUM.findall(out)) == len(smoke.EXAMPLE_TOL[name[:-3]]), out


def test_distributed_example_on_two_gloo_ranks(tmp_path):
    """Example 02 on 2 ranks: 8 shots split 4 and 4, rank 0 prints."""
    name = "02_distributed_seismic.py"
    rdv = f"file://{tmp_path / 'rdv'}"
    procs = [_run(name, "--device", "cpu", "--init-method", rdv,
                  env=dict(os.environ, RANK=str(r), WORLD_SIZE="2", OMP_NUM_THREADS="1"))
             for r in range(2)]
    outs = [_done(p, f"{name} rank {r}") for r, p in enumerate(procs)]
    assert "devices: 2, mesh: {'block': 2}" in outs[0]
    assert "distributed LSQR: 60 iters" in outs[0]
    assert outs[1].strip() == ""


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the machine without a card")
def test_examples_need_the_card_unless_told():
    p = _run("01_deconvolution.py")
    out, err = p.communicate(timeout=300)
    assert p.returncode != 0 and "no CUDA device" in err
