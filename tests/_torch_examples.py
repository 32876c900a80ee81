"""Helpers of the example parity tests (``tests/test_torch_example_parity.py``
and ``tests/test_torch_example_parity_wave.py``): run a JAX example and
capture what it prints, run a port example's ``main`` on the CPU, parse
printed numbers and hold a number to a printed one."""
import contextlib
import importlib.util
import io
import os
import re
import runpy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NUM = r"[-+]?\d+(?:\.\d+)?(?:e[-+]?\d+)?"


def _jax_stdout(name):
    """What ``examples/<name>.py`` prints, run as ``__main__`` here with x64
    off (the state a fresh process starts in); x64 is restored after."""
    x64 = bool(jax.config.jax_enable_x64)
    jax.config.update("jax_enable_x64", False)
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            runpy.run_path(os.path.join(REPO, "examples", f"{name}.py"), run_name="__main__")
    finally:
        jax.config.update("jax_enable_x64", x64)
    return buf.getvalue()


@contextlib.contextmanager
def _capture(module, name):
    """While the block runs, ``module.<name>`` records each call's
    arguments and result in the list it yields: a JAX example run inside
    the block hands the test what it computed (its draws, its solver's
    history) instead of the test computing it again."""
    calls, f = [], getattr(module, name)

    def record(*args, **kwargs):
        out = f(*args, **kwargs)
        calls.append((args, kwargs, out))
        return out

    setattr(module, name, record)
    try:
        yield calls
    finally:
        setattr(module, name, f)


def _port(name, **draws):
    """``examples_torch/<name>.py``'s ``main`` on the CPU with ``draws``."""
    spec = importlib.util.spec_from_file_location(
        f"examples_torch_{name}", os.path.join(REPO, "examples_torch", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.main(device="cpu", **draws)


def _nums(text, pattern):
    """The printed numbers of the first line matching ``pattern`` (a regex
    with one group per number), as strings."""
    m = re.search(pattern, text)
    assert m, f"no line matches {pattern!r} in:\n{text}"
    return m.groups()


def _close(got, printed, rel):
    """``got`` against a printed number: within ``rel`` of it or half a unit
    of its last printed digit, whichever is larger."""
    s = printed.rstrip("%")
    mant, _, exp = s.lower().partition("e")
    digits = len(mant.split(".")[1]) if "." in mant else 0
    half = 0.5 * 10.0 ** (int(exp or 0) - digits)
    want = float(s)
    if printed.endswith("%"):
        got = 100.0 * got
    assert abs(got - want) <= max(rel * abs(want), half), (got, printed, rel)


def _iters(got, printed):
    assert abs(int(got) - int(printed)) <= 2, (got, printed)


def _f32(key_seed, shape):
    return np.asarray(jax.random.normal(jax.random.PRNGKey(key_seed), shape, jnp.float32))


@pytest.fixture(autouse=True)
def _x64_off_for_draws():
    """The JAX draws below are made as the examples make them: x64 off."""
    x64 = bool(jax.config.jax_enable_x64)
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", x64)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The port's examples on one intra-op thread: their tensors are small,
    and under ``pytest -n 6`` each worker's default thread team (one per
    core) oversubscribes the machine, which slows their many small
    operations twentyfold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _f32_krylov_spread(got, printed):
    """The printed float32 result of a Krylov solve that roundoff steers
    (07, 08): within 0.2 of JAX's. Both packages' float32 runs stand far
    from their float64 result there (07: 2.5× at 400 iterations; 08: 15% at
    6), so their digits cannot agree to ``1e-3``; the solve's parity is
    held in float64 instead (the parity tests' ``_deblend_f64`` and ``_lsm_f64``)."""
    _close(got, printed, 0.2)
