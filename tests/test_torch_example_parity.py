"""Each example of ``examples_torch/`` held against its JAX counterpart in
``examples/``: the JAX example runs in this process (``runpy``, its stdout
captured, x64 off as when it runs alone; 03, 05 and 06 turn it on
themselves), the numbers it prints are parsed, the JAX example's random
draws are recomputed with the same ``jax.random`` (or numpy) calls, and the
port example's ``main(device="cpu", **draws)`` must return the same numbers.

Tolerances (relative to the JAX number unless said):

* dot-product gates: ``1e-5``;
* numbers of the deterministic wave examples: ``1e-4``, ``1e-3`` for
  gradients from int8 histories;
* solver residuals after a fixed iteration count: ``1e-3``;
* iteration counts that stop on ``tol``: equal within ±2;
* L-BFGS and Gauss–Newton runs: the first objective value (and what the
  starting model alone sets) ``1e-5``, the final one (and what the final
  model sets) ``1e-2``: Armijo branches can part in float32.

A printed number is known to its printed digits only, so each comparison
allows the tolerance above or half a unit of the last printed digit,
whichever is larger. Four cases cannot meet these in float32 and say
why: the deblending (07) and least-squares migration (08) solves, whose
float32 digits roundoff steers in both packages (held in float64 instead),
the bounded L-BFGS of 11, whose Armijo branches part after 8 iterations
(held on the common path), and the isotropic misfit of 12, a 4e-5
difference of two traces.
"""
import re

import jax
import jax.numpy as jnp
import numpy as np
import torch

from _torch_examples import (NUM, _capture, _close, _f32, _f32_krylov_spread,  # noqa: F401
                             _iters, _jax_stdout, _nums, _one_torch_thread, _port,
                             _x64_off_for_draws)


def test_example_01():
    n = 2000
    x = jnp.zeros((n,)).at[jax.random.randint(jax.random.PRNGKey(42), (20,), 50,
                                              n - 50)].set(1.0)
    got = _port("01_deconvolution", gate_m=_f32(0, (n,)), gate_d=_f32(1, (n,)),
                x_true=np.asarray(x))
    out = _jax_stdout("01_deconvolution")
    lhs, rhs = _nums(out, rf"dot-product gate: ({NUM}) vs ({NUM})")
    _close(got["gate"][0], lhs, 1e-5)
    _close(got["gate"][1], rhs, 1e-5)
    its, rel = _nums(out, rf"LSQR: (\d+) iterations, relative residual ({NUM})")
    _iters(got["iterations"], its)
    _close(got["relres"], rel, 1e-3)


def test_example_02():
    """JAX runs on this process's 8 virtual devices (16 shots); the port on
    a gloo world of one with the same 16-shot problem: the JAX example's
    weights and model (recorded from its own ``make_seismic_problem`` call)
    and its noise draw."""
    import jets_tpu.models.seismic as jseismic

    with _capture(jseismic, "make_seismic_problem") as calls:
        out = _jax_stdout("02_distributed_seismic")
    (A, m_true, d), = (c[2] for c in calls)
    eps = jax.random.normal(jax.random.split(jax.random.PRNGKey(0), 3)[2], d.shape,
                            jnp.float32)
    got = _port("02_distributed_seismic", wr=np.asarray(A.jet.state["bstate"]["wr"]),
                m_true=np.asarray(m_true), eps=np.asarray(eps))
    assert _nums(out, r"devices: (\d+)")[0] == "8" and got["devices"] == 1
    its, rel = _nums(out, rf"distributed LSQR: (\d+) iters, rel residual ({NUM})")
    _iters(got["iterations"], its)
    _close(got["relres"], rel, 1e-3)


def test_example_03():
    got = _port("03_fwi_gauss_newton")["residuals"]
    out = _jax_stdout("03_fwi_gauss_newton")
    want = re.findall(rf"'({NUM})'", out)
    assert len(want) == len(got) == 5
    _close(got[0], want[0], 1e-5)
    _close(got[-1], want[-1], 1e-2)


def test_example_04():
    from jets_tpu.models.seismic import make_seismic_operator

    A = make_seismic_operator((128, 128), 32, 256, jax.random.PRNGKey(0))
    got = _port("04_out_of_core", wr=np.asarray(A.jet.state["bstate"]["wr"]),
                m_true=0.1 * _f32(1, (128, 128)))
    out = _jax_stdout("04_out_of_core")
    assert _nums(out, r"native prefetch: (\w+)")[0] == str(got["native"])
    want = re.findall(rf"rel residual ({NUM})", out)
    assert len(want) == 3
    for g, w in zip(got["relres"], want):  # fixed step count
        _close(g, w, 1e-3)


def test_example_05():
    got = _port("05_fwi_lbfgs")
    out = _jax_stdout("05_fwi_lbfgs")
    phi0, phi, its = _nums(out, rf"phi: ({NUM}) -> ({NUM}) in (\d+) L-BFGS")
    _close(got["phi0"], phi0, 1e-5)
    _close(got["phi"], phi, 1e-2)
    _iters(got["iterations"], its)
    _close(got["relres"], _nums(out, rf"relative data residual: ({NUM})")[0], 1e-2)
    _close(got["err"], _nums(out, rf"max velocity error: ({NUM})")[0], 1e-2)


def test_example_06():
    f64 = lambda k: np.asarray(jax.random.normal(  # noqa: E731
        jax.random.PRNGKey(k), (16, 512), jnp.float64))
    jax.config.update("jax_enable_x64", True)  # the example's own setting
    draws = dict(gate_m=f64(0), gate_d=f64(1), noise=f64(7))
    got = _port("06_dsp_wavelet_processing", **draws)
    out = _jax_stdout("06_dsp_wavelet_processing")
    lhs, rhs = _nums(out, rf"chain dot-product test: ({NUM}) vs ({NUM})")
    _close(got["gate"][0], lhs, 1e-5)
    _close(got["gate"][1], rhs, 1e-5)
    its, rel = _nums(out, rf"lsqr deprocessing: (\d+) iters, relative data misfit ({NUM})")
    _iters(got["iterations"], its)
    _close(got["relres"], rel, 1e-3)
    _close(got["wavelet_err"], _nums(out, rf"reconstruction error: ({NUM}%)")[0], 1e-3)


def _deblend_f64(t0, spikes):
    """07's damped solve in float64 in both packages, run to convergence
    (``tol 1e-14``, at most 4000 iterations): ``(blended residual, model)``
    of each. Unconverged, even float64 LSQR is steered by roundoff here (a
    1e-15 change of the data moves JAX's own 400-iteration residual by
    7e-3); the damped least-squares solution itself is unique."""
    import jets_tpu as jtj
    import jets_tpu_torch as jt
    from jets_tpu.ops import blend_operator as jblend, integration_operator as jinteg
    from jets_tpu.solvers import lsqr as jlsqr
    from jets_tpu_torch.ops import blend_operator, integration_operator
    from jets_tpu_torch.solvers import lsqr

    jax.config.update("jax_enable_x64", True)
    kw = dict(maxiter=4000, tol=1e-14, damp=1e-3)
    nshots, nt = spikes.shape
    T = int(t0.max()) + nt
    B = jblend(nshots, nt, t0, T, dtype=jnp.float64)
    S = jinteg(jtj.Space((nshots, nt), jnp.float64), axis=1)
    d = B(S(jnp.asarray(spikes, jnp.float64)))
    me = S(jlsqr(B @ S, d, **kw).x)
    ref = float(B.rng.norm(B(me) - d) / B.rng.norm(d)), np.asarray(me)
    B = blend_operator(nshots, nt, [int(t) for t in t0], T, torch.float64, device="cpu")
    S = integration_operator(jt.Space((nshots, nt), torch.float64, "cpu"), axis=1)
    d = B(S(torch.from_numpy(spikes.astype(np.float64))))
    me = S(lsqr(B @ S, d, **kw).x)
    return (float(B.rng.norm(B(me) - d) / B.rng.norm(d)), me.numpy()), ref


def test_example_07():
    nshots, nt = 16, 400
    rng = np.random.default_rng(0)
    t0 = np.sort(rng.integers(0, (3 * nshots * nt) // 4, nshots))
    spikes = np.zeros((nshots, nt), np.float32)
    for s in range(nshots):
        idx = rng.integers(20, nt - 20, 4)
        spikes[s, idx] = rng.standard_normal(4)
    T = int(t0.max()) + nt
    got = _port("07_deblending", t0=t0, spikes=spikes, gate_m=_f32(0, (nshots, nt)),
                gate_d=_f32(1, (T,)))
    out = _jax_stdout("07_deblending")
    lhs, rhs = _nums(out, rf"dot-product gate: ({NUM}) vs ({NUM})")
    _close(got["gate"][0], lhs, 1e-5)
    _close(got["gate"][1], rhs, 1e-5)
    _iters(got["iterations"], _nums(out, r"LSQR: (\d+) iterations")[0])
    res, err = _nums(out, rf"blended-data residual ({NUM}), model error ({NUM})")
    _f32_krylov_spread(got["relres"], res)
    _f32_krylov_spread(got["model_err"], err)
    (g_res, g_m), (r_res, r_m) = _deblend_f64(t0, spikes)
    np.testing.assert_allclose(g_res, r_res, rtol=1e-3)
    np.testing.assert_allclose(g_m, r_m, rtol=0, atol=1e-3 * float(np.max(np.abs(r_m))))


