"""The wave examples of ``examples_torch/`` (08–13) held against their JAX
counterparts, as tests/test_torch_example_parity.py holds 01–07 (its
docstring states the method and the tolerances; the two files split the
work so that no test worker runs much longer than another).
"""
import re

import jax
import jax.numpy as jnp
import numpy as np
import torch

from _torch_examples import (NUM, _capture, _close, _f32_krylov_spread, _iters,  # noqa: F401
                             _jax_stdout, _nums, _one_torch_thread, _port,
                             _x64_off_for_draws)


def _lsm_f64():
    """08's Born operator and six LSQR iterations in float64 in both
    packages: the relative residual of each."""
    from jets_tpu.ops.wave import born_operator as jborn
    from jets_tpu.ops.wave import offgrid_wave_propagator as joffgrid
    from jets_tpu.solvers import lsqr as jlsqr
    from jets_tpu_torch.ops.wave import born_operator, offgrid_wave_propagator
    from jets_tpu_torch.solvers import lsqr

    jax.config.update("jax_enable_x64", True)
    n = 48
    grid = (n, n)
    kw = dict(src_pos=(2.0, n / 2 - 0.5), rcv_depth=4.5, nt=300, dt=0.0012, dx=10.0,
              freq=12.0, sponge_width=8, space_order=8)
    c0 = np.full(grid, 2000.0)
    dc = np.zeros(grid)
    dc[28:32, 12:36] = 40.0
    J = jborn(joffgrid(grid, rcv_coords=jnp.linspace(4.0, n - 5.0, 24), dtype=jnp.float64,
                       **kw), jnp.asarray(c0))
    d = J(jnp.asarray(dc))
    ref = float(J.rng.norm(J(jlsqr(J, d, maxiter=6, tol=1e-7).x) - d)) / float(J.rng.norm(d))
    J = born_operator(offgrid_wave_propagator(grid, rcv_coords=np.linspace(4.0, n - 5.0, 24),
                                              dtype=torch.float64, device="cpu", **kw),
                      torch.from_numpy(c0))
    d = J(torch.from_numpy(dc))
    got = float(J.rng.norm(J(lsqr(J, d, maxiter=6, tol=1e-7).x) - d)) / float(J.rng.norm(d))
    return got, ref


def test_example_08():
    got = _port("08_rtm_imaging")
    out = _jax_stdout("08_rtm_imaging")
    _close(got["energy"], _nums(out, rf"data energy: ({NUM})")[0], 1e-4)
    assert got["peak"] == tuple(int(i) for i in _nums(out, r"RTM peak at \((\d+), (\d+)\)"))
    _f32_krylov_spread(got["relres"], _nums(out, rf"after 6 iterations: ({NUM})")[0])
    g64, r64 = _lsm_f64()
    np.testing.assert_allclose(g64, r64, rtol=1e-3)
    cpml, spng = _nums(out, rf"cpml: ({NUM})\s+sponge: ({NUM})")
    _close(got["cpml"], cpml, 1e-4)
    _close(got["sponge"], spng, 1e-4)


def test_example_09():
    got = _port("09_multiparameter_fwi")
    out = _jax_stdout("09_multiparameter_fwi")
    phi0, gc, gb = _nums(out, rf"initial misfit: ({NUM})\s+\(grad blocks: \|g_c\|=({NUM}), "
                              rf"\|g_b\|=({NUM})\)")
    _close(got["phi0"], phi0, 1e-5)
    _close(got["gc"], gc, 1e-5)
    _close(got["gb"], gb, 1e-5)
    its, phi = _nums(out, rf"misfit after (\d+) L-BFGS iterations: ({NUM})")
    _iters(got["iterations"], its)
    _close(got["phi"], phi, 1e-2)


def test_example_10():
    got = _port("10_compressed_snapshot_rtm")
    out = _jax_stdout("10_compressed_snapshot_rtm")
    ratio, bound = _nums(out, rf"ratio ({NUM})x \(format bound ({NUM})x\)")
    _close(got["ratio"], ratio, 1e-4)
    _close(got["bound"], bound, 1e-4)
    _close(got["cc"], _nums(out, rf"image correlation: ({NUM})")[0], 1e-4)
    _close(got["band"], _nums(out, rf"reflector band: ({NUM}%)")[0], 1e-4)


def test_example_11():
    """The bounded L-BFGS with int8 gradients: what the starting model sets
    at ``1e-5`` (``phi0`` unrounded, the model error at ``c0``), the
    recording grid exactly. The two packages' runs follow one path to
    within 9e-4 of ``phi`` for 8 iterations, then an Armijo test at
    roundoff parts them (after 15, 19% apart), so the common path is held
    at ``1e-2`` (``phi`` after 8 iterations, from each run's history; the
    JAX example's objective and run recorded from its own calls), and the
    port's final printed numbers meet the example's own contract: ``phi <
    0.2·phi0``, the model in the box, a smaller model error."""
    import jets_tpu.solvers as jsolvers

    lo, hi = 1400.0, 1700.0
    c = jnp.clip(1500.0 + 60.0 * jax.random.normal(jax.random.PRNGKey(0), (32, 32),
                                                    jnp.float32), lo, hi)
    got = _port("11_production_fwi", c_true=np.asarray(c))
    with _capture(jsolvers, "lbfgs") as calls:
        out = _jax_stdout("11_production_fwi")
    ((fg, c0), _, res), = calls
    assert int(_nums(out, r"recording grid: (\d+) samples")[0]) == got["ntrec"]
    np.testing.assert_allclose(got["phi0"], float(fg(c0)[0]), rtol=1e-5)
    _close(got["err0"], _nums(out, rf"model error: ({NUM}) ->")[0], 1e-5)
    np.testing.assert_allclose(got["history"][7], float(res.history[7]), rtol=1e-2)
    _iters(got["iterations"], _nums(out, r"\((\d+) iterations\)")[0])
    assert got["phi"] < 0.2 * got["phi0"] and got["err"] < got["err0"]
    assert lo - 1e-3 <= got["range"][0] and got["range"][1] <= hi + 1e-3


def test_example_12():
    """The TTI gradient maxima (int8 histories) at ``1e-3``. The isotropic
    ``phi`` and ``|g|max`` cannot be held at ``1e-4``: in 24 steps the wave
    barely reaches the anomaly two cells below the sources, so the residual
    ``r = F(c0) − F(c_true)`` is ~4e-5 of the traces, and float32 traces of
    the two packages (XLA contracts multiply-adds, the port does not) part
    by ~1.5e-6 of their maximum — 2% of the residual. So the parts are held
    where they are well conditioned: each package's traces ``F(c_true)`` and
    ``F(c0)`` within ``2e-6`` of their maximum (tests/test_gspmd.py's trace
    tolerance), and the int8 gradient of one and the same residual within
    ``1e-3`` of its maximum; the printed ``phi`` and ``|g|max`` within what
    that trace tolerance allows through the cancellation, ``δ = 2·2e-6·
    max|d|/max|r|`` for ``|g|max`` (linear in ``r``) and ``2δ`` for ``phi``
    (quadratic), ``max|d|`` and ``max|r|`` from this run."""
    import jets_tpu.ops.wave as jwave
    from jets_tpu_torch.ops.wave import multishot_wave_operator

    got = _port("12_multishot_imaging")
    with _capture(jwave, "multishot_wave_operator") as calls:
        out = _jax_stdout("12_multishot_imaging")
    ((grid, srcs), kw, Fj), = calls  # the JAX example's operator
    kw = {k: v for k, v in kw.items() if k != "dtype"}
    kw["rcv_idx"] = np.asarray(kw["rcv_idx"]).tolist()
    Ft = multishot_wave_operator(grid, np.asarray(srcs).tolist(), device="cpu", **kw)
    c_true = np.full(grid, 1500.0, np.float32)
    c_true[10:] = 1560.0
    c0 = np.full(grid, 1500.0, np.float32)
    traces = {}
    for name, c in (("true", c_true), ("c0", c0)):
        dj = np.asarray(Fj(jnp.asarray(c)))
        dt_ = Ft(torch.from_numpy(c)).numpy()
        np.testing.assert_allclose(dt_, dj, rtol=0, atol=2e-6 * float(np.max(np.abs(dj))))
        traces[name] = dj
    r = traces["c0"] - traces["true"]
    gj = np.asarray(Fj.linearize(jnp.asarray(c0)).H(jnp.asarray(r)))
    gt = Ft.linearize(torch.from_numpy(c0)).H(torch.from_numpy(r)).numpy()
    np.testing.assert_allclose(gt, gj, rtol=0, atol=1e-3 * float(np.max(np.abs(gj))))

    phi, gmax = _nums(out, rf"phi=({NUM}), \|g\|max=({NUM})")
    delta = 2 * 2e-6 * float(np.max(np.abs(traces["true"]))) / float(np.max(np.abs(r)))
    _close(got["phi"], phi, 2.0 * delta)
    _close(got["gmax"], gmax, delta)
    mags = dict(re.findall(rf"'(\w+)': '({NUM})'", out))
    assert set(mags) == {"c", "eps", "delta", "theta", "phi"}
    for k, v in mags.items():
        _close(got[f"tti_{k}"], v, 1e-3)


def test_example_13():
    got = _port("13_anisotropic_denq_gradient")
    out = _jax_stdout("13_anisotropic_denq_gradient")
    want = re.findall(rf"^\s+d(\w+)\s+\|g\|max = ({NUM})", out, re.M)
    assert len(want) == 6
    for (nm, v), kind in zip(want, ["vti"] * 3 + ["denq"] * 3):
        _close(got[f"{kind}_{nm}"], v, 1e-3)  # int8 histories
    _close(got["vtiq"], _nums(out, rf"VTI\+staticQ stored gradient \|g\|max = ({NUM})")[0],
           1e-4)
