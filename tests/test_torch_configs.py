"""The five BASELINE configurations (jets_tpu_torch/models/configs.py) held
against jets_tpu's builders at the small sizes of tests/test_configs.py,
with JAX's draws carried across through the builders' keyword overrides
(config 1 ``M``, ``w``, ``x_true``; configs 2–3 ``x_true``; configs 4–5
the seismic weights ``wr``), float64, ``mesh=None``; configs 4–5 also with
``mesh=`` on 2 and 4 gloo ranks against the JAX builders
(``test_mesh_is_not_ported``).

Tolerances: ``A(x)`` and ``A.H(d)`` at ``rtol=1e-12``; the port's
dot-product gate at ``rtol=1e-8`` (tests/test_configs.py). The iterate and
history are compared with JAX's at ``rtol=1e-8`` after the iterations where
the solve is still stable against roundoff: there JAX against itself, with
the data perturbed by 1e-16, moves x by ≤ 3e-14; later it moves x by up
to 7.6e-5 after 60 CGLS iterations on config 3, 2.2e-3 after 150 LSQR
iterations on config 2, 2.5e-2 after 40 on config 4 and 1.3e-7 after 20 on
config 5 (the solvers go on past convergence on ill-conditioned
operators). The full runs are held to the thresholds of
tests/test_configs.py (1e-8, 0.05, 0.05, 0.2, 0.3) and to JAX's relative
residual within 5% (the perturbation moves it by up to 0.7% on config 2;
the port lands 2.4% from JAX there).
"""
import inspect
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jets_tpu_torch as tt
from jets_tpu.models import configs as jcfg
from jets_tpu_torch.models import configs as cfg

CPU = torch.device("cpu")  # the tests build on the CPU, as a caller asks

# name: (small-size kwargs, full maxiter, threshold, stable iterations)
CASES = {
    "config1_spd_cg": (dict(n=96), 400, 1e-8, 400),
    "config2_deconv_lsqr": (dict(n=400), 150, 0.05, 40),
    "config3_deblur_cgls": (dict(side=48), 60, 0.05, 20),
    "config4_distributed_lsqr": (dict(nblocks=16, grid=(24, 24), nrecv=64), 40, 0.2, 20),
    "config5_seismic3d_pod": (dict(nshots=8, grid=(12, 12, 8), nrecv=48), 30, 0.3, 10),
}


def _overrides(name, kw, info, A):
    """The JAX builder's draws, as the port's keyword overrides."""
    if name == "config1_spd_cg":
        k1, k2, _ = jax.random.split(jax.random.PRNGKey(0), 3)
        n = kw["n"]
        return dict(M=np.asarray(jax.random.normal(k1, (n, n), jnp.float64)),
                    w=np.asarray(1.0 + jax.random.uniform(k2, (n,), jnp.float64)),
                    x_true=np.asarray(info["x_true"]))
    if name in ("config2_deconv_lsqr", "config3_deblur_cgls"):
        return dict(x_true=np.asarray(info["x_true"]))
    return dict(wr=np.asarray(A.jet.state["bstate"]["wr"]), dtype=torch.float64)


def _pair(name):
    kw = CASES[name][0]
    jkw = kw if name < "config4" else dict(kw, dtype=jnp.float64)
    jA, jsolve, jd, jinfo = getattr(jcfg, name)(**jkw)
    tA, tsolve, td, tinfo = getattr(cfg, name)(**kw, **_overrides(name, kw, jinfo, jA),
                                               device=CPU)
    return (jA, jsolve, jd), (tA, tsolve, td)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@pytest.mark.parametrize("name", sorted(CASES))
def test_config_operator_matches_jax(name):
    (jA, _, jd), (tA, _, td) = _pair(name)
    assert tA.dom.device == CPU and tA.dom.dtype == torch.float64
    if name < "config4":  # the observed data is A(x_true) on both sides
        assert _rel(td.numpy(), jd) <= 1e-12
    rng = np.random.default_rng(0)
    m, d = rng.standard_normal(tA.dom.shape), rng.standard_normal(tA.rng.shape)
    assert _rel(tA(torch.from_numpy(m)).numpy(), jA(jnp.asarray(m))) <= 1e-12
    assert _rel(tA.H(torch.from_numpy(d)).numpy(), jA.H(jnp.asarray(d))) <= 1e-12
    g = torch.Generator().manual_seed(0)
    lhs, rhs = tt.dot_product_test(tA, tA.dom.randn(g), tA.rng.randn(g))
    np.testing.assert_allclose(float(lhs), float(rhs), rtol=1e-8)


@pytest.mark.parametrize("name", sorted(CASES))
def test_config_solve_matches_jax(name):
    """The same solver on the same data: iterate and history at the stable
    iteration count, then the full run's relative residual."""
    (jA, jsolve, jd), (tA, tsolve, _) = _pair(name)
    _, maxiter, threshold, stable = CASES[name]
    d = torch.from_numpy(np.array(jd))
    rj = jsolve(jA, jd, maxiter=stable, tol=1e-10)
    rt = tsolve(tA, d, maxiter=stable, tol=1e-10)
    assert rt.iterations == int(rj.iterations)
    assert _rel(rt.x.numpy(), rj.x) <= 1e-8
    hj, ht = np.asarray(rj.history), rt.history.numpy()
    ran = np.isfinite(hj)
    assert (np.isfinite(ht) == ran).all()
    np.testing.assert_allclose(ht[ran], hj[ran], rtol=1e-8)
    rj = jsolve(jA, jd, maxiter=maxiter, tol=1e-10)
    rt = tsolve(tA, d, maxiter=maxiter, tol=1e-10)
    rel_j = float(jA.rng.norm(jA(rj.x) - jd) / jA.rng.norm(jd))
    rel_t = float(tA.rng.norm(tA(rt.x) - d) / tA.rng.norm(d))
    assert rel_t < threshold
    assert rel_t == pytest.approx(rel_j, rel=5e-2)


@pytest.mark.parametrize("name", sorted(CASES))
def test_run_config_meets_threshold(name):
    """The port's own draws, through ``run_config``, as tests/test_configs.py
    runs JAX's."""
    kw, maxiter, threshold, _ = CASES[name]
    extra = {} if name < "config4" else dict(dtype=torch.float64)
    res, rel, A = cfg.run_config(getattr(cfg, name), maxiter=maxiter, tol=1e-10,
                                 device=CPU, **kw, **extra)
    assert rel < threshold, rel
    assert bool(torch.isfinite(res.history[:res.iterations]).all())
    g = torch.Generator().manual_seed(1)
    lhs, rhs = tt.dot_product_test(A, A.dom.randn(g), A.rng.randn(g))
    np.testing.assert_allclose(float(lhs), float(rhs), rtol=1e-8)


@pytest.mark.parametrize("name", sorted(CASES))
def test_signature_defaults_match_jax(name):
    """Full BASELINE sizes by default, configs 1–3 in float64 and 4–5 in
    float32, and the device left to the card."""
    tsig = inspect.signature(getattr(cfg, name)).parameters
    jsig = inspect.signature(getattr(jcfg, name)).parameters
    for p, jp in jsig.items():
        if p == "dtype":
            assert str(tsig[p].default).split(".")[-1] == np.dtype(jp.default).name
        else:
            assert tsig[p].default == jp.default, p
    assert tsig["device"].default is None


@pytest.fixture(scope="module")
def on_ranks(tmp_path_factory):
    """Configs 4 and 5 on 2 and on 4 gloo ranks (``tests/_torch_mp_worker.py``,
    battery ``configs``), with the JAX package's weights and data, beside
    JAX's own solves."""
    from _torch_mp_worker import spawn

    inp, ref = {}, {}
    rng = np.random.default_rng(3)
    for name in ("config4_distributed_lsqr", "config5_seismic3d_pod"):
        kw, maxiter, threshold, stable = CASES[name]
        jA, jsolve, jd, _ = getattr(jcfg, name)(**kw, dtype=jnp.float64)
        inp[f"{name}:kw"] = np.array(json.dumps(kw))
        inp[f"{name}:wr"] = np.asarray(jA.jet.state["bstate"]["wr"])
        inp[f"{name}:jd"] = np.asarray(jd)
        inp[f"{name}:iters"] = np.array([stable, maxiter])
        inp[f"{name}:m"] = rng.standard_normal(jA.dom.shape)
        inp[f"{name}:d"] = rng.standard_normal(jA.rng.shape)
        ref[name] = dict(fwd=np.asarray(jA(jnp.asarray(inp[f"{name}:m"]))),
                         adj=np.asarray(jA.H(jnp.asarray(inp[f"{name}:d"]))),
                         solve=jsolve(jA, jd, maxiter=stable, tol=1e-10),
                         full=jsolve(jA, jd, maxiter=maxiter, tol=1e-10), jA=jA, jd=jd)
    tmp = tmp_path_factory.mktemp("configs")
    return ref, {w: spawn("configs", w, tmp, inp) for w in (2, 4)}


@pytest.mark.parametrize("name", ["config4_distributed_lsqr", "config5_seismic3d_pod"])
def test_mesh_is_not_ported(name, on_ranks):
    """``mesh=`` on 2 and 4 gloo ranks against the JAX builder on the same
    weights and data (the name is kept from when the port refused a mesh):
    the operator at ``rtol 1e-12``; LSQR's iterate and history at the
    stable iteration count at ``rtol 1e-8`` (the ranks add their partial
    inner products, a roundoff the stable iterations do not amplify); the
    full runs under the threshold of tests/test_configs.py and within 5% of
    JAX's relative residual; the port's own problem under the threshold."""
    ref, res = on_ranks
    ref = ref[name]
    _, maxiter, threshold, stable = CASES[name]
    for r in res[2] + res[4]:
        assert _rel(r[f"{name}:fwd"], ref["fwd"]) <= 1e-12
        assert _rel(r[f"{name}:adj"], ref["adj"]) <= 1e-12
        rj = ref["solve"]
        assert int(r[f"{name}:iterations"]) == int(rj.iterations)
        assert _rel(r[f"{name}:x"], rj.x) <= 1e-8
        hj, ht = np.asarray(rj.history), r[f"{name}:history"]
        ran = np.isfinite(hj)
        assert (np.isfinite(ht) == ran).all()
        np.testing.assert_allclose(ht[ran], hj[ran], rtol=1e-8)
        jA, jd, rf = ref["jA"], ref["jd"], ref["full"]
        rel_j = float(jA.rng.norm(jA(rf.x) - jd) / jA.rng.norm(jd))
        assert r[f"{name}:relres_jd"] < threshold
        assert float(r[f"{name}:relres_jd"]) == pytest.approx(rel_j, rel=5e-2)
        assert r[f"{name}:relres_own"] < threshold


def test_a_seed_gives_one_problem():
    """The draws come from a CPU generator, so a seed fixes the problem."""
    A1, _, d1, i1 = cfg.config1_spd_cg(n=12, seed=3, device=CPU)
    A2, _, d2, i2 = cfg.config1_spd_cg(n=12, seed=3, device=CPU)
    assert torch.equal(d1, d2) and torch.equal(i1["x_true"], i2["x_true"])
    _, _, d3, _ = cfg.config1_spd_cg(n=12, seed=4, device=CPU)
    assert not torch.equal(d1, d3)
