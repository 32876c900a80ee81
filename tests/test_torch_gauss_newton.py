"""Gauss–Newton (jets_tpu_torch/solvers/gauss_newton.py) held against
jets_tpu.solvers.gauss_newton on the CPU, on the same numpy inputs: both
cases of tests/test_gauss_newton.py.

Tolerances: float64 on both sides; the inner CGLS runs jitted in the JAX
package and sums its inner products in another order than the port, so
models agree to ``rtol=1e-9`` (elementwise power, with a fixed inner
budget: at ``inner_tol=1e-12`` the two CGLS runs stop one iteration apart)
and ``1e-8`` (the wave operator, whose JAX time loop is compiled with FMA
contraction), and residual norms, each a difference of two data vectors,
to the same tolerances relative to the first. The ground truths of
tests/test_gauss_newton.py hold on the port's run with their tolerances.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

import jets_tpu as jt
from jets_tpu.ops import wave as jw
from jets_tpu.ops.elementwise import power_operator as j_power
from jets_tpu.solvers import gauss_newton as j_gauss_newton
from jets_tpu_torch.core.jet import Jet, Operator
from jets_tpu_torch.core.spaces import Space
from jets_tpu_torch.ops import wave as tw
from jets_tpu_torch.solvers import GNResult, cgls, gauss_newton

CPU = torch.device("cpu")  # the tests build on the CPU, as a caller asks


def _T(x):
    return torch.from_numpy(np.array(x))


def _power(n, p):
    """``d = m^p`` with its tangent diagonal refreshed by ``upstate`` at
    ``linearize`` (the JAX package's ``power_operator``) on the port's jet."""
    sp = Space((n,), torch.float64, CPU)
    return Operator(Jet(dom=sp, rng=sp, f=lambda m, s: m ** s["p"],
                        df=lambda dm, m0, s: s["diag"] * dm,
                        dft=lambda dd, m0, s: torch.conj(s["diag"]) * dd,
                        upstate=lambda m0, s: {"diag": s["p"] * m0 ** (s["p"] - 1)},
                        state={"p": float(p), "diag": sp.zeros()}))


def _same(rj, rt, rtol):
    """The same outer iterations: inner counts, residual norms (each a
    difference of two data vectors, so held relative to the first) and
    the model."""
    assert isinstance(rt, GNResult)
    assert rt.inner_iterations == [int(i) for i in rj.inner_iterations]
    np.testing.assert_allclose(rt.residuals, rj.residuals, rtol=0,
                               atol=rtol * rj.residuals[0])
    np.testing.assert_allclose(rt.m.numpy(), np.asarray(rj.m), rtol=rtol, atol=0)


def test_gn_recovers_elementwise_model():
    m_true = np.asarray(1.0 + jax.random.uniform(jax.random.PRNGKey(0), (32,),
                                                 jnp.float64))
    Fj = j_power(jt.Space((32,), jnp.float64), 3.0)
    Ft = _power(32, 3.0)
    m0j, m0t = jnp.full((32,), 1.5, jnp.float64), torch.full((32,), 1.5,
                                                           dtype=torch.float64)
    # the same iterates while no inner stopping test sits at roundoff (a
    # fixed inner budget; at inner_tol=1e-12 CGLS stops one iteration apart)
    fixed = dict(outer_iters=3, inner_iters=10, inner_tol=0.0)
    _same(j_gauss_newton(Fj, Fj(jnp.asarray(m_true)), m0j, **fixed),
          gauss_newton(Ft, Ft(_T(m_true)), m0t, **fixed), 1e-9)
    kw = dict(outer_iters=8, inner_iters=30, inner_tol=1e-12)
    seen = []
    rt = gauss_newton(Ft, Ft(_T(m_true)), m0t, callback=lambda k, m, r: seen.append((k, r)),
                      **kw)
    np.testing.assert_allclose(rt.m.numpy(), m_true, rtol=1e-6)
    assert rt.residuals[-1] < 1e-8 * rt.residuals[0]
    assert [k for k, _ in seen] == list(range(len(seen)))
    assert [r for _, r in seen] == rt.residuals[:len(seen)]
    # the inner solver is CGLS unless one is given: the same run through it
    again = gauss_newton(Ft, Ft(_T(m_true)), m0t, inner_solver=cgls, **kw)
    assert again.residuals == rt.residuals


def test_gn_stops_at_the_data():
    """A start on the data stops before any inner solve (which would divide
    by zero), as in the JAX package: one residual, no inner iterations."""
    Ft = _power(8, 2.0)
    m = torch.linspace(1.0, 2.0, 8, dtype=torch.float64)
    rt = gauss_newton(Ft, Ft(m), m, outer_iters=3)
    Fj = j_power(jt.Space((8,), jnp.float64), 2.0)
    mj = jnp.asarray(m.numpy())
    rj = j_gauss_newton(Fj, Fj(mj), mj, outer_iters=3)
    assert rt.residuals == [0.0] == [float(r) for r in rj.residuals]
    assert rt.inner_iterations == [] == list(rj.inner_iterations)
    assert torch.equal(rt.m, m)


def test_gn_wave_fwi_mini():
    """Miniature FWI: recover a velocity anomaly from traces."""
    kw = dict(nt=40, dt=0.0008, dx=10.0, freq=18.0, src_idx=16 * 8 + 8, sponge_width=3)
    Fj = jw.wave_propagator((16, 16), dtype=jnp.float64, **kw)
    s = Fj.jet.state
    Ft = tw.with_wave_arrays(tw.wave_propagator((16, 16), dtype=torch.float64,
                                                device=CPU, **kw),
                             wavelet=s["wavelet"], sponge=np.asarray(s["sponge"]),
                             src_idx=s["src_idx"], rcv_idx=s["rcv_idx"])
    c_true = np.full((16, 16), 2000.0)
    c_true[9:12, 9:12] += 40.0
    c0 = np.full((16, 16), 2000.0)
    gkw = dict(outer_iters=3, inner_iters=10, inner_tol=1e-10, step=1.0)
    rj = j_gauss_newton(Fj, Fj(jnp.asarray(c_true)), jnp.asarray(c0), **gkw)
    rt = gauss_newton(Ft, Ft(_T(c_true)), _T(c0), **gkw)
    _same(rj, rt, 1e-8)
    # residual strictly decreases and the update is finite
    assert rt.residuals[-1] < 0.7 * rt.residuals[0]
    assert np.isfinite(rt.m.numpy()).all()
