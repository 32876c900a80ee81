"""NLCG, L-BFGS and the least-squares objective
(jets_tpu_torch/solvers/nonlinear.py) held against jets_tpu.solvers on the
CPU, on the same numpy inputs: every case of tests/test_nonlinear.py, the
resumes of both solvers, and ``ravel_pytree`` against
``jax.flatten_util.ravel_pytree``.

Tolerances: float64 on both sides. The JAX solvers run jitted, where XLA
contracts multiply-adds into FMAs and sums its inner products in another
order; the port rounds every operation. Iterates, objective values and
histories agree to ``rtol=1e-10`` over the first ``k`` iterations of a run
with ``tol=0`` (observed ≤ 1e-13); beyond that an Armijo test sitting on
its boundary may accept in one package and halve in the other, so the full
runs are held to the ground truths of tests/test_nonlinear.py (the
analytic minimum, the model recovered, the box) with its tolerances, and
to the JAX run's iteration count.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree as j_ravel

import jets_tpu as jt
import jets_tpu_torch as tt
from jets_tpu.core.blockspace import BlockSpace as JBlockSpace
from jets_tpu.ops import square_operator as j_square
from jets_tpu.ops import wave as jw
from jets_tpu.solvers import lbfgs as j_lbfgs
from jets_tpu.solvers import least_squares_objective as j_objective
from jets_tpu.solvers import nlcg as j_nlcg
from jets_tpu_torch.core.jet import Jet, Operator
from jets_tpu_torch.ops import wave as tw
from jets_tpu_torch.solvers import lbfgs, least_squares_objective, nlcg
from jets_tpu_torch.utils.tree import ravel_pytree

CPU = torch.device("cpu")  # the tests build on the CPU, as a caller asks
KEY = jax.random.PRNGKey(3)
RTOL = 1e-10


def _T(x):
    return torch.from_numpy(np.array(x))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    nb = np.linalg.norm(b)
    assert nb > 0, "vacuous: reference is zero"
    return np.linalg.norm(a - b) / nb


def _np(m):
    if isinstance(m, tt.BlockVector):
        return np.concatenate([b.numpy().ravel() for b in m.blocks])
    return m.numpy()


def _j_np(m):
    return np.asarray(j_ravel(m)[0]) if hasattr(m, "blocks") else np.asarray(m)


def _same_run(rj, rt, rtol=RTOL):
    """The port's run equals JAX's: iteration count, model, objective and
    the whole history (inf where no iteration ran)."""
    assert rt.iterations == int(rj.iterations)
    assert _rel(_np(rt.m), _j_np(rj.m)) <= rtol, _rel(_np(rt.m), _j_np(rj.m))
    np.testing.assert_allclose(float(rt.phi), float(rj.phi), rtol=rtol, atol=0)
    hj, ht = np.asarray(rj.history), rt.history.numpy()
    fin = np.isfinite(hj)
    assert (np.isfinite(ht) == fin).all()
    np.testing.assert_allclose(ht[fin], hj[fin], rtol=rtol, atol=0)
    np.testing.assert_allclose(float(rt.gnorm), float(rj.gnorm), rtol=1e-8,
                               atol=1e-12 * float(rt.state.g0norm))


def _quad(n, seed):
    rng = np.random.default_rng(seed)
    Q = rng.standard_normal((n, n))
    return Q.T @ Q / n + np.eye(n), rng.standard_normal(n)


def _quad_fgs(A, b):
    Aj, bj, At, bt = jnp.asarray(A), jnp.asarray(b), _T(A), _T(b)

    def fgj(x):
        r = Aj @ x - bj
        return 0.5 * jnp.dot(r, r), Aj.T @ r

    def fgt(x):
        r = At @ x - bt
        return 0.5 * torch.dot(r, r), At.T @ r

    return fgj, fgt


def _square(n):
    """The elementwise square ``d = m²`` (the JAX package's
    ``square_operator``, self-adjoint tangent ``2m₀·dm``) on the port's jet."""
    sp = tt.Space((n,), torch.float64, CPU)
    return Operator(Jet(dom=sp, rng=sp, f=lambda m, s: m * m,
                        df=lambda dm, m0, s: 2.0 * m0 * dm, dft="self"))


def _square_problem():
    sp = jt.Space((20,), jnp.float64)
    Fj = j_square(sp)
    m_true = sp.rand(KEY) + 0.5
    d = Fj(m_true)
    return (j_objective(Fj, d), least_squares_objective(_square(20), _T(d)),
            np.asarray(m_true))


def test_ravel_pytree_matches_jax():
    rng = np.random.default_rng(0)
    a, b = rng.standard_normal((3, 4)), rng.standard_normal(5).astype(np.float32)
    fj, unj = j_ravel((jnp.asarray(a), jnp.asarray(b)))
    ft, unt = ravel_pytree((_T(a), _T(b)))
    assert ft.dtype == torch.float64 and fj.dtype == jnp.float64
    np.testing.assert_array_equal(ft.numpy(), np.asarray(fj))
    back = unt(ft)
    assert back[1].dtype == torch.float32
    assert torch.equal(back[0], _T(a)) and torch.equal(back[1], _T(b))
    # BlockVector leaves in block order, as the JAX package's BlockVector
    bj = JBlockSpace([jt.Space((3,), jnp.float64), jt.Space((2, 2), jnp.float64)])
    vj = bj.zeros().setblock(0, jnp.asarray(a[0, :3])).setblock(1, jnp.asarray(a[1:3, :2]))
    bt = tt.BlockSpace([tt.Space((3,), torch.float64, CPU),
                        tt.Space((2, 2), torch.float64, CPU)])
    vt = tt.BlockVector((_T(a[0, :3]), _T(a[1:3, :2])), bt)
    ft, unt = ravel_pytree(vt)
    np.testing.assert_array_equal(ft.numpy(), np.asarray(j_ravel(vj)[0]))
    back = unt(2.0 * ft)
    assert isinstance(back, tt.BlockVector) and back.space == bt
    assert torch.equal(back.blocks[1], 2.0 * vt.blocks[1])


def test_nlcg_quadratic():
    n = 30
    A = np.random.default_rng(0).standard_normal((n, n)) / np.sqrt(n) + 2.0 * np.eye(n)
    b = np.random.default_rng(1).standard_normal(n)
    fgj, fgt = _quad_fgs(A, b)
    _same_run(j_nlcg(fgj, jnp.zeros(n), maxiter=25, tol=0.0),
              nlcg(fgt, torch.zeros(n, dtype=torch.float64), maxiter=25, tol=0.0))
    rj = j_nlcg(fgj, jnp.zeros(n), maxiter=200, tol=1e-10)
    rt = nlcg(fgt, torch.zeros(n, dtype=torch.float64), maxiter=200, tol=1e-10)
    x_star = np.linalg.solve(A, b)
    assert np.allclose(rt.m.numpy(), x_star, atol=1e-6)
    assert abs(rt.iterations - int(rj.iterations)) <= 2


def test_lbfgs_quadratic_faster_than_gd():
    n = 50
    A, b = _quad(n, 0)
    fgj, fgt = _quad_fgs(A, b)
    _same_run(j_lbfgs(fgj, jnp.zeros(n), maxiter=20, mem=10, tol=0.0),
              lbfgs(fgt, torch.zeros(n, dtype=torch.float64), maxiter=20, mem=10,
                    tol=0.0))
    rj = j_lbfgs(fgj, jnp.zeros(n), maxiter=100, mem=10, tol=1e-10)
    rt = lbfgs(fgt, torch.zeros(n, dtype=torch.float64), maxiter=100, mem=10, tol=1e-10)
    assert np.allclose(rt.m.numpy(), np.linalg.solve(A, b), atol=1e-5)
    assert rt.iterations < 80
    assert abs(rt.iterations - int(rj.iterations)) <= 2


def test_lbfgs_rosenbrock():
    def fgj(m):
        x, y = m[0], m[1]
        phi = (1.0 - x) ** 2 + 100.0 * (y - x * x) ** 2
        return phi, jnp.array([-2.0 * (1.0 - x) - 400.0 * x * (y - x * x),
                               200.0 * (y - x * x)])

    def fgt(m):
        x, y = m[0], m[1]
        phi = (1.0 - x) ** 2 + 100.0 * (y - x * x) ** 2
        return phi, torch.stack([-2.0 * (1.0 - x) - 400.0 * x * (y - x * x),
                                 200.0 * (y - x * x)])

    x0 = np.array([-1.2, 1.0])
    _same_run(j_lbfgs(fgj, jnp.asarray(x0), maxiter=15, mem=10, tol=0.0),
              lbfgs(fgt, _T(x0), maxiter=15, mem=10, tol=0.0), rtol=1e-9)
    rt = lbfgs(fgt, _T(x0), maxiter=400, mem=10, tol=1e-12)
    assert np.allclose(rt.m.numpy(), [1.0, 1.0], atol=1e-4)


def test_least_squares_objective_adjoint_state_gradient():
    fgj, fgt, m_true = _square_problem()
    m0 = np.ones(20)
    phi_j, g_j = fgj(jnp.asarray(m0))
    phi_t, g_t = fgt(_T(m0))
    np.testing.assert_allclose(float(phi_t), float(phi_j), rtol=1e-14)
    np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), rtol=1e-14, atol=0)
    # ground truth by autodiff of the same objective, and central differences
    d = _T(m_true) ** 2
    m = _T(m0).requires_grad_()
    (g_ad,) = torch.autograd.grad(0.5 * torch.sum((m * m - d) ** 2), m)
    np.testing.assert_allclose(g_t.numpy(), g_ad.numpy(), atol=1e-12)
    h = 1e-6
    for i in (0, 7, 19):
        e = torch.zeros(20, dtype=torch.float64)
        e[i] = h
        fd = (float(fgt(_T(m0) + e)[0]) - float(fgt(_T(m0) - e)[0])) / (2 * h)
        np.testing.assert_allclose(fd, float(g_t[i]), rtol=1e-7)


@pytest.mark.parametrize("solver", ["nlcg", "lbfgs"])
def test_recovers_model_through_nonlinear_op(solver):
    fgj, fgt, m_true = _square_problem()
    if solver == "nlcg":
        run_j, run_t, kw = j_nlcg, nlcg, dict(maxiter=300)
    else:
        run_j, run_t, kw = j_lbfgs, lbfgs, dict(maxiter=200, mem=8)
    k = 12
    _same_run(run_j(fgj, jnp.ones(20), **{**kw, "maxiter": k}, tol=0.0),
              run_t(fgt, torch.ones(20, dtype=torch.float64), **{**kw, "maxiter": k},
                    tol=0.0))
    rt = run_t(fgt, torch.ones(20, dtype=torch.float64), **kw, tol=1e-12)
    assert float(rt.phi) < 1e-12
    assert np.allclose(rt.m.numpy(), m_true, atol=1e-5)


@pytest.mark.parametrize("solver", ["nlcg", "lbfgs"])
def test_resume_from_state(solver):
    """A resumed run continues the uninterrupted one exactly (the same
    operations in the same order, the original ``g0norm``), the saved state
    is not written, and JAX's resumed run agrees."""
    n = 40
    A, b = _quad(n, 2)
    fgj, fgt = _quad_fgs(A, b)
    run_j, run_t = (j_nlcg, nlcg) if solver == "nlcg" else (j_lbfgs, lbfgs)
    kw = {} if solver == "nlcg" else dict(mem=5)
    x0 = torch.zeros(n, dtype=torch.float64)
    full = run_t(fgt, x0, maxiter=24, tol=0.0, **kw)
    part = run_t(fgt, x0, maxiter=12, tol=0.0, **kw)
    saved = [f.clone() if isinstance(f, torch.Tensor) else f for f in part.state]
    for _ in range(2):
        cont = run_t(fgt, None, maxiter=24, tol=0.0, state=part.state, **kw)
        assert cont.iterations == 24
        assert torch.equal(cont.m, full.m) and torch.equal(cont.phi, full.phi)
        assert torch.equal(cont.history[12:], full.history[12:])
        assert torch.equal(cont.state.g0norm, part.state.g0norm)
    for a, s in zip(part.state, saved):
        assert (torch.equal(a, s) if isinstance(a, torch.Tensor) else a == s)
    jpart = run_j(fgj, jnp.zeros(n), maxiter=12, tol=0.0, **kw)
    _same_run(run_j(fgj, None, maxiter=24, tol=0.0, state=jpart.state, **kw), cont)


def test_lbfgs_resume_reaches_uninterrupted_quality():
    n = 40
    A, b = _quad(n, 2)
    _, fgt = _quad_fgs(A, b)
    x0 = torch.zeros(n, dtype=torch.float64)
    full = lbfgs(fgt, x0, maxiter=60, mem=5, tol=0.0)
    part = lbfgs(fgt, x0, maxiter=30, mem=5, tol=0.0)
    cont = lbfgs(fgt, None, maxiter=60, mem=5, tol=0.0, state=part.state)
    assert float(cont.phi) <= float(full.phi) * (1.0 + 1e-6) + 1e-12


def _box_fgs(t):
    """phi(x) = ½‖x − t‖²: the projected minimum over a box is clip(t)."""
    tj, tt_ = jnp.asarray(t), _T(t)

    def fgj(x):
        r = x - tj
        return 0.5 * jnp.vdot(r, r).real, r

    def fgt(x):
        # summed as XLA sums JAX's vdot here (torch.dot takes another order,
        # and at the optimum phi's last bit decides Armijo's ties)
        r = x - tt_
        return 0.5 * torch.sum(r * r), r

    return fgj, fgt


@pytest.mark.parametrize("solver", ["nlcg", "lbfgs"])
def test_bounded_solution_lands_on_box(solver):
    t = np.array([3.0, -2.0, 0.25, 0.8])
    fgj, fgt = _box_fgs(t)
    run_j, run_t = (j_nlcg, nlcg) if solver == "nlcg" else (j_lbfgs, lbfgs)
    _same_run(run_j(fgj, jnp.zeros(4, jnp.float64), maxiter=5, tol=0.0, bounds=(0.0, 1.0)),
              run_t(fgt, torch.zeros(4, dtype=torch.float64), maxiter=5, tol=0.0,
                    bounds=(0.0, 1.0)))
    rt = run_t(fgt, torch.zeros(4, dtype=torch.float64), maxiter=60, tol=1e-10,
               bounds=(0.0, 1.0))
    np.testing.assert_allclose(rt.m.numpy(), np.clip(t, 0.0, 1.0), rtol=0, atol=1e-8)
    assert float(rt.gnorm) <= 1e-8 * max(float(rt.state.g0norm), 1.0)


def test_bounded_one_sided_and_pytree_bounds():
    fgj, fgt = _box_fgs(np.array([3.0, -2.0]))
    z = torch.zeros(2, dtype=torch.float64)
    lo, hi = np.array([-10.0, -0.5]), np.array([2.5, 10.0])
    # lower bound only, then congruent-pytree bounds (per-component boxes)
    for bj, bt, want in (((-1.0, None), (-1.0, None), [3.0, -1.0]),
                         ((jnp.asarray(lo), jnp.asarray(hi)), (_T(lo), _T(hi)),
                          [2.5, -0.5])):
        _same_run(j_lbfgs(fgj, jnp.zeros(2, jnp.float64), maxiter=4, tol=0.0, bounds=bj),
                  lbfgs(fgt, z, maxiter=4, tol=0.0, bounds=bt))
        rt = lbfgs(fgt, z, maxiter=50, tol=1e-10, bounds=bt)
        np.testing.assert_allclose(rt.m.numpy(), want, atol=1e-8)


@pytest.mark.parametrize("solver", ["nlcg", "lbfgs"])
def test_bounded_blockvector_velocity_bounds(solver):
    """Bound only the velocity block of a two-block model (the production
    FWI pattern, bounds as a model-congruent BlockVector)."""
    run_j, run_t = (j_nlcg, nlcg) if solver == "nlcg" else (j_lbfgs, lbfgs)
    sp = tt.BlockSpace([tt.Space((3,), torch.float64, CPU)] * 2)
    tgt = tt.BlockVector((_T([2.0, -2.0, 0.5]), _T([5.0, -5.0, 0.0])), sp)

    def fg(m):
        r = tt.utils.tree.sub(m, tgt)
        return 0.5 * sp.dot(r, r), r

    inf = torch.full((3,), float("inf"), dtype=torch.float64)
    lo = tt.BlockVector((torch.full((3,), -1.0, dtype=torch.float64), -inf), sp)
    hi = tt.BlockVector((torch.full((3,), 1.0, dtype=torch.float64), inf), sp)
    rt = run_t(fg, sp.zeros(), maxiter=60, tol=1e-10, bounds=(lo, hi))
    np.testing.assert_allclose(rt.m.getblock(0).numpy(), [1.0, -1.0, 0.5], atol=1e-8)
    np.testing.assert_allclose(rt.m.getblock(1).numpy(), [5.0, -5.0, 0.0], atol=1e-8)
    # the same run in the JAX package
    bj = JBlockSpace([jt.Space((3,), jnp.float64), jt.Space((3,), jnp.float64)])

    def blk(a, b_):
        return bj.zeros().setblock(0, jnp.asarray(a)).setblock(1, jnp.asarray(b_))

    tj = blk(tgt.blocks[0].numpy(), tgt.blocks[1].numpy())

    def fgj(m):
        from jets_tpu.utils import tree as jtr
        r = jtr.sub(m, tj)
        return 0.5 * jnp.vdot(j_ravel(r)[0], j_ravel(r)[0]).real, r

    rj = run_j(fgj, bj.zeros(), maxiter=2, tol=0.0,
               bounds=(blk(lo.blocks[0].numpy(), lo.blocks[1].numpy()),
                       blk(hi.blocks[0].numpy(), hi.blocks[1].numpy())))
    _same_run(rj, run_t(fg, sp.zeros(), maxiter=2, tol=0.0, bounds=(lo, hi)))


def test_bounded_fwi_smoke():
    """Bounded L-BFGS on a tiny FWI problem through the adjoint-state
    gradient of ``wave_propagator``: the same iterates as the JAX package,
    the model inside the velocity box, the objective decreased."""
    shape = (16, 16)
    kw = dict(nt=24, dt=1e-3, dx=10.0, freq=18.0, src_idx=8 * 16 + 8, sponge_width=3)
    Fj = jw.wave_propagator(shape, dtype=jnp.float64, **kw)
    s = Fj.jet.state
    Ft = tw.with_wave_arrays(tw.wave_propagator(shape, dtype=torch.float64, device=CPU,
                                                **kw),
                             wavelet=s["wavelet"], sponge=np.asarray(s["sponge"]),
                             src_idx=s["src_idx"], rcv_idx=s["rcv_idx"])
    c_true = np.asarray(1500.0 + 40.0 * jax.random.normal(jax.random.PRNGKey(7), shape,
                                                          jnp.float64))
    d_obs = Fj(jnp.asarray(c_true))
    fgj, fgt = j_objective(Fj, d_obs), least_squares_objective(Ft, _T(d_obs))
    c0 = np.full(shape, 1500.0)
    box = (1450.0, 1550.0)
    rj = j_lbfgs(fgj, jnp.asarray(c0), maxiter=8, tol=1e-12, bounds=box)
    rt = lbfgs(fgt, _T(c0), maxiter=8, tol=1e-12, bounds=box)
    _same_run(rj, rt, rtol=1e-9)
    m = rt.m.numpy()
    assert m.min() >= 1450.0 - 1e-9 and m.max() <= 1550.0 + 1e-9
    assert float(rt.phi) < float(fgt(_T(c0))[0])
