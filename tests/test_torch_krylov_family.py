"""MINRES, BiCGStab, GMRES (real and complex), Chebyshev and
``estimate_spectral_bounds`` (jets_tpu_torch/solvers/krylov.py) held
against jets_tpu on the same operators and right-hand sides (the cases of
tests/test_solvers.py), with their resumes and the zero right-hand side;
and the earlier solvers (CG, LSQR, LSMR, CGLS) on block and complex
matrix operators.

Tolerances: float64 / complex128 on both sides; x and history at
``rtol=1e-10`` against JAX (the port's rotations take ``hypot`` where JAX
takes ``sqrt(a² + b²)``, and the two sum their inner products in other
orders); against the dense solve at the ``atol`` of tests/test_solvers.py.
A resumed run equals the continuous run bit for bit (the same operations
in the same order), and no solver writes into ``b``, ``x0`` or ``state=``.
GMRES also runs on the FFT composite ``F^H D F + 2I`` of
tests/test_solvers.py, over ``fft_operator`` and ``identity_operator``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jets_tpu as jt
import jets_tpu.solvers as jsolvers
import jets_tpu_torch as tt
import jets_tpu_torch.solvers as tsolvers
from jets_tpu.ops import diagonal_operator as j_diagonal
from jets_tpu.ops import matrix_operator as j_matrix
from jets_tpu.solvers import bicgstab as j_bicgstab
from jets_tpu.solvers import cg as j_cg
from jets_tpu.solvers import chebyshev as j_chebyshev
from jets_tpu.solvers import estimate_spectral_bounds as j_bounds
from jets_tpu.solvers import gmres as j_gmres
from jets_tpu.solvers import minres as j_minres
from jets_tpu_torch.ops import diagonal_operator, matrix_operator
from jets_tpu_torch.solvers import (
    bicgstab,
    cg,
    chebyshev,
    estimate_spectral_bounds,
    gmres,
    minres,
)

CPU = torch.device("cpu")  # the tests build on the CPU, as a caller asks


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _same_as_jax(rj, rt, rtol=1e-10):
    assert rt.iterations == int(rj.iterations)
    assert _rel(rt.x.numpy(), rj.x) <= rtol, _rel(rt.x.numpy(), rj.x)
    hj, ht = np.asarray(rj.history), rt.history.numpy()
    fin = np.isfinite(hj)
    assert (np.isfinite(ht) == fin).all()
    np.testing.assert_allclose(ht[fin], hj[fin], rtol=rtol, atol=rtol * hj[fin].max())


def _pair_matrix(M):
    return j_matrix(jnp.asarray(M)), matrix_operator(M, device=CPU)


def _run(jsolve, tsolve, jA, tA, b, **kw):
    bt = torch.from_numpy(np.array(b))
    keep = bt.clone()
    rt = tsolve(tA, bt, **kw)
    assert torch.equal(bt, keep), "the solver wrote into b"
    return jsolve(jA, jnp.asarray(b), **kw), rt


def _resumes(tsolve, tA, b, total, part, **kw):
    """A run resumed from a saved state equals the continuous run, the
    saved state is not written, and it can be resumed from twice."""
    bt = torch.from_numpy(np.array(b))
    full = tsolve(tA, bt, maxiter=total, **kw)
    half = tsolve(tA, bt, maxiter=part, **kw)
    saved = [f.clone() if isinstance(f, torch.Tensor) else f for f in half.state]
    for _ in range(2):
        cont = tsolve(tA, bt, maxiter=total, state=half.state, **kw)
        assert cont.iterations == full.iterations
        assert torch.equal(cont.x, full.x)
        ran = torch.isfinite(cont.history)
        assert torch.equal(cont.history[ran], full.history[ran])
    for f, g in zip(half.state, saved):
        assert (torch.equal(f, g) if isinstance(f, torch.Tensor) else f == g)


# -- MINRES ---------------------------------------------------------------------------------


def test_minres_symmetric_indefinite_matches_jax():
    w = np.concatenate([np.linspace(1.0, 5.0, 30), -np.linspace(1.0, 5.0, 30)])
    b = np.random.default_rng(6).standard_normal(60)
    rj, rt = _run(j_minres, minres, j_diagonal(jnp.asarray(w)),
                  diagonal_operator(w, device=CPU), b, maxiter=200, tol=1e-12)
    _same_as_jax(rj, rt)
    np.testing.assert_allclose(rt.x.numpy(), b / w, atol=1e-8)
    h = rt.history.numpy()
    h = h[np.isfinite(h)]
    assert np.all(np.diff(h) <= 1e-10)  # monotone residual


def test_minres_matches_cg_on_spd_and_jax():
    Q = np.random.default_rng(3).standard_normal((30, 30))
    jA, tA = _pair_matrix(Q.T @ Q / 30 + np.eye(30))
    b = np.random.default_rng(7).standard_normal(30)
    rj, rt = _run(j_minres, minres, jA, tA, b, maxiter=200, tol=1e-13)
    _same_as_jax(rj, rt)
    x_cg = cg(tA, torch.from_numpy(b), maxiter=200, tol=1e-13).x
    np.testing.assert_allclose(rt.x.numpy(), x_cg.numpy(), atol=1e-8)
    assert _rel(x_cg.numpy(), j_cg(jA, jnp.asarray(b), maxiter=200, tol=1e-13).x) <= 1e-10


def test_minres_resume_and_x0():
    w = np.linspace(1.0, 9.0, 40)
    tA = diagonal_operator(w, device=CPU)
    b = np.random.default_rng(8).standard_normal(40)
    _resumes(minres, tA, b, 40, 20, tol=0.0)
    x0 = torch.from_numpy(np.random.default_rng(9).standard_normal(40))
    keep = x0.clone()
    rt = minres(tA, torch.from_numpy(b), x0, maxiter=40, tol=0.0)
    rj = j_minres(j_diagonal(jnp.asarray(w)), jnp.asarray(b), jnp.asarray(x0.numpy()),
                  maxiter=40, tol=0.0)
    assert torch.equal(x0, keep)
    _same_as_jax(rj, rt)


# -- BiCGStab and GMRES -----------------------------------------------------------------------


def _nonsymmetric_problem(n=60, seed=3):
    rng = np.random.default_rng(seed)
    M = np.eye(n) + 0.5 * rng.standard_normal((n, n)) / np.sqrt(n)
    x_true = rng.standard_normal(n)
    return M, x_true, M @ x_true


def _complex_problem(n, scale, seed):
    rng = np.random.default_rng(seed)
    M = np.eye(n) + scale * (rng.standard_normal((n, n))
                             + 1j * rng.standard_normal((n, n))) / np.sqrt(2 * n)
    x_true = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    return M, x_true, M @ x_true


def test_bicgstab_matches_dense_solve_and_jax():
    M, x_true, b = _nonsymmetric_problem()
    rj, rt = _run(j_bicgstab, bicgstab, *_pair_matrix(M), b, maxiter=200, tol=1e-12)
    _same_as_jax(rj, rt)
    np.testing.assert_allclose(rt.x.numpy(), x_true, atol=1e-7)


def test_bicgstab_complex_matches_jax():
    M, x_true, b = _complex_problem(30, 0.4, 22)
    rj, rt = _run(j_bicgstab, bicgstab, *_pair_matrix(M), b, maxiter=300, tol=1e-13)
    _same_as_jax(rj, rt)
    np.testing.assert_allclose(rt.x.numpy(), x_true, atol=1e-7)


def test_bicgstab_breakdown_safe_on_zero_rhs_and_resumes():
    M, _, b = _nonsymmetric_problem()
    tA = matrix_operator(M, device=CPU)
    res = bicgstab(tA, torch.zeros(60, dtype=torch.float64), maxiter=10)
    assert res.iterations == 0 and bool(torch.isfinite(res.x).all())
    assert torch.equal(res.x, torch.zeros(60, dtype=torch.float64))
    _resumes(bicgstab, tA, b, 30, 12, tol=0.0)


def test_gmres_matches_dense_solve_and_jax():
    M, x_true, b = _nonsymmetric_problem()
    rj, rt = _run(j_gmres, gmres, *_pair_matrix(M), b, maxiter=120, restart=20, tol=1e-12)
    _same_as_jax(rj, rt)
    np.testing.assert_allclose(rt.x.numpy(), x_true, atol=1e-8)
    h = rt.history.numpy()
    h = h[np.isfinite(h)]
    assert h[-1] < 1e-10 * h[0] + 1e-12


@pytest.mark.parametrize("cplx", [False, True])
def test_gmres_single_cycle_exact_in_n_steps(cplx):
    if cplx:
        M, x_true, b = _complex_problem(20, 0.3, 12)
    else:
        M, x_true, b = _nonsymmetric_problem(n=24)
    n = M.shape[0]
    rj, rt = _run(j_gmres, gmres, *_pair_matrix(M), b, maxiter=n, restart=n, tol=0.0)
    np.testing.assert_allclose(rt.x.numpy(), x_true, atol=1e-8)
    assert _rel(rt.x.numpy(), rj.x) <= 1e-10


def test_gmres_resume_restart_boundary():
    M, _, b = _nonsymmetric_problem()
    tA = matrix_operator(M, device=CPU)
    _resumes(gmres, tA, b, 40, 20, restart=10, tol=0.0)
    full = j_gmres(j_matrix(jnp.asarray(M)), jnp.asarray(b), maxiter=40, restart=10, tol=0.0)
    half = gmres(tA, torch.from_numpy(b), maxiter=20, restart=10, tol=0.0)
    cont = gmres(tA, torch.from_numpy(b), maxiter=40, restart=10, tol=0.0, state=half.state)
    assert _rel(cont.x.numpy(), full.x) <= 1e-10


def test_gmres_complex_matches_dense_solve_and_jax():
    M, x_true, b = _complex_problem(48, 0.4, 11)
    rj, rt = _run(j_gmres, gmres, *_pair_matrix(M.astype(np.complex128)), b,
                  maxiter=96, restart=16, tol=1e-13)
    assert rt.x.dtype == torch.complex128
    _same_as_jax(rj, rt)
    np.testing.assert_allclose(rt.x.numpy(), x_true, atol=1e-8)


def test_gmres_on_composite_and_block_operators():
    """GMRES through the operator algebra (a sum with a scaled identity) and
    on a 2 × 2 block operator, whose members are ``BlockVector``s."""
    rng = np.random.default_rng(2)
    N = rng.standard_normal((24, 24)) / np.sqrt(24)
    tA = matrix_operator(N, device=CPU) + 2.0 * matrix_operator(np.eye(24), device=CPU)
    jA = j_matrix(jnp.asarray(N)) + 2.0 * j_matrix(jnp.eye(24))
    x_true = rng.standard_normal(24)
    rj, rt = _run(j_gmres, gmres, jA, tA, (N + 2.0 * np.eye(24)) @ x_true,
                  maxiter=96, restart=16, tol=1e-13)
    _same_as_jax(rj, rt)
    np.testing.assert_allclose(rt.x.numpy(), x_true, atol=1e-8)
    blocks = [[matrix_operator(np.eye(12) + 0.3 * rng.standard_normal((12, 12)) / 4,
                               device=CPU) for _ in range(2)] for _ in range(2)]
    B = tt.block_operator(blocks)
    xb = B.dom.randn(torch.Generator().manual_seed(4))
    res = gmres(B, B(xb), maxiter=48, restart=24, tol=1e-13)
    assert isinstance(res.x, tt.BlockVector)
    np.testing.assert_allclose(B.dom.ravel(res.x).numpy(), B.dom.ravel(xb).numpy(),
                               atol=1e-8)


# -- Chebyshev and spectral bounds ------------------------------------------------------------


def _spd(n, lo, hi, seed):
    rng = np.random.default_rng(seed)
    Q = np.linalg.qr(rng.standard_normal((n, n)))[0]
    return (Q * np.linspace(lo, hi, n)) @ Q.T, rng


def test_chebyshev_converges_and_matches_jax():
    M, rng = _spd(80, 1.0, 10.0, 11)
    x_true = rng.standard_normal(80)
    rj, rt = _run(j_chebyshev, chebyshev, *_pair_matrix(M), M @ x_true, maxiter=300,
                  tol=1e-10, check_every=10, lmin=0.9, lmax=10.5)
    _same_as_jax(rj, rt)
    np.testing.assert_allclose(rt.x.numpy(), x_true, atol=1e-6)
    h = rt.history.numpy()
    h = h[np.isfinite(h)]
    assert h[-1] < h[0]


def test_chebyshev_resume_matches_full():
    M, rng = _spd(40, 1.0, 5.0, 12)
    tA = matrix_operator(M, device=CPU)
    b = rng.standard_normal(40)
    _resumes(lambda A, b_, **kw: chebyshev(A, b_, 1.0, 5.0, **kw), tA, b, 60, 30,
             tol=0.0, check_every=10)
    full = j_chebyshev(j_matrix(jnp.asarray(M)), jnp.asarray(b), 1.0, 5.0, maxiter=60,
                       tol=0.0, check_every=10)
    res = chebyshev(tA, torch.from_numpy(b), 1.0, 5.0, maxiter=60, tol=0.0, check_every=10)
    assert _rel(res.x.numpy(), full.x) <= 1e-10


def test_estimate_spectral_bounds_matches_jax():
    """On a spectrum with wide gaps the power iterations converge within
    their 30 steps, so the port and JAX agree whatever their start vectors;
    on a dense spectrum the bounds still enclose it and drive Chebyshev."""
    lam = np.concatenate([[1.0], np.linspace(5.0, 6.0, 30), [10.0]])
    Q = np.linalg.qr(np.random.default_rng(13).standard_normal((32, 32)))[0]
    M = (Q * lam) @ Q.T
    jA, tA = _pair_matrix(M)
    tlo, thi = estimate_spectral_bounds(tA)
    jlo, jhi = j_bounds(jA)
    assert float(thi) == pytest.approx(float(jhi), rel=1e-10)
    assert float(thi) == pytest.approx(10.0 * 1.05, rel=1e-10)
    assert float(tlo) == pytest.approx(float(jlo), rel=1e-8)
    assert 0.0 < float(tlo) <= 1.0
    M, rng = _spd(80, 1.0, 10.0, 11)
    tA = matrix_operator(M, device=CPU)
    lmin, lmax = estimate_spectral_bounds(tA, torch.Generator().manual_seed(5))
    assert float(lmax) >= 10.0 and float(lmin) <= 1.0
    x_true = rng.standard_normal(80)
    res = chebyshev(tA, torch.from_numpy(M @ x_true), max(float(lmin), 0.5), lmax,
                    maxiter=300, tol=1e-10)
    np.testing.assert_allclose(res.x.numpy(), x_true, atol=1e-6)


# -- the earlier solvers on matrix, block and complex operators ----------------------------


def test_cg_and_lsqr_on_block_operators_match_jax():
    """CG on a block-diagonal SPD system with structural zeros, and LSQR on
    a tall block column whose range is a BlockSpace: BlockVectors flow
    through the recurrences (tests/test_solvers.py:82, :145)."""
    rng = np.random.default_rng(30)
    mats = [rng.standard_normal((24, 24)) for _ in range(2)]
    spd = [M @ M.T + 24 * np.eye(24) for M in mats]
    (j1, t1), (j2, t2) = (_pair_matrix(S) for S in spd)
    jB = jt.block_operator([[j1, jt.zero_block(j2.dom, j1.rng)],
                            [jt.zero_block(j1.dom, j2.rng), j2]])
    tB = tt.block_operator([[t1, tt.zero_block(t2.dom, t1.rng)],
                            [tt.zero_block(t1.dom, t2.rng), t2]])
    b = tB.rng.randn(torch.Generator().manual_seed(13))
    rt = cg(tB, b, maxiter=300, tol=1e-12)
    rj = j_cg(jB, jB.rng.reshape(jnp.asarray(tB.rng.ravel(b).numpy())), maxiter=300,
              tol=1e-12)
    for i in range(2):
        np.testing.assert_allclose(rt.x.getblock(i).numpy(),
                                   np.linalg.solve(spd[i], b.getblock(i).numpy()),
                                   rtol=1e-7)
    assert _rel(tB.dom.ravel(rt.x).numpy(), jB.dom.ravel(rj.x)) <= 1e-10
    A1, A2 = rng.standard_normal((9, 6)), rng.standard_normal((4, 6))
    jC = jt.block_operator([[j_matrix(jnp.asarray(A1))], [j_matrix(jnp.asarray(A2))]])
    tC = tt.block_operator([[matrix_operator(A1, device=CPU)],
                            [matrix_operator(A2, device=CPU)]])
    x_true = rng.standard_normal(6)
    d = tC(torch.from_numpy(x_true))
    rt = tsolvers.lsqr(tC, d, maxiter=100, tol=1e-13)
    rj = jsolvers.lsqr(jC, jC(jnp.asarray(x_true)), maxiter=100, tol=1e-13)
    np.testing.assert_allclose(rt.x.numpy(), x_true, rtol=1e-8)
    _same_as_jax(rj, rt)


@pytest.mark.parametrize("name", ["lsqr", "lsmr", "cgls"])
def test_complex_least_squares_family_matches_jax(name):
    """The bidiagonalization's scalars are real norms, so LSQR, LSMR and
    CGLS take complex operators as they are (tests/test_solvers.py:316)."""
    rng = np.random.default_rng(21)
    M = rng.standard_normal((40, 24)) + 1j * rng.standard_normal((40, 24))
    b = rng.standard_normal(40) + 1j * rng.standard_normal(40)
    rj, rt = _run(getattr(jsolvers, name), getattr(tsolvers, name), *_pair_matrix(M), b,
                  maxiter=200, tol=1e-14)
    np.testing.assert_allclose(rt.x.numpy(), np.linalg.lstsq(M, b, rcond=None)[0],
                               atol=1e-8)
    assert _rel(rt.x.numpy(), rj.x) <= 1e-10


@pytest.mark.parametrize("name", ["cg", "minres"])
def test_complex_hermitian_family_matches_jax(name):
    rng = np.random.default_rng(22)
    B = rng.standard_normal((30, 30)) + 1j * rng.standard_normal((30, 30))
    H = B @ B.conj().T + 30 * np.eye(30)
    b = rng.standard_normal(30) + 1j * rng.standard_normal(30)
    rj, rt = _run(getattr(jsolvers, name), getattr(tsolvers, name), *_pair_matrix(H), b,
                  maxiter=300, tol=1e-14)
    np.testing.assert_allclose(rt.x.numpy(), np.linalg.solve(H, b), atol=1e-8)
    assert _rel(rt.x.numpy(), rj.x) <= 1e-10


def test_gmres_complex_on_fft_composite():
    """GMRES on a complex-domain operator composite, ``A = F^H D F + 2I``
    with the unitary FFT ``F`` and a complex diagonal ``D``, on the same
    numpy draws in both packages."""
    from jets_tpu.ops import fft_operator as j_fft
    from jets_tpu.ops import identity_operator as j_identity
    from jets_tpu_torch.ops import fft_operator, identity_operator

    rng = np.random.default_rng(4)
    dvals = 0.5 * (rng.standard_normal(32) + 1j * rng.standard_normal(32)) / np.sqrt(2)
    x_true = (rng.standard_normal(32) + 1j * rng.standard_normal(32)) / np.sqrt(2)
    jsp, tsp = jt.Space((32,), jnp.complex128), tt.Space((32,), torch.complex128, CPU)
    jF, tF = j_fft(jsp), fft_operator(tsp)
    jA = (jF.H @ j_diagonal(jnp.asarray(dvals)) @ jF) + 2.0 * j_identity(jsp)
    tA = (tF.H @ diagonal_operator(dvals, device=CPU) @ tF) + 2.0 * identity_operator(tsp)
    b = np.asarray(jA(jnp.asarray(x_true)))
    np.testing.assert_allclose(tA(torch.from_numpy(x_true)).numpy(), b, rtol=1e-12, atol=1e-12)
    rj, rt = _run(j_gmres, gmres, jA, tA, b, maxiter=96, restart=16, tol=1e-13)
    _same_as_jax(rj, rt)
    np.testing.assert_allclose(rt.x.numpy(), x_true, atol=1e-8)
