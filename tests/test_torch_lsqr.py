"""The slice end to end: the port's LSQR on the seismic flagship held
against jets_tpu's, on the same operator (``wr`` lifted from the JAX
operator) and the same observed data.

Tolerances: float64 (both sides with x64) x and history at ``rtol=1e-10``;
float32 ``‖Δx‖/‖x‖ <= 1e-4`` and history at ``rtol=1e-4`` — the two
packages sum their norms in different orders, and f32 LSQR amplifies that
over 25 iterations.
"""
import numpy as np
import pytest
import torch

from jets_tpu.models.seismic import make_seismic_problem as jax_make_seismic_problem
from jets_tpu.solvers import lsqr as jax_lsqr
from jets_tpu_torch.models.seismic import seismic_operator_from_arrays
from jets_tpu_torch.ops import cuda_solver as cs
from jets_tpu_torch.solvers import LSQRState, lsqr
from jets_tpu_torch.solvers.krylov import _sym_ortho

CPU = torch.device("cpu")  # the tests build on the CPU, as a caller asks

SHAPE, NSHOTS, NRECV = (16, 16, 128), 4, 64


def lifted_problem(dtype, epilogue_hook=False):
    """The JAX flagship problem and the port's operator and data lifted
    from it (numpy in between)."""
    A_j, m_j, d_j = jax_make_seismic_problem(SHAPE, NSHOTS, NRECV, seed=1,
                                             noise=0.02, dtype=dtype)
    wr = np.asarray(A_j.jet.state["bstate"]["wr"])
    tdtype = torch.float32 if dtype == np.float32 else torch.float64
    A_t = seismic_operator_from_arrays(SHAPE, NSHOTS, NRECV, wr=wr, dtype=tdtype,
                                       epilogue_hook=epilogue_hook, device=CPU)
    return A_j, d_j, A_t, torch.from_numpy(np.array(d_j))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@pytest.mark.parametrize("damp", [0.0, 0.3])
def test_lsqr_matches_jax_f64(damp):
    A_j, d_j, A_t, d_t = lifted_problem(np.float64)
    r_j = jax_lsqr(A_j, d_j, maxiter=25, tol=0.0, damp=damp)
    r_t = lsqr(A_t, d_t, maxiter=25, tol=0.0, damp=damp)
    assert r_t.iterations == int(r_j.iterations) == 25
    x_j = np.asarray(r_j.x)
    np.testing.assert_allclose(r_t.x.numpy(), x_j, rtol=1e-10,
                               atol=1e-10 * float(np.max(np.abs(x_j))))
    np.testing.assert_allclose(r_t.history.numpy(), np.asarray(r_j.history),
                               rtol=1e-10)
    np.testing.assert_allclose(float(r_t.resnorm), float(r_j.resnorm), rtol=1e-10)


def test_lsqr_matches_jax_f32():
    A_j, d_j, A_t, d_t = lifted_problem(np.float32)
    r_j = jax_lsqr(A_j, d_j, maxiter=25, tol=0.0)
    r_t = lsqr(A_t, d_t, maxiter=25, tol=0.0)
    assert r_t.x.dtype == torch.float32
    assert _rel(r_t.x.numpy(), r_j.x) <= 1e-4
    np.testing.assert_allclose(r_t.history.numpy(), np.asarray(r_j.history),
                               rtol=1e-4)
    # the CPU run took the plain versions: nothing was launched
    assert cs.launch_counts() == {
        "xw_update": 0, "lap3d_axpy_norm2": 0, "laplacian3d": 0, "cg_update": 0,
        "p_update": 0, "lsmr_update": 0}


def test_lsqr_tol_stops_where_jax_stops():
    A_j, d_j, A_t, d_t = lifted_problem(np.float64)
    r_j = jax_lsqr(A_j, d_j, maxiter=25, tol=0.1)
    r_t = lsqr(A_t, d_t, maxiter=25, tol=0.1)
    assert 0 < r_t.iterations == int(r_j.iterations) < 25
    h = r_t.history.numpy()
    assert np.all(np.isinf(h[r_t.iterations:]))
    np.testing.assert_allclose(h, np.asarray(r_j.history), rtol=1e-10)


def test_lsqr_hook_path_matches_generic():
    """The epilogue hook (K2's plain version on the CPU) reproduces the
    generic adjoint-axpy-norm path exactly: same math, same order."""
    _, _, A_h, d = lifted_problem(np.float32, epilogue_hook=True)
    _, _, A_p, _ = lifted_problem(np.float32)
    assert "adjoint_axpy_norm" in A_h.jet.state
    r_h = lsqr(A_h, d, maxiter=25, tol=0.0)
    r_p = lsqr(A_p, d, maxiter=25, tol=0.0)
    assert torch.equal(r_h.x, r_p.x)
    assert torch.equal(r_h.history, r_p.history)


def test_lsqr_resume_equals_continuous_and_never_mutates_inputs():
    _, _, A, d = lifted_problem(np.float32)
    full = lsqr(A, d, maxiter=25, tol=0.0)
    part = lsqr(A, d, maxiter=10, tol=0.0)
    saved = [t.clone() if isinstance(t, torch.Tensor) else t for t in part.state]
    resumed = lsqr(A, d, maxiter=25, tol=0.0, state=part.state)
    assert resumed.iterations == 25
    assert torch.equal(resumed.x, full.x)
    assert torch.equal(resumed.history[10:], full.history[10:])
    assert bool(torch.isinf(resumed.history[:10]).all())
    # the state handed in is untouched, so it can be resumed from again
    for a, b in zip(part.state, saved):
        assert (torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b)
    again = lsqr(A, d, maxiter=25, tol=0.0, state=LSQRState(*part.state))
    assert torch.equal(again.x, full.x)
    # x0 is cloned, never updated in place
    x0 = torch.full(A.dom.shape, 0.01)
    x0_copy = x0.clone()
    warm = lsqr(A, d, x0, maxiter=5, tol=0.0)
    assert torch.equal(x0, x0_copy) and warm.x.data_ptr() != x0.data_ptr()


def test_sym_ortho_keeps_c_unit_when_squares_underflow():
    """A fault found against the reference: with ``sqrt(a**2 + b**2)`` the
    square of a ~1e-21 float32 ``rhobar`` is a denormal, so the damping
    rotation's ``|c|`` drifts from 1 and LSQR's residual estimate jumps
    once a problem has converged. ``hypot`` keeps ``|c| = 1`` exactly."""
    for a in (-1.6e-20, 6.5e-21, -2.83e-21, 1.2e-21, -3.27e-23):
        a = torch.tensor(a)
        c, s, r = _sym_ortho(a, torch.tensor(0.0))
        assert abs(float(c)) == 1.0 and float(s) == 0.0 and float(r) == abs(float(a))
    c, s, r = _sym_ortho(torch.tensor(3e-21), torch.tensor(12.0))
    assert 0.0 <= float(s) <= 1.0 and float(r) == 12.0
    c, s, r = _sym_ortho(torch.tensor(0.0), torch.tensor(0.0))
    assert (float(c), float(s), float(r)) == (1.0, 0.0, 0.0)
    # the old form drifts on the same input (the denormal square)
    a = torch.tensor(-8.448899718953876e-23)
    assert abs(float(a / torch.sqrt(a**2))) != 1.0


def test_lsqr_history_non_increasing_after_convergence():
    """Run far past convergence in float32 (rank <= 64): the residual
    estimate never increases."""
    _, _, A, d = lifted_problem(np.float32)
    r = lsqr(A, d, maxiter=120, tol=0.0)
    h = r.history
    assert bool(torch.isfinite(h).all())
    assert bool((h[1:] <= h[:-1]).all())
