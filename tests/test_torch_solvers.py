"""The port's CG, CGLS and LSMR (jets_tpu_torch/solvers/krylov.py), the
normal operator and the Jacobi preconditioner (solvers/precond.py) and the
diagonal operator (ops/diagonal.py) held against jets_tpu on the seismic
flagship, on the same operator (``wr`` lifted from the JAX operator) and
the same observed data.

Tolerances: float64 (both sides with x64) x and history at ``rtol=1e-10``
(the port's ``hypot`` rotations in LSMR differ from JAX's ``sqrt(a²+b²)``
by an ulp); float32 ``‖Δx‖/‖x‖ <= 1e-4`` and history at ``rtol=1e-4`` —
the packages sum their norms in different orders, which 25 iterations
amplify (observed: CG on the normal operator 6e-5, LSMR 2e-7, CGLS 1e-7),
and undamped CG's residual history carries an absolute ``1e-5·h[0]`` once it
has fallen to float32 roundoff.
On the CPU the float32 solver tails take the kernels' plain versions, in
place, and launch nothing.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jets_tpu_torch as tt
from jets_tpu.models.seismic import make_seismic_problem as jax_make_seismic_problem
from jets_tpu.ops.diagonal import diagonal_operator as jax_diagonal_operator
from jets_tpu.solvers import cg as jax_cg
from jets_tpu.solvers import cgls as jax_cgls
from jets_tpu.solvers import lsmr as jax_lsmr
from jets_tpu.solvers.precond import estimate_diagonal as jax_estimate_diagonal
from jets_tpu.solvers.precond import jacobi_preconditioner as jax_jacobi
from jets_tpu.solvers.precond import normal_operator as jax_normal_operator
from jets_tpu_torch.models.seismic import seismic_operator_from_arrays
from jets_tpu_torch.ops import cuda_solver as cs
from jets_tpu_torch.ops.diagonal import diagonal_operator
from jets_tpu_torch.solvers import krylov
from jets_tpu_torch.solvers import (
    CGLSState,
    CGState,
    LSMRState,
    cg,
    cgls,
    estimate_diagonal,
    jacobi_preconditioner,
    lsmr,
    lsqr,
    normal_operator,
)

CPU = torch.device("cpu")  # the tests build on the CPU, as a caller asks

SHAPE, NSHOTS, NRECV = (16, 16, 128), 4, 64
ZERO = {"xw_update": 0, "lap3d_axpy_norm2": 0, "laplacian3d": 0, "cg_update": 0,
        "p_update": 0, "lsmr_update": 0}


def lifted_problem(dtype, epilogue_hook=False):
    """The JAX flagship problem and the port's operator and data lifted
    from it (numpy in between)."""
    A_j, _, d_j = jax_make_seismic_problem(SHAPE, NSHOTS, NRECV, seed=1, noise=0.02,
                                           dtype=dtype)
    wr = np.asarray(A_j.jet.state["bstate"]["wr"])
    tdtype = torch.float32 if dtype == np.float32 else torch.float64
    A_t = seismic_operator_from_arrays(SHAPE, NSHOTS, NRECV, wr=wr, dtype=tdtype,
                                       epilogue_hook=epilogue_hook, device=CPU)
    return A_j, d_j, A_t, torch.from_numpy(np.array(d_j))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _solve(name, A_j, d_j, A_t, d_t, damp, **kw):
    """One solver on both packages: CG on the damped normal operator with
    right-hand side ``A'd``, CGLS and LSMR on ``A`` with data ``d``."""
    if name == "cg":
        b_j = A_j.H(d_j)
        return (jax_cg(jax_normal_operator(A_j, damp), b_j, **kw),
                cg(normal_operator(A_t, damp), torch.from_numpy(np.array(b_j)), **kw))
    if name == "cgls":
        return jax_cgls(A_j, d_j, **kw), cgls(A_t, d_t, **kw)
    return jax_lsmr(A_j, d_j, damp=damp, **kw), lsmr(A_t, d_t, damp=damp, **kw)


CASES = [("cg", 0.0, False), ("cg", 0.3, False), ("cgls", 0.0, False),
         ("lsmr", 0.0, False), ("lsmr", 0.3, False), ("lsmr", 0.0, True),
         ("lsmr", 0.3, True)]


@pytest.mark.parametrize("name,damp,hook", CASES)
def test_solver_matches_jax_f64(name, damp, hook):
    A_j, d_j, A_t, d_t = lifted_problem(np.float64, hook)
    r_j, r_t = _solve(name, A_j, d_j, A_t, d_t, damp, maxiter=25, tol=0.0)
    assert r_t.iterations == int(r_j.iterations) == 25
    x_j = np.asarray(r_j.x)
    np.testing.assert_allclose(r_t.x.numpy(), x_j, rtol=1e-10,
                               atol=1e-10 * float(np.max(np.abs(x_j))))
    np.testing.assert_allclose(r_t.history.numpy(), np.asarray(r_j.history), rtol=1e-10)
    np.testing.assert_allclose(float(r_t.resnorm), float(r_j.resnorm), rtol=1e-10)


@pytest.mark.parametrize("name,damp,hook", CASES)
def test_solver_matches_jax_f32(name, damp, hook):
    cs.reset_launch_counts()
    A_j, d_j, A_t, d_t = lifted_problem(np.float32, hook)
    r_j, r_t = _solve(name, A_j, d_j, A_t, d_t, damp, maxiter=25, tol=0.0)
    assert r_t.x.dtype == torch.float32 and r_t.iterations == 25
    assert _rel(r_t.x.numpy(), r_j.x) <= 1e-4
    # once undamped CG on the singular normal operator has cut its residual
    # by five orders, float32 rounding sets the trailing digits of rnorm
    h_j = np.asarray(r_j.history)
    np.testing.assert_allclose(r_t.history.numpy(), h_j, rtol=1e-4, atol=1e-5 * h_j[0])
    assert cs.launch_counts() == ZERO  # the plain versions ran: nothing launched


def test_lsmr_hook_path_matches_generic():
    """The epilogue hook (K2's plain version on the CPU) reproduces the
    generic adjoint-axpy-norm path exactly under LSMR."""
    _, _, A_h, d = lifted_problem(np.float32, epilogue_hook=True)
    _, _, A_p, _ = lifted_problem(np.float32)
    r_h = lsmr(A_h, d, maxiter=25, tol=0.0, damp=0.3)
    r_p = lsmr(A_p, d, maxiter=25, tol=0.0, damp=0.3)
    assert torch.equal(r_h.x, r_p.x) and torch.equal(r_h.history, r_p.history)


def test_pcg_with_a_given_diagonal_matches_jax():
    """Preconditioned CG (generic tree updates, as in JAX) with the same
    diagonal handed to both packages' ``jacobi_preconditioner``."""
    A_j, d_j, A_t, _ = lifted_problem(np.float64)
    diag = np.asarray(jax_estimate_diagonal(A_j, jax.random.PRNGKey(3), nsamples=4))
    b_j = A_j.H(d_j)
    N_j, N_t = jax_normal_operator(A_j, 0.1), normal_operator(A_t, 0.1)
    r_j = jax_cg(N_j, b_j, maxiter=20, tol=0.0, M=jax_jacobi(A_j, jnp.asarray(diag)))
    cs.reset_launch_counts()
    r_t = cg(N_t, torch.from_numpy(np.array(b_j)), maxiter=20, tol=0.0,
             M=jacobi_preconditioner(A_t, torch.from_numpy(diag.copy())))
    assert r_t.iterations == 20
    np.testing.assert_allclose(r_t.x.numpy(), np.asarray(r_j.x), rtol=1e-10,
                               atol=1e-10 * float(np.max(np.abs(np.asarray(r_j.x)))))
    np.testing.assert_allclose(r_t.history.numpy(), np.asarray(r_j.history), rtol=1e-10)
    # the preconditioned branch stays on tree ops: no K6 (nor its plain version)
    assert cs.launch_counts() == ZERO


@pytest.mark.parametrize("name,tol", [("cg", 0.05), ("cgls", 0.05), ("lsmr", 0.02)])
def test_tol_stops_where_jax_stops(name, tol):
    A_j, d_j, A_t, d_t = lifted_problem(np.float64)
    r_j, r_t = _solve(name, A_j, d_j, A_t, d_t, 0.1, maxiter=60, tol=tol)
    assert 0 < r_t.iterations == int(r_j.iterations) < 60
    h = r_t.history.numpy()
    assert np.all(np.isinf(h[r_t.iterations:]))
    np.testing.assert_allclose(h, np.asarray(r_j.history), rtol=1e-10)


def _snapshot(tree):
    return [t.clone() if isinstance(t, torch.Tensor) else t for t in tree]


def _same(a, b):
    return all((torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y)
               for x, y in zip(a, b))


@pytest.mark.parametrize("name", ["cg", "cgls", "lsmr"])
def test_resume_equals_continuous_and_never_mutates_inputs(name):
    """In float32 the CG and LSMR tails update in place (the kernels' plain
    versions): a resumed run equals a continuous one, the state handed in
    stays as it was (so it can be resumed from twice), and neither ``b``
    nor ``x0`` is written."""
    _, _, A, d = lifted_problem(np.float32)
    if name == "cg":
        op, rhs, solve, St = normal_operator(A, 0.3), A.H(d), cg, CGState
    elif name == "cgls":
        op, rhs, solve, St = A, d, cgls, CGLSState
    else:
        op, rhs, solve, St = A, d, lsmr, LSMRState
    rhs0 = rhs.clone()
    full = solve(op, rhs, maxiter=20, tol=0.0)
    part = solve(op, rhs, maxiter=8, tol=0.0)
    saved = _snapshot(part.state)
    resumed = solve(op, rhs, maxiter=20, tol=0.0, state=part.state)
    assert resumed.iterations == 20
    assert torch.equal(resumed.x, full.x)
    assert torch.equal(resumed.history[8:], full.history[8:])
    assert bool(torch.isinf(resumed.history[:8]).all())
    assert _same(part.state, saved)
    again = solve(op, rhs, maxiter=20, tol=0.0, state=St(*part.state))
    assert torch.equal(again.x, full.x)
    x0 = torch.full(op.dom.shape, 0.01)
    warm = solve(op, rhs, x0, maxiter=5, tol=0.0)
    assert torch.equal(x0, torch.full(op.dom.shape, 0.01))
    assert warm.x.data_ptr() != x0.data_ptr()
    assert torch.equal(rhs, rhs0)


def test_cg_start_copies_r_into_p():
    """JAX starts CG with ``p = z = r`` (harmless for immutable arrays). The
    port's K6a writes r and K6b writes p in place, so p must be a copy: a
    shared buffer would corrupt both. The start state's p and r are
    distinct, and CG on an SPD diagonal converges to the exact solution."""
    w = torch.linspace(1.0, 4.0, 64).reshape(8, 8)
    D = diagonal_operator(w, device=CPU)
    b = torch.linspace(-1.0, 1.0, 64).reshape(8, 8)
    res0 = cg(D, b, maxiter=0, tol=0.0)
    assert res0.state.p.data_ptr() != res0.state.r.data_ptr()
    assert torch.equal(res0.state.p, res0.state.r)
    res = cg(D, b, maxiter=64, tol=1e-6)
    assert res.iterations < 64
    torch.testing.assert_close(res.x, b / w, rtol=1e-5, atol=1e-5)


def _strided(t):
    """``t``'s values in a transposed, non-contiguous layout."""
    out = torch.empty(t.shape[::-1], dtype=t.dtype).permute(*reversed(range(t.ndim)))
    assert not out.is_contiguous()
    return out.copy_(t)


def _tail_args(name):
    """Float32 arguments of one solver tail, the first vector strided."""
    g = torch.Generator().manual_seed(4)
    v = [torch.randn(6, 5, generator=g) for _ in range(4)]
    s = [torch.tensor(0.5), torch.tensor(-0.25), torch.tensor(2.0), torch.tensor(0.75)]
    v[0] = _strided(v[0])
    if name == "xw":
        return krylov._xw_update, (*v[:3], *s[:3])
    if name == "lsmr":
        return krylov._lsmr_model_update, (*v, *s)
    if name == "cg_xr":
        return krylov._cg_xr_update, (None, *v, s[0])
    return krylov._cg_p_update, (*v[:2], s[0])


@pytest.mark.parametrize("name", ["xw", "lsmr", "cg_xr", "p"])
def test_solver_tail_raises_on_a_non_contiguous_float32_member(name):
    """The tails route on dtype and shape only: a float32 member the
    kernels cannot take reaches the wrapper, which raises, and never slips
    onto the generic tree path."""
    fn, args = _tail_args(name)
    with pytest.raises(ValueError, match="contiguous"):
        fn(*args)


def _spy(monkeypatch):
    """Counts the calls of the solver tails' kernel wrappers."""
    calls = {}
    for name in ("xw_update", "cg_update", "p_update", "lsmr_update"):
        def wrapped(*a, _fn=getattr(krylov, name), _name=name):
            calls[_name] = calls.get(_name, 0) + 1
            return _fn(*a)
        monkeypatch.setattr(krylov, name, wrapped)
    return calls


@pytest.mark.parametrize("name", ["cg", "lsqr", "lsmr"])
def test_strided_inputs_are_copied_densely_and_take_the_kernels(name, monkeypatch):
    """A strided ``b``, ``x0`` or saved state reaches the kernels through
    the dense copies made on entry, and gives bitwise the same solve as the
    contiguous inputs."""
    _, _, A, d = lifted_problem(np.float32)
    op, rhs, solve = {"cg": (normal_operator(A, 0.3), A.H(d), cg),
                      "lsqr": (A, d, lsqr), "lsmr": (A, d, lsmr)}[name]
    x0 = torch.full(op.dom.shape, 0.01)
    ref = solve(op, rhs, x0, maxiter=6, tol=0.0)
    full = solve(op, rhs, maxiter=6, tol=0.0)
    part = solve(op, rhs, maxiter=3, tol=0.0)
    calls = _spy(monkeypatch)
    got = solve(op, _strided(rhs) if name == "cg" else rhs, _strided(x0), maxiter=6,
                tol=0.0)
    assert torch.equal(got.x, ref.x) and torch.equal(got.history, ref.history)
    want = {"cg": {"cg_update": 6, "p_update": 6}, "lsqr": {"xw_update": 6},
            "lsmr": {"lsmr_update": 6}}[name]
    assert calls == want
    state = type(part.state)(*(_strided(f) if isinstance(f, torch.Tensor) and f.ndim > 1
                               else f for f in part.state))
    calls.clear()
    resumed = solve(op, rhs, maxiter=6, tol=0.0, state=state)
    assert torch.equal(resumed.x, full.x)
    assert calls == {k: 3 for k in want}


@pytest.mark.parametrize("damp", [0.0, 0.7])
def test_normal_operator_passes_the_dot_product_gate(damp):
    _, _, A, _ = lifted_problem(np.float64)
    N = normal_operator(A, damp)
    g = torch.Generator().manual_seed(0)
    lhs, rhs = tt.dot_product_test(N, N.dom.randn(g), N.rng.randn(g))
    assert abs(float(rhs)) > 0.0
    np.testing.assert_allclose(float(lhs), float(rhs), rtol=1e-10)
    # A'A + damp² I, applied
    m = N.dom.randn(g)
    torch.testing.assert_close(N(m), A.H(A(m)) + damp * damp * m, rtol=1e-12, atol=0.0)


def test_estimate_diagonal_is_exact_on_a_diagonal_operator():
    """For ``A = diag(w)``, each Rademacher probe gives ``z ⊙ w²z = w²``
    exactly (``z = ±1``), whatever the draw; the mean of 8 probes is ``w²``
    up to the rounding of the running sum (``3w²``, ``5w²``, ... are not
    all exact): ``rtol=1e-15``."""
    w = torch.from_numpy(np.random.default_rng(5).uniform(0.5, 2.0, (6, 10)))
    D = diagonal_operator(w, device=CPU)
    for seed in (1, 2):
        est = estimate_diagonal(D, torch.Generator().manual_seed(seed), nsamples=8)
        torch.testing.assert_close(est, w * w, rtol=1e-15, atol=0.0)
    assert torch.equal(estimate_diagonal(D, torch.Generator().manual_seed(1), 1), w * w)
    M = jacobi_preconditioner(D, generator=torch.Generator().manual_seed(2), nsamples=8)
    m = torch.ones_like(w)
    torch.testing.assert_close(M(m), 1.0 / (w * w), rtol=1e-15, atol=0.0)
    assert torch.equal(M.H(m), M(m))


def test_jacobi_on_a_block_domain():
    """A BlockVector diagonal gives the generic elementwise (self-adjoint)
    operator, clamped at ``eps``."""
    sp = tt.Space((3, 4), torch.float64, CPU)
    bs = tt.BlockSpace([sp, sp])
    I = tt.LinearOperator(tt.Jet(dom=bs, rng=bs, df=lambda dm, m0, s: dm, dft="self"))
    diag = tt.BlockVector((torch.full((3, 4), 4.0), torch.zeros(3, 4).double()), bs)
    M = jacobi_preconditioner(I, tt.BlockVector((diag[0].double(), diag[1]), bs),
                              eps=0.5)
    out = M(bs.ones())
    assert isinstance(out, tt.BlockVector)
    assert torch.equal(out[0], torch.full((3, 4), 0.25, dtype=torch.float64))
    assert torch.equal(out[1], torch.full((3, 4), 2.0, dtype=torch.float64))
    est = estimate_diagonal(I, torch.Generator().manual_seed(0), nsamples=4)
    assert all(torch.equal(b, torch.ones(3, 4, dtype=torch.float64)) for b in est)


@pytest.mark.parametrize("dtype", [np.float64, np.complex128])
def test_diagonal_operator_matches_jax(dtype):
    rng = np.random.default_rng(6)
    shape = (5, 7)

    def draw():
        x = rng.standard_normal(shape)
        if dtype == np.complex128:
            x = x + 1j * rng.standard_normal(shape)
        return x.astype(dtype)

    w, m, d = draw(), draw(), draw()
    Dj, Dt = jax_diagonal_operator(jnp.asarray(w)), diagonal_operator(w, device=CPU)
    assert Dt.dom.shape == Dt.rng.shape == shape and Dt.dom.dtype == torch.from_numpy(w).dtype
    # real products round alike; complex ones are formed in another order
    # (a few ulp): rtol 1e-15
    tol = 0.0 if dtype == np.float64 else 1e-15
    np.testing.assert_allclose(Dt(torch.from_numpy(m)).numpy(), np.asarray(Dj(m)),
                               rtol=tol, atol=0.0)
    np.testing.assert_allclose(Dt.H(torch.from_numpy(d)).numpy(),
                               np.asarray(Dj.H(jnp.asarray(d))), rtol=tol, atol=0.0)
    g = torch.Generator().manual_seed(7)
    lhs, rhs = tt.dot_product_test(Dt, Dt.dom.randn(g), Dt.rng.randn(g))
    np.testing.assert_allclose(complex(lhs), complex(rhs), rtol=1e-12)
