"""Core of the port (spaces, jets, algebra, gates) held against jets_tpu on
the same numpy inputs.

Tolerances: float64 on both sides (the test session runs JAX with x64) at
``rtol=1e-12``; float32 inner products and norms at ``rtol=1e-5`` (the two
packages sum in different orders).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jets_tpu as jt
import jets_tpu_torch as tt
from jets_tpu.ops.diagonal import diagonal_operator as jax_diagonal
from jets_tpu.ops.stencil import laplacian_operator as jax_laplacian
from jets_tpu_torch.ops.diagonal import diagonal_operator
from jets_tpu_torch.ops.stencil import laplacian_operator

CPU = torch.device("cpu")  # the tests build on the CPU, as a caller asks


def _diag(w):
    """The port's diagonal operator (jets_tpu_torch.ops.diagonal) on the CPU."""
    return diagonal_operator(w, device=CPU)


def _square(sp):
    """Nonlinear ``m -> m**2`` with its tangent at ``m0``."""
    return tt.Operator(tt.Jet(
        dom=sp, rng=sp, f=lambda m, s: m**2,
        df=lambda dm, m0, s: 2 * m0 * dm, dft="self"))


@pytest.mark.parametrize("dtype,rtol", [
    (np.float32, 1e-5), (np.float64, 1e-12), (np.complex128, 1e-12),
])
def test_space_dot_and_norms_match_jax(dtype, rtol):
    rng = np.random.default_rng(0)
    shape = (6, 7, 33)
    x, y = (rng.standard_normal(shape) for _ in range(2))
    if np.dtype(dtype).kind == "c":
        x = x + 1j * rng.standard_normal(shape)
        y = y + 1j * rng.standard_normal(shape)
    x, y = x.astype(dtype), y.astype(dtype)
    js = jt.Space(shape, dtype)
    ts = tt.Space(shape, torch.from_numpy(x).dtype, device=CPU)
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    np.testing.assert_allclose(ts.dot(tx, ty).numpy(),
                               np.asarray(js.dot(jnp.asarray(x), jnp.asarray(y))),
                               rtol=rtol)
    for p in (2, float("inf"), 1):
        np.testing.assert_allclose(float(ts.norm(tx, p)),
                                   float(js.norm(jnp.asarray(x), p)), rtol=rtol)


def test_space_allocators_and_identity():
    sp = tt.Space((3, 4), torch.float64, device=CPU)
    assert sp.shape == (3, 4) and sp.size == 12 and sp.ndim == 2 and len(sp) == 12
    assert sp.device == torch.device("cpu")
    assert sp == tt.Space([3, 4], torch.float64, "cpu")
    assert sp != tt.Space((3, 4), torch.float32, device=CPU)
    assert hash(sp) == hash(tt.Space((3, 4), torch.float64, device=CPU))
    assert torch.equal(sp.zeros(), torch.zeros(3, 4, dtype=torch.float64))
    assert torch.equal(sp.ones(), torch.ones(3, 4, dtype=torch.float64))
    g1, g2 = torch.Generator().manual_seed(7), torch.Generator().manual_seed(7)
    a, b = sp.randn(g1), sp.randn(g2)
    assert a.dtype == torch.float64 and torch.equal(a, b)
    u = sp.rand(g1)
    assert bool((u >= 0).all() and (u < 1).all())
    assert sp.reshape(np.arange(12.0)).shape == (3, 4)
    with pytest.raises(ValueError):
        sp.reshape(np.arange(5.0))
    with pytest.raises(AttributeError):
        sp._shape = (1,)


def test_jet_defaulting_rules():
    sp = tt.Space((5,), torch.float64, device=CPU)
    M = torch.from_numpy(np.random.default_rng(1).standard_normal((5, 5)))
    lin = lambda dm, m0, s: s["M"] @ dm  # noqa: E731
    # no f: linear, f is df
    A = tt.LinearOperator(tt.Jet(dom=sp, rng=sp, df=lin, state={"M": M}))
    x = torch.arange(5.0, dtype=torch.float64)
    assert torch.equal(A.jet.apply_f(x), M @ x)
    # no df: f is linear and its own tangent
    B = tt.LinearOperator(tt.Jet(dom=sp, rng=sp, f=lambda m, s: s["M"] @ m,
                                 state={"M": M}))
    assert torch.equal(B(x), M @ x)
    # dft="self": the tangent is reused as the adjoint
    S = tt.LinearOperator(tt.Jet(dom=sp, rng=sp, df=lin, dft="self",
                                 state={"M": M}))
    assert torch.equal(S.H(x), M @ x)
    with pytest.raises(ValueError):
        tt.Jet(dom=sp, rng=sp)
    with pytest.raises(AttributeError):
        A.jet.f = None


def test_derived_adjoint_matches_jax_and_passes_gate():
    """``dft=None`` is derived by torch.func.vjp, as jets_tpu derives it by
    jax.linear_transpose; real and complex."""
    rng = np.random.default_rng(2)
    for dtype in (np.float64, np.complex128):
        M = rng.standard_normal((4, 6)).astype(dtype)
        d = rng.standard_normal(4).astype(dtype)
        m = rng.standard_normal(6).astype(dtype)
        if dtype == np.complex128:
            M = M + 1j * rng.standard_normal((4, 6))
            d = d + 1j * rng.standard_normal(4)
            m = m + 1j * rng.standard_normal(6)
        ja = jt.LinearOperator(jt.Jet(
            dom=jt.Space((6,), dtype), rng=jt.Space((4,), dtype),
            df=lambda dm, m0, s: s["M"] @ dm, state={"M": jnp.asarray(M)}))
        tdt = torch.from_numpy(M).dtype
        ta = tt.LinearOperator(tt.Jet(
            dom=tt.Space((6,), tdt, device=CPU), rng=tt.Space((4,), tdt, device=CPU),
            df=lambda dm, m0, s: s["M"] @ dm, state={"M": torch.from_numpy(M)}))
        np.testing.assert_allclose(ta.H(torch.from_numpy(d)).numpy(),
                                   np.asarray(ja.H(jnp.asarray(d))), rtol=1e-12)
        lhs, rhs = tt.dot_product_test(ta, torch.from_numpy(m), torch.from_numpy(d))
        np.testing.assert_allclose(complex(lhs), complex(rhs), rtol=1e-12)


def _pair(expr):
    """Build the same operator expression with both packages; return the
    two dense matrices."""
    rng = np.random.default_rng(3)
    shape = (3, 4)
    w1, w2, w3 = (rng.standard_normal(shape) for _ in range(3))
    J = dict(D1=jax_diagonal(jnp.asarray(w1)), D2=jax_diagonal(jnp.asarray(w2)),
             D3=jax_diagonal(jnp.asarray(w3)), L=jax_laplacian(shape, jnp.float64))
    T = dict(D1=_diag(w1), D2=_diag(w2), D3=_diag(w3),
             L=laplacian_operator(shape, torch.float64, device=CPU))
    return expr(**J), expr(**T)


@pytest.mark.parametrize("name,expr", [
    ("compose", lambda D1, D2, D3, L: (D1 @ L) @ (D2 @ D3)),
    ("sum_signs", lambda D1, D2, D3, L: D1 - (L - (D2 - D3))),
    ("scale", lambda D1, D2, D3, L: 2.5 * (L @ D1) - D2 * -0.5),
    ("adjoint_mix", lambda D1, D2, D3, L: (D1 @ L).H + (-D3) @ L),
])
def test_algebra_matches_jax_materialize(name, expr):
    ja, ta = _pair(expr)
    np.testing.assert_allclose(tt.materialize(ta).numpy(),
                               np.asarray(jt.materialize(ja)), rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_allclose(tt.materialize(ta.H).numpy(),
                               np.asarray(jt.materialize(ja.H)), rtol=1e-12,
                               atol=1e-12)


def test_algebra_structure_bookkeeping():
    ja, ta = _pair(lambda D1, D2, D3, L: D1 - (L - (D2 - D3)))
    assert tt.is_sum(ta) and len(ta.jet.state["ops"]) == 4
    assert ta.jet.state["sgns"] == ja.jet.state["sgns"] == (1, -1, 1, -1)
    ja, ta = _pair(lambda D1, D2, D3, L: (D1 @ L) @ (D2 @ D3))
    assert tt.is_composite(ta) and len(ta.jet.state["ops"]) == 4
    with pytest.raises(ValueError, match="mismatch"):
        tt.compose(_diag(np.ones(3)), _diag(np.ones(4)))
    with pytest.raises(ValueError, match="matching spaces"):
        _diag(np.ones(3)) + _diag(np.ones(4))
    # a raw 2-D matrix is wrapped as jets_tpu wraps it; a 3-D array is not
    M = np.arange(12.0).reshape(3, 4)
    np.testing.assert_allclose(
        tt.materialize(tt.compose(_diag(np.arange(1.0, 4.0)), M)).numpy(),
        np.asarray(jt.materialize(jt.compose(jax_diagonal(jnp.arange(1.0, 4.0)), M))),
        rtol=1e-12)
    with pytest.raises(TypeError):
        tt.compose(_diag(np.ones(3)), np.ones((3, 3, 3)))
    with pytest.raises(TypeError, match="complex"):
        tt.scale(1j, _diag(np.ones(3)))
    V = tt.vec(laplacian_operator((3, 4), torch.float64, device=CPU))
    assert V.dom.shape == (12,) and V.rng.shape == (12,)
    assert tt.vec(V) is V


def test_state_lookup_perfstat_close_and_linearize():
    D1, D2 = _diag(np.ones(3)), _diag(2 * np.ones(3))
    with pytest.raises(KeyError, match="ambiguous"):
        tt.state(D1 @ D2, "w")
    L = laplacian_operator((3,), torch.float64, device=CPU)
    assert torch.equal(tt.state(L @ D1, "w"), torch.ones(3, dtype=torch.float64))
    with pytest.raises(KeyError):
        tt.state(L @ D1, "nope")
    D3 = tt.with_state(D1, w=3 * torch.ones(3, dtype=torch.float64))
    assert torch.equal(D3(torch.ones(3, dtype=torch.float64)),
                       3 * torch.ones(3, dtype=torch.float64))
    assert torch.equal(D1.state["w"], torch.ones(3, dtype=torch.float64))

    stats, closed = {"mflops": 1}, []
    sp = tt.Space((3,), torch.float64, device=CPU)
    I = tt.LinearOperator(tt.Jet(dom=sp, rng=sp, df=lambda dm, m0, s: dm,
                                 dft="self", perfstat=lambda j: stats,
                                 close=lambda j: closed.append("I")))
    assert tt.perfstat(D1) is None and tt.perfstat(D1 @ I) is stats
    tt.close(D1 + I)
    assert closed == ["I"]

    F = _square(sp)
    m1 = torch.arange(1.0, 4.0, dtype=torch.float64)
    J1, J2 = tt.linearize(F, m1), tt.jacobian(F, 2 * m1)
    assert J1 is not J2 and tt.point(J1) is m1
    assert torch.equal(J1(torch.ones(3, dtype=torch.float64)), 2 * m1)
    assert torch.equal(J2(torch.ones(3, dtype=torch.float64)), 4 * m1)
    assert tt.adjoint(J1).H is J1


def test_gates_on_port_operators():
    """The three gates on the port's own operators: the dot-product gate on
    the Laplacian (both impls, 3-D f32) and on a composite, the linearity
    gate, and the linearization gate on a nonlinear operator."""
    g = torch.Generator().manual_seed(0)
    shape = (8, 16, 128)
    for impl in ("torch", "kernel"):
        L = laplacian_operator(shape, torch.float32, impl=impl, device=CPU)
        lhs, rhs = tt.dot_product_test(L, L.dom.randn(g), L.rng.randn(g))
        np.testing.assert_allclose(float(lhs), float(rhs), rtol=1e-4)
    C = laplacian_operator((5, 6), torch.float64, device=CPU) @ _diag(np.arange(30.0).reshape(5, 6))
    lhs, rhs = tt.dot_product_test(C, C.dom.randn(g), C.rng.randn(g))
    np.testing.assert_allclose(float(lhs), float(rhs), rtol=1e-12)
    a, b = tt.linearity_test(C, g)
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-12, atol=1e-12)
    sp = tt.Space((20,), torch.float64, device=CPU)
    obs, exp = tt.linearization_test(_square(sp) @ _diag(np.linspace(1, 2, 20)),
                                     sp.randn(g), generator=g)
    np.testing.assert_allclose(obs.numpy(), exp.numpy(), rtol=1e-6)


def test_laplacian_operator_impls_and_errors():
    z = torch.from_numpy(np.random.default_rng(6).standard_normal((4, 8, 32))
                         .astype(np.float32))
    Lk = laplacian_operator(z.shape, torch.float32, impl="kernel", device=CPU)
    Lt = laplacian_operator(z.shape, torch.float32, device=CPU)
    assert torch.equal(Lk(z), Lt(z)) and torch.equal(Lk.H(z), Lt(z))
    L2 = laplacian_operator((6, 7), torch.float32, impl="kernel", device=CPU)  # 2-D: torch
    assert L2.jet.df is Lt.jet.df
    with pytest.raises(ValueError, match="3-D float32"):
        laplacian_operator((4, 8, 32), torch.float64, impl="kernel", device=CPU)
    with pytest.raises(ValueError, match="order=2"):
        laplacian_operator((4, 8, 32), impl="kernel", order=4, device=CPU)
    with pytest.raises(ValueError, match="order"):
        laplacian_operator((4, 8, 32), order=6, device=CPU)
    with pytest.raises(ValueError, match="impl"):
        laplacian_operator((4, 8, 32), impl="pallas", device=CPU)
    m = z.double()
    np.testing.assert_array_equal(
        laplacian_operator(m.shape, torch.float64, order=8, device=CPU)(m).numpy(),
        np.asarray(jax_laplacian(m.shape, jnp.float64, order=8)(jnp.asarray(m.numpy()))),
    )
