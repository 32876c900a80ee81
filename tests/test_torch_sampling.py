"""The port's off-grid sampling operators (``jets_tpu_torch/ops/sampling.py``)
held against ``jets_tpu/ops/sampling.py`` on the CPU: the counterparts of
``tests/test_sampling.py``, with the JAX matrices and operators as the
reference on the same numpy inputs.

Tolerances: the weights are built in float64 numpy by the same code, so the
matrices agree bit for bit; products of float64 operators agree to
``rtol=1e-12`` (the sums are ordered differently), and the float64
dot-product gates hold to ``rtol=1e-12``, as in the JAX tests.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jets_tpu as jt
import jets_tpu_torch as tt
from jets_tpu.ops import sampling as js
from jets_tpu_torch.ops import (kaiser_sinc_matrix, sinc_point_sampling_operator,
                                sinc_sampling_operator)

CPU = torch.device("cpu")  # the tests build on the CPU, as a caller asks


def _randn(shape, seed):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(shape))


def _gate(A, seed):
    lhs, rhs = tt.dot_product_test(A, _randn(A.dom.shape, seed), _randn(A.rng.shape, seed + 1))
    assert abs(float(rhs)) > 0.0, "vacuous: zero gate"
    np.testing.assert_allclose(float(lhs), float(rhs), rtol=1e-12)


def test_on_grid_rows_are_one_hot_and_match_jax():
    W = kaiser_sinc_matrix(16, [3.0, 7.0, 12.0], radius=4, dtype=torch.float64, device=CPU)
    expect = np.zeros((3, 16))
    expect[0, 3] = expect[1, 7] = expect[2, 12] = 1.0
    np.testing.assert_allclose(W.numpy(), expect, atol=1e-12)
    for coords, radius in (([3.0, 7.0, 12.0], 4), ([0.3, 5.5, 15.9], 4), ([2.25, 9.75], 2)):
        got = kaiser_sinc_matrix(16, coords, radius=radius, dtype=torch.float64, device=CPU)
        ref = js.kaiser_sinc_matrix(16, coords, radius=radius, dtype=jnp.float64)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
        got32 = kaiser_sinc_matrix(16, coords, radius=radius, device=CPU)
        assert got32.dtype == torch.float32
        np.testing.assert_array_equal(got32.numpy(), np.asarray(
            js.kaiser_sinc_matrix(16, coords, radius=radius)))


def test_fractional_sampling_accuracy():
    # a bandlimited signal sampled at fractional offsets: r = 4 reconstructs
    # to ~1e-3 (Hicks 2002's design point)
    n = 128
    t = np.arange(n)

    def f(x):
        return np.sin(2 * np.pi * 3.7 * x / n) + 0.5 * np.cos(2 * np.pi * 7.3 * x / n)

    coords = np.linspace(20.25, 100.75, 37)
    W = kaiser_sinc_matrix(n, coords, radius=4, dtype=torch.float64, device=CPU)
    got = (W @ torch.from_numpy(f(t))).numpy()
    np.testing.assert_allclose(got, f(coords), atol=2e-3)
    ref = np.asarray(js.kaiser_sinc_matrix(n, coords, radius=4, dtype=jnp.float64)
                     @ jnp.asarray(f(t)))
    np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-14)


def test_separable_operator_gates_and_exactness():
    coords = [np.array([2.0, 5.5, 11.0]), np.array([1.0, 7.25, 13.0, 20.5])]
    sp = tt.Space((20, 24), torch.float64, CPU)
    A = sinc_sampling_operator(sp, coords)
    assert A.rng.shape == (3, 4) and A.rng.device == CPU
    m = _randn((20, 24), 0)
    out = A(m)
    np.testing.assert_allclose(float(out[0, 0]), float(m[2, 1]), atol=1e-12)
    np.testing.assert_allclose(float(out[2, 2]), float(m[11, 13]), atol=1e-12)
    Aj = js.sinc_sampling_operator(jt.Space((20, 24), jnp.float64), coords)
    np.testing.assert_allclose(out.numpy(), np.asarray(Aj(jnp.asarray(m.numpy()))),
                               rtol=1e-12, atol=1e-14)
    d = _randn((3, 4), 1)
    np.testing.assert_allclose(A.H(d).numpy(), np.asarray(Aj.H(jnp.asarray(d.numpy()))),
                               rtol=1e-12, atol=1e-14)
    _gate(A, 2)
    with pytest.raises(ValueError, match="one coordinate array per axis"):
        sinc_sampling_operator(sp, coords[:1])


def test_point_sampling_matches_separable_tensor_product():
    sp = tt.Space((14, 17), torch.float64, CPU)
    pts = np.array([[3.25, 4.5], [7.0, 10.75], [11.5, 2.0]])
    P = sinc_point_sampling_operator(sp, pts)
    m = _randn((14, 17), 3)
    got = P(m).numpy()
    Wz = kaiser_sinc_matrix(14, pts[:, 0], dtype=torch.float64, device=CPU).numpy()
    Wx = kaiser_sinc_matrix(17, pts[:, 1], dtype=torch.float64, device=CPU).numpy()
    expect = np.array([Wz[k] @ m.numpy() @ Wx[k] for k in range(3)])
    np.testing.assert_allclose(got, expect, rtol=1e-12)
    Pj = js.sinc_point_sampling_operator(jt.Space((14, 17), jnp.float64), pts)
    np.testing.assert_allclose(got, np.asarray(Pj(jnp.asarray(m.numpy()))), rtol=1e-12)
    _gate(P, 4)
    with pytest.raises(ValueError, match="points must be"):
        sinc_point_sampling_operator(sp, pts[:, :1])


def test_point_sampling_3d_and_materialize_adjoint():
    sp = tt.Space((6, 7, 8), torch.float64, CPU)
    pts = np.array([[2.5, 3.0, 4.25], [1.0, 5.5, 6.0]])
    P = sinc_point_sampling_operator(sp, pts)
    M = tt.materialize(P).numpy()
    assert M.shape == (2, 6 * 7 * 8)
    m = _randn((6, 7, 8), 5)
    np.testing.assert_allclose(P(m).numpy(), M @ m.numpy().ravel(), rtol=1e-12)
    Mj = np.asarray(jt.materialize(js.sinc_point_sampling_operator(
        jt.Space((6, 7, 8), jnp.float64), pts)))
    np.testing.assert_allclose(M, Mj, rtol=1e-12, atol=1e-15)
    d = _randn((2,), 6)
    np.testing.assert_allclose(P.H(d).numpy().ravel(), M.T @ d.numpy(), rtol=1e-12,
                               atol=1e-15)
