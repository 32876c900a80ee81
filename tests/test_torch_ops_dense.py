"""The operators of BASELINE configs 1–3 (jets_tpu_torch/ops/matrix.py,
ops/conv.py, and stencil_operator/blur2d_operator of ops/stencil.py) and
the raw-matrix auto-wrap of the operator algebra (core/jet.py,
core/algebra.py), held against jets_tpu on the same numpy inputs.

Tolerances: float64 and complex128 on both sides (x64), forward and
adjoint at ``rtol=1e-12`` (the convolutions sum in another order than XLA's);
the port's own dot-product gate at ``rtol=1e-12`` and linearity gate at
``atol=1e-12`` relative to the output's size.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jets_tpu as jt
import jets_tpu_torch as tt
from jets_tpu.ops.conv import conv1d_operator as jax_conv1d
from jets_tpu.ops.conv import convnd_operator as jax_convnd
from jets_tpu.ops.conv import derivative_operator as jax_derivative
from jets_tpu.ops.conv import gradient_operator as jax_gradient
from jets_tpu.ops.diagonal import diagonal_operator as jax_diagonal
from jets_tpu.ops.matrix import matrix_operator as jax_matrix
from jets_tpu.ops.stencil import blur2d_operator as jax_blur2d
from jets_tpu.ops.stencil import stencil_operator as jax_stencil
from jets_tpu_torch.ops import (
    blur2d_operator,
    conv1d_operator,
    convnd_operator,
    derivative_operator,
    diagonal_operator,
    gradient_operator,
    matrix_operator,
    stencil_operator,
)

CPU = torch.device("cpu")  # the tests build on the CPU, as a caller asks


def _close(a, b, rtol=1e-12):
    a, b = np.asarray(a), np.asarray(b)
    np.testing.assert_allclose(a, b, rtol=rtol, atol=rtol * np.abs(b).max())


def _hold(ja, ta, seed=0):
    """Forward and adjoint of the pair agree on one random input each, and
    the port's operator passes its dot-product and linearity gates."""
    rng = np.random.default_rng(seed)
    cplx = ta.dom.dtype.is_complex

    def draw(shape):
        x = rng.standard_normal(shape)
        return x + 1j * rng.standard_normal(shape) if cplx else x

    m, d = draw(ta.dom.shape), draw(ta.rng.shape)
    tm, td = torch.from_numpy(m), torch.from_numpy(d)
    _close(ta(tm).numpy(), ja(jnp.asarray(m)))
    _close(ta.H(td).numpy(), ja.H(jnp.asarray(d)))
    lhs, rhs = tt.dot_product_test(ta, tm, td)
    np.testing.assert_allclose(complex(lhs), complex(rhs), rtol=1e-12)
    a, b = tt.linearity_test(ta, torch.Generator().manual_seed(seed))
    _close(a.numpy(), b.numpy())


@pytest.mark.parametrize("shape,dtype", [((7, 5), np.float64), ((6, 6), np.complex128),
                                         ((3, 9), np.float64)])
def test_matrix_operator_matches_jax(shape, dtype):
    rng = np.random.default_rng(1)
    M = rng.standard_normal(shape)
    if np.dtype(dtype).kind == "c":
        M = M + 1j * rng.standard_normal(shape)
    ta = matrix_operator(M.astype(dtype), device=CPU)
    assert ta.dom.shape == (shape[1],) and ta.rng.shape == (shape[0],)
    assert ta.dom.dtype == ta.rng.dtype == torch.from_numpy(M.astype(dtype)).dtype
    _hold(jax_matrix(jnp.asarray(M.astype(dtype))), ta)
    _close(tt.materialize(ta).numpy(), M)
    with pytest.raises(ValueError, match="2-D"):
        matrix_operator(np.ones(3), device=CPU)


@pytest.mark.parametrize("L", [2, 3, 4, 5, 6, 9])
def test_conv1d_matches_jax_and_numpy(L):
    """Even and odd kernel lengths: the 'same' crop is numpy's."""
    rng = np.random.default_rng(L)
    n, k = 21, rng.standard_normal(L)
    ta = conv1d_operator(k, n, torch.float64, device=CPU)
    _hold(jax_conv1d(jnp.asarray(k), n, jnp.float64), ta, seed=L)
    x = rng.standard_normal(n)
    _close(ta(torch.from_numpy(x)).numpy(), np.convolve(x, k, mode="same"))


@pytest.mark.parametrize("dx", [1.0, 0.3])
def test_derivative_matches_jax(dx):
    n = 12
    ta = derivative_operator(n, dx, torch.float64, device=CPU)
    _hold(jax_derivative(n, dx, jnp.float64), ta)
    dense = (np.eye(n, k=1) - np.eye(n)) / dx
    dense[-1] = 0.0
    _close(tt.materialize(ta).numpy(), dense)


@pytest.mark.parametrize("shape", [(9,), (5, 7), (4, 5, 6)])
def test_gradient_matches_jax(shape):
    ta = gradient_operator(tt.Space(shape, torch.float64, device=CPU), dx=0.5)
    assert ta.rng.shape == (len(shape),) + shape
    _hold(jax_gradient(jt.Space(shape, jnp.float64), dx=0.5), ta)


@pytest.mark.parametrize("shape,kshape", [
    ((17,), (4,)), ((17,), (5,)), ((9, 10), (4, 3)), ((9, 10), (3, 4)),
    ((6, 7, 8), (2, 3, 4)), ((6, 7, 8), (3, 2, 5)),
])
def test_convnd_matches_jax(shape, kshape):
    k = np.random.default_rng(len(shape)).standard_normal(kshape)
    ta = convnd_operator(k, tt.Space(shape, torch.float64, device=CPU))
    _hold(jax_convnd(jnp.asarray(k), jt.Space(shape, jnp.float64)), ta)
    with pytest.raises(ValueError, match="ndim"):
        convnd_operator(np.ones((3,)), tt.Space((4, 4), torch.float64, device=CPU))


def test_convnd_complex_matches_jax():
    rng = np.random.default_rng(3)
    k = rng.standard_normal((3, 4)) + 1j * rng.standard_normal((3, 4))
    ta = convnd_operator(k, tt.Space((8, 9), torch.complex128, device=CPU))
    _hold(jax_convnd(jnp.asarray(k), jt.Space((8, 9), jnp.complex128)), ta)


@pytest.mark.parametrize("shape,sshape", [
    ((15,), (3,)), ((15,), (4,)), ((10, 12), (3, 2)), ((10, 12), (2, 5)),
    ((6, 7, 8), (3, 3, 3)), ((6, 7, 8), (2, 4, 3)),
])
def test_stencil_matches_jax(shape, sshape):
    s = np.random.default_rng(7).standard_normal(sshape)
    ta = stencil_operator(tt.Space(shape, torch.float64, device=CPU), s)
    _hold(jax_stencil(jt.Space(shape, jnp.float64), jnp.asarray(s)), ta)


@pytest.mark.parametrize("radius", [1, 3])
def test_blur2d_matches_jax(radius):
    ta = blur2d_operator((24, 20), radius, torch.float64, device=CPU)
    ja = jax_blur2d((24, 20), radius, jnp.float64)
    _close(ta.jet.state["stencil"].numpy(), ja.jet.state["stencil"])
    _hold(ja, ta)
    assert float(ta.jet.state["stencil"].sum()) == pytest.approx(1.0, rel=1e-14)


def _pairs():
    rng = np.random.default_rng(5)
    w, M = rng.uniform(0.5, 2.0, 4), rng.standard_normal((4, 6))
    return jax_diagonal(jnp.asarray(w)), diagonal_operator(w, device=CPU), M


def _mat(ja_op, ta_op):
    return (np.asarray(jt.materialize(ja_op)), tt.materialize(ta_op).numpy())


def test_raw_matrix_autowraps_like_jax():
    """``@``, ``*``, ``compose``, ``add`` and ``block_operator`` wrap a raw
    2-D matrix that is not shaped like a domain member, as jets_tpu does."""
    jD, tD, M = _pairs()
    for jop, top in ((jD @ M, tD @ M), (jD * M, tD * M),
                     (jt.compose(jD, M), tt.compose(tD, M)),
                     (jt.compose(jD, M) + M[:, :4] @ M, tt.compose(tD, M) + M[:, :4] @ M)):
        assert top.dom.shape == (6,) and top.dom.device == CPU
        a, b = _mat(jop, top)
        _close(b, a)
    # a raw matrix sums with an operator, on either side
    N = M[:, :4]
    a, b = _mat(jt.add(jD, N), tt.add(tD, N))
    _close(b, a)
    a, b = _mat(jt.subtract(N, jD), tt.subtract(N, tD))
    _close(b, a)
    # a tensor wraps as an array does
    a, b = _mat(jD @ M, tD @ torch.from_numpy(M))
    _close(b, a)
    jB = jt.block_operator([[jD, N], [M.T @ N, jt.zero_block(jD.dom, jt.Space(
        (6,), jnp.float64))]])
    tB = tt.block_operator([[tD, N], [M.T @ N, tt.zero_block(tD.dom, tt.Space(
        (6,), torch.float64, device=CPU))]])
    a, b = _mat(jB, tB)
    _close(b, a)


def test_a_domain_shaped_array_is_applied_not_wrapped():
    """JAX's rule: a 2-D array shaped like a domain member is applied; any
    other 2-D array is wrapped, and composing it here fails on the spaces."""
    tS = stencil_operator(tt.Space((4, 5), torch.float64, device=CPU), np.ones((3, 3)))
    jS = jax_stencil(jt.Space((4, 5), jnp.float64), jnp.ones((3, 3)))
    x = np.random.default_rng(0).standard_normal((4, 5))
    _close((tS @ torch.from_numpy(x)).numpy(), jS @ jnp.asarray(x))
    _close((tS * torch.from_numpy(x)).numpy(), jS * jnp.asarray(x))
    for op in (jS, tS):
        with pytest.raises(ValueError, match="mismatch"):
            op @ np.ones((5, 2))


def test_autowrap_device_rules(monkeypatch):
    """An array goes to the device of the operators beside it, a tensor
    keeps its own, and a raw matrix with no operator beside it goes to the
    card (which, with none, raises)."""
    D = diagonal_operator(np.ones(3), device="meta")
    C = tt.compose(D, np.ones((3, 4)))
    assert C.dom.device == torch.device("meta")
    assert tt.add(np.ones((3, 3)), D).dom.device == torch.device("meta")
    assert tt.block_operator([[np.ones((3, 3)), D]]).dom.device == torch.device("meta")
    with pytest.raises(ValueError, match="mismatch"):
        tt.compose(D, torch.ones((3, 4)))  # a CPU tensor stays on the CPU
    with pytest.raises(ValueError, match="matching spaces"):
        tt.add(torch.ones((3, 3)), D)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for lone in (lambda: tt.block_operator([[np.eye(2), np.eye(2)]]),
                 lambda: tt.vec(np.eye(2)), lambda: tt.compose(np.eye(2), np.eye(2))):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            lone()
    with pytest.raises(TypeError):
        tt.compose(D, np.ones((3, 3, 3)))
