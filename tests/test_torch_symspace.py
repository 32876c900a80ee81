"""Symmetric spaces (jets_tpu_torch/core/spaces.py: ``SymmetricSpace``,
``MappedSymmetricSpace``, ``symspace``, ``randperm``) held against jets_tpu
on the same numpy arrays: the symmetric-space cases of
tests/test_spaces.py and the cases of tests/test_symspace.py, plus the
weights' device and dtype.

Tolerances: float64 and complex128 on both sides; dots and norms at
``rtol=1e-12`` against JAX and against the full-spectrum numpy values,
logical views at ``atol=1e-12`` (``1e-11`` in n-D). ``randperm`` draws
with ``torch.randperm``, whose numbers differ from ``jax.random``'s, so
only its contract is held: a permutation, and a sorted distinct
``k``-sample.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jets_tpu as jt
import jets_tpu_torch as tt
from jets_tpu_torch.core.jet import Jet, LinearOperator

CPU = torch.device("cpu")  # the tests build on the CPU, as a caller asks
C128 = torch.complex128


def _crand(shape, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


def _t(a):
    return torch.from_numpy(np.asarray(a))


# ------------------------------------------------ SymmetricSpace


@pytest.mark.parametrize("n", [8, 9])
@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
def test_symmetric_space_weights_device_and_dtype(n, dtype):
    """DC and (even n) Nyquist count once, the other bins twice; the
    weights are the space's real dtype on its device."""
    sp = tt.SymmetricSpace((n // 2 + 1,), (n,), dtype, device=CPU)
    w = sp._weights()
    assert w.dtype == (torch.float32 if dtype == torch.complex64 else torch.float64)
    assert w.device == CPU
    want = np.full(n // 2 + 1, 2.0)
    want[0] = 1.0
    if n % 2 == 0:
        want[-1] = 1.0
    np.testing.assert_array_equal(w.numpy(), want)
    x = torch.ones(n // 2 + 1, dtype=dtype)
    assert float(sp.norm(x)) == pytest.approx(np.sqrt(n), rel=1e-6)
    d = sp.dot(x, x)
    assert d.dtype == dtype and d.ndim == 0 and d.device == CPU
    assert complex(d) == pytest.approx(n, rel=1e-6)
    with pytest.raises(ValueError):
        tt.SymmetricSpace((n // 2,), (n,), dtype, device=CPU)  # wrong stored length


@pytest.mark.parametrize("n", [15, 16])
def test_symmetric_space_dot_and_norms_match_jax_and_full_spectrum(n):
    rng = np.random.default_rng(n)
    a, b = rng.standard_normal(n), rng.standard_normal(n)
    A, B = np.fft.rfft(a), np.fft.rfft(b)
    jsp = jt.SymmetricSpace((n // 2 + 1,), (n,), jnp.complex128)
    tsp = tt.SymmetricSpace((n // 2 + 1,), (n,), C128, device=CPU)
    assert complex(tsp.dot(_t(A), _t(B))) == pytest.approx(
        complex(np.vdot(np.fft.fft(a), np.fft.fft(b))), rel=1e-12)
    # non-Hermitian members too: the weighted dot and the norms of every order
    x, y = _crand(n // 2 + 1, 1), _crand(n // 2 + 1, 2)
    assert complex(tsp.dot(_t(x), _t(y))) == pytest.approx(
        complex(jsp.dot(jnp.asarray(x), jnp.asarray(y))), rel=1e-12)
    for p in (2, 1, 3, 0, np.inf, -np.inf):
        assert float(tsp.norm(_t(x), p)) == pytest.approx(
            float(jsp.norm(jnp.asarray(x), p)), rel=1e-12)
    assert float(tsp.norm(_t(A))) == pytest.approx(np.linalg.norm(np.fft.fft(a)), rel=1e-12)


def test_symmetric_space_allocators_and_equality():
    sp = tt.SymmetricSpace((9,), (16,), C128, device=CPU)
    z = sp.zeros()
    assert z.shape == (9,) and z.dtype == C128
    assert sp.randn(torch.Generator().manual_seed(0)).dtype == C128
    assert sp == tt.SymmetricSpace((9,), (16,), C128, device=CPU)
    assert hash(sp) == hash(tt.SymmetricSpace((9,), (16,), C128, device=CPU))
    assert sp != tt.Space((9,), C128, device=CPU)
    assert sp != tt.SymmetricSpace((9,), (17,), C128, device=CPU)
    assert sp.logical_shape == (16,) and sp.axis == 0
    with pytest.raises(AttributeError):
        sp.axis = 1


@pytest.mark.parametrize("n", [8, 9])
def test_rfft_to_logical_matches_full_fft_1d(n):
    x = np.random.default_rng(n).standard_normal(n)
    sp = tt.SymmetricSpace((n // 2 + 1,), (n,), C128, device=CPU)
    full = sp.to_logical(_t(np.fft.rfft(x))).numpy()
    np.testing.assert_allclose(full, np.fft.fft(x), atol=1e-12)
    np.testing.assert_allclose(sp.from_logical(_t(np.fft.fft(x))).numpy(), np.fft.rfft(x),
                               atol=1e-12)


@pytest.mark.parametrize("shape", [(6, 8), (5, 9), (4, 6, 8)])
def test_rfft_to_logical_matches_full_fft_nd_and_jax(shape):
    """n-D: the mirrored bins reflect EVERY axis modularly; the logical
    view of a non-Hermitian member equals JAX's."""
    x = np.random.default_rng(sum(shape)).standard_normal(shape)
    stored = shape[:-1] + (shape[-1] // 2 + 1,)
    sp = tt.SymmetricSpace(stored, shape, C128, axis=-1, device=CPU)
    jsp = jt.SymmetricSpace(stored, shape, jnp.complex128, axis=-1)
    np.testing.assert_allclose(sp.to_logical(_t(np.fft.rfftn(x))).numpy(), np.fft.fftn(x),
                               atol=1e-11)
    np.testing.assert_allclose(sp.from_logical(_t(np.fft.fftn(x))).numpy(), np.fft.rfftn(x),
                               atol=1e-11)
    z = _crand(stored, 3)
    np.testing.assert_array_equal(sp.to_logical(_t(z)).numpy(),
                                  np.asarray(jsp.to_logical(jnp.asarray(z))))


# ------------------------------------------------ symspace: arbitrary maps


def _rfft_map(n):
    def index_map(out_idx):
        (i,) = out_idx
        return ((n - i) % n,)

    return index_map


def _reflection_map(n):
    """A NON-rfft Hermitian redundancy: pure reflection i -> n-1-i."""

    def index_map(out_idx):
        (i,) = out_idx
        return (n - 1 - i,)

    return index_map


def test_symspace_reproduces_rfft_semantics():
    n = 16
    rng = np.random.default_rng(2)
    A = _t(np.fft.rfft(rng.standard_normal(n)))
    B = _t(np.fft.rfft(rng.standard_normal(n)))
    dedicated = tt.SymmetricSpace((n // 2 + 1,), (n,), C128, device=CPU)
    generic = tt.symspace((n // 2 + 1,), (n,), C128, _rfft_map(n), device=CPU)
    assert isinstance(generic, tt.MappedSymmetricSpace)
    assert complex(generic.dot(A, B)) == pytest.approx(complex(dedicated.dot(A, B)), rel=1e-12)
    assert float(generic.norm(A)) == pytest.approx(float(dedicated.norm(A)), rel=1e-12)
    np.testing.assert_allclose(generic.to_logical(A).numpy(), dedicated.to_logical(A).numpy(),
                               atol=1e-12)


@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
def test_symspace_arbitrary_map_matches_jax_and_full_spectrum(dtype):
    """dot and norm of the mapped space equal the unweighted ones of the
    expanded logical array, for a non-rfft map, and JAX's; the mirror
    counts are the space's real dtype."""
    n, h = 12, 6
    sp = tt.symspace((h,), (n,), dtype, _reflection_map(n), device=CPU)
    jsp = jt.symspace((h,), (n,), jnp.complex128, _reflection_map(n))
    assert sp._c.dtype == (torch.float32 if dtype == torch.complex64 else torch.float64)
    x, y = (_t(_crand(h, s)).to(dtype) for s in (4, 5))
    X, Y = sp.to_logical(x), sp.to_logical(y)
    assert X.shape == (n,)
    np.testing.assert_array_equal(X[h:].numpy(), np.conj(X[:h].numpy())[::-1])
    rtol = 1e-12 if dtype == C128 else 1e-6
    assert complex(sp.dot(x, y)) == pytest.approx(complex(torch.vdot(X, Y)), rel=rtol)
    assert float(sp.norm(x)) == pytest.approx(float(torch.linalg.vector_norm(X)), rel=rtol)
    jx, jy = jnp.asarray(x.numpy()), jnp.asarray(y.numpy())
    assert complex(sp.dot(x, y)) == pytest.approx(complex(jsp.dot(jx, jy)), rel=rtol)
    for p in (2, 1, 0, np.inf):
        assert float(sp.norm(x, p)) == pytest.approx(float(jsp.norm(jx, p)), rel=rtol)
    np.testing.assert_array_equal(sp.from_logical(X).numpy(), x.numpy())


def test_symspace_2d_map():
    n1, n2 = 4, 8

    def index_map(out_idx):
        i, j = out_idx
        return ((n1 - i) % n1, (n2 - j) % n2)

    sp = tt.symspace((n1, n2 // 2 + 1), (n1, n2), C128, index_map, device=CPU)
    x = np.random.default_rng(3).standard_normal((n1, n2))
    A = _t(np.fft.rfftn(x))
    np.testing.assert_allclose(sp.to_logical(A).numpy(), np.fft.fftn(x), atol=1e-11)
    assert float(sp.norm(A)) == pytest.approx(np.linalg.norm(np.fft.fftn(x)), rel=1e-12)


def test_symspace_operator_gate():
    """An operator whose RANGE is a mapped symmetric space passes the
    dot-product gate with the adjoint written through the logical view."""
    n = 16
    dom = tt.Space((n,), torch.float64, CPU)
    rng_sp = tt.symspace((n // 2 + 1,), (n,), C128, _rfft_map(n), device=CPU)

    def df(dm, m0, state):
        return torch.fft.rfft(dm)

    def dft(dd, m0, state):
        return n * torch.real(torch.fft.ifft(rng_sp.to_logical(dd)))

    A = LinearOperator(Jet(dom=dom, rng=rng_sp, df=df, dft=dft))
    g = torch.Generator().manual_seed(5)
    lhs, rhs = tt.dot_product_test(A, dom.randn(g), rng_sp.randn(g))
    assert complex(lhs) == pytest.approx(complex(rhs), rel=1e-11)


def test_symspace_validation():
    with pytest.raises(ValueError):
        tt.symspace((6,), (12,), C128, None, device=CPU)  # no map
    with pytest.raises(ValueError):
        tt.symspace((4,), (12,), C128, lambda out: (out[0],), device=CPU)  # outside
    with pytest.raises(ValueError):
        tt.symspace((13,), (12,), C128, _rfft_map(12), device=CPU)
    with pytest.raises(ValueError):
        tt.symspace((4, 4), (12,), C128, _rfft_map(12), device=CPU)  # ndim


def test_vec_refuses_nd_mapped_space():
    n1, n2 = 4, 8

    def index_map(out_idx):
        i, j = out_idx
        return ((n1 - i) % n1, (n2 - j) % n2)

    rng_sp = tt.symspace((n1, n2 // 2 + 1), (n1, n2), C128, index_map, device=CPU)
    A = LinearOperator(Jet(
        dom=tt.Space((n1, n2), torch.float64, CPU), rng=rng_sp,
        df=lambda dm, m0, s: torch.fft.rfftn(dm),
        dft=lambda dd, m0, s: torch.real(torch.fft.ifftn(rng_sp.to_logical(dd))) * (n1 * n2)))
    with pytest.raises(NotImplementedError):
        tt.vec(A)


# ------------------------------------------------ randperm


@pytest.mark.parametrize("k", [None, 4])
def test_randperm_contract(k):
    sp = tt.Space((10,), device=CPU)
    p = tt.randperm(torch.Generator().manual_seed(0), sp, k)
    assert p.device == CPU and p.dtype == torch.int64
    pl = p.tolist()
    if k is None:
        assert sorted(pl) == list(range(10))
    else:
        assert len(pl) == 4 and pl == sorted(pl) and len(set(pl)) == 4
        assert set(pl) <= set(range(10))
    # the same generator state gives the same draw
    assert torch.equal(p, tt.randperm(torch.Generator().manual_seed(0), sp, k))
