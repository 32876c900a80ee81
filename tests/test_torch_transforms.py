"""The FFT, DCT and structural operators (jets_tpu_torch/ops/fft.py and
ops/transforms.py) held against jets_tpu on the same numpy inputs: each
constructor's forward and adjoint, the port's own dot-product and
linearity gates, and the cases of tests/test_ops.py (FFT gates,
unitarity, Parseval on the symmetric space, transform gates),
tests/test_dsp.py (reshape, real and imaginary parts, transpose, flip,
permutation) and tests/test_jetpack_extra.py (circular shift,
projection) that cover these modules.

Each case is built by the same code through both packages (``J`` and
``T``, tests/_torch_parity.py). Tolerances: float64 and complex128 on both
sides, forward and adjoint at ``rtol=1e-12`` against JAX's jitted
programs; the data-movement operators bitwise. The
DCT has no PyTorch call; the port's FFT form is held against
``jax.scipy.fft.dct`` at ``1e-12`` relative in float64 and ``2e-6`` in
float32, at odd and even lengths, and against an explicit orthonormal
DCT-II matrix. The rfft adjoint is fed a random member of the
symmetric space, whose DC and Nyquist bins are not real: the port zeroes
their imaginary parts as NumPy's and JAX's inverse transforms drop them.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jets_tpu as jt
import jets_tpu.ops as jops
import jets_tpu_torch as tt
import jets_tpu_torch.ops as tops
from _torch_parity import CPU, close, draw, hold


CASES = {
    # tests/test_ops.py: the FFT gates
    "fft2d": lambda P: P.ops.fft_operator(P.space((8, 8), P.c128)),
    "rfft_even": lambda P: P.ops.rfft_operator(P.space((16,))),
    "rfft_odd": lambda P: P.ops.rfft_operator(P.space((15,))),
    "rfft_2d": lambda P: P.ops.rfft_operator(P.space((6, 10))),
    "rfft_3d_odd": lambda P: P.ops.rfft_operator(P.space((3, 5, 7))),
    # tests/test_ops.py: the transform gates
    "dct3d": lambda P: P.ops.dct_operator(P.space((3, 7, 4))),
    "identity": lambda P: P.ops.identity_operator(P.space((9,))),
    "pad": lambda P: P.ops.pad_operator(P.space((6, 7)), [(1, 2), (0, 3)]),
    "restrict": lambda P: P.ops.restriction_operator(P.space((10, 8)), [(2, 9), (1, 8)]),
    # tests/test_dsp.py and tests/test_jetpack_extra.py: structural
    "reshape": lambda P: P.ops.reshape_operator(P.space((6, 4)), (3, 8)),
    "transpose": lambda P: P.ops.transpose_operator(P.space((4, 6)), (1, 0)),
    "transpose3d": lambda P: P.ops.transpose_operator(P.space((2, 3, 4)), (2, 0, 1)),
    "flip": lambda P: P.ops.flip_operator(P.space((4, 6)), (1,)),
    "permutation": lambda P: P.ops.permutation_operator(
        P.space((4, 6)), np.random.default_rng(7).permutation(24)),
    "circshift": lambda P: P.ops.circshift_operator(P.space((6, 8)), (2, -3)),
    "projection": lambda P: P.ops.projection_operator(
        np.random.default_rng(4).standard_normal((3, 6, 5)), **P.kw),
    "projection_complement": lambda P: P.ops.projection_operator(
        np.random.default_rng(5).standard_normal((2, 12)), complement=True, **P.kw),
}
# data movement: the same bits as JAX
BITWISE = {"identity", "pad", "restrict", "reshape", "transpose", "transpose3d", "flip",
           "permutation", "circshift"}


@pytest.mark.parametrize("name", sorted(CASES))
def test_operator_matches_jax_and_passes_gates(name):
    hold(CASES[name], rtol=0 if name in BITWISE else 1e-12)


def test_real_imag_operators_match_jax():
    """R-linear: the adjoint identity under the real inner product
    ``Re⟨·,·⟩``, and ``Re(m) + i·Im(m) == m``."""
    rng = np.random.default_rng(9)
    m = rng.standard_normal(12) + 1j * rng.standard_normal(12)
    d = rng.standard_normal(12)
    for name in ("real_operator", "imag_operator"):
        ja = getattr(jops, name)(jt.Space((12,), jnp.complex128))
        ta = getattr(tops, name)(tt.Space((12,), torch.complex128, CPU))
        assert ta.rng.dtype == torch.float64
        tm, td = torch.from_numpy(m), torch.from_numpy(d)
        close(ta(tm).numpy(), ja(jnp.asarray(m)), 0)
        close(ta.H(td).numpy(), ja.H(jnp.asarray(d)), 0)
        lhs = float(torch.vdot(td, ta(tm)).real)
        rhs = float(torch.vdot(ta.H(td), tm).real)
        assert lhs == pytest.approx(rhs, rel=1e-12)
    Re, Im = tops.real_operator(tt.Space((12,), torch.complex128, CPU)), tops.imag_operator(
        tt.Space((12,), torch.complex128, CPU))
    tm = torch.from_numpy(m)
    assert torch.equal(Re(tm) + 1j * Im(tm), tm)
    with pytest.raises(TypeError):
        tops.real_operator(tt.Space((3,), torch.float64, CPU))


def test_fft_unitary_and_rfft_parseval():
    F = tops.fft_operator(tt.Space((16,), torch.complex128, CPU))
    m = F.dom.randn(torch.Generator().manual_seed(5))
    np.testing.assert_allclose(F.H(F(m)).numpy(), m.numpy(), rtol=1e-12, atol=1e-12)
    assert float(F.rng.norm(F(m))) == pytest.approx(float(F.dom.norm(m)), rel=1e-12)
    R = tops.rfft_operator(tt.Space((32,), torch.float64, CPU))
    assert isinstance(R.rng, tt.SymmetricSpace) and R.rng.dtype == torch.complex128
    m = R.dom.randn(torch.Generator().manual_seed(6))
    assert float(R.rng.norm(R(m))) == pytest.approx(float(R.dom.norm(m)), rel=1e-12)
    with pytest.raises(TypeError):
        tops.fft_operator(tt.Space((4,), torch.float64, CPU))
    with pytest.raises(TypeError):
        tops.rfft_operator(tt.Space((4,), torch.complex128, CPU))


def test_rfft_float32_range_and_adjoint_match_jax():
    """A float32 domain maps onto complex64; the adjoint of a random
    (non-Hermitian) member matches JAX's irfftn at float32 rounding."""
    R = tops.rfft_operator(tt.Space((4, 6, 8), torch.float32, CPU))
    JR = jops.rfft_operator(jt.Space((4, 6, 8), jnp.float32))
    assert R.rng.dtype == torch.complex64 and R.rng.logical_shape == (4, 6, 8)
    d = draw(R.rng, 3)
    x = R.H(torch.from_numpy(d))
    assert x.dtype == torch.float32
    close(x.numpy(), JR.H(jnp.asarray(d)), 2e-6)


def _dct_matrix(n):
    """The explicit orthonormal DCT-II matrix: ``C[k, j] = s_k cos(πk(2j+1)/(2n))``."""
    k, j = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    C = np.sqrt(2.0 / n) * np.cos(np.pi * k * (2 * j + 1) / (2 * n))
    C[0] /= np.sqrt(2.0)
    return C


@pytest.mark.parametrize("n", [2, 7, 8, 33])
def test_dct_matches_jax_scipy_and_the_explicit_matrix(n):
    x = np.random.default_rng(n).standard_normal((3, n))
    want = np.asarray(jax.scipy.fft.dct(jnp.asarray(x), norm="ortho", axis=1))
    got = tops.transforms.dct(torch.from_numpy(x), 1).numpy()
    assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()
    np.testing.assert_allclose(got, x @ _dct_matrix(n).T, rtol=1e-12, atol=1e-12)
    back = tops.transforms.idct(torch.from_numpy(got), 1).numpy()
    np.testing.assert_allclose(back, x, rtol=1e-12, atol=1e-12)
    x32 = x.astype(np.float32)
    want32 = np.asarray(jax.scipy.fft.dct(jnp.asarray(x32), norm="ortho", axis=1))
    got32 = tops.transforms.dct(torch.from_numpy(x32), 1)
    assert got32.dtype == torch.float32
    assert np.abs(got32.numpy() - want32).max() <= 2e-6 * np.abs(want32).max()
    inv32 = np.asarray(jax.scipy.fft.idct(jnp.asarray(x32), norm="ortho", axis=1))
    assert np.abs(tops.transforms.idct(torch.from_numpy(x32), 1).numpy()
                  - inv32).max() <= 2e-6 * np.abs(inv32).max()


def test_dct_operator_unitary_and_float32():
    D = tops.dct_operator(tt.Space((12, 10), torch.float64, CPU))
    m = D.dom.randn(torch.Generator().manual_seed(9))
    np.testing.assert_allclose(D.H(D(m)).numpy(), m.numpy(), rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(tt.materialize(D).numpy(),
                               np.kron(_dct_matrix(12), _dct_matrix(10)), atol=1e-12)
    D32 = tops.dct_operator(tt.Space((9, 16), torch.float32, CPU))
    J32 = jops.dct_operator(jt.Space((9, 16), jnp.float32))
    x = np.random.default_rng(2).standard_normal((9, 16)).astype(np.float32)
    for a, b in ((D32(torch.from_numpy(x)), J32(jnp.asarray(x))),
                 (D32.H(torch.from_numpy(x)), J32.H(jnp.asarray(x)))):
        assert a.dtype == torch.float32
        close(a.numpy(), b, 2e-6)
    with pytest.raises(TypeError):
        tops.dct_operator(tt.Space((4,), torch.complex128, CPU))


def test_pad_and_restriction_are_mutual_transposes():
    P = tops.pad_operator(tt.Space((6, 7), torch.float64, CPU), [(1, 2), (0, 3)])
    np.testing.assert_array_equal(tt.materialize(P).numpy().T, tt.materialize(P.H).numpy())
    R = tops.restriction_operator(tt.Space((10, 8), torch.float64, CPU), [(2, 9), (1, 8)])
    np.testing.assert_array_equal(tt.materialize(R).numpy().T, tt.materialize(R.H).numpy())
    with pytest.raises(ValueError):
        tops.restriction_operator(tt.Space((4,), torch.float64, CPU), [(2, 5)])
    with pytest.raises(ValueError):
        tops.pad_operator(tt.Space((4,), torch.float64, CPU), [(1, 1), (0, 0)])


def test_reshape_transpose_flip_permutation_ground_truths():
    sp = tt.Space((4, 6), torch.float64, CPU)
    x = sp.randn(torch.Generator().manual_seed(1))
    R = tops.reshape_operator(sp, (3, 8))
    assert torch.equal(R.H(R(x)), x)
    with pytest.raises(ValueError):
        tops.reshape_operator(sp, (5, 5))
    assert torch.equal(tops.transpose_operator(sp, (1, 0))(x), x.T)
    with pytest.raises(ValueError):
        tops.transpose_operator(sp, (0, 0))
    assert torch.equal(tops.flip_operator(sp, (1,))(x), x.flip(1))
    P = tops.permutation_operator(sp, torch.randperm(24, generator=torch.Generator()
                                                     .manual_seed(0)))
    assert torch.equal(P.H(P(x)), x)
    M = tt.materialize(P).numpy()
    np.testing.assert_array_equal(M.T @ M, np.eye(24))
    with pytest.raises(ValueError):
        tops.permutation_operator(sp, np.arange(5))
    C = tops.circshift_operator(tt.Space((6, 8), torch.float64, CPU), (2, -3))
    y = C.dom.randn(torch.Generator().manual_seed(2))
    assert torch.equal(C(y), torch.roll(y, (2, -3), (0, 1)))
    Mc = tt.materialize(C).numpy()
    np.testing.assert_array_equal(Mc.T @ Mc, np.eye(48))


def test_projection_idempotent_self_adjoint_and_rank_deficient():
    rng = np.random.default_rng(4)
    V = rng.standard_normal((3, 6, 5))
    P = tops.projection_operator(V, device=CPU)
    assert P.dom.shape == (6, 5) and P.dom.device == CPU
    M = tt.materialize(P).numpy()
    np.testing.assert_allclose(M, M.T, atol=1e-12)
    np.testing.assert_allclose(M @ M, M, atol=1e-12)
    assert np.trace(M) == pytest.approx(3.0, abs=1e-10)
    np.testing.assert_allclose(P(torch.from_numpy(V[0])).numpy(), V[0], atol=1e-10)
    v = rng.standard_normal(12)
    W = np.stack([v, 2 * v, rng.standard_normal(12)])  # rank 2, not 3
    Mp = tt.materialize(tops.projection_operator(W, device=CPU)).numpy()
    Mc = tt.materialize(tops.projection_operator(torch.from_numpy(W), complement=True,
                                                 device=CPU)).numpy()
    assert np.trace(Mp) == pytest.approx(2.0, abs=1e-10)
    np.testing.assert_allclose(Mp + Mc, np.eye(12), atol=1e-12)
