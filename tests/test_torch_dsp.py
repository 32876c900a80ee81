"""The signal-processing, causal, wavelet, Radon, interpolation,
acquisition and elementwise operator packs (jets_tpu_torch/ops/dsp.py,
causal.py, wavelet.py, radon.py, interp.py, acquisition.py,
elementwise.py) held against jets_tpu on the same numpy inputs: each
constructor's forward and adjoint (and, for the nonlinear ones, the
forward, the tangent and its adjoint at one point), the port's own
dot-product, linearity and linearization gates, and the cases of
tests/test_dsp.py and tests/test_jetpack_extra.py that cover these
modules.

Each case is built by the same code through both packages
(tests/_torch_parity.py). Tolerances, float64 on both sides unless named:
forward and adjoint at ``rtol=1e-12`` against JAX's jitted programs; the
elementwise and data-movement ones (taper, mute, difference, blending
without overlaps) bitwise (not interpolation: XLA fuses its blend into
fused multiply-adds; not overlapping shots: the port adds them in shot
order, XLA's reduction in its own). The
box sums of mix and roughness add the window in another order than XLA's
``reduce_window`` (separably), ``1e-13``; the blocked leaky integration
``1e-12`` in float64 and ``1e-5`` in float32 at ``nt = 512``; the
envelope on a float32 space stays float32 (JAX with x64 promotes it to
float64 through its float64 Hilbert multiplier) and is held against JAX's
float64 values at ``1e-5``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jets_tpu as jt
import jets_tpu.ops as jops
import jets_tpu_torch as tt
import jets_tpu_torch.ops as tops
from _torch_parity import CPU, J, T, close, draw, gates, hold

_R = np.random.default_rng(11)
MUTE = (_R.uniform(size=(5, 16)) > 0.3).astype(np.float64)
POS = np.array([0.0, 0.25, 3.5, 7.9, 15.0, 3.6, 15.0, 0.1])  # duplicate bins
FIRING = np.sort(np.random.default_rng(0).integers(0, 90, 6))

CASES = {
    # dsp: tests/test_dsp.py and tests/test_jetpack_extra.py
    "taper": lambda P: P.ops.taper_operator(P.space((6, 32)), (2, 5)),
    "bandpass": lambda P: P.ops.bandpass_operator(P.space((4, 128)), 0.004, 10.0, 60.0,
                                                  f_taper=5.0),
    "bandpass_odd_axis0": lambda P: P.ops.bandpass_operator(P.space((63, 3)), 0.004, 10.0,
                                                            60.0, f_taper=5.0, axis=0),
    "shift": lambda P: P.ops.shift_operator(P.space((3, 64)), 2.5),
    "shift_odd": lambda P: P.ops.shift_operator(P.space((3, 63)), 3.5 * 0.004, dt=0.004),
    "resample_down": lambda P: P.ops.resample_operator(P.space((64,)), 32),
    "resample_up": lambda P: P.ops.resample_operator(P.space((8, 32)), 48, axis=1),
    "resample_odd": lambda P: P.ops.resample_operator(P.space((33, 4)), 20, axis=0),
    "mute": lambda P: P.ops.mute_operator(P.space((5, 16)), MUTE),
    "mix": lambda P: P.ops.mix_operator(P.space((9, 11)), (3, 1)),
    "mix_3d": lambda P: P.ops.mix_operator(P.space((4, 6, 12)), (1, 5, 11)),
    "roughness": lambda P: P.ops.roughness_operator(P.space((16,)), (5,)),
    "translation": lambda P: P.ops.translation_operator(P.space((16, 32)), (3.0, -5.0)),
    "translation_fractional": lambda P: P.ops.translation_operator(
        P.space((8, 12)), (1.5, -2.25), dts=(1.0, 0.5)),
    "translation_zero": lambda P: P.ops.translation_operator(P.space((8,)), (0.0,)),
    # causal: tests/test_jetpack_extra.py
    "integration_a1_ax0": lambda P: P.ops.integration_operator(P.space((6, 7)), 1.0, 0),
    "integration_a1_ax1": lambda P: P.ops.integration_operator(P.space((6, 7)), 1.0, 1),
    "integration_a09_ax0": lambda P: P.ops.integration_operator(P.space((6, 7)), 0.9, 0),
    "integration_a09_ax1": lambda P: P.ops.integration_operator(P.space((6, 7)), 0.9, 1),
    "integration_blocked": lambda P: P.ops.integration_operator(P.space((3, 512)), 0.95),
    "integration_blocked_ragged": lambda P: P.ops.integration_operator(P.space((201, 2)),
                                                                       0.8, 0),
    "difference": lambda P: P.ops.difference_operator(P.space((32,))),
    "difference_ax0": lambda P: P.ops.difference_operator(P.space((5, 4)), axis=0),
    # wavelet: tests/test_dsp.py
    "wavelet_2d": lambda P: P.ops.wavelet_operator(P.space((16, 8)), "db2", levels=2),
    "wavelet_axis": lambda P: P.ops.wavelet_operator(P.space((3, 32)), "db4", 3, axes=(1,)),
    # radon: tests/test_dsp.py
    "radon": lambda P: P.ops.radon_operator(128, np.arange(8) * 100.0,
                                            np.linspace(-4e-4, 4e-4, 9), 0.004,
                                            dtype=P.f64, **P.kw),
    "radon_odd": lambda P: P.ops.radon_operator(63, np.arange(5) * 50.0,
                                                np.linspace(-2e-3, 2e-3, 4), 0.004,
                                                dtype=P.f64, **P.kw),
    # interp and acquisition: tests/test_jetpack_extra.py
    "interp": lambda P: P.ops.interp_operator(P.space((4, 16)), POS, axis=1),
    "interp_dup": lambda P: P.ops.interp_operator(P.space((8,)), np.array([2.25, 2.75]), 0),
    "blend": lambda P: P.ops.blend_operator(3, 10, [0, 7, 23], 40, dtype=P.f64, **P.kw),
    "blend_overlapping": lambda P: P.ops.blend_operator(6, 20, FIRING, int(FIRING.max()) + 20,
                                                        dtype=P.f64, **P.kw),
    "lmo": lambda P: P.ops.lmo_operator(P.space((3, 32)), 0.004,
                                        np.array([0.0, 100.0, 250.0]), 0.7 * 0.004 / 100.0),
    "reghost": lambda P: P.ops.reghost_operator(P.space((8, 64)), 0.004, 12.5, 15.0),
}
BITWISE = {"taper", "mute", "difference", "difference_ax0", "blend", "translation_zero"}
RTOL = {"mix": 1e-13, "mix_3d": 1e-13, "roughness": 1e-13}


@pytest.mark.parametrize("name", sorted(CASES))
def test_operator_matches_jax_and_passes_gates(name):
    hold(CASES[name], rtol=0 if name in BITWISE else RTOL.get(name, 1e-12))


@pytest.mark.parametrize("wavelet", ["haar", "db2", "db3", "db4"])
@pytest.mark.parametrize("levels", [1, 3])
def test_wavelet_orthonormal_and_matches_jax(wavelet, levels):
    W = hold(lambda P: P.ops.wavelet_operator(P.space((32,)), wavelet=wavelet, levels=levels))
    M = tt.materialize(W).numpy()
    np.testing.assert_allclose(M.T @ M, np.eye(32), atol=1e-12)


def test_wavelet_haar_level1_by_hand_and_validation():
    W = tops.wavelet_operator(tt.Space((4,), torch.float64, CPU), wavelet="haar")
    s = 1 / np.sqrt(2)
    np.testing.assert_allclose(W(torch.tensor([1.0, 2.0, 3.0, 4.0], dtype=torch.float64)),
                               [s * 3.0, s * 7.0, -s, -s])
    with pytest.raises(ValueError):
        tops.wavelet_operator(tt.Space((6,), torch.float64, CPU), levels=2)
    with pytest.raises(ValueError):
        tops.wavelet_operator(tt.Space((8,), torch.float64, CPU), wavelet="nope")


def _nonlinear(build, shift=0.0, rtol=1e-12, positive=False):
    """``build(P)`` (nonlinear) through both packages: the forward, the
    tangent and its adjoint at one point agree; the port's tangent passes
    the dot-product gate and the port's forward the linearization gate."""
    jF, tF = build(J), build(T)
    m0 = draw(tF.dom, 1, shift)
    if positive:
        m0 = np.abs(m0) + 0.5
    dm, dd = draw(tF.dom, 2), draw(tF.rng, 3)
    tm0 = torch.from_numpy(m0)
    close(tF(tm0).numpy(), jF(jnp.asarray(m0)), rtol)
    tJ, jJ = tF.linearize(tm0), jF.linearize(jnp.asarray(m0))
    close(tJ(torch.from_numpy(dm)).numpy(), jJ(jnp.asarray(dm)), rtol)
    close(tJ.H(torch.from_numpy(dd)).numpy(), jJ.H(jnp.asarray(dd)), rtol)
    gates(tJ, dm, dd, gate=1e-10)
    # a perturbation small against the curvature's scale (the envelope's
    # analytic amplitude is ~2 here), so the second-order term leads
    obs, exp = tt.linearization_test(tF, tm0, delta_m=0.1 * torch.from_numpy(draw(tF.dom, 4)))
    np.testing.assert_allclose(obs.numpy()[-2:], exp.numpy()[-2:], rtol=0.2)
    return tF


NONLINEAR = {
    "square": (lambda P: P.ops.square_operator(P.space((50,))), False),
    "power": (lambda P: P.ops.power_operator(P.space((50,)), 3.0), False),
    "exp": (lambda P: P.ops.exp_operator(P.space((50,))), False),
    "log": (lambda P: P.ops.log_operator(P.space((50,))), True),
    "sqrt": (lambda P: P.ops.sqrt_operator(P.space((50,))), True),
    "tanh": (lambda P: P.ops.tanh_operator(P.space((50,))), False),
    "sigmoid": (lambda P: P.ops.sigmoid_operator(P.space((50,))), False),
    "atan": (lambda P: P.ops.atan_operator(P.space((50,))), False),
    "sin": (lambda P: P.ops.sin_operator(P.space((50,))), False),
    "cos": (lambda P: P.ops.cos_operator(P.space((50,))), False),
}


@pytest.mark.parametrize("name", sorted(NONLINEAR))
def test_elementwise_matches_jax_and_linearizes(name):
    build, positive = NONLINEAR[name]
    _nonlinear(build, positive=positive)


def test_nonlinear_elementwise_from_callables():
    F = tops.nonlinear_elementwise(tt.Space((20,), torch.float64, CPU),
                                   lambda m: m ** 3, lambda m: 3.0 * m ** 2)
    jF = jops.nonlinear_elementwise(jt.Space((20,), jnp.float64),
                                    lambda m: m ** 3, lambda m: 3.0 * m ** 2)
    m0 = np.linspace(-1.0, 2.0, 20)
    close(F(torch.from_numpy(m0)).numpy(), jF(jnp.asarray(m0)), 0)
    dd = np.cos(np.arange(20.0))
    close(F.linearize(torch.from_numpy(m0)).H(torch.from_numpy(dd)).numpy(),
          jF.linearize(jnp.asarray(m0)).H(jnp.asarray(dd)), 0)


def test_envelope_matches_jax_and_linearizes():
    F = _nonlinear(lambda P: P.ops.envelope_operator(P.space((4, 64))), shift=2.0)
    # an analytic tone has a flat envelope
    t = np.arange(128)
    E = tops.envelope_operator(tt.Space((128,), torch.float64, CPU))
    np.testing.assert_allclose(E(torch.from_numpy(np.cos(2 * np.pi * 8 * t / 128))).numpy(),
                               1.0, atol=1e-10)
    assert F.rng.dtype == torch.float64


def test_envelope_float32_stays_float32():
    """JAX with x64 on promotes a float32 envelope to float64 (its Hilbert
    multiplier is a float64 numpy array); the port builds the multiplier
    in the space's dtype, so its result is float32, as JAX's is with x64
    off. The values agree at float32 rounding."""
    x = (np.random.default_rng(5).standard_normal((3, 64)) + 2.0).astype(np.float32)
    jE = jops.envelope_operator(jt.Space((3, 64), jnp.float32))
    tE = tops.envelope_operator(tt.Space((3, 64), torch.float32, CPU))
    want = np.asarray(jE(jnp.asarray(x)))
    assert want.dtype == np.float64
    got = tE(torch.from_numpy(x))
    assert got.dtype == torch.float32
    close(got.numpy(), want, 1e-5)
    dd = np.random.default_rng(6).standard_normal((3, 64)).astype(np.float32)
    tJ = tE.linearize(torch.from_numpy(x))
    assert tJ.H(torch.from_numpy(dd)).dtype == torch.float32
    close(tJ.H(torch.from_numpy(dd)).numpy(),
          jE.linearize(jnp.asarray(x)).H(jnp.asarray(dd)), 1e-5)


def test_nim_matches_jax_monotone_and_linearizes():
    F = _nonlinear(lambda P: P.ops.nim_operator(P.space((3, 40)), p=2.0, axis=1), shift=0.1)
    d = F(torch.from_numpy(draw(F.dom, 1, 0.1))).numpy()
    assert np.all(np.diff(d, axis=1) >= -1e-14)
    np.testing.assert_allclose(d[:, -1], 1.0, atol=1e-12)


@pytest.mark.parametrize("alpha", [0.95, 1.0])
def test_integration_float32_against_jax_at_nt_512(alpha):
    x = np.random.default_rng(8).standard_normal((4, 512)).astype(np.float32)
    jL = jops.integration_operator(jt.Space((4, 512), jnp.float32), alpha=alpha)
    tL = tops.integration_operator(tt.Space((4, 512), torch.float32, CPU), alpha=alpha)
    for a, b in ((tL(torch.from_numpy(x)), jL(jnp.asarray(x))),
                 (tL.H(torch.from_numpy(x)), jL.H(jnp.asarray(x)))):
        assert a.dtype == torch.float32
        close(a.numpy(), np.asarray(b), 1e-5)


def test_integration_dense_ground_truth_and_difference_inverse():
    sp = tt.Space((6, 7), torch.float64, CPU)
    for alpha, axis in ((0.9, 0), (0.7, 1)):
        L = tops.integration_operator(sp, alpha=alpha, axis=axis)
        n = sp.shape[axis]
        Tm = np.tril(alpha ** np.subtract.outer(np.arange(n), np.arange(n)))
        x = np.random.default_rng(0).standard_normal(sp.shape)
        want = np.apply_along_axis(lambda v: Tm @ v, axis, x)
        np.testing.assert_allclose(L(torch.from_numpy(x)).numpy(), want, atol=1e-12)
    s1 = tt.Space((32,), torch.float64, CPU)
    D, S = tops.difference_operator(s1), tops.integration_operator(s1)
    x = s1.randn(torch.Generator().manual_seed(1))
    np.testing.assert_allclose(D(S(x)).numpy(), x.numpy(), atol=1e-12)
    np.testing.assert_allclose(S(D(x)).numpy(), x.numpy(), atol=1e-12)
    np.testing.assert_array_equal(tt.materialize(D).numpy().T, tt.materialize(D.H).numpy())


def test_dsp_ground_truths():
    """tests/test_dsp.py's ground truths on the port: the taper's edges,
    the bandpass against a numpy mask, an integer shift against a roll,
    band-limited resampling, the mute mask, and the mix mean."""
    sp = tt.Space((32, 16), torch.float64, CPU)
    y = tops.taper_operator(sp, (4, 3))(sp.ones()).numpy()
    assert y[16, 8] == pytest.approx(1.0) and y[0, 8] < 0.1 and y[16, 0] < 0.2
    n, dt = 128, 0.004
    s1 = tt.Space((n,), torch.float64, CPU)
    B = tops.bandpass_operator(s1, dt, 10.0, 60.0, f_taper=5.0)
    x = s1.randn(torch.Generator().manual_seed(7))
    f = np.fft.rfftfreq(n, d=dt)
    Y, X = np.fft.rfft(B(x).numpy()), np.fft.rfft(x.numpy())
    passed, stopped = (f >= 10.0) & (f <= 60.0), (f < 5.0) | (f > 65.0)
    np.testing.assert_allclose(Y[passed], X[passed], atol=1e-12)
    np.testing.assert_allclose(Y[stopped], 0.0, atol=1e-12)
    M = tt.materialize(B).numpy()
    np.testing.assert_allclose(M, M.T, atol=1e-12)
    s64 = tt.Space((64,), torch.float64, CPU)
    x = s64.randn(torch.Generator().manual_seed(3))
    S = tops.shift_operator(s64, 5.0)
    np.testing.assert_allclose(S(x).numpy(), np.roll(x.numpy(), 5), atol=1e-10)
    np.testing.assert_allclose(S.H(S(x)).numpy(), x.numpy(), atol=1e-10)
    t = np.arange(64) / 64
    sig = np.sin(2 * np.pi * 3 * t) + 0.5 * np.cos(2 * np.pi * 7 * t)
    t2 = np.arange(32) / 32
    np.testing.assert_allclose(tops.resample_operator(s64, 32)(torch.from_numpy(sig)).numpy(),
                               np.sin(2 * np.pi * 3 * t2) + 0.5 * np.cos(2 * np.pi * 7 * t2),
                               atol=1e-10)
    s16 = tt.Space((16,), torch.float64, CPU)
    mask = np.concatenate([np.zeros(4), np.ones(12)])
    np.testing.assert_array_equal(tops.mute_operator(s16, mask)(s16.ones()).numpy(), mask)
    with pytest.raises(ValueError):
        tops.mute_operator(s16, np.ones(15))
    s9 = tt.Space((9, 11), torch.float64, CPU)
    x = s9.randn(torch.Generator().manual_seed(2)).numpy()
    pad = np.pad(x, ((1, 1), (0, 0)))
    np.testing.assert_allclose(tops.mix_operator(s9, (3, 1))(torch.from_numpy(x)).numpy(),
                               (pad[:-2] + pad[1:-1] + pad[2:]) / 3.0, atol=1e-12)
    R = tops.roughness_operator(s16, (5,))
    np.testing.assert_allclose(R(s16.ones()).numpy()[2:-2], 0.0, atol=1e-14)
    with pytest.raises(ValueError):
        tops.mix_operator(s16, (4,))
    with pytest.raises(TypeError):
        tops.bandpass_operator(tt.Space((8,), torch.complex128, CPU), 0.004, 1.0, 2.0)


def test_radon_moves_a_spike_out_linearly():
    nt, dt = 128, 0.004
    offsets, slownesses = np.arange(8) * 100.0, np.linspace(-4e-4, 4e-4, 9)
    R = tops.radon_operator(nt, offsets, slownesses, dt, dtype=torch.float64, device=CPU)
    assert R.dom.shape == (nt, 9) and R.rng.shape == (nt, 8)
    assert R.jet.state["phase"].dtype == torch.complex128
    m = torch.zeros((nt, 9), dtype=torch.float64)
    m[40, 7] = 1.0
    d = R(m).numpy()
    for ix, x in enumerate(offsets):
        expect_t = (40 * dt + float(slownesses[7]) * x) / dt
        assert abs(int(np.argmax(d[:, ix])) - round(expect_t)) <= 1
    assert tops.radon_operator(8, [1.0], [0.0], device=CPU).jet.state["phase"].dtype \
        == torch.complex64


def test_interp_blend_lmo_reghost_ground_truths():
    sp = tt.Space((4, 16), torch.float64, CPU)
    pos = np.array([0.0, 0.25, 3.5, 7.9, 15.0])
    x = sp.randn(torch.Generator().manual_seed(0)).numpy()
    got = tops.interp_operator(sp, pos, axis=1)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.stack([np.interp(pos, np.arange(16.0), r) for r in x]),
                               atol=1e-12)
    A = tops.interp_operator(tt.Space((8,), torch.float64, CPU), np.array([2.25, 2.75]), 0)
    np.testing.assert_allclose(tt.materialize(A).numpy().T, tt.materialize(A.H).numpy(),
                               atol=1e-14)
    B = tops.blend_operator(3, 10, [0, 7, 23], 40, dtype=torch.float64, device=CPU)
    xb = B.dom.randn(torch.Generator().manual_seed(1)).numpy()
    want = np.zeros(40)
    for s, t0 in enumerate([0, 7, 23]):
        want[t0:t0 + 10] += xb[s]
    np.testing.assert_allclose(B(torch.from_numpy(xb)).numpy(), want, atol=1e-12)
    with pytest.raises(ValueError):
        tops.blend_operator(2, 10, [0, 35], 40, device=CPU)
    s3 = tt.Space((3, 32), torch.float64, CPU)
    L = tops.lmo_operator(s3, 0.004, np.array([0.0, 100.0, 200.0]), 2 * 0.004 / 100.0)
    xl = s3.randn(torch.Generator().manual_seed(2)).numpy()
    got = L(torch.from_numpy(xl)).numpy()
    for i in range(3):
        np.testing.assert_allclose(got[i], np.roll(xl[i], -2 * i), atol=1e-10)
    nx, nt, dt = 8, 256, 0.004
    G = tops.reghost_operator(tt.Space((nx, nt), torch.float64, CPU), dt, 12.5, 15.0)
    tt_ = np.arange(nt) * dt
    pulse = np.exp(-0.5 * ((tt_ - 0.3) / 0.01) ** 2)
    d = G(torch.from_numpy(np.broadcast_to(pulse, (nx, nt)).copy())).numpy()
    np.testing.assert_allclose(d[0], pulse - np.roll(pulse, 5), atol=1e-8)
    np.testing.assert_allclose(d, np.broadcast_to(d[0], d.shape), atol=1e-10)
    G0 = tops.reghost_operator(tt.Space((4, 64), torch.float64, CPU), 0.004, 10.0, 12.0,
                               sea_surface_reflectivity=0.0)
    xg = G0.dom.randn(torch.Generator().manual_seed(3))
    np.testing.assert_allclose(G0(xg).numpy(), xg.numpy(), atol=1e-12)


def test_gather_adjoints_repeat_bitwise():
    """The interpolation and blending adjoints are gathers added in a fixed
    order: two calls give the same bits."""
    from jets_tpu_torch.ops.interp import gather_table

    np.testing.assert_array_equal(gather_table([2, 0, 2, 1, 2], 4),
                                  [[1, 3, 0, 5], [5, 5, 2, 5], [5, 5, 4, 5]])
    A = tops.interp_operator(tt.Space((3, 50), torch.float32, CPU),
                             np.random.default_rng(1).uniform(0, 49, 300), axis=1)
    dd = A.rng.randn(torch.Generator().manual_seed(0))
    assert torch.equal(A.H(dd), A.H(dd))
