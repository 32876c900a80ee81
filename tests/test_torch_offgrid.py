"""The port's off-grid acquisition (``offgrid_wave_propagator`` and the
custom source-mask, extractor and injector hooks of ``_propagate`` and
``_adjoint_stored``) held against ``jets_tpu.ops.wave`` on the CPU: the
counterparts of the off-grid tests of ``tests/test_wavefd.py``, with the JAX
operator's wavelet and sponge carried across (the source stamp and the
sampling matrices are built by the same float64 numpy code on both sides).

Tolerances: float64 traces against JAX's ``rtol=1e-10, atol=1e-10·max|ref|``
(products and time loops summed in another order); integer positions
against the port's own on-grid propagator ``rtol=1e-12`` (as
``tests/test_wavefd.py``: a one-hot sinc row carries ``sin(πk)`` residues
of 1e-17); float32 traces and gradients ``rtol=1e-5, atol=1e-5·max|ref|``
(bf16 and int8 histories included: both packages encode alike); the stored
f32-history adjoint against autograd ``rtol=1e-5, atol=2e-5`` of the peak,
as the JAX test; float64 dot-product gates ``rtol=1e-9``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jets_tpu_torch as tt
from jets_tpu.ops import wave as jw
from jets_tpu_torch.ops import wave as tw

CPU = torch.device("cpu")  # the tests build on the CPU, as a caller asks

N = 24
KW2 = dict(src_pos=(11.3, 12.6), rcv_depth=5.45, rcv_coords=np.linspace(4.2, 19.7, 9),
           nt=40, dt=0.0008, dx=10.0, freq=18.0, sponge_width=4)
SHAPE3 = (12, 14, 16)
KW3 = dict(src_pos=(6.5, 7.25, 8.0), rcv_depth=3.5,
           rcv_coords=(np.array([4.5, 7.0, 9.5]), np.array([5.25, 10.75])),
           nt=24, dt=0.0008, dx=10.0, freq=18.0, sponge_width=3)
ZERO = {"fused_leapfrog_step": 0, "fused_adjoint_step": 0, "fused_q_step": 0,
        "fused_leapfrog_step2d": 0, "fused_adjoint_step2d": 0, "fused_q_adjoint_step": 0}


def _live(x):
    assert float(np.max(np.abs(np.asarray(x, np.float64)))) > 0.0, "vacuous: zero signal"


def _close(got, ref, rtol=1e-5, atol=1e-5):
    ref = np.asarray(ref, np.float64)
    _live(ref)
    np.testing.assert_allclose(np.asarray(got, np.float64), ref, rtol=rtol,
                               atol=atol * float(np.max(np.abs(ref))))


def _T(x):
    return torch.from_numpy(np.array(x))


def _gate(J, seed):
    g = torch.Generator().manual_seed(seed)
    lhs, rhs = tt.dot_product_test(J, J.dom.randn(g), J.rng.randn(g))
    _live(float(rhs))
    np.testing.assert_allclose(float(lhs), float(rhs), rtol=1e-9)


def pair(shape, kw, dtype=np.float64, **extra):
    """The JAX and the port's off-grid propagators, the JAX wavelet and
    sponge carried across."""
    Fj = jw.offgrid_wave_propagator(shape, dtype=jnp.dtype(dtype), **kw, **extra)
    Ft = tw.offgrid_wave_propagator(shape, dtype=torch.from_numpy(np.zeros(1, dtype)).dtype,
                                    device=CPU, **kw, **extra)
    s = Fj.jet.state
    sp = s["sponge"]
    sp = tuple(_T(f) for f in sp) if isinstance(sp, tuple) else _T(sp)
    Ft = tt.with_state(Ft, wavelet=_T(s["wavelet"]), sponge=sp)
    for key in ("src_mask", "wz"):
        np.testing.assert_array_equal(Ft.jet.state[key].numpy(), np.asarray(s[key]))
    for a, b in zip(Ft.jet.state["Wr"], s["Wr"]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    return Fj, Ft


def _model(shape, dtype=np.float64, seed=0):
    rng = np.random.default_rng(seed)
    return (2000.0 + 40.0 * rng.standard_normal(shape)).astype(dtype)


def test_offgrid_integer_positions_match_ongrid():
    """Integer source and receiver coordinates collapse the sinc stamps to
    one-hot rows, so the off-grid propagator reproduces the on-grid one."""
    kw = dict(nt=40, dt=0.0008, dx=10.0, freq=18.0, sponge_width=4, dtype=torch.float64,
              device=CPU)
    cols = np.arange(4, 20, 2)
    Foff = tw.offgrid_wave_propagator((N, N), src_pos=(12.0, 12.0), rcv_depth=6.0,
                                      rcv_coords=cols.astype(np.float64), **kw)
    Fon = tw.wave_propagator((N, N), src_idx=N * 12 + 12, rcv_idx=N * 6 + cols, **kw)
    c = torch.full((N, N), 2000.0, dtype=torch.float64)
    ref = Fon(c)
    _live(ref)
    np.testing.assert_allclose(Foff(c).numpy(), ref.numpy(), rtol=1e-12, atol=1e-18)
    # 3-D, a receiver plane: the same collapse
    src = (6, 7, 8)
    Foff3 = tw.offgrid_wave_propagator(
        SHAPE3, src_pos=tuple(float(x) for x in src), rcv_depth=3.0,
        rcv_coords=(np.array([4.0, 9.0]), np.array([5.0, 10.0, 12.0])), nt=24,
        dt=0.0008, dx=10.0, freq=18.0, sponge_width=3, dtype=torch.float64, device=CPU)
    rcv = [np.ravel_multi_index((3, y, x), SHAPE3) for y in (4, 9) for x in (5, 10, 12)]
    Fon3 = tw.wave_propagator(SHAPE3, src_idx=int(np.ravel_multi_index(src, SHAPE3)),
                              rcv_idx=rcv, nt=24, dt=0.0008, dx=10.0, freq=18.0,
                              sponge_width=3, dtype=torch.float64, device=CPU)
    c3 = _T(_model(SHAPE3))
    ref3 = Fon3(c3)
    _live(ref3)
    np.testing.assert_allclose(Foff3(c3).numpy().reshape(24, -1), ref3.numpy(),
                               rtol=1e-12, atol=1e-18)


@pytest.mark.parametrize("dim", ["2d", "3d"])
def test_forward_tangent_and_adjoint_match_jax_in_float64(dim):
    shape, kw = ((N, N), KW2) if dim == "2d" else (SHAPE3, KW3)
    Fj, Ft = pair(shape, kw)
    c = _model(shape)
    d = Ft(_T(c))
    assert d.shape == Fj.rng.shape == ((40, 9) if dim == "2d" else (24, 3, 2))
    _close(d.numpy(), Fj(jnp.asarray(c)), rtol=1e-10, atol=1e-10)
    rng = np.random.default_rng(1)
    dc = rng.standard_normal(shape)
    dd = rng.standard_normal(Fj.rng.shape)
    Jj, Jt = Fj.linearize(jnp.asarray(c)), Ft.linearize(_T(c))
    _close(Jt(_T(dc)).numpy(), Jj(jnp.asarray(dc)), rtol=1e-10, atol=1e-10)
    _close(Jt.H(_T(dd)).numpy(), Jj.H(jnp.asarray(dd)), rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("dim", ["2d", "3d"])
def test_offgrid_born_gate_and_fractional_signal(dim):
    shape, kw = ((N, N), KW2) if dim == "2d" else (SHAPE3, KW3)
    F = tw.offgrid_wave_propagator(shape, dtype=torch.float64, device=CPU, **kw)
    c0 = torch.full(shape, 2000.0, dtype=torch.float64)
    d = F(c0)
    assert d.shape == F.rng.shape
    _live(d)
    _gate(tw.born_operator(F, c0), 12)
    Fs = tw.offgrid_wave_propagator(shape, dtype=torch.float64, store_adjoint="f32",
                                    device=CPU, **kw)
    _gate(tw.born_operator(Fs, c0), 13)


@pytest.mark.parametrize("store", ["f32", "bf16", "int8"])
def test_stored_adjoint_matches_jax(store):
    Fj, Ft = pair((N, N), KW2, np.float32, store_adjoint=store)
    c = _model((N, N), np.float32, 2)
    d = np.asarray(Fj(jnp.asarray(c * 1.02))) - np.asarray(Fj(jnp.asarray(c)))
    _close(Ft.linearize(_T(c)).H(_T(d)).numpy(), Fj.linearize(jnp.asarray(c)).H(d))


def test_offgrid_stored_adjoint_matches_autodiff():
    """The fractional source rides the forward history sweep and the
    receiver injection is the transpose of the Kaiser-sinc extraction."""
    cfg = dict(dtype=torch.float32, device=CPU)
    c0 = torch.full((N, N), 2000.0)
    for kw, seed in ((KW2, 95), (dict(KW2, dtrec=1.6e-3), 96)):
        Fa = tw.offgrid_wave_propagator((N, N), **kw, **cfg)
        Fs = tw.offgrid_wave_propagator((N, N), store_adjoint="f32", **kw, **cfg)
        d = torch.from_numpy(np.random.default_rng(seed).standard_normal(
            Fa.rng.shape).astype(np.float32))
        ga = Fa.linearize(c0).H(d).numpy()
        gs = Fs.linearize(c0).H(d).numpy()
        scale = float(np.max(np.abs(ga)))
        assert scale > 0.0, "vacuous: zero adjoint"
        np.testing.assert_allclose(gs / scale, ga / scale, rtol=1e-5, atol=2e-5)
    # the 3-D plane's injection, against autograd through the extraction
    Fa = tw.offgrid_wave_propagator(SHAPE3, **KW3, **cfg)
    Fs = tw.offgrid_wave_propagator(SHAPE3, store_adjoint="f32", **KW3, **cfg)
    c3 = _T(_model(SHAPE3, np.float32, 3))
    d3 = torch.from_numpy(np.random.default_rng(97).standard_normal(
        Fa.rng.shape).astype(np.float32))
    _close(Fs.linearize(c3).H(d3).numpy(), Fa.linearize(c3).H(d3).numpy(), atol=2e-5)


def test_remat_blocks_and_dtrec():
    cfg = dict(dtype=torch.float32, device=CPU)
    F1 = tw.offgrid_wave_propagator((N, N), **KW2, **cfg)
    F4 = tw.offgrid_wave_propagator((N, N), remat_blocks=4, **KW2, **cfg)
    c = _T(_model((N, N), np.float32, 4))
    assert torch.equal(F4(c), F1(c))
    d = torch.from_numpy(np.random.default_rng(5).standard_normal((40, 9)).astype(np.float32))
    assert torch.equal(F4.linearize(c).H(d), F1.linearize(c).H(d))
    Fj, Ft = pair((N, N), KW2, np.float32, dtrec=1.6e-3)
    assert Ft.rng.shape == Fj.rng.shape == (20, 9)
    _close(Ft(c).numpy(), Fj(jnp.asarray(c.numpy())))


def test_custom_geometry_refuses_the_kernel_route():
    """A custom source mask, extractor or injector takes the plain step:
    ``fused=None`` never launches a kernel and ``fused=True`` raises, as in
    the JAX package (on the card the kernels have no such inputs)."""
    from jets_tpu_torch.ops import cuda_wave as cw

    shape = (6, 8, 16)
    c = torch.full(shape, 1500.0)
    wav = torch.ones(5)
    sponge = tw._make_sponge(shape, 2)
    mask = torch.zeros(shape)
    mask[3, 4, 8] = 1e-6
    cfg = dict(dt=6e-4, dx=10.0, sponge=sponge)
    rcv = torch.arange(16) + int(np.ravel_multi_index((3, 4, 0), shape))
    with pytest.raises(ValueError, match="on-grid source"):
        tw._propagate(c, wav, 0, rcv, src_mask=mask, fused=True, **cfg)
    with pytest.raises(ValueError, match="on-grid source"):
        tw._propagate(c, wav, 0, None, extract=lambda u: u[0], fused=True, **cfg)
    with pytest.raises(ValueError, match="on-grid source"):
        tw._adjoint_stored(c, torch.ones(5, 16), wav, 0, rcv, src_mask=mask, fused=True,
                           **cfg)
    cw.reset_launch_counts()
    src = int(np.ravel_multi_index((3, 4, 8), shape))
    ref = tw._propagate(c, wav, src, rcv, fused=False, **cfg)
    _live(ref)
    mask6 = tw.cuda_wave.source_mask(shape, src, torch.tensor(6e-4 * 6e-4))
    assert torch.equal(tw._propagate(c, wav, 0, rcv, src_mask=mask6, **cfg), ref)
    got = tw._propagate(c, wav, src, None, extract=lambda u: u[3, 4], **cfg)
    assert torch.equal(got, ref)
    assert cw.launch_counts() == ZERO


def test_validation():
    with pytest.raises(ValueError, match="rcv_coords"):
        tw.offgrid_wave_propagator(SHAPE3, src_pos=(1.0, 1.0, 1.0), rcv_depth=2.0,
                                   rcv_coords=(np.array([1.0]),), device=CPU)
    with pytest.raises(ValueError, match="store_adjoint"):
        tw.offgrid_wave_propagator((N, N), store_adjoint="int4", device=CPU, **KW2)
    with pytest.raises(ValueError, match="space_order"):
        tw.offgrid_wave_propagator((N, N), space_order=3, device=CPU, **KW2)
    # clamped depth windows at both edges of the grid
    for depth in (0.5, N - 1.2):
        F = tw.offgrid_wave_propagator((N, N), src_pos=(11.3, 12.6), rcv_depth=depth,
                                       rcv_coords=np.linspace(4.2, 19.7, 9), nt=20,
                                       dt=0.0008, freq=18.0, sponge_width=4,
                                       dtype=torch.float64, device=CPU)
        Fj = jw.offgrid_wave_propagator((N, N), src_pos=(11.3, 12.6), rcv_depth=depth,
                                        rcv_coords=np.linspace(4.2, 19.7, 9), nt=20,
                                        dt=0.0008, freq=18.0, sponge_width=4,
                                        dtype=jnp.float64)
        np.testing.assert_array_equal(F.jet.state["wz"].numpy(), np.asarray(Fj.jet.state["wz"]))
        _gate(tw.born_operator(F, torch.full((N, N), 2000.0, dtype=torch.float64)), 14)
