"""The port's constant-Q (visco-acoustic) slice held against jets_tpu on the
CPU, on the same numpy inputs: the kernel K14's plain version
(``cuda_wave.fused_q_step_torch``) against the Pallas ``fused_q_step`` in
interpret mode, and ``q_wave_propagator`` (forward, tangent, autodiff and
stored-history adjoints) against ``jets_tpu.ops.wave.q_wave_propagator``
with the JAX operator's wavelet, sponge and geometry carried across
(``with_wave_arrays``).

Tolerances: interpret-mode Pallas and the jitted JAX time loop run under
``jit``, where XLA on the CPU contracts multiply-adds into FMAs, while the
port rounds every multiply and add: the step agrees to ``rtol=1e-6,
atol=1e-5·max|ref|``, traces, tangents and gradients to ``rtol=1e-5,
atol=1e-5·max|ref|`` (observed ≤ 3e-6 of the peak, bf16 and int8 histories
included: both packages encode alike). Against EAGER JAX (op by op,
subnormals flushed on both sides) the forward is bitwise: the port keeps
JAX's tree, divides ``π·f0·dt/Q`` as JAX does (a 0-d tensor dividend, not
a Python float), and rounds bf16 friction straight through. Every
comparison has a live-signal guard.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jets_tpu_torch as tt
from jets_tpu.ops import pallas_wave as pw
from jets_tpu.ops import wave as jw
from jets_tpu_torch.ops import cuda_wave as cw
from jets_tpu_torch.ops import wave as tw

CPU = torch.device("cpu")  # the tests build on the CPU, as a caller asks

SHAPE3 = (16, 8, 128)
SRC3 = int(np.ravel_multi_index((8, 4, 64), SHAPE3))
RCV3 = np.array([np.ravel_multi_index((8, 4, x), SHAPE3) for x in range(128)])
KW3 = dict(nt=21, dt=6e-4, dx=10.0, freq=16.0, src_idx=SRC3, rcv_idx=RCV3,
           sponge_width=3)
SHAPE2 = (20, 20)
KW2 = dict(nt=35, dt=8e-4, dx=10.0, freq=18.0, src_idx=20 * 10 + 10, sponge_width=4)
WIDTHS = [(None, None), (jnp.bfloat16, torch.bfloat16)]
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


def _np_sponge(sp):
    return tuple(np.asarray(f) for f in sp) if isinstance(sp, tuple) else np.asarray(sp)


def carried(Ft, Fj):
    s = Fj.jet.state
    return tw.with_wave_arrays(Ft, wavelet=s["wavelet"], sponge=_np_sponge(s["sponge"]),
                               src_idx=s["src_idx"], rcv_idx=s["rcv_idx"])


def _kw(dim):
    return (SHAPE2, KW2) if dim == "2d" else (SHAPE3, KW3)


def pair(dim, cj=None, ct=None, **extra):
    shape, kw = _kw(dim)
    Fj = jw.q_wave_propagator(shape, fused=False, coeff_dtype=cj, dtype=jnp.float32,
                              **kw, **extra)
    Ft = tw.q_wave_propagator(shape, coeff_dtype=ct, device=CPU, **kw, **extra)
    return Fj, carried(Ft, Fj)


def model(shape, seed=0):
    rng = np.random.default_rng(seed)
    c = (1800.0 + 30.0 * rng.standard_normal(shape)).astype(np.float32)
    q = (40.0 + 20.0 * rng.random(shape)).astype(np.float32)
    return c, q


def models(Fj, Ft, c, q):
    mj = Fj.dom.zeros().setblock(0, jnp.asarray(c)).setblock(1, jnp.asarray(q))
    return mj, tt.BlockVector((_T(c), _T(q)), Ft.dom)


@pytest.fixture
def flush_denormals():
    """XLA on the CPU flushes subnormals; the bitwise tests flush them on the
    port's side too."""
    torch.set_flush_denormal(True)
    try:
        yield
    finally:
        torch.set_flush_denormal(False)


@pytest.mark.parametrize("order", [2, 4, 8])
@pytest.mark.parametrize("gdt", ["f32", "bf16"])
def test_q_step_plain_matches_pallas(order, gdt):
    shape = (16, 16, 128)  # bf16 g tiles at (16, 128) on the TPU
    D, H, W = shape
    rng = np.random.default_rng(order)
    up, u = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    c2 = (0.3 * rng.random(shape)).astype(np.float32)
    g = (0.01 + 0.05 * rng.random(shape)).astype(np.float32)
    tg = _T(g) if gdt == "f32" else _T(g).to(torch.bfloat16)
    gj = jnp.asarray(tg.float().numpy())
    gj = gj if gdt == "f32" else gj.astype(jnp.bfloat16)
    sz, sy, sx = (np.linspace(lo, 1.0, n, dtype=np.float32)
                  for lo, n in ((0.9, D), (0.8, H), (0.7, W)))
    src, s_t, amp = 5 * H * W + 3 * W + 17, -0.37, 2.5e-7
    ref = pw.fused_q_step(jnp.asarray(up), jnp.asarray(u), jnp.asarray(c2), gj,
                          jnp.asarray(sz), jnp.asarray(sy).reshape(H, 1),
                          jnp.asarray(sx).reshape(1, W), jnp.float32(s_t), src,
                          jnp.float32(amp), order=order, interpret=True)
    got = cw.fused_q_step_torch(_T(up), _T(u), _T(c2), tg, _T(sz), _T(sy), _T(sx),
                                torch.tensor(s_t), src, torch.tensor(amp), order=order)
    _close(got.numpy(), ref, rtol=1e-6)


def test_q_step_wrapper_takes_plain_version_on_cpu_in_place():
    shape = (4, 8, 32)
    rng = np.random.default_rng(1)
    up, u, c2 = (_T(rng.standard_normal(shape).astype(np.float32)) for _ in range(3))
    g = _T((0.02 * rng.random(shape)).astype(np.float32))
    f = [torch.linspace(0.8, 1.0, n) for n in shape]
    cw.reset_launch_counts()
    for gg in (g, g.to(torch.bfloat16)):
        ref = cw.fused_q_step_torch(up, u, c2, gg, *f, 0.5, 7, torch.tensor(1e-3), order=4)
        assert torch.equal(cw.fused_q_step(up, u, c2, gg, *f, 0.5, 7, 1e-3, order=4), ref)
        upk = up.clone()
        out = cw.fused_q_step(upk, u, c2, gg, *f, 0.5, 7, 1e-3, order=4, out=upk)
        assert out is upk and torch.equal(upk, ref)
    # g = 0 is the lossless leapfrog K4, bit for bit
    assert torch.equal(cw.fused_q_step(up, u, c2, torch.zeros_like(g), *f, 0.5, 7, 1e-3),
                       cw.fused_leapfrog_step(up, u, c2, *f, 0.5, 7, 1e-3))
    with pytest.raises(TypeError, match="g must be"):
        cw.fused_q_step(up, u, c2, g.half(), *f, 0.5, 7, 1e-3)
    with pytest.raises(ValueError, match="g "):
        cw.fused_q_step(up, u, c2, g[:2].clone(), *f, 0.5, 7, 1e-3)
    with pytest.raises(ValueError, match="out must be"):
        cw.fused_q_step(up, u, c2, g, *f, 0.5, 7, 1e-3, out=u.clone())
    with pytest.raises(ValueError, match="distinct"):
        cw.fused_q_step(u, u, c2, g, *f, 0.5, 7, 1e-3)
    with pytest.raises(ValueError, match="order"):
        cw.fused_q_step(up, u, c2, g, *f, 0.5, 7, 1e-3, order=6)
    assert cw.launch_counts() == ZERO


@pytest.mark.parametrize("dim,width", [("3d", 0), ("3d", 1), ("2d", 0), ("2d", 1)])
def test_forward_bitwise_vs_eager_jax(dim, width, flush_denormals):
    Fj, Ft = pair(dim, *WIDTHS[width])
    c, q = model(_kw(dim)[0])
    mj, mt = models(Fj, Ft, c, q)
    with jax.disable_jit():
        ref = np.asarray(Fj(mj))
    _live(ref)
    got = Ft(mt).numpy()
    assert got.shape == ref.shape == (_kw(dim)[1]["nt"], 128)
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("dim,width,order,dtrec", [
    ("3d", 0, 2, None), ("3d", 1, 4, 1.2e-3), ("3d", 0, 8, None), ("2d", 0, 4, 2e-3),
    ("2d", 1, 2, None)])
def test_forward_matches_jitted_jax(dim, width, order, dtrec):
    Fj, Ft = pair(dim, *WIDTHS[width], space_order=order, dtrec=dtrec)
    assert Ft.rng.shape == Fj.rng.shape
    c, q = model(_kw(dim)[0], 1)
    mj, mt = models(Fj, Ft, c, q)
    _close(Ft(mt).numpy(), Fj(mj))


@pytest.mark.parametrize("width", [0, 1])
def test_kernel_route_on_cpu_equals_plain_route(width):
    """``fused=True`` on CPU tensors runs the kernel route (K14 in place,
    :class:`_QStep` under autodiff, K14 in the stored adjoint's forward
    sweep) through the wrapper's plain version: forward and stored adjoints
    are bitwise the plain route's, the tangent and the derived adjoint
    agree to roundoff, nothing is launched."""
    ct = WIDTHS[width][1]
    c, q = model(SHAPE3, 2)
    sp = tt.BlockSpace([tt.Space(SHAPE3, device=CPU)] * 2)
    m = tt.BlockVector((_T(c), _T(q)), sp)
    rng = np.random.default_rng(3)
    d = _T(rng.standard_normal((21, 128)).astype(np.float32))
    dm = tt.BlockVector((_T(rng.standard_normal(SHAPE3).astype(np.float32)),
                         _T(rng.standard_normal(SHAPE3).astype(np.float32))), sp)
    cw.reset_launch_counts()
    for store in (None, "f32", "bf16", "int8"):
        Fk, Fp = (tw.q_wave_propagator(SHAPE3, fused=f, coeff_dtype=ct, store_adjoint=store,
                                       device=CPU, **KW3) for f in (True, False))
        yk, yp = Fk(m), Fp(m)
        _live(yp)
        assert torch.equal(yk, yp)
        gk, gp = Fk.linearize(m).H(d), Fp.linearize(m).H(d)
        for a, b in zip(gk, gp):
            if store is None:  # the Function's backward rounds its own transpose
                _close(a, b)
            else:
                _live(b)
                assert torch.equal(a, b)
    _close(Fk.linearize(m)(dm), Fp.linearize(m)(dm))
    assert cw.launch_counts() == ZERO


@pytest.mark.parametrize("dim", ["3d", "2d"])
def test_q_infinite_reduces_bitwise_to_wave_propagator(dim):
    shape, kw = _kw(dim)
    c, _ = model(shape, 4)
    for fused in ((None, True) if dim == "3d" else (None,)):
        Fq = tw.q_wave_propagator(shape, fused=fused, device=CPU, **kw)
        F0 = tw.wave_propagator(shape, fused=fused, device=CPU, **kw)
        m = tt.BlockVector((_T(c), torch.full(shape, float("inf"))), Fq.dom)
        d0 = F0(_T(c))
        _live(d0)
        assert torch.equal(Fq(m), d0)


@pytest.mark.parametrize("dim,store,width", [
    ("3d", "f32", 0), ("3d", "bf16", 0), ("3d", "int8", 0), ("3d", "int8", 1),
    ("3d", "f32", 1), ("2d", "f32", 0), ("2d", "int8", 1)])
def test_stored_adjoint_matches_jax(dim, store, width):
    Fj, Ft = pair(dim, *WIDTHS[width], store_adjoint=store)
    c, q = model(_kw(dim)[0], 5)
    mj, mt = models(Fj, Ft, c, q)
    d = np.asarray(Fj(mj.setblock(0, jnp.asarray(c * 1.02)))) - np.asarray(Fj(mj))
    gj = Fj.linearize(mj).H(jnp.asarray(d))
    gt = Ft.linearize(mt).H(_T(d))
    for i in range(2):  # (gc, gQ)
        _close(gt[i].numpy(), gj.getblock(i))


def test_stored_adjoint_with_dtrec_matches_jax():
    Fj, Ft = pair("3d", store_adjoint="int8", dtrec=1.2e-3)
    c, q = model(SHAPE3, 6)
    mj, mt = models(Fj, Ft, c, q)
    d = np.random.default_rng(7).standard_normal(Fj.rng.shape).astype(np.float32)
    gj, gt = Fj.linearize(mj).H(jnp.asarray(d)), Ft.linearize(mt).H(_T(d))
    for i in range(2):
        _close(gt[i].numpy(), gj.getblock(i))


@pytest.mark.parametrize("dim,width", [("3d", 0), ("3d", 1), ("2d", 0)])
def test_autodiff_adjoint_and_tangent_match_jax(dim, width):
    Fj, Ft = pair(dim, *WIDTHS[width])
    shape = _kw(dim)[0]
    c, q = model(shape, 8)
    mj, mt = models(Fj, Ft, c, q)
    rng = np.random.default_rng(9)
    d = rng.standard_normal(Fj.rng.shape).astype(np.float32)
    gj, gt = Fj.linearize(mj).H(jnp.asarray(d)), Ft.linearize(mt).H(_T(d))
    for i in range(2):
        _close(gt[i].numpy(), gj.getblock(i))
    dc, dq = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    dmj = Fj.dom.zeros().setblock(0, jnp.asarray(dc)).setblock(1, jnp.asarray(dq))
    _close(Ft.linearize(mt)(tt.BlockVector((_T(dc), _T(dq)), Ft.dom)).numpy(),
           Fj.linearize(mj)(dmj))


def test_gates_in_float64():
    """The port's own gates on test_wavefd.py's 20² Q problem (f64): the
    Jacobian passes the dot-product gate with the autodiff adjoint and
    with the stored f32 history (``rtol=1e-9``), and the linearization
    gate shows second-order decay; smaller Q absorbs more."""
    kw = dict(nt=60, dt=8e-4, dx=10.0, freq=18.0, src_idx=20 * 10 + 10, sponge_width=4,
              dtype=torch.float64, device=CPU)
    c0 = torch.full((20, 20), 2000.0, dtype=torch.float64)
    g = torch.Generator().manual_seed(0)
    for store in (None, "f32"):
        F = tw.q_wave_propagator((20, 20), store_adjoint=store, **kw)
        m0 = tt.BlockVector((c0, torch.full((20, 20), 30.0, dtype=torch.float64)), F.dom)
        J = F.linearize(m0)
        lhs, rhs = tt.dot_product_test(J, J.dom.randn(g), J.rng.randn(g))
        _live(float(rhs))
        np.testing.assert_allclose(float(lhs), float(rhs), rtol=1e-9)
    dm = F.dom.randn(torch.Generator().manual_seed(2))
    dm = tt.BlockVector((50.0 * dm[0], 2.0 * dm[1]), F.dom)
    obs, exp = tt.linearization_test(F, m0, delta_m=dm, mu=(1.0, 0.5, 0.25, 0.125))
    np.testing.assert_allclose(obs.numpy(), exp.numpy(), rtol=0.35)
    energy = [float(torch.sum(F(tt.BlockVector((c0, torch.full_like(c0, Q)), F.dom)) ** 2))
              for Q in (1e9, 100.0, 20.0)]
    assert energy[0] > energy[1] > energy[2] > 0


def test_jacobian_gate_on_the_kernel_route():
    """The tangent through :class:`_QStep` against the stored f32-history
    adjoint whose forward sweep rides K14 (their plain versions here), in
    float32 with f64 sums: ``rtol=1e-4``."""
    F = tw.q_wave_propagator(SHAPE3, fused=True, store_adjoint="f32", device=CPU, **KW3)
    c, q = model(SHAPE3, 10)
    J = F.linearize(tt.BlockVector((_T(c), _T(q)), F.dom))
    g = torch.Generator().manual_seed(1)
    m, d = J.dom.randn(g), J.rng.randn(g)
    Jm, Jd = J(m), J.H(d)
    lhs = float(torch.vdot(d.double().reshape(-1), Jm.double().reshape(-1)))
    rhs = sum(float(torch.vdot(a.double().reshape(-1), b.double().reshape(-1)))
              for a, b in zip(Jd, m))
    _live(lhs)
    np.testing.assert_allclose(lhs, rhs, rtol=1e-4)


def test_validation_and_what_is_not_ported():
    with pytest.raises(ValueError, match="coeff_dtype"):
        tw.q_wave_propagator(SHAPE2, coeff_dtype=torch.float16, device=CPU)
    with pytest.raises(ValueError, match="fused Q step"):
        tw.q_wave_propagator(SHAPE2, fused=True, device=CPU)
    with pytest.raises(ValueError, match="store_adjoint"):
        tw.q_wave_propagator(SHAPE2, store_adjoint="int4", device=CPU)
    with pytest.raises(ValueError, match="space_order"):
        tw.q_wave_propagator(SHAPE2, space_order=6, device=CPU)
    F2 = tw.q_wave_propagator(SHAPE2, nt=8, remat_blocks=2, device=CPU)
    m = tt.BlockVector((torch.full(SHAPE2, 1500.0), torch.full(SHAPE2, 40.0)), F2.dom)
    assert torch.equal(F2(m), tw.q_wave_propagator(SHAPE2, nt=8, device=CPU)(m))
    F = tw.q_wave_propagator(SHAPE2, nt=8, f0=25.0, device=CPU)
    assert isinstance(F.dom, tt.BlockSpace) and F.dom.nblocks == 2
    assert F.rng.shape == (8, 128)
