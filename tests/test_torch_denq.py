"""The port's variable-density physics (``vd_wave_propagator``) and the full
IsoDenQ physics (``vdq_wave_propagator``: velocity, buoyancy and Kosloff
constant Q) held against ``jets_tpu.ops.wave`` on the CPU, on the same numpy
inputs, with the JAX operator's wavelet, sponge and geometry carried across
(``with_wave_arrays``): the counterparts of ``test_vd_*``,
``test_vdq_full_denq_physics`` and the vd/vdq cases of
``TestStoredAdjointDenQ`` in ``tests/test_wavefd.py``.

Tolerances: against EAGER JAX (op by op, subnormals flushed on both sides)
the forward and ``_div_b_grad`` are bitwise (the port keeps JAX's tree; the
staggered buoyancies ``b_{i+½}`` are computed once per propagation, the
same bits as once per step). Against jitted JAX (FMA contraction on the
CPU) traces, tangents and gradients agree to ``rtol=1e-5,
atol=1e-5·max|ref|`` (bf16 and int8 histories included: both packages
encode alike); stored f32-history adjoints against autograd to ``rtol=1e-5,
atol=2e-5`` of each block's peak, as the JAX tests; float64 gates
``rtol=1e-9``, float32 gates with the f32 history ``rtol=2e-4``. Q = ∞ is
``vd_wave_propagator`` bit for bit. Every comparison has a live-signal
guard.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jets_tpu_torch as tt
from jets_tpu.ops import wave as jw
from jets_tpu_torch.ops import wave as tw

CPU = torch.device("cpu")  # the tests build on the CPU, as a caller asks

SHAPE2 = (24, 24)
KW2 = dict(nt=36, dt=8e-4, dx=10.0, freq=18.0, src_idx=12 * 24 + 12, sponge_width=4)
SHAPE3 = (12, 10, 16)
SRC3 = int(np.ravel_multi_index((6, 5, 8), SHAPE3))
RCV3 = np.array([np.ravel_multi_index((3, 5, x), SHAPE3) for x in range(16)])
KW3 = dict(nt=24, dt=6e-4, dx=10.0, freq=16.0, src_idx=SRC3, rcv_idx=RCV3, sponge_width=3)


def _live(x):
    assert float(np.max(np.abs(np.asarray(x, np.float64)))) > 0.0, "vacuous: zero signal"


def _close(got, ref, rtol=1e-5, atol=1e-5):
    ref = np.asarray(ref, np.float64)
    _live(ref)
    np.testing.assert_allclose(np.asarray(got, np.float64), ref, rtol=rtol,
                               atol=atol * float(np.max(np.abs(ref))))


def _T(x):
    return torch.from_numpy(np.array(x))


def _kw(dim):
    return (SHAPE2, KW2) if dim == "2d" else (SHAPE3, KW3)


def carried(Ft, Fj):
    s = Fj.jet.state
    sp = s["sponge"]
    sp = tuple(np.asarray(f) for f in sp) if isinstance(sp, tuple) else np.asarray(sp)
    return tw.with_wave_arrays(Ft, wavelet=s["wavelet"], sponge=sp, src_idx=s["src_idx"],
                               rcv_idx=s["rcv_idx"])


def pair(kind, dim, dtype=np.float32, **extra):
    shape, kw = _kw(dim)
    kw = {**kw, **extra}
    Fj = getattr(jw, f"{kind}_wave_propagator")(shape, dtype=jnp.dtype(dtype), **kw)
    Ft = getattr(tw, f"{kind}_wave_propagator")(
        shape, dtype=torch.from_numpy(np.zeros(1, dtype)).dtype, device=CPU, **kw)
    return Fj, carried(Ft, Fj)


def model(shape, nblocks, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    c = 2000.0 + 30.0 * rng.standard_normal(shape)
    b = 1e-3 * (1.0 + 0.3 * rng.random(shape))
    q = 25.0 + 20.0 * rng.random(shape)
    return tuple(x.astype(dtype) for x in (c, b, q)[:nblocks])


def models(Fj, Ft, arrays):
    mj = Fj.dom.zeros()
    for i, a in enumerate(arrays):
        mj = mj.setblock(i, jnp.asarray(a))
    return mj, tt.BlockVector(tuple(_T(a) for a in arrays), Ft.dom)


def _nb(kind):
    return 2 if kind == "vd" else 3


@pytest.fixture
def flush_denormals():
    """XLA on the CPU flushes subnormals; the bitwise tests flush them on the
    port's side too."""
    torch.set_flush_denormal(True)
    try:
        yield
    finally:
        torch.set_flush_denormal(False)


def test_div_b_grad_bitwise_vs_eager_jax_and_symmetric():
    rng = np.random.default_rng(0)
    for shape in ((6, 7), (5, 6, 9)):
        u = rng.standard_normal(shape).astype(np.float32)
        b = (0.5 + rng.random(shape)).astype(np.float32)
        w = rng.standard_normal(shape).astype(np.float32)
        inv = np.float32(1.0 / 100.0)
        with jax.disable_jit():
            ref = np.asarray(jw._div_b_grad(jnp.asarray(u), jnp.asarray(b), jnp.asarray(inv)))
            refb = np.asarray(jw._div_b_grad_bbar(jnp.asarray(u), jnp.asarray(w),
                                                  jnp.asarray(inv)))
        _live(ref)
        bh = tw._b_half(_T(b))
        np.testing.assert_array_equal(tw._div_b_grad(_T(u), bh, torch.tensor(inv)).numpy(), ref)
        np.testing.assert_array_equal(
            tw._div_b_grad_bbar(_T(u), _T(w), torch.tensor(inv)).numpy(), refb)
    # the pinned-b operator materializes to a symmetric negative semidefinite matrix
    sp = tt.Space((6, 7), torch.float64, CPU)
    bh = tw._b_half(0.5 + torch.from_numpy(rng.random((6, 7))))
    A = tt.LinearOperator(tt.Jet(dom=sp, rng=sp, state={"bh": bh}, df=lambda dm, m0, st:
                                 tw._div_b_grad(dm, st["bh"], torch.tensor(1.0,
                                                                           dtype=torch.float64))))
    M = tt.materialize(A).numpy()
    np.testing.assert_allclose(M, M.T, rtol=0, atol=1e-14)
    assert np.linalg.eigvalsh(M).max() <= 1e-12


@pytest.mark.parametrize("kind,dim", [("vd", "2d"), ("vd", "3d"), ("vdq", "2d"),
                                      ("vdq", "3d")])
def test_forward_bitwise_vs_eager_jax(kind, dim, flush_denormals):
    Fj, Ft = pair(kind, dim, nt=14)  # eager JAX runs op by op: a short run
    assert isinstance(Ft.dom, tt.BlockSpace) and Ft.dom.nblocks == _nb(kind)
    mj, mt = models(Fj, Ft, model(_kw(dim)[0], _nb(kind)))
    with jax.disable_jit():
        ref = np.asarray(Fj(mj))
    _live(ref)
    got = Ft(mt).numpy()
    assert got.shape == ref.shape == Ft.rng.shape
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("kind,dim,dtrec", [("vd", "3d", 1.2e-3), ("vdq", "2d", 1.6e-3),
                                            ("vdq", "3d", None)])
def test_forward_tangent_and_autodiff_adjoint_match_jitted_jax(kind, dim, dtrec):
    Fj, Ft = pair(kind, dim, dtrec=dtrec)
    assert Ft.rng.shape == Fj.rng.shape
    shape, nb = _kw(dim)[0], _nb(kind)
    mj, mt = models(Fj, Ft, model(shape, nb, 1))
    _close(Ft(mt).numpy(), Fj(mj))
    rng = np.random.default_rng(2)
    dm = [rng.standard_normal(shape).astype(np.float32) * s
          for s in (10.0, 1e-5, 1.0)[:nb]]
    dmj, dmt = models(Fj, Ft, dm)
    _close(Ft.linearize(mt)(dmt).numpy(), Fj.linearize(mj)(dmj))
    d = rng.standard_normal(Fj.rng.shape).astype(np.float32)
    gj, gt = Fj.linearize(mj).H(jnp.asarray(d)), Ft.linearize(mt).H(_T(d))
    for i in range(nb):
        _close(gt[i].numpy(), gj.getblock(i))


@pytest.mark.parametrize("kind,dim,store", [
    ("vd", "2d", "f32"), ("vd", "2d", "int8"), ("vd", "3d", "bf16"), ("vdq", "2d", "f32"),
    ("vdq", "2d", "bf16"), ("vdq", "3d", "int8")])
def test_stored_adjoint_matches_jax(kind, dim, store):
    Fj, Ft = pair(kind, dim, store_adjoint=store)
    arrays = model(_kw(dim)[0], _nb(kind), 3)
    mj, mt = models(Fj, Ft, arrays)
    mj2 = mj.setblock(0, jnp.asarray(arrays[0] * 1.02))
    d = np.asarray(Fj(mj2)) - np.asarray(Fj(mj))
    gj, gt = Fj.linearize(mj).H(jnp.asarray(d)), Ft.linearize(mt).H(_T(d))
    for i in range(_nb(kind)):
        _close(gt[i].numpy(), gj.getblock(i))


def test_stored_adjoint_with_dtrec_matches_jax():
    Fj, Ft = pair("vdq", "3d", store_adjoint="int8", dtrec=1.2e-3)
    mj, mt = models(Fj, Ft, model(SHAPE3, 3, 4))
    d = np.random.default_rng(5).standard_normal(Fj.rng.shape).astype(np.float32)
    gj, gt = Fj.linearize(mj).H(jnp.asarray(d)), Ft.linearize(mt).H(_T(d))
    for i in range(3):
        _close(gt[i].numpy(), gj.getblock(i))


def _cmp_blocks(ga, gs, nblk):
    for i in range(nblk):
        a, s = ga[i].numpy(), gs[i].numpy()
        scale = float(np.max(np.abs(a)))
        assert scale > 0.0, f"vacuous: zero adjoint block {i}"
        np.testing.assert_allclose(s / scale, a / scale, rtol=1e-5, atol=2e-5,
                                   err_msg=f"block {i}")


@pytest.mark.parametrize("kind,hetero", [("vd", False), ("vd", True), ("vdq", False)])
def test_stored_f32_history_matches_autodiff(kind, hetero):
    """The hand-derived reverse sweep (with a non-constant buoyancy the
    b-transpose ``_div_b_grad_bbar`` works in earnest) against autograd
    through the time loop."""
    kw = dict(KW2, device=CPU)
    Fa = getattr(tw, f"{kind}_wave_propagator")(SHAPE2, **kw)
    Fs = getattr(tw, f"{kind}_wave_propagator")(SHAPE2, store_adjoint="f32", **kw)
    rng = np.random.default_rng(86)
    b = 1e-3 * (1.0 + 0.3 * rng.random(SHAPE2)) if hetero else np.full(SHAPE2, 1e-3)
    blocks = [torch.full(SHAPE2, 2000.0), _T(b.astype(np.float32)),
              torch.full(SHAPE2, 25.0)][:_nb(kind)]
    m0 = tt.BlockVector(blocks, Fa.dom)
    d = _T(rng.standard_normal(Fa.rng.shape).astype(np.float32))
    _cmp_blocks(Fa.linearize(m0).H(d), Fs.linearize(m0).H(d), _nb(kind))


def test_vd_gates_and_taylor_decay_in_float64():
    """``tests/test_wavefd.py``'s 20² variable-density problem: the Jacobian
    passes the float64 gate with the autodiff and the stored f32 adjoints,
    and the linearization gate decays at second order."""
    kw = dict(nt=40, dt=0.0008, dx=10.0, freq=18.0, src_idx=20 * 10 + 10, sponge_width=4,
              dtype=torch.float64, device=CPU)
    c = torch.full((20, 20), 2000.0, dtype=torch.float64)
    b = torch.full((20, 20), 1e-3, dtype=torch.float64)
    g = torch.Generator().manual_seed(5)
    for store in (None, "f32"):
        F = tw.vd_wave_propagator((20, 20), store_adjoint=store, **kw)
        m0 = tt.BlockVector((c, b), F.dom)
        d = F(m0)
        assert d.shape == F.rng.shape
        _live(d)
        J = F.linearize(m0)
        lhs, rhs = tt.dot_product_test(J, J.dom.randn(g), J.rng.randn(g))
        _live(float(rhs))
        np.testing.assert_allclose(float(lhs), float(rhs), rtol=1e-9)
    dm = F.dom.randn(torch.Generator().manual_seed(7))
    dm = tt.BlockVector((50.0 * dm[0], 1e-5 * dm[1]), F.dom)
    obs, exp = tt.linearization_test(F, m0, delta_m=dm, mu=(1.0, 0.5, 0.25, 0.125))
    np.testing.assert_allclose(obs.numpy(), exp.numpy(), rtol=0.35)


def test_vdq_full_denq_physics():
    """IsoDenQ ``(c, b, Q)``: Q = ∞ is variable density bit for bit
    (forward and stored f32 gradient), finite Q attenuates, and the
    Jacobian passes the float64 gate."""
    kw = dict(nt=60, dt=0.0008, dx=10.0, freq=18.0, src_idx=20 * 10 + 10, sponge_width=4,
              dtype=torch.float64, device=CPU)
    Fq = tw.vdq_wave_propagator((20, 20), **kw)
    Fvd = tw.vd_wave_propagator((20, 20), **kw)
    c = torch.full((20, 20), 2000.0, dtype=torch.float64)
    b = torch.full((20, 20), 1e-3, dtype=torch.float64)
    inf = torch.full((20, 20), float("inf"), dtype=torch.float64)
    m_inf = tt.BlockVector((c, b, inf), Fq.dom)
    d_vd = Fvd(tt.BlockVector((c, b), Fvd.dom))
    _live(d_vd)
    assert torch.equal(Fq(m_inf), d_vd)
    m_20 = tt.BlockVector((c, b, torch.full_like(c, 20.0)), Fq.dom)
    e_inf, e_20 = float(torch.sum(Fq(m_inf) ** 2)), float(torch.sum(Fq(m_20) ** 2))
    assert e_inf > e_20 > 0
    J = Fq.linearize(m_20)
    g = torch.Generator().manual_seed(25)
    lhs, rhs = tt.dot_product_test(J, J.dom.randn(g), J.rng.randn(g))
    np.testing.assert_allclose(float(lhs), float(rhs), rtol=1e-9)
    # float32 stored f32-history gradients: (gc, gb) of vdq at Q = inf are vd's
    kw32 = dict(KW2, store_adjoint="f32", device=CPU)
    Fq32 = tw.vdq_wave_propagator(SHAPE2, **kw32)
    Fv32 = tw.vd_wave_propagator(SHAPE2, **kw32)
    c32, b32 = (_T(a) for a in model(SHAPE2, 2, 6))
    d = _T(np.random.default_rng(7).standard_normal(Fq32.rng.shape).astype(np.float32))
    gq = Fq32.linearize(tt.BlockVector((c32, b32, torch.full(SHAPE2, float("inf"))),
                                       Fq32.dom)).H(d)
    gv = Fv32.linearize(tt.BlockVector((c32, b32), Fv32.dom)).H(d)
    for i in range(2):
        _live(gv[i])
        assert torch.equal(gq[i], gv[i]), f"block {i}"
    assert not bool(gq[2].abs().max() > 0), "dQ at Q = inf is zero"


def test_float32_gate_with_the_f32_history():
    Fs = tw.vdq_wave_propagator(SHAPE2, store_adjoint="f32", dtrec=1.6e-3, device=CPU, **KW2)
    m0 = tt.BlockVector((torch.full(SHAPE2, 2000.0), torch.full(SHAPE2, 1e-3),
                         torch.full(SHAPE2, 25.0)), Fs.dom)
    J = Fs.linearize(m0)
    g = torch.Generator().manual_seed(89)
    m, d = J.dom.randn(g), J.rng.randn(g)
    Jm, Jd = J(m), J.H(d)
    lhs = float(torch.vdot(d.double().reshape(-1), Jm.double().reshape(-1)))
    rhs = sum(float(torch.vdot(a.double().reshape(-1), b.double().reshape(-1)))
              for a, b in zip(Jd, m))
    _live(lhs)
    np.testing.assert_allclose(lhs, rhs, rtol=2e-4)


@pytest.mark.parametrize("kind", ["vd", "vdq"])
def test_remat_blocks(kind):
    """``remat_blocks`` checkpoints the loop under a tape: the traces and the
    derived adjoint are the same bits as one segment."""
    F1 = getattr(tw, f"{kind}_wave_propagator")(SHAPE2, device=CPU, **KW2)
    F6 = getattr(tw, f"{kind}_wave_propagator")(SHAPE2, remat_blocks=6, device=CPU, **KW2)
    m = tt.BlockVector(tuple(_T(a) for a in model(SHAPE2, _nb(kind), 8)), F1.dom)
    d1 = F1(m)
    _live(d1)
    assert torch.equal(F6(m), d1)
    r = _T(np.random.default_rng(9).standard_normal(F1.rng.shape).astype(np.float32))
    for a, b in zip(F6.linearize(m).H(r), F1.linearize(m).H(r)):
        _live(b)
        assert torch.equal(a, b)


def test_validation():
    with pytest.raises(ValueError, match="store_adjoint"):
        tw.vd_wave_propagator(SHAPE2, store_adjoint="int4", device=CPU)
    with pytest.raises(ValueError, match="store_adjoint"):
        tw.vdq_wave_propagator(SHAPE2, store_adjoint="fp8", device=CPU)
    F = tw.vdq_wave_propagator(SHAPE2, nt=8, f0=25.0, device=CPU)
    assert F.dom.nblocks == 3 and F.rng.shape == (8, 128)
    assert tw.vd_wave_propagator(SHAPE2, nt=8, device=CPU).dom.nblocks == 2
