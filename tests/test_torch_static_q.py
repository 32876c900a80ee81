"""Static Kosloff Q on the port's VTI and TTI propagators
(``vti_wave_propagator(q=...)``, ``tti_wave_propagator(q=...)``) held against
``jets_tpu.ops.wave`` on the CPU, on the same numpy inputs, with the JAX
operator's wavelet, sponge and geometry carried across
(``with_wave_arrays``): the counterparts of ``TestAnisotropicStaticQ`` and
the two ``test_static_q_stored_matches_autodiff`` of
``tests/test_wavefd.py``, with bf16 TTI coefficients, ``dtrec`` and the
stored adjoints beside them.

Q is a modelling parameter (a scalar or a grid), not a block of the domain.
No kernel takes friction fields: a Q'ed propagator takes the plain steps,
``fused=None`` launches nothing and ``fused=True`` raises. ``q=inf`` gives
friction factors of exactly 1, so its traces and stored gradients are the
lossless plain route's bit for bit, and so the kernel route's (whose plain
versions run here).

Tolerances: against EAGER JAX (op by op, subnormals flushed on both sides)
the VTI forward with Q is bitwise; against jitted JAX (FMA contraction on
the CPU) traces, tangents and gradients agree to ``rtol=1e-5,
atol=1e-5·max|ref|``; TTI at general angles, whose float32 cosines JAX
rounds an ulp apart on a few percent of elements (``tests/test_torch_tti.py``),
agrees to the same for traces and f32 histories, to 1e-3 of each block's
peak for int8 histories. Stored f32-history adjoints against autograd:
``rtol=1e-5, atol=2e-5`` (VTI) and ``rtol=1e-4, atol=5e-5`` (TTI) of each
block's peak, as the JAX tests; float64 gates ``rtol=1e-9``. Every
comparison has a live-signal guard.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jets_tpu_torch as tt
from jets_tpu.ops import wave as jw
from jets_tpu_torch.ops import cuda_tti as ct
from jets_tpu_torch.ops import cuda_vti as cv
from jets_tpu_torch.ops import wave as tw

CPU = torch.device("cpu")  # the tests build on the CPU, as a caller asks

SHAPE3 = (12, 8, 32)
SRC3 = int(np.ravel_multi_index((6, 4, 16), SHAPE3))
RCV3 = np.array([np.ravel_multi_index((6, 4, x), SHAPE3) for x in range(32)])
KW3 = dict(nt=16, dt=6e-4, dx=10.0, freq=16.0, src_idx=SRC3, rcv_idx=RCV3, sponge_width=3)
SHAPE2 = (20, 20)
KW2 = dict(nt=40, dt=8e-4, dx=10.0, freq=18.0, src_idx=20 * 10 + 10, sponge_width=3)
NBLOCKS = {("vti", "2d"): 3, ("vti", "3d"): 3, ("tti", "2d"): 4, ("tti", "3d"): 5}


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


def _q_grid(shape, seed=11):
    """A grid of quality factors 20-40."""
    return (20.0 + 20.0 * np.random.default_rng(seed).random(shape)).astype(np.float32)


def ctor(kind, dim, coeff=None, device=CPU, **extra):
    shape, kw = _kw(dim)
    cd = {} if coeff is None else {"coeff_dtype": torch.bfloat16}
    return getattr(tw, f"{kind}_wave_propagator")(shape, device=device, **{**kw, **extra},
                                                  **cd)


def pair(kind, dim, coeff=None, q=None, **extra):
    shape, kw = _kw(dim)
    cd = {} if coeff is None else {"coeff_dtype": jnp.bfloat16}
    Fj = getattr(jw, f"{kind}_wave_propagator")(shape, fused=False, q=q, dtype=jnp.float32,
                                               **{**kw, **extra}, **cd)
    Ft = ctor(kind, dim, coeff, q=q, **extra)
    s = Fj.jet.state
    sp = s["sponge"]
    sp = tuple(np.asarray(f) for f in sp) if isinstance(sp, tuple) else np.asarray(sp)
    return Fj, tw.with_wave_arrays(Ft, wavelet=s["wavelet"], sponge=sp,
                                   src_idx=s["src_idx"], rcv_idx=s["rcv_idx"])


def model_np(kind, dim, seed=0, dtype=np.float32):
    """(c, ε, δ[, θ[, φ]]): 1500 m/s, Thomsen 0.1/0.05, tilt 0.3 and azimuth
    0.7 rad, perturbed."""
    shape = _kw(dim)[0]
    rng = np.random.default_rng(seed)
    blocks = [1500.0 + 20.0 * rng.standard_normal(shape),
              0.1 + 0.02 * rng.standard_normal(shape),
              0.05 + 0.01 * rng.standard_normal(shape),
              0.3 + 0.05 * rng.standard_normal(shape),
              0.7 + 0.05 * rng.standard_normal(shape)]
    return [b.astype(dtype) for b in blocks[:NBLOCKS[kind, dim]]]


def models(Fj, Ft, blocks):
    mj = Fj.dom.zeros()
    for i, b in enumerate(blocks):
        mj = mj.setblock(i, jnp.asarray(b))
    return mj, tt.BlockVector([_T(b) for b in blocks], Ft.dom)


def tmodel(F, blocks):
    return tt.BlockVector([_T(b) for b in blocks], F.dom)


CASES = [("vti", "2d", None), ("vti", "3d", None), ("tti", "2d", None), ("tti", "3d", None),
         ("tti", "3d", "bf16")]


@pytest.mark.parametrize("kind,dim,coeff", CASES)
def test_infinite_q_is_the_lossless_route_bit_for_bit(kind, dim, coeff):
    """``q=inf`` multiplies by exact ones: the traces and the stored f32
    gradient are the lossless plain route's, and in 3-D the lossless kernel
    route's (its plain versions here), bit for bit; nothing launches."""
    cv.reset_launch_counts()
    ct.reset_launch_counts()
    m = tmodel(ctor(kind, dim, coeff), model_np(kind, dim, 1))
    d = _T(np.random.default_rng(2).standard_normal(
        ctor(kind, dim, coeff).rng.shape).astype(np.float32))
    routes = (None, True) if dim == "3d" else (None,)
    # the 2-D tilt keeps the autodiff adjoint (no stored sweep)
    for store in (None,) if (kind, dim) == ("tti", "2d") else (None, "f32"):
        Fq = ctor(kind, dim, coeff, q=float("inf"), store_adjoint=store)
        yq = Fq(m)
        gq = Fq.linearize(m).H(d) if store else None
        for fused in routes:
            F0 = ctor(kind, dim, coeff, fused=fused, store_adjoint=store)
            y0 = F0(m)
            _live(y0)
            assert torch.equal(yq, y0), (store, fused)
            if store:
                for a, b in zip(gq, F0.linearize(m).H(d)):
                    _live(b)
                    assert torch.equal(a, b), (store, fused)
    # the Q'ed runs launched nothing; only the lossless fused=True runs
    # went through the wrappers (their plain versions, uncounted on the CPU)
    assert all(n == 0 for n in {**cv.launch_counts(), **ct.launch_counts()}.values())


@pytest.mark.parametrize("kind", ["vti", "tti"])
def test_finite_q_attenuates(kind):
    F0, Fq = ctor(kind, "2d"), ctor(kind, "2d", q=8.0)
    m = tmodel(F0, [np.full(SHAPE2, v, np.float32)
                    for v in (2000.0, 0.1, 0.05, 0.2)[:NBLOCKS[kind, "2d"]]])
    tail = slice(30, None)  # the late arrivals carry the decay
    e0 = float(torch.linalg.vector_norm(F0(m)[tail]))
    eq = float(torch.linalg.vector_norm(Fq(m)[tail]))
    assert e0 > 0 and eq < 0.9 * e0, (kind, e0, eq)


@pytest.mark.parametrize("kind", ["vti", "tti"])
def test_q_jacobian_gate_in_float64(kind):
    g = torch.Generator().manual_seed(51)
    # the 2-D tilt keeps the autodiff adjoint (no stored sweep)
    for store in (None, "f32") if kind == "vti" else (None,):
        F = getattr(tw, f"{kind}_wave_propagator")(SHAPE2, q=30.0, store_adjoint=store,
                                                  dtype=torch.float64, device=CPU, **KW2)
        m0 = tmodel(F, [np.full(SHAPE2, v) for v in
                        (2000.0, 0.1, 0.05, 0.2)[:NBLOCKS[kind, "2d"]]])
        J = F.linearize(m0)
        lhs, rhs = tt.dot_product_test(J, J.dom.randn(g), J.rng.randn(g))
        _live(float(rhs))
        np.testing.assert_allclose(float(lhs), float(rhs), rtol=1e-9)


def test_fused_true_with_q_raises():
    for kind in ("vti", "tti"):
        with pytest.raises(ValueError, match=f"fused {kind.upper()} step does not support "
                                             "static Q"):
            ctor(kind, "3d", q=30.0, fused=True)
    # the internal sweeps refuse the kernel route for friction fields too
    blocks = [_T(b) for b in model_np("tti", "3d", 3)]
    fr = tw._static_q(30.0, 6e-4, 16.0, SHAPE3, torch.float32)
    cfg = dict(dt=6e-4, dx=10.0, sponge=tw._make_sponge(SHAPE3, 3), fused=True, **fr)
    wav, rcv = torch.ones(4), torch.as_tensor(RCV3)
    for fn, args, what in (
            (tw._propagate_vti, (*blocks[:3], wav, SRC3, rcv), "VTI"),
            (tw._adjoint_stored_vti, (*blocks[:3], torch.ones(4, 32), wav, SRC3, rcv), "VTI"),
            (tw._propagate_tti3d, (*blocks, wav, SRC3, rcv), "TTI"),
            (tw._adjoint_stored_tti3d, (*blocks, torch.ones(4, 32), wav, SRC3, rcv), "TTI")):
        with pytest.raises(ValueError, match=f"fused {what} step does not support static Q"):
            fn(*args, **cfg)


def test_vti_forward_with_q_bitwise_vs_eager_jax():
    torch.set_flush_denormal(True)
    try:
        for q in (25.0, _q_grid(SHAPE3)):
            Fj, Ft = pair("vti", "3d", q=q, nt=8)  # eager JAX runs op by op: a short run
            mj, mt = models(Fj, Ft, model_np("vti", "3d", 4))
            with jax.disable_jit():
                ref = np.asarray(Fj(mj))
            _live(ref)
            np.testing.assert_array_equal(Ft(mt).numpy(), ref)
    finally:
        torch.set_flush_denormal(False)


@pytest.mark.parametrize("kind,dim,coeff,grid_q,dtrec", [
    ("vti", "3d", None, True, 1.2e-3), ("tti", "2d", None, False, None),
    ("tti", "3d", "bf16", True, 1.2e-3)])
def test_forward_tangent_and_autodiff_adjoint_match_jax(kind, dim, coeff, grid_q, dtrec):
    shape = _kw(dim)[0]
    Fj, Ft = pair(kind, dim, coeff, q=_q_grid(shape) if grid_q else 30.0, dtrec=dtrec)
    assert Ft.rng.shape == Fj.rng.shape
    blocks = model_np(kind, dim, 5)
    mj, mt = models(Fj, Ft, blocks)
    _close(Ft(mt).numpy(), Fj(mj))
    rng = np.random.default_rng(6)
    dm = [(s * rng.standard_normal(shape)).astype(np.float32)
          for s in (20.0, 0.02, 0.02, 0.05, 0.05)[:len(blocks)]]
    dmj, dmt = models(Fj, Ft, dm)
    _close(Ft.linearize(mt)(dmt).numpy(), Fj.linearize(mj)(dmj))
    d = rng.standard_normal(Fj.rng.shape).astype(np.float32)
    gj, gt = Fj.linearize(mj).H(jnp.asarray(d)), Ft.linearize(mt).H(_T(d))
    for i in range(len(blocks)):
        _close(gt[i].numpy(), gj.getblock(i))


@pytest.mark.parametrize("kind,coeff,store,dtrec", [
    ("vti", None, "f32", None), ("vti", None, "int8", 1.2e-3), ("tti", None, "f32", None),
    ("tti", "bf16", "int8", 1.2e-3)])
def test_stored_adjoint_with_q_matches_jax(kind, coeff, store, dtrec):
    Fj, Ft = pair(kind, "3d", coeff, q=_q_grid(SHAPE3), store_adjoint=store, dtrec=dtrec)
    blocks = model_np(kind, "3d", 7)
    mj, mt = models(Fj, Ft, blocks)
    mj2 = mj.setblock(0, jnp.asarray(blocks[0] * 1.02))
    d = np.asarray(Fj(mj2)) - np.asarray(Fj(mj))
    gj, gt = Fj.linearize(mj).H(jnp.asarray(d)), Ft.linearize(mt).H(_T(d))
    tol = 1e-3 if kind == "tti" and store == "int8" else 1e-5
    for i in range(len(blocks)):
        _close(gt[i].numpy(), gj.getblock(i), atol=tol)


@pytest.mark.parametrize("kind,dim,coeff", [("vti", "2d", None), ("vti", "3d", None),
                                            ("tti", "3d", None), ("tti", "3d", "bf16")])
def test_static_q_stored_matches_autodiff(kind, dim, coeff):
    """The transposed recurrence carries the same ``og``/``ig`` factors as
    the forward: the stored f32-history sweep against autograd through the
    Q'ed time loop."""
    Fa = ctor(kind, dim, coeff, q=25.0)
    Fs = ctor(kind, dim, coeff, q=25.0, store_adjoint="f32")
    m0 = tmodel(Fa, model_np(kind, dim, 8))
    d = _T(np.random.default_rng(66).standard_normal(Fa.rng.shape).astype(np.float32))
    ga, gs = Fa.linearize(m0).H(d), Fs.linearize(m0).H(d)
    rtol, atol = (1e-5, 2e-5) if kind == "vti" else (1e-4, 5e-5)
    for i, (a, s) in enumerate(zip(ga, gs)):
        a, s = a.numpy(), s.numpy()
        scale = float(np.max(np.abs(a)))
        assert scale > 0.0, f"vacuous: zero adjoint block {i}"
        np.testing.assert_allclose(s / scale, a / scale, rtol=rtol, atol=atol,
                                   err_msg=f"block {i}")


@pytest.mark.parametrize("kind", ["vti", "tti"])
def test_remat_blocks_with_q(kind):
    F1, F4 = ctor(kind, "3d", q=30.0), ctor(kind, "3d", q=30.0, remat_blocks=4)
    m = tmodel(F1, model_np(kind, "3d", 9))
    y1 = F1(m)
    _live(y1)
    assert torch.equal(F4(m), y1)
    d = _T(np.random.default_rng(10).standard_normal(F1.rng.shape).astype(np.float32))
    for a, b in zip(F4.linearize(m).H(d), F1.linearize(m).H(d)):
        _live(b)
        assert torch.equal(a, b)
