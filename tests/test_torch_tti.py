"""The port's TTI wave slice (``tti_wave_propagator``,
``multishot_tti_wave_operator`` in jets_tpu_torch/ops/wave.py) held against
jets_tpu.ops.wave on the CPU, on the same numpy inputs, with the JAX
operator's wavelet, sponge and geometry carried across
(``with_wave_arrays``) so both run on the same state.

Tolerances: the port takes every cosine and sine as a float64 result rounded
to float32 (the same on the CPU and the card); JAX's float32 ``cos``/``sin``
on the CPU differ from those by an ulp on a few percent of the elements
(on the 768-element angle fields of ``test_coefficients_match_jax``: nz 1,
ny 24 and nx 46 elements, 0.13%, 3.1% and 6.0%).
Against eager JAX (``jax.disable_jit``: every multiply and add rounded, as
the port rounds them) with subnormals flushed on both sides (XLA on the CPU
flushes them; ``torch.set_flush_denormal``), the TTI path is therefore
bitwise at θ = φ = 0, where every cosine and sine is exact, and at general
angles agrees to ``rtol=1e-5, atol=1e-5·max|ref|`` for traces and f32
histories, to 1e-4 (bf16 histories) and 1e-3 (int8 histories: an ulp in a
coefficient can move a code by one) of each gradient block's peak. The
jitted JAX tangent and autodiff adjoint contract multiply-adds into FMAs and
agree to ``rtol=1e-5, atol=1e-5·max|ref|``. The float64 gates (dot product
at ``rtol=1e-9``, linearization) run on small 2-D and 3-D problems. Every
comparison has a live-signal guard.
"""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

import jets_tpu_torch as tt
from jets_tpu.ops import wave as jw
from jets_tpu_torch import BlockVector
from jets_tpu_torch.ops import cuda_tti as ct
from jets_tpu_torch.ops import wave as tw
from jets_tpu_torch.parallel.sharded import make_block_mesh
from jets_tpu_torch.ops.stencil import d1_axis

CPU = torch.device("cpu")  # the tests build on the CPU, as a caller asks
SHAPE3 = (12, 8, 128)
SRC3 = int(np.ravel_multi_index((6, 4, 64), SHAPE3))
# receivers on the x-line through the source: the default strided set lies
# on the x=0 plane, which a short run never reaches
RCV3 = np.array([np.ravel_multi_index((6, 4, x), SHAPE3) for x in range(128)])
KW3 = dict(nt=16, dt=6e-4, dx=10.0, freq=16.0, src_idx=SRC3, rcv_idx=RCV3,
           sponge_width=3)
SHAPE2 = (24, 24)
KW2 = dict(nt=30, dt=1e-3, dx=10.0, freq=18.0, src_idx=12 * 24 + 12, sponge_width=4)
ZERO = {k: 0 for k in ("fused_tti_step", "fused_tti_hist_step",
                       "fused_tti_adjoint_step")}
STORE_TOL = {"f32": 1e-5, "bf16": 1e-4, "int8": 1e-3}


@contextlib.contextmanager
def eager_xla_rounding():
    """JAX op by op (no fusion, no FMA contraction) and subnormals flushed on
    the port's side as XLA on the CPU flushes them."""
    torch.set_flush_denormal(True)
    try:
        with jax.disable_jit():
            yield
    finally:
        torch.set_flush_denormal(False)


def _live(x):
    assert float(np.max(np.abs(np.asarray(x)))) > 0.0, "vacuous: signal is zero"


def _close(got, ref, rtol=1e-5, atol=1e-5):
    ref = np.asarray(ref)
    _live(ref)
    np.testing.assert_allclose(np.asarray(got), ref, rtol=rtol,
                               atol=atol * float(np.max(np.abs(ref))))


def _equal(got, ref):
    _live(ref)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))


def _np_sponge(sp):
    return tuple(np.asarray(f) for f in sp) if isinstance(sp, tuple) else np.asarray(sp)


def carried(Ft, Fj):
    """The port operator ``Ft`` running on the JAX operator ``Fj``'s state."""
    s = Fj.jet.state
    if "sstate" in s:
        ss = s["sstate"]
        return tw.with_wave_arrays(Ft, wavelet=ss["wavelet"],
                                   sponge=_np_sponge(ss["sponge"]),
                                   src_idx=s["bstate"]["src"], rcv_idx=ss["rcv"])
    return tw.with_wave_arrays(Ft, wavelet=s["wavelet"], sponge=_np_sponge(s["sponge"]),
                               src_idx=s["src_idx"], rcv_idx=s["rcv_idx"])


def pair(shape, kw, coeff=None, **extra):
    Fj = jw.tti_wave_propagator(shape, fused=False, dtype=jnp.float32,
                                coeff_dtype=jnp.bfloat16 if coeff == "bf16" else None,
                                **kw, **extra)
    Ft = tw.tti_wave_propagator(shape, coeff_dtype=torch.bfloat16 if coeff == "bf16"
                                else None, **kw, **extra, device=CPU)
    return Fj, carried(Ft, Fj)


def _model_np(shape, seed, tilt=True, dtype=np.float32):
    """(c, ε, δ, θ[, φ]) blocks: 1500 m/s, Thomsen 0.1/0.05, tilt 0.3 and
    azimuth 0.7 rad, perturbed (θ = φ = 0 without ``tilt``)."""
    rng = np.random.default_rng(seed)
    blocks = [1500.0 + 20.0 * rng.standard_normal(shape),
              0.1 + 0.02 * rng.standard_normal(shape),
              0.05 + 0.01 * rng.standard_normal(shape)]
    for mean in (0.3, 0.7)[:len(shape) - 1]:
        blocks.append(mean + 0.05 * rng.standard_normal(shape) if tilt
                      else np.zeros(shape))
    return [b.astype(dtype) for b in blocks]


def _perturbation_np(shape, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    scales = (20.0, 0.02, 0.02, 0.05, 0.05)[:len(shape) + 2]
    return [(s * rng.standard_normal(shape)).astype(dtype) for s in scales]


def jm(F, blocks):
    m = F.dom.zeros()
    for i, b in enumerate(blocks):
        m = m.setblock(i, jnp.asarray(b))
    return m


def tm(F, blocks):
    return BlockVector([torch.from_numpy(np.array(b)) for b in blocks], F.dom)


def _jblocks(g, n):
    return [np.asarray(g.getblock(i)) for i in range(n)]


@pytest.mark.parametrize("order", [2, 4, 8])
def test_d1_axis_matches_jax_bitwise(order):
    u = np.random.default_rng(1).standard_normal((6, 8, 16)).astype(np.float32)
    for x in (u, u[0]):
        for ax in range(x.ndim):
            ref = np.asarray(jw._d1_axis(jnp.asarray(x), ax, jnp.float32(0.1), order))
            _equal(d1_axis(torch.from_numpy(x), ax, torch.tensor(0.1), order).numpy(), ref)


@pytest.mark.parametrize("tilt", [False, True])
def test_coefficients_match_jax(tilt):
    """C, 1+2ε and √(1+2δ) bitwise; the axis bitwise at θ = φ = 0 and within
    an ulp of JAX's at general angles; the bf16 straight-through values
    bitwise ``lax.reduce_precision`` of the float32 fields, the streamed
    fields their bfloat16 tensors, the δ chain's root unrounded."""
    shape = (6, 8, 16)
    blocks = _model_np(shape, 0, tilt)
    tb = [torch.from_numpy(b) for b in blocks]
    C, ah, av, nz, ny, nx, inv2, inv1, av_raw, kc = tw._tti_coefficients(*tb, 6e-4, 7.3)
    cj, ej, dj, thj, phj = (jnp.asarray(b) for b in blocks)
    _equal(C.numpy(), (cj * cj) * (6e-4 * 6e-4))
    assert float(inv2) == float(jnp.asarray(1.0 / (7.3 * 7.3), jnp.float32))
    assert float(inv1) == float(jnp.asarray(1.0 / 7.3, jnp.float32))
    _equal(ah.numpy(), 1.0 + 2.0 * ej)
    _equal(av.numpy(), jnp.sqrt(1.0 + 2.0 * dj))
    assert av_raw is av and all(k is f for k, f in zip(kc, (ah, av, nz, ny, nx)))
    refs = [np.asarray(r) for r in (jnp.cos(thj), jnp.sin(thj) * jnp.cos(phj),
                                    jnp.sin(thj) * jnp.sin(phj))]
    if tilt:
        for g, r in zip((nz, ny, nx), refs):
            np.testing.assert_allclose(g.numpy(), r, rtol=2.5e-7, atol=1e-7)
            assert np.mean(g.numpy() != r) < 0.1
    else:
        _equal(nz.numpy(), refs[0])
        assert not ny.any() and not nx.any() and not np.any(refs[1]) and not np.any(refs[2])
    st = tw._tti_coefficients(*tb, 6e-4, 7.3, True)
    for raw, s16, k in zip((ah, av, nz, ny, nx), st[1:6], st[9]):
        np.testing.assert_array_equal(
            s16.numpy(), np.asarray(lax.reduce_precision(jnp.asarray(raw.numpy()), 8, 7)))
        assert k.dtype == torch.bfloat16 and torch.equal(k.float(), s16)
    assert torch.equal(st[8], av)


@pytest.mark.parametrize("dim", ["2d", "3d"])
def test_tti_at_zero_tilt_is_vti(dim):
    shape, kw = (SHAPE2, KW2) if dim == "2d" else (SHAPE3, KW3)
    Ft = tw.tti_wave_propagator(shape, **kw, device=CPU)
    Fv = tw.vti_wave_propagator(shape, **kw, device=CPU)
    m = _model_np(shape, 1, tilt=False)
    yt, yv = Ft(tm(Ft, m)), Fv(tm(Fv, m[:3]))
    _equal(yt.numpy(), yv.numpy())
    if dim == "3d":  # Hᵀ on the summed weight rounds apart from VTI's two Lh
        F5 = tw.tti_wave_propagator(shape, store_adjoint="f32", **kw, device=CPU)
        F3 = tw.vti_wave_propagator(shape, store_adjoint="f32", **kw, device=CPU)
        d = torch.from_numpy(np.random.default_rng(2).standard_normal((16, 128))
                             .astype(np.float32))
        g5, g3 = F5.linearize(tm(F5, m)).H(d), F3.linearize(tm(F3, m[:3])).H(d)
        for a, b in zip(g5.blocks[:3], g3.blocks):
            _close(a.numpy(), b.numpy())


@pytest.mark.parametrize("dim,order,tilt,coeff,dtrec", [
    ("3d", 2, False, None, None), ("3d", 8, False, None, None),
    ("3d", 2, False, "bf16", None), ("3d", 4, True, None, None),
    ("3d", 2, True, "bf16", None), ("3d", 2, True, None, 1.2e-3),
    ("2d", 2, False, None, None), ("2d", 4, True, None, None)])
def test_forward_traces_match_jax(dim, order, tilt, coeff, dtrec):
    """Bitwise at θ = φ = 0, to the trigonometry's ulps elsewhere."""
    shape, kw = (SHAPE2, KW2) if dim == "2d" else (SHAPE3, KW3)
    Fj, Ft = pair(shape, kw, coeff, space_order=order, dtrec=dtrec)
    assert Ft.rng.shape == Fj.rng.shape
    assert isinstance(Ft.dom, tt.BlockSpace) and Ft.dom.nblocks == len(shape) + 2
    m = _model_np(shape, 2, tilt)
    with eager_xla_rounding():
        ref = np.asarray(Fj(jm(Fj, m)))
        got = Ft(tm(Ft, m)).numpy()
    if tilt:
        _close(got, ref)
    else:
        _equal(got, ref)


@pytest.mark.parametrize("dim", ["2d", "3d"])
def test_tangent_matches_jax_jvp(dim):
    shape, kw = (SHAPE2, KW2) if dim == "2d" else (SHAPE3, KW3)
    Fj, Ft = pair(shape, kw)
    m, dm = _model_np(shape, 3), _perturbation_np(shape, 4)
    _, ref = jax.jvp(lambda x: Fj(x), (jm(Fj, m),), (jm(Fj, dm),))
    _close(tw.born_operator(Ft, tm(Ft, m))(tm(Ft, dm)).numpy(), ref)


def _residual(Fj, shape, seed, tilt=True):
    m = _model_np(shape, seed, tilt)
    m_obs = [m[0] * np.float32(1.02)] + m[1:]
    d = np.array(Fj(jm(Fj, m_obs)) - Fj(jm(Fj, m)))  # physical residual
    _live(d)
    return m, d


@pytest.mark.parametrize("store,coeff", [("f32", None), ("bf16", None), ("int8", None),
                                         ("f32", "bf16"), ("bf16", "bf16"),
                                         ("int8", "bf16")])
def test_stored_adjoint_matches_jax_per_block(store, coeff):
    """All five blocks against JAX's ``_adjoint_stored_tti3d`` at general
    angles."""
    Fj, Ft = pair(SHAPE3, KW3, coeff, store_adjoint=store)
    m, d = _residual(Fj, SHAPE3, 5)
    with eager_xla_rounding():
        gj = _jblocks(Fj.linearize(jm(Fj, m)).H(jnp.asarray(d)), 5)
        gt = Ft.linearize(tm(Ft, m)).H(torch.from_numpy(d))
    assert isinstance(gt, BlockVector) and gt.nblocks == 5
    for a, b in zip(gt.blocks, gj):
        _close(a.numpy(), b, rtol=0.0, atol=STORE_TOL[store])


@pytest.mark.parametrize("store,coeff", [("f32", None), ("bf16", None), ("int8", None),
                                         ("int8", "bf16")])
def test_stored_adjoint_is_bitwise_jax_at_zero_tilt(store, coeff):
    """At θ = φ = 0 every block but the azimuth's is bitwise JAX's; the
    azimuth gradient vanishes there (sinθ = 0) on both sides."""
    Fj, Ft = pair(SHAPE3, KW3, coeff, store_adjoint=store)
    m, d = _residual(Fj, SHAPE3, 6, tilt=False)
    with eager_xla_rounding():
        gj = _jblocks(Fj.linearize(jm(Fj, m)).H(jnp.asarray(d)), 5)
        gt = Ft.linearize(tm(Ft, m)).H(torch.from_numpy(d))
    for a, b in zip(gt.blocks[:4], gj[:4]):
        _equal(a.numpy(), b)
    assert not gt.blocks[4].any() and not np.any(gj[4])


@pytest.mark.parametrize("dim", ["2d", "3d"])
def test_autodiff_adjoint_matches_jax(dim):
    shape, kw = (SHAPE2, KW2) if dim == "2d" else (SHAPE3, KW3)
    Fj, Ft = pair(shape, kw)
    m = _model_np(shape, 6)
    d = np.random.default_rng(7).standard_normal(Fj.rng.shape).astype(np.float32)
    gt = Ft.linearize(tm(Ft, m)).H(torch.from_numpy(d))
    gj = _jblocks(Fj.linearize(jm(Fj, m)).H(jnp.asarray(d)), len(shape) + 2)
    for a, b in zip(gt.blocks, gj):
        _close(a.numpy(), b)


@pytest.mark.parametrize("coeff", [None, "bf16"])
def test_kernel_route_on_cpu_equals_plain_route(coeff):
    """``fused=True`` on CPU tensors runs the kernel route (the K11 autograd
    Function, in-place sweeps, K12 and K13) through the wrappers' plain
    versions: forward and stored adjoints are bitwise the plain route's, the
    derived adjoint and the tangent agree to roundoff, nothing is launched."""
    m = _model_np(SHAPE3, 10)
    d = torch.from_numpy(np.random.default_rng(11).standard_normal((16, 128))
                         .astype(np.float32))
    cd = torch.bfloat16 if coeff else None
    ct.reset_launch_counts()
    for store in (None, "f32", "bf16", "int8"):
        Fk, Fp = (tw.tti_wave_propagator(SHAPE3, fused=f, store_adjoint=store,
                                         coeff_dtype=cd, **KW3, device=CPU)
                  for f in (True, False))
        mk, mp = tm(Fk, m), tm(Fp, m)
        yk, yp = Fk(mk), Fp(mp)
        _live(yp)
        assert torch.equal(yk, yp)
        gk, gp = Fk.linearize(mk).H(d), Fp.linearize(mp).H(d)
        for a, b in zip(gk.blocks, gp.blocks):
            if store is None:  # the Function's vjp runs its own transform
                _close(a, b)
            else:
                _live(b)
                assert torch.equal(a, b)
    dm = _perturbation_np(SHAPE3, 12)
    _close(Fk.linearize(mk)(tm(Fk, dm)), Fp.linearize(mp)(tm(Fp, dm)))
    # a tape through the Function matches a tape through the plain step
    grads = []
    for F in (Fk, Fp):
        leaves = [torch.from_numpy(b).requires_grad_() for b in m]
        torch.sum(F(BlockVector(leaves, F.dom)) ** 2).backward()
        grads.append([x.grad for x in leaves])
    for a, b in zip(*grads):
        _close(a, b)
    assert ct.launch_counts() == ZERO


def _f64_problem(dim, **kw):
    if dim == "2d":
        return tw.tti_wave_propagator((20, 20), nt=40, dt=0.0008, dx=10.0, freq=18.0,
                                      src_idx=20 * 10 + 10, sponge_width=4,
                                      dtype=torch.float64, **kw, device=CPU)
    shape = (8, 8, 16)
    return tw.tti_wave_propagator(shape, nt=20, dt=0.0008, dx=10.0, freq=18.0,
                                  src_idx=int(np.ravel_multi_index((4, 4, 8), shape)),
                                  rcv_idx=[int(np.ravel_multi_index((4, 4, x), shape))
                                           for x in range(16)],
                                  sponge_width=2, dtype=torch.float64, **kw, device=CPU)


def _f64_point(F):
    shape = F.dom.subspace(0).shape
    vals = (2000.0, 0.1, 0.05, 0.4, 0.6)[:len(shape) + 2]
    return BlockVector([torch.full(shape, v, dtype=torch.float64) for v in vals], F.dom)


@pytest.mark.parametrize("dim,store", [("2d", None), ("3d", None), ("3d", "f32")])
def test_gates_in_float64(dim, store):
    """The dot-product gate (f64, ``rtol=1e-9``; autodiff and stored
    adjoints) and the linearization gate (second-order Taylor decay)."""
    F = _f64_problem(dim, store_adjoint=store)
    J = F.linearize(_f64_point(F))
    g = torch.Generator().manual_seed(17)
    lhs, rhs = tt.dot_product_test(J, J.dom.randn(g), J.rng.randn(g))
    _live(float(rhs))
    np.testing.assert_allclose(float(lhs), float(rhs), rtol=1e-9)
    if store is None:
        dm = F.dom.randn(torch.Generator().manual_seed(19))
        scales = (50.0, 0.02, 0.02, 0.05, 0.05)
        dm = BlockVector([s * b for s, b in zip(scales, dm.blocks)], F.dom)
        obs, exp = tt.linearization_test(F, _f64_point(F), delta_m=dm,
                                         mu=(1.0, 0.5, 0.25, 0.125))
        np.testing.assert_allclose(obs.numpy(), exp.numpy(), rtol=0.35)


def test_lossy_histories_keep_the_f32_gradient_direction():
    """int8 and bf16 histories against the f32 history, per block, by cosine
    on a physical residual (a tight dot-product gate is out of reach for a
    lossy history)."""
    Fj = jw.tti_wave_propagator(SHAPE3, fused=False, **KW3)
    m, d = _residual(Fj, SHAPE3, 13)
    g = {}
    for store in ("f32", "bf16", "int8"):
        F = carried(tw.tti_wave_propagator(SHAPE3, store_adjoint=store, **KW3, device=CPU),
                    Fj)
        g[store] = F.linearize(tm(F, m)).H(torch.from_numpy(d))
    for store, tol in (("bf16", 2e-2), ("int8", 5e-2)):
        for a, b in zip(g[store].blocks, g["f32"].blocks):
            a, b = a.numpy().ravel().astype(np.float64), b.numpy().ravel().astype(np.float64)
            _live(b)
            cos = float(np.dot(a, b) / (np.linalg.norm(a) * np.linalg.norm(b)))
            assert cos > 1.0 - tol, f"{store}: cosine {cos}"


def _multishot_pair(dim, shot_map, store):
    if dim == "2d":
        grid, srcs = (20, 20), np.array([20 * 5 + 5, 20 * 14 + 14])
        kw = dict(nt=24, dt=8e-4, dx=10.0, freq=18.0, sponge_width=3)
    else:
        grid, srcs = SHAPE3, np.array([SRC3, SRC3 + 40])
        kw = {k: v for k, v in KW3.items() if k != "src_idx"}
    kw.update(store_adjoint=store, shot_map=shot_map)
    Fj = jw.multishot_tti_wave_operator(grid, jnp.asarray(srcs), dtype=jnp.float32, **kw)
    return grid, Fj, carried(tw.multishot_tti_wave_operator(grid, srcs, **kw, device=CPU),
                             Fj)


@pytest.mark.parametrize("dim,shot_map,store", [
    ("2d", "vmap", None), ("2d", "map", None), ("3d", "vmap", "f32"), ("3d", "map", "f32")])
def test_multishot_matches_jax(dim, shot_map, store):
    grid, Fj, Ft = _multishot_pair(dim, shot_map, store)
    m = _model_np(grid, 13)
    assert Ft.rng.shape == Fj.rng.shape
    _close(Ft(tm(Ft, m)).numpy(), Fj(jm(Fj, m)))
    d = np.random.default_rng(14).standard_normal(Fj.rng.shape).astype(np.float32)
    gt = Ft.linearize(tm(Ft, m)).H(torch.from_numpy(d))
    gj = _jblocks(Fj.linearize(jm(Fj, m)).H(jnp.asarray(d)), len(grid) + 2)
    for a, b in zip(gt.blocks, gj):
        _close(a.numpy(), b, rtol=1e-5 if store is None else 0.0)
    dm = _perturbation_np(grid, 15)
    _close(Ft.linearize(tm(Ft, m))(tm(Ft, dm)).numpy(),
           Fj.linearize(jm(Fj, m))(jm(Fj, dm)))


def test_multishot_3d_map_on_the_kernel_route_equals_single_shots():
    """map mode rides the kernel route where it applies (``fused=None``;
    forced here on CPU tensors by the single-shot ``fused=True``
    counterparts): each shot of the stack is its single-shot run, and the
    int8 adjoint of two shots is the sum of the single-shot adjoints."""
    srcs = np.array([SRC3, SRC3 + 40])
    kw = {k: v for k, v in KW3.items() if k != "src_idx"}
    F = tw.multishot_tti_wave_operator(SHAPE3, srcs, store_adjoint="int8", shot_map="map",
                                       **kw, device=CPU)
    m = tm(F, _model_np(SHAPE3, 16))
    d = torch.from_numpy(np.random.default_rng(17).standard_normal((2, 16, 128))
                         .astype(np.float32))
    singles = [tw.tti_wave_propagator(SHAPE3, src_idx=int(s), store_adjoint="int8",
                                      fused=True, **kw, device=CPU) for s in srcs]
    y = F(m)
    for b, Fs in enumerate(singles):
        ys = Fs(m)
        _live(ys)
        assert torch.equal(y[b], ys)
    g = F.linearize(m).H(d)
    gs = singles[0].linearize(m).H(d[0]) + singles[1].linearize(m).H(d[1])
    for a, b in zip(g.blocks, gs.blocks):
        _live(b)
        assert torch.equal(a, b)


def test_with_wave_arrays_carries_the_jax_state():
    Fj, Ft = pair(SHAPE3, KW3)
    sj, st = Fj.jet.state, Ft.jet.state
    np.testing.assert_array_equal(st["wavelet"].numpy(), np.asarray(sj["wavelet"]))
    for a, b in zip(st["sponge"], sj["sponge"]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert int(st["src_idx"]) == SRC3
    np.testing.assert_array_equal(st["rcv_idx"].numpy(), RCV3)
    _, Fm_j, Fm_t = _multishot_pair("2d", "map", None)
    np.testing.assert_array_equal(Fm_t.jet.state["bstate"]["src"].numpy(),
                                  np.asarray(Fm_j.jet.state["bstate"]["src"]))


def test_validation_errors_match_jax():
    for kw, match in ((dict(space_order=3), "space_order"),
                      (dict(store_adjoint="int4"), "store_adjoint"),
                      (dict(coeff_dtype=torch.float16), "coeff_dtype"),
                      (dict(coeff_dtype=torch.bfloat16), "3-D only"),
                      (dict(store_adjoint="f32"), "3-D only"),
                      (dict(nt=4, fused=True), "fused TTI step"),
                      (dict(nt=4, dt=1e-3, dtrec=5e-4), "dtrec"),
                      (dict(fused=True, wavefield_sharding=object()), "fused=True")):
        with pytest.raises(ValueError, match=match):
            tw.tti_wave_propagator(SHAPE2, **kw, device=CPU)
    with pytest.raises(ValueError, match="2-D and 3-D"):
        tw.tti_wave_propagator((8,), device=CPU)
    with pytest.raises(ValueError, match="3-D only"):
        tw.multishot_tti_wave_operator((20, 20), [5, 9], store_adjoint="int8", device=CPU)
    with pytest.raises(ValueError, match="shot_map"):
        tw.multishot_tti_wave_operator((20, 20), [5, 9], shot_map="scan", device=CPU)
    F = tw.tti_wave_propagator(SHAPE2, nt=4, device=CPU)
    other = tt.BlockSpace([tt.Space(SHAPE2, device=CPU)] * 5)
    with pytest.raises(ValueError, match="different BlockSpace"):
        F.dom.reshape(other.zeros())


def test_what_is_not_ported_names_its_roadmap_item():
    with pytest.raises(ValueError, match="wavefield_sharding"):  # ported: not a sharding
        tw.tti_wave_propagator(SHAPE3, wavefield_sharding=object(), device=CPU)
    with pytest.raises(ValueError, match="static Q"):  # ported: no kernel takes Q
        tw.tti_wave_propagator(SHAPE3, q=50.0, fused=True, device=CPU)
    F4 = tw.tti_wave_propagator((12, 12), nt=6, remat_blocks=3, device=CPU)
    m = tt.BlockVector((torch.full((12, 12), 1500.0), torch.full((12, 12), 0.1),
                        torch.full((12, 12), 0.05), torch.full((12, 12), 0.3)), F4.dom)
    assert torch.equal(F4(m), tw.tti_wave_propagator((12, 12), nt=6, device=CPU)(m))
    Fv = tw.multishot_tti_wave_operator((20, 20), [5, 9], nt=4, remat_blocks=2,
                                        device=CPU)  # vmap takes remat segments
    mv = tt.BlockVector((torch.full((20, 20), 1500.0), torch.full((20, 20), 0.1),
                         torch.full((20, 20), 0.05), torch.full((20, 20), 0.3)), Fv.dom)
    for shot_map in ("map", "vmap"):  # mesh= on a world of one: bitwise
        Fmesh = tw.multishot_tti_wave_operator((20, 20), [5, 9], nt=4, shot_map=shot_map,
                                               mesh=make_block_mesh(device=CPU))
        F1 = tw.multishot_tti_wave_operator((20, 20), [5, 9], nt=4, shot_map=shot_map,
                                            device=CPU)
        d1 = F1(mv)
        assert torch.equal(Fmesh(mv), d1)
        for a, b in zip(Fmesh.linearize(mv).H(d1), F1.linearize(mv).H(d1)):
            assert torch.equal(a, b)
    assert torch.equal(Fv(mv), tw.multishot_tti_wave_operator((20, 20), [5, 9], nt=4,
                                                              device=CPU)(mv))
    Fm = tw.multishot_tti_wave_operator((20, 20), [5, 9], nt=4, remat_blocks=2,
                                        shot_map="map", device=CPU)
    assert Fm.rng.shape == (2, 4, 128)
