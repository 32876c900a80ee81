"""The port's isotropic wave slice (jets_tpu_torch/ops/wave.py) held against
jets_tpu.ops.wave on the CPU, on the same numpy inputs, with the JAX
operator's wavelet, sponge and geometry carried across
(``with_wave_arrays``) so both run on the same state.

Tolerances: the JAX time loop runs inside ``lax.scan`` (compiled), where
XLA on the CPU contracts multiply-adds into FMAs; the port rounds every
multiply and add. Over a few tens of steps traces, Born data and f32
gradients agree to ``rtol=1e-5, atol=1e-5·max|ref|`` (observed ≤ 6e-7 of
the peak). bf16/int8 stored gradients are held to the JAX package's own
tolerances for its fused-vs-XLA stored adjoints (``atol`` 2e-2 and 5e-2 of
the peak), and against the autodiff gradient by cosine. Eager JAX scalar
arithmetic rounds like the port, so ``c²dt²`` and the int8 codec are
compared bitwise, and the wavelet and sponge (``exp`` of each framework)
to a few ulp. Every comparison has a live-signal guard.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jets_tpu_torch as tt
from jets_tpu.ops import wave as jw
from jets_tpu_torch.ops import cuda_wave as cw
from jets_tpu_torch.ops import wave as tw
from jets_tpu_torch.parallel.sharded import block_sharding, make_block_mesh

CPU = torch.device("cpu")  # the tests build on the CPU, as a caller asks

SHAPE3 = (12, 8, 128)
SRC3 = int(np.ravel_multi_index((6, 4, 64), SHAPE3))
# receivers on the x-line through the source: the default strided set lies
# on the x=0 plane, which a short run never reaches
RCV3 = np.array([np.ravel_multi_index((6, 4, x), SHAPE3) for x in range(128)])
KW3 = dict(nt=24, dt=6e-4, dx=10.0, freq=16.0, src_idx=SRC3, rcv_idx=RCV3,
           sponge_width=3)
SHAPE2 = (24, 24)
KW2 = dict(nt=36, dt=1e-3, dx=10.0, freq=18.0, src_idx=12 * 24 + 12, sponge_width=4)


def _live(x):
    assert float(np.max(np.abs(np.asarray(x)))) > 0.0, "vacuous: signal is zero"


def _close(got, ref, rtol=1e-5, atol=1e-5):
    ref = np.asarray(ref)
    _live(ref)
    np.testing.assert_allclose(np.asarray(got), ref, rtol=rtol,
                               atol=atol * float(np.max(np.abs(ref))))


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


def pair(shape, kw, **extra):
    Fj = jw.wave_propagator(shape, fused=False, dtype=jnp.float32, **kw, **extra)
    return Fj, carried(tw.wave_propagator(shape, **kw, **extra, device=CPU), Fj)


def _velocity(shape, seed=0):
    rng = np.random.default_rng(seed)
    return (1500.0 + 20.0 * rng.standard_normal(shape)).astype(np.float32)


def _T(x):
    return torch.from_numpy(np.array(x))


def test_helpers_match_jax():
    rj = np.asarray(jw._ricker(48, 8e-4, 18.0))
    rt = tw._ricker(48, 8e-4, 18.0).numpy()
    _live(rj)
    np.testing.assert_array_max_ulp(rt, rj, maxulp=4)
    for shape, fs in (((24, 20), False), ((12, 8, 128), True), ((12, 8, 128), False)):
        sj, st = jw._make_sponge(shape, 4, free_surface=fs), tw._make_sponge(
            shape, 4, free_surface=fs)
        for a, b in zip(*(x if isinstance(x, tuple) else (x,) for x in (sj, st))):
            assert tuple(b.shape) == a.shape
            assert float(np.min(np.asarray(a))) < 1.0  # the taper is there
            np.testing.assert_array_max_ulp(b.numpy(), np.asarray(a), maxulp=2)
    # the factor product is bit-identical to the full sponge, as in JAX
    assert torch.equal(tw._sponge_full(tw._make_sponge((12, 8, 16), 3)),
                       tw._sponge((12, 8, 16), 3))
    c = _velocity((6, 8, 16))
    for dt, dx in ((6e-4, 10.0), (5e-4, 7.3), (1e-3, 12.5)):
        ref = np.asarray((jnp.asarray(c) * jnp.asarray(c)) * (dt * dt) / (dx * dx))
        np.testing.assert_array_equal(tw._c2dt2(_T(c), dt, dx).numpy(), ref)
    enc_j, dec_j = jw._store_codec("int8", jnp.float32)
    enc_t, dec_t = tw._store_codec("int8", torch.float32)
    u = np.random.default_rng(1).standard_normal((6, 8, 16)).astype(np.float32)
    qj, sj_ = enc_j(jnp.asarray(u))
    qt, st_ = enc_t(_T(u))
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(dec_t(qt, st_).numpy(), np.asarray(dec_j(qj, sj_)))


@pytest.mark.parametrize("dim,order,dtrec", [
    ("2d", 2, None), ("2d", 4, 2e-3), ("3d", 2, None), ("3d", 4, None),
    ("3d", 2, 1.2e-3), ("3d", 4, 1.2e-3), ("2d", 2, 2e-3), ("2d", 4, None),
])
def test_forward_traces_match_jax(dim, order, dtrec):
    shape, kw = (SHAPE2, KW2) if dim == "2d" else (SHAPE3, KW3)
    Fj, Ft = pair(shape, kw, space_order=order, dtrec=dtrec)
    assert Ft.rng.shape == Fj.rng.shape
    c = _velocity(shape)
    _close(Ft(_T(c)).numpy(), Fj(jnp.asarray(c)))


def test_born_forward_matches_jax_jvp():
    Fj, Ft = pair(SHAPE3, KW3)
    c = _velocity(SHAPE3, 2)
    dc = np.random.default_rng(3).standard_normal(SHAPE3).astype(np.float32)
    _, ref = jax.jvp(lambda cc: Fj(cc), (jnp.asarray(c),), (jnp.asarray(dc),))
    _close(tw.born_operator(Ft, _T(c))(_T(dc)).numpy(), ref)


@pytest.mark.parametrize("store,tol", [("f32", 1e-5), ("bf16", 2e-2), ("int8", 5e-2)])
def test_stored_adjoint_matches_jax(store, tol):
    Fj, Ft = pair(SHAPE3, KW3, store_adjoint=store)
    c = _velocity(SHAPE3, 4)
    d = np.asarray(Fj(jnp.asarray(c * 1.02)) - Fj(jnp.asarray(c)))  # physical residual
    _live(d)
    gj = np.asarray(Fj.linearize(jnp.asarray(c)).H(jnp.asarray(d)))
    gt = Ft.linearize(_T(c)).H(_T(d)).numpy()
    _close(gt, gj, rtol=tol, atol=tol)
    if store != "f32":  # the lossy history keeps the autodiff gradient's direction
        Fa = tw.wave_propagator(SHAPE3, **KW3, device=CPU)
        ga = carried(Fa, Fj).linearize(_T(c)).H(_T(d)).numpy()
        cos = float(np.dot(ga.ravel(), gt.ravel())
                    / (np.linalg.norm(ga) * np.linalg.norm(gt)))
        assert cos > 1.0 - tol, f"{store}: cosine {cos}"


@pytest.mark.parametrize("dim", ["2d", "3d"])
def test_autodiff_adjoint_matches_jax(dim):
    shape, kw = (SHAPE2, KW2) if dim == "2d" else (SHAPE3, KW3)
    Fj, Ft = pair(shape, kw)
    c = _velocity(shape, 5)
    d = np.random.default_rng(6).standard_normal(Fj.rng.shape).astype(np.float32)
    _close(Ft.linearize(_T(c)).H(_T(d)).numpy(),
           Fj.linearize(jnp.asarray(c)).H(jnp.asarray(d)))


def test_stored_adjoint_with_dtrec_matches_jax():
    Fj, Ft = pair(SHAPE2, KW2, dtrec=2e-3, store_adjoint="f32")
    c = _velocity(SHAPE2, 7)
    d = np.random.default_rng(8).standard_normal(Fj.rng.shape).astype(np.float32)
    _close(Ft.linearize(_T(c)).H(_T(d)).numpy(),
           Fj.linearize(jnp.asarray(c)).H(jnp.asarray(d)))


def test_kernel_route_on_cpu_equals_plain_route():
    """``fused=True`` on CPU tensors runs the kernel route (the K4 autograd
    Function, in-place sweeps, K5) through the wrappers' plain versions:
    forward and stored adjoints are bitwise the plain route's, the derived
    adjoint and Born forward agree to roundoff, nothing is launched."""
    c = _T(_velocity(SHAPE3, 9))
    d = _T(np.random.default_rng(10).standard_normal((24, 128)).astype(np.float32))
    dc = _T(np.random.default_rng(11).standard_normal(SHAPE3).astype(np.float32))
    cw.reset_launch_counts()
    for store in (None, "int8"):
        Fk = tw.wave_propagator(SHAPE3, fused=True, store_adjoint=store, **KW3, device=CPU)
        Fp = tw.wave_propagator(SHAPE3, fused=False, store_adjoint=store, **KW3, device=CPU)
        yk, yp = Fk(c), Fp(c)
        _live(yp)
        assert torch.equal(yk, yp)
        gk, gp = Fk.linearize(c).H(d), Fp.linearize(c).H(d)
        if store is None:  # the Function's backward rounds its own transpose
            _close(gk, gp)
        else:
            _live(gp)
            assert torch.equal(gk, gp)
    _close(Fk.linearize(c)(dc), Fp.linearize(c)(dc))
    # a tape through the Function matches a tape through the plain step
    ck = c.clone().requires_grad_()
    torch.sum(Fk(ck) ** 2).backward()
    cp = c.clone().requires_grad_()
    torch.sum(Fp(cp) ** 2).backward()
    _close(ck.grad, cp.grad)
    assert cw.launch_counts() == {"fused_leapfrog_step": 0, "fused_adjoint_step": 0,
                                 "fused_q_step": 0, "fused_leapfrog_step2d": 0,
                                 "fused_adjoint_step2d": 0, "fused_q_adjoint_step": 0}


def _multishot_pair(shot_map, store):
    grid, srcs = (20, 20), np.array([20 * 5 + 5, 20 * 14 + 14])
    kw = dict(nt=24, dt=8e-4, dx=10.0, freq=18.0, sponge_width=3,
              store_adjoint=store, shot_map=shot_map)
    Fj = jw.multishot_wave_operator(grid, jnp.asarray(srcs), dtype=jnp.float32, **kw)
    return Fj, carried(tw.multishot_wave_operator(grid, srcs, **kw, device=CPU), Fj)


@pytest.mark.parametrize("shot_map", ["vmap", "map"])
@pytest.mark.parametrize("store", [None, "f32"])
def test_multishot_matches_jax(shot_map, store):
    Fj, Ft = _multishot_pair(shot_map, store)
    c = _velocity((20, 20), 12)
    assert Ft.rng.shape == Fj.rng.shape == (2, 24, 128)
    _close(Ft(_T(c)).numpy(), Fj(jnp.asarray(c)))
    d = np.random.default_rng(13).standard_normal(Fj.rng.shape).astype(np.float32)
    _close(Ft.linearize(_T(c)).H(_T(d)).numpy(),
           Fj.linearize(jnp.asarray(c)).H(jnp.asarray(d)))
    dc = np.random.default_rng(14).standard_normal((20, 20)).astype(np.float32)
    _close(Ft.linearize(_T(c))(_T(dc)).numpy(),
           Fj.linearize(jnp.asarray(c))(jnp.asarray(dc)))


def test_gates_in_float64():
    """The port's own dot-product gate on test_wave.py's 24² Born problem
    (f64, ``rtol=1e-9``) and the linearization gate (second-order decay)."""
    F = tw.wave_propagator((24, 24), nt=48, dt=8e-4, dx=10.0, freq=18.0,
                           src_idx=24 * 12 + 12, sponge_width=4, dtype=torch.float64, device=CPU)
    c0 = torch.full((24, 24), 2000.0, dtype=torch.float64)
    J = tw.born_operator(F, c0)
    g = torch.Generator().manual_seed(0)
    lhs, rhs = tt.dot_product_test(J, J.dom.randn(g), J.rng.randn(g))
    _live(float(rhs))
    np.testing.assert_allclose(float(lhs), float(rhs), rtol=1e-9)
    Fs = tw.wave_propagator((24, 24), nt=48, dt=8e-4, dx=10.0, freq=18.0,
                            src_idx=24 * 12 + 12, sponge_width=4, dtype=torch.float64,
                            store_adjoint="f32", device=CPU)
    Js = Fs.linearize(c0)
    lhs, rhs = tt.dot_product_test(Js, Js.dom.randn(g), Js.rng.randn(g))
    np.testing.assert_allclose(float(lhs), float(rhs), rtol=1e-9)
    dm = 50.0 * J.dom.randn(torch.Generator().manual_seed(2))
    obs, exp = tt.linearization_test(F, c0, delta_m=dm, mu=(1.0, 0.5, 0.25, 0.125))
    np.testing.assert_allclose(obs.numpy(), exp.numpy(), rtol=0.35)


def test_validation_and_what_is_not_ported():
    with pytest.raises(ValueError, match="space_order"):
        tw.wave_propagator(SHAPE2, space_order=3, device=CPU)
    with pytest.raises(ValueError, match="store_adjoint"):
        tw.wave_propagator(SHAPE2, store_adjoint="int4", device=CPU)
    # a 2-D float32 grid has the 2-D pair; float64 and 1-D grids have no kernel
    with pytest.raises(ValueError, match="fused wave step"):
        tw.wave_propagator(SHAPE2, nt=4, fused=True, dtype=torch.float64, device=CPU)
    with pytest.raises(ValueError, match="fused wave step"):
        tw.wave_propagator((64,), nt=4, fused=True, device=CPU)
    with pytest.raises(ValueError, match="dtrec"):
        tw.wave_propagator(SHAPE2, nt=4, dt=1e-3, dtrec=5e-4, device=CPU)
    c = _T(_velocity(SHAPE2))
    assert torch.equal(tw.wave_propagator(SHAPE2, nt=8, remat_blocks=4, device=CPU)(c),
                       tw.wave_propagator(SHAPE2, nt=8, device=CPU)(c))
    # the z-slab sharding on a world of one: the unsharded operator, bitwise
    mesh = make_block_mesh(axis="grid", device=CPU)
    ws = block_sharding(mesh, "grid")
    c3 = _T(_velocity(SHAPE3))
    for fused in (False, True):
        F0 = tw.wave_propagator(SHAPE3, fused=fused, store_adjoint="int8", device=CPU, **KW3)
        Fs = tw.wave_propagator(SHAPE3, fused=fused, store_adjoint="int8",
                                wavefield_sharding=ws, **KW3)
        assert Fs.dom.mesh is mesh and Fs.dom.local_shape == SHAPE3
        d0 = F0(c3)
        assert torch.equal(Fs(c3), d0)
        assert torch.equal(Fs.linearize(c3).H(d0), F0.linearize(c3).H(d0))
    # a 2-D grid under the sharding (once refused): the unsharded operator, bitwise
    F2 = tw.wave_propagator(SHAPE2, nt=8, wavefield_sharding=ws)
    assert Fs.dom.mesh is mesh and torch.equal(
        F2(c), tw.wave_propagator(SHAPE2, nt=8, device=CPU)(c))
    with pytest.raises(ValueError, match="wavefield_sharding"):  # a slab thinner than the halo
        tw.wave_propagator((3,) + SHAPE2, space_order=8, wavefield_sharding=ws)
    with pytest.raises(ValueError, match="wavefield_sharding"):
        tw.wave_propagator(SHAPE3, wavefield_sharding=object())
    srcs = [5, 9]
    Fw = tw.multishot_wave_operator((20, 20), srcs, nt=4, window_shape=(16, 16),
                                    window_corners=[[0, 0], [4, 4]], device=CPU)
    assert Fw.dom.shape == (20, 20) and Fw.rng.shape == (2, 4, 128)
    with pytest.raises(ValueError, match="BOTH"):
        tw.multishot_wave_operator((20, 20), srcs, window_shape=(16, 16), device=CPU)
    c20 = torch.full((20, 20), 1500.0)  # the vmap stack takes remat segments
    assert torch.equal(
        tw.multishot_wave_operator((20, 20), srcs, nt=4, remat_blocks=2, device=CPU)(c20),
        tw.multishot_wave_operator((20, 20), srcs, nt=4, device=CPU)(c20))
    Fc = tw.multishot_wave_operator((20, 20), srcs, nt=4, boundary="cpml", device=CPU)
    assert Fc(torch.full((20, 20), 1500.0)).shape == (2, 4, 128)
    with pytest.raises(ValueError, match="store_adjoint is not available with CPML"):
        tw.multishot_wave_operator((20, 20), srcs, boundary="cpml", store_adjoint="f32",
                                   device=CPU)
    with pytest.raises(ValueError, match="boundary"):
        tw.multishot_wave_operator((20, 20), srcs, boundary="pml", device=CPU)
    for shot_map in ("map", "vmap"):  # mesh= on a world of one: bitwise
        Fm = tw.multishot_wave_operator((20, 20), srcs, nt=4, shot_map=shot_map,
                                        mesh=make_block_mesh(device=CPU))
        F1 = tw.multishot_wave_operator((20, 20), srcs, nt=4, shot_map=shot_map,
                                        device=CPU)
        d1 = F1(c20)
        assert torch.equal(Fm(c20), d1)
        assert torch.equal(Fm.linearize(c20).H(d1), F1.linearize(c20).H(d1))
    with pytest.raises(ValueError, match="shot_map"):
        tw.multishot_wave_operator((20, 20), srcs, shot_map="scan", device=CPU)
