"""The port's VTI wave slice (``vti_wave_propagator``,
``multishot_vti_wave_operator`` in jets_tpu_torch/ops/wave.py) held against
jets_tpu.ops.wave on the CPU, on the same numpy inputs, with the JAX
operator's wavelet, sponge and geometry carried across
(``with_wave_arrays``) so both run on the same state.

Tolerances: the JAX time loop runs inside ``lax.scan`` (compiled), where
XLA on the CPU contracts multiply-adds into FMAs; the port rounds every
multiply and add. Over a few tens of steps traces, tangents and f32
gradients agree to ``rtol=1e-5, atol=1e-5·max|ref|``. The stored adjoints
are held per model block to the JAX suite's own fused-vs-XLA tolerances
relative to the block's peak (f32 2e-5, bf16 2e-2, int8 5e-2), and the
lossy ones also against the autodiff gradient by cosine. Eager JAX rounds
like the port, so the coefficients and ``d2_axis`` are compared bitwise.
The float64 gates (dot product at ``rtol=1e-9``, the VTI→isotropic
reduction at ``rtol=1e-10``) run on test_wavefd.py's 20×20 problem. Every
comparison has a live-signal guard.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jets_tpu_torch as tt
from jets_tpu.ops import wave as jw
from jets_tpu_torch import BlockVector
from jets_tpu_torch.ops import cuda_vti as cv
from jets_tpu_torch.ops import wave as tw
from jets_tpu_torch.parallel.sharded import make_block_mesh
from jets_tpu_torch.ops.stencil import d2_axis

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
ZERO = {k: 0 for k in ("fused_vti_step", "fused_vti_hist_step",
                       "fused_vti_adjoint_step")}


def _live(x):
    assert float(np.max(np.abs(np.asarray(x)))) > 0.0, "vacuous: signal is zero"


def _close(got, ref, rtol=1e-5, atol=1e-5):
    ref = np.asarray(ref)
    _live(ref)
    np.testing.assert_allclose(np.asarray(got), ref, rtol=rtol,
                               atol=atol * float(np.max(np.abs(ref))))


def _blocks_close(got, ref, rtol=1e-5, atol=1e-5):
    assert isinstance(got, BlockVector) and got.nblocks == 3
    for g, r in zip(got.blocks, ref.blocks):
        _close(g.numpy(), r, rtol=rtol, atol=atol)


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
    Fj = jw.vti_wave_propagator(shape, fused=False, dtype=jnp.float32, **kw, **extra)
    return Fj, carried(tw.vti_wave_propagator(shape, **kw, **extra, device=CPU), Fj)


def _model_np(shape, seed, dtype=np.float32):
    """(c, ε, δ) blocks: 1500 m/s and Thomsen parameters 0.1/0.05, perturbed."""
    rng = np.random.default_rng(seed)
    return [(1500.0 + 20.0 * rng.standard_normal(shape)).astype(dtype),
            (0.1 + 0.02 * rng.standard_normal(shape)).astype(dtype),
            (0.05 + 0.01 * rng.standard_normal(shape)).astype(dtype)]


def _perturbation_np(shape, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return [(s * rng.standard_normal(shape)).astype(dtype) for s in (20.0, 0.02, 0.02)]


def jm(F, blocks):
    m = F.dom.zeros()
    for i, b in enumerate(blocks):
        m = m.setblock(i, jnp.asarray(b))
    return m


def tm(F, blocks):
    return BlockVector([torch.from_numpy(np.array(b)) for b in blocks], F.dom)


def test_coefficients_and_d2_axis_match_jax_bitwise():
    c, eps, delta = _model_np((6, 8, 16), 0)
    C, ah, av, inv = tw._vti_coefficients(*(torch.from_numpy(b) for b in (c, eps, delta)),
                                          6e-4, 7.3)
    cj, ej, dj = (jnp.asarray(b) for b in (c, eps, delta))
    np.testing.assert_array_equal(C.numpy(), np.asarray((cj * cj) * (6e-4 * 6e-4)))
    np.testing.assert_array_equal(ah.numpy(), np.asarray(1.0 + 2.0 * ej))
    np.testing.assert_array_equal(av.numpy(), np.asarray(jnp.sqrt(1.0 + 2.0 * dj)))
    assert float(inv) == float(jnp.asarray(1.0 / (7.3 * 7.3), jnp.float32))
    u = np.random.default_rng(1).standard_normal((6, 8, 16)).astype(np.float32)
    for order in (2, 4, 8):
        for x in (u, u[0]):
            for ax in range(x.ndim):
                ref = np.asarray(jw._d2_axis(jnp.asarray(x), ax, jnp.float32(0.01), order))
                _live(ref)
                np.testing.assert_array_equal(
                    d2_axis(torch.from_numpy(x), ax, torch.tensor(0.01), order).numpy(), ref)


@pytest.mark.parametrize("dim,order,dtrec", [
    ("3d", 2, None), ("3d", 4, None), ("3d", 8, None), ("3d", 2, 1.2e-3),
    ("2d", 2, None), ("2d", 4, 2e-3)])
def test_forward_traces_match_jax(dim, order, dtrec):
    shape, kw = (SHAPE2, KW2) if dim == "2d" else (SHAPE3, KW3)
    Fj, Ft = pair(shape, kw, space_order=order, dtrec=dtrec)
    assert Ft.rng.shape == Fj.rng.shape
    assert isinstance(Ft.dom, tt.BlockSpace) and Ft.dom.nblocks == 3
    m = _model_np(shape, 2)
    _close(Ft(tm(Ft, m)).numpy(), Fj(jm(Fj, m)))


@pytest.mark.parametrize("dim", ["2d", "3d"])
def test_tangent_matches_jax_jvp(dim):
    shape, kw = (SHAPE2, KW2) if dim == "2d" else (SHAPE3, KW3)
    Fj, Ft = pair(shape, kw)
    m, dm = _model_np(shape, 3), _perturbation_np(shape, 4)
    _, ref = jax.jvp(lambda x: Fj(x), (jm(Fj, m),), (jm(Fj, dm),))
    _close(tw.born_operator(Ft, tm(Ft, m))(tm(Ft, dm)).numpy(), ref)


def _residual(Fj, shape, seed):
    m = _model_np(shape, seed)
    m_obs = [m[0] * np.float32(1.02), m[1], m[2]]
    d = np.array(Fj(jm(Fj, m_obs)) - Fj(jm(Fj, m)))  # physical residual
    _live(d)
    return m, d


@pytest.mark.parametrize("store,tol", [("f32", 2e-5), ("bf16", 2e-2), ("int8", 5e-2)])
def test_stored_adjoint_matches_jax_per_block(store, tol):
    Fj, Ft = pair(SHAPE3, KW3, store_adjoint=store)
    m, d = _residual(Fj, SHAPE3, 5)
    gj = Fj.linearize(jm(Fj, m)).H(jnp.asarray(d))
    gt = Ft.linearize(tm(Ft, m)).H(torch.from_numpy(d))
    _blocks_close(gt, gj, rtol=0.0, atol=tol)
    if store != "f32":  # the lossy history keeps the autodiff gradient's direction
        Fa = carried(tw.vti_wave_propagator(SHAPE3, **KW3, device=CPU), Fj)
        ga = Fa.linearize(tm(Fa, m)).H(torch.from_numpy(d))
        for a, b in zip(ga.blocks, gt.blocks):
            a, b = a.numpy().ravel(), b.numpy().ravel()
            cos = float(np.dot(a, b) / (np.linalg.norm(a) * np.linalg.norm(b)))
            assert cos > 1.0 - tol, f"{store}: cosine {cos}"


@pytest.mark.parametrize("dim", ["2d", "3d"])
def test_autodiff_adjoint_matches_jax(dim):
    shape, kw = (SHAPE2, KW2) if dim == "2d" else (SHAPE3, KW3)
    Fj, Ft = pair(shape, kw)
    m = _model_np(shape, 6)
    d = np.random.default_rng(7).standard_normal(Fj.rng.shape).astype(np.float32)
    _blocks_close(Ft.linearize(tm(Ft, m)).H(torch.from_numpy(d)),
                  Fj.linearize(jm(Fj, m)).H(jnp.asarray(d)))


def test_stored_adjoint_2d_with_dtrec_matches_jax():
    Fj, Ft = pair(SHAPE2, KW2, dtrec=2e-3, store_adjoint="f32")
    m = _model_np(SHAPE2, 8)
    d = np.random.default_rng(9).standard_normal(Fj.rng.shape).astype(np.float32)
    _blocks_close(Ft.linearize(tm(Ft, m)).H(torch.from_numpy(d)),
                  Fj.linearize(jm(Fj, m)).H(jnp.asarray(d)), rtol=0.0, atol=2e-5)


def test_kernel_route_on_cpu_equals_plain_route():
    """``fused=True`` on CPU tensors runs the kernel route (the K8 autograd
    Function, in-place sweeps, K9 and K10) through the wrappers' plain
    versions: forward and stored adjoints are bitwise the plain route's, the
    derived adjoint and the tangent agree to roundoff, nothing is launched."""
    m = _model_np(SHAPE3, 10)
    d = torch.from_numpy(np.random.default_rng(11).standard_normal((24, 128))
                         .astype(np.float32))
    cv.reset_launch_counts()
    for store in (None, "f32", "bf16", "int8"):
        Fk = tw.vti_wave_propagator(SHAPE3, fused=True, store_adjoint=store, **KW3, device=CPU)
        Fp = tw.vti_wave_propagator(SHAPE3, fused=False, store_adjoint=store, **KW3, device=CPU)
        mk, mp = tm(Fk, m), tm(Fp, m)
        yk, yp = Fk(mk), Fp(mp)
        _live(yp)
        assert torch.equal(yk, yp)
        gk, gp = Fk.linearize(mk).H(d), Fp.linearize(mp).H(d)
        for a, b in zip(gk.blocks, gp.blocks):
            if store is None:  # the Function's backward rounds its own transpose
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
    assert cv.launch_counts() == ZERO


def _multishot_pair(shot_map, store):
    grid, srcs = (20, 20), np.array([20 * 5 + 5, 20 * 14 + 14])
    kw = dict(nt=24, dt=8e-4, dx=10.0, freq=18.0, sponge_width=3,
              store_adjoint=store, shot_map=shot_map)
    Fj = jw.multishot_vti_wave_operator(grid, jnp.asarray(srcs), dtype=jnp.float32, **kw)
    return Fj, carried(tw.multishot_vti_wave_operator(grid, srcs, **kw, device=CPU), Fj)


@pytest.mark.parametrize("shot_map", ["vmap", "map"])
@pytest.mark.parametrize("store", [None, "f32"])
def test_multishot_matches_jax(shot_map, store):
    Fj, Ft = _multishot_pair(shot_map, store)
    m = _model_np((20, 20), 13)
    assert Ft.rng.shape == Fj.rng.shape == (2, 24, 128)
    _close(Ft(tm(Ft, m)).numpy(), Fj(jm(Fj, m)))
    d = np.random.default_rng(14).standard_normal(Fj.rng.shape).astype(np.float32)
    _blocks_close(Ft.linearize(tm(Ft, m)).H(torch.from_numpy(d)),
                  Fj.linearize(jm(Fj, m)).H(jnp.asarray(d)))
    dm = _perturbation_np((20, 20), 15)
    _close(Ft.linearize(tm(Ft, m))(tm(Ft, dm)).numpy(),
           Fj.linearize(jm(Fj, m))(jm(Fj, dm)))


def test_multishot_3d_map_on_the_kernel_route_equals_single_shots():
    """map mode rides the kernel route where it applies (``fused=None``;
    forced here on CPU tensors by the single-shot ``fused=True``
    counterparts): shot 0 of the stack is the single-shot run, and the int8
    adjoint of two shots is the sum of the single-shot adjoints."""
    srcs = np.array([SRC3, SRC3 + 40])
    kw = {k: v for k, v in KW3.items() if k != "src_idx"}
    F = tw.multishot_vti_wave_operator(SHAPE3, srcs, store_adjoint="int8", shot_map="map",
                                       **kw, device=CPU)
    m = tm(F, _model_np(SHAPE3, 16))
    d = torch.from_numpy(np.random.default_rng(17).standard_normal((2, 24, 128))
                         .astype(np.float32))
    singles = [tw.vti_wave_propagator(SHAPE3, src_idx=int(s), store_adjoint="int8",
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


def _f64_problem(**kw):
    return tw.vti_wave_propagator((20, 20), nt=40, dt=0.0008, dx=10.0, freq=18.0,
                                  src_idx=20 * 10 + 10, sponge_width=4,
                                  dtype=torch.float64, **kw, device=CPU)


def _f64_point(F, eps=0.1, delta=0.05):
    return BlockVector([torch.full((20, 20), v, dtype=torch.float64)
                        for v in (2000.0, eps, delta)], F.dom)


def test_vti_reduces_to_isotropic_and_anisotropy_moves_the_traces():
    F = _f64_problem()
    d_vti = F(_f64_point(F, 0.0, 0.0))
    Fi = tw.wave_propagator((20, 20), nt=40, dt=0.0008, dx=10.0, freq=18.0,
                            src_idx=20 * 10 + 10, sponge_width=4, dtype=torch.float64, device=CPU)
    d_iso = Fi(torch.full((20, 20), 2000.0, dtype=torch.float64))
    _live(d_iso)
    np.testing.assert_allclose(d_vti.numpy(), d_iso.numpy(), rtol=1e-10, atol=1e-22)
    d1 = F(_f64_point(F, 0.2, 0.1))
    assert float((d1 - d_vti).abs().max()) > 1e-3 * float(d_vti.abs().max())


@pytest.mark.parametrize("store", [None, "f32"])
def test_gates_in_float64(store):
    """The port's dot-product gate on test_wavefd.py's 20×20 VTI problem
    (f64, ``rtol=1e-9``; autodiff and stored adjoints) and the linearization
    gate (second-order Taylor decay)."""
    F = _f64_problem(store_adjoint=store)
    J = F.linearize(_f64_point(F))
    g = torch.Generator().manual_seed(17)
    lhs, rhs = tt.dot_product_test(J, J.dom.randn(g), J.rng.randn(g))
    _live(float(rhs))
    np.testing.assert_allclose(float(lhs), float(rhs), rtol=1e-9)
    if store is None:
        dm = F.dom.randn(torch.Generator().manual_seed(19))
        dm = BlockVector([50.0 * dm[0], 0.02 * dm[1], 0.02 * dm[2]], F.dom)
        obs, exp = tt.linearization_test(F, _f64_point(F), delta_m=dm,
                                         mu=(1.0, 0.5, 0.25, 0.125))
        np.testing.assert_allclose(obs.numpy(), exp.numpy(), rtol=0.35)


def test_with_wave_arrays_carries_the_jax_state():
    Fj, Ft = pair(SHAPE3, KW3)
    sj, st = Fj.jet.state, Ft.jet.state
    np.testing.assert_array_equal(st["wavelet"].numpy(), np.asarray(sj["wavelet"]))
    for a, b in zip(st["sponge"], sj["sponge"]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert int(st["src_idx"]) == SRC3
    np.testing.assert_array_equal(st["rcv_idx"].numpy(), RCV3)
    Fm_j, Fm_t = _multishot_pair("map", None)
    np.testing.assert_array_equal(Fm_t.jet.state["bstate"]["src"].numpy(),
                                  np.asarray(Fm_j.jet.state["bstate"]["src"]))


def test_validation_and_what_is_not_ported():
    with pytest.raises(ValueError, match="space_order"):
        tw.vti_wave_propagator(SHAPE2, space_order=3, device=CPU)
    with pytest.raises(ValueError, match="store_adjoint"):
        tw.vti_wave_propagator(SHAPE2, store_adjoint="int4", device=CPU)
    with pytest.raises(ValueError, match="fused VTI step"):
        tw.vti_wave_propagator(SHAPE2, nt=4, fused=True, device=CPU)
    with pytest.raises(ValueError, match="dtrec"):
        tw.vti_wave_propagator(SHAPE2, nt=4, dt=1e-3, dtrec=5e-4, device=CPU)
    with pytest.raises(ValueError, match="static Q"):  # ported: no kernel takes Q
        tw.vti_wave_propagator(SHAPE2, q=50.0, fused=True, device=CPU)
    assert tw.vti_wave_propagator(SHAPE2, nt=4, q=50.0, device=CPU).dom.nblocks == 3
    F4 = tw.vti_wave_propagator(SHAPE2, nt=8, remat_blocks=4, device=CPU)
    m = F4.dom.reshape(torch.cat([torch.full((24 * 24,), 1500.0),
                                  torch.full((24 * 24,), 0.1),
                                  torch.full((24 * 24,), 0.05)]))
    assert torch.equal(F4(m), tw.vti_wave_propagator(SHAPE2, nt=8, device=CPU)(m))
    with pytest.raises(ValueError, match="wavefield_sharding"):  # ported: not a sharding
        tw.vti_wave_propagator(SHAPE2, wavefield_sharding=object(), device=CPU)
    Fv = tw.multishot_vti_wave_operator((20, 20), [5, 9], nt=4, remat_blocks=2,
                                        device=CPU)  # vmap takes remat segments
    mv = tt.BlockVector((torch.full((20, 20), 1500.0), torch.full((20, 20), 0.1),
                         torch.full((20, 20), 0.05)), Fv.dom)
    for shot_map in ("map", "vmap"):  # mesh= on a world of one: bitwise
        Fmesh = tw.multishot_vti_wave_operator((20, 20), [5, 9], nt=4, shot_map=shot_map,
                                               mesh=make_block_mesh(device=CPU))
        F1 = tw.multishot_vti_wave_operator((20, 20), [5, 9], nt=4, shot_map=shot_map,
                                            device=CPU)
        d1 = F1(mv)
        assert torch.equal(Fmesh(mv), d1)
        for a, b in zip(Fmesh.linearize(mv).H(d1), F1.linearize(mv).H(d1)):
            assert torch.equal(a, b)
    assert torch.equal(Fv(mv), tw.multishot_vti_wave_operator((20, 20), [5, 9], nt=4,
                                                              device=CPU)(mv))
    Fm = tw.multishot_vti_wave_operator((20, 20), [5, 9], nt=4, remat_blocks=2,
                                        shot_map="map", device=CPU)
    assert Fm.rng.shape == (2, 4, 128)
    with pytest.raises(ValueError, match="shot_map"):
        tw.multishot_vti_wave_operator((20, 20), [5, 9], shot_map="scan", device=CPU)
    F = tw.vti_wave_propagator(SHAPE2, nt=4, device=CPU)
    other = tt.BlockSpace([tt.Space(SHAPE2, device=CPU)] * 2)
    with pytest.raises(ValueError, match="different BlockSpace"):
        F.dom.reshape(other.zeros())
