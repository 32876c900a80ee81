"""The port's remat segments, Ginsu windows and CPML boundaries
(jets_tpu_torch/ops/wave.py) held against jets_tpu.ops.wave on the CPU, on
the same numpy inputs: the remat, Ginsu, CPML and free-surface cases of
tests/test_wavefd.py, with each check of the JAX test run on the port and
the port's numbers held against the JAX package's.

Tolerances: float64 unless a test says otherwise. The one-axis derivatives
and the CPML profiles are bitwise the eager JAX functions. JAX's time loops
run under ``lax.scan`` (compiled, FMA-contracted), the port's eagerly, so
traces and gradients agree to ``rtol=1e-10`` of their peak (observed
≤ 1e-13), and the reflection ratios of the boundary test to 1e-6. Within
the port, remat segments change memory, not values: traces are the same
bits and gradients are the same bits (one autograd graph, its saved tensors
recomputed), on the plain route and on the kernel route run through the
kernels' plain versions. Every comparison has a live-signal guard.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

import jets_tpu as jt
import jets_tpu_torch as tt
from jets_tpu.ops import wave as jw
from jets_tpu.ops.wave import _d1_axis as j_d1, _d2_axis as j_d2
from jets_tpu_torch.ops import cuda_wave as cw
from jets_tpu_torch.ops import wave as tw
from jets_tpu_torch.ops.stencil import d1_axis, d2_axis

CPU = torch.device("cpu")  # the tests build on the CPU, as a caller asks
F64 = torch.float64


def _T(x):
    return torch.from_numpy(np.array(x))


def _live(x):
    assert float(np.max(np.abs(np.asarray(x)))) > 0.0, "vacuous: signal is zero"


def _close(got, ref, rtol=1e-10):
    ref = np.asarray(ref)
    _live(ref)
    np.testing.assert_allclose(np.asarray(got), ref, rtol=0,
                               atol=rtol * float(np.max(np.abs(ref))))


def _gate(J, seed):
    g = torch.Generator().manual_seed(seed)
    lhs, rhs = tt.dot_product_test(J, J.dom.randn(g), J.rng.randn(g))
    _live(float(lhs))
    np.testing.assert_allclose(float(lhs), float(rhs), rtol=1e-9)


def _carried(Ft, Fj):
    """The port operator ``Ft`` on the JAX operator ``Fj``'s wavelet and
    sponge (``exp`` rounds differently in the two packages)."""
    s = Fj.jet.state
    if "sstate" in s:
        ss = s["sstate"]
        sp = ss["sponge"]
        return tw.with_wave_arrays(
            Ft, wavelet=ss["wavelet"],
            sponge=tuple(np.asarray(f) for f in sp) if isinstance(sp, tuple) else
            np.asarray(sp), src_idx=s["bstate"]["src"], rcv_idx=ss["rcv"])
    return tw.with_wave_arrays(Ft, wavelet=s["wavelet"], sponge=np.asarray(s["sponge"]),
                               src_idx=s["src_idx"], rcv_idx=s["rcv_idx"])


def _cpml_pair(shape, **kw):
    """A JAX and a port CPML propagator on the same wavelet (the profiles
    are bitwise equal already)."""
    Fj = jw.cpml_wave_propagator(shape, dtype=jnp.float64, **kw)
    Ft = tw.cpml_wave_propagator(shape, dtype=F64, device=CPU, **kw)
    return Fj, tt.with_state(Ft, wavelet=_T(Fj.jet.state["wavelet"]))


# ---------------------------------------------------------------------- #
# CPML absorbing boundaries
# ---------------------------------------------------------------------- #


@pytest.mark.parametrize("order", [2, 4, 8])
def test_axis_derivatives_and_profiles_bitwise_eager_jax(order):
    """d1/d2 along each axis equal the JAX package's eager ``_d1_axis`` /
    ``_d2_axis`` bit for bit (the CPML step's derivatives), and the CPML
    profiles equal ``_cpml_profiles``, free surface or not."""
    rng = np.random.default_rng(order)
    for dtype in (np.float32, np.float64):
        x = rng.standard_normal((7, 9, 11)).astype(dtype)
        inv = np.asarray(1.0 / 10.0, dtype)
        with jax.disable_jit():
            for ax in range(3):
                np.testing.assert_array_equal(
                    d1_axis(_T(x), ax, _T(inv), order).numpy(),
                    np.asarray(j_d1(jnp.asarray(x), ax, jnp.asarray(inv), order)))
                np.testing.assert_array_equal(
                    d2_axis(_T(x), ax, _T(inv), order).numpy(),
                    np.asarray(j_d2(jnp.asarray(x), ax, jnp.asarray(inv), order)))
    for fs in (False, True):
        aj, bj = jw._cpml_profiles((32, 20), 6, 1e-3, 10.0, 2000.0, 15.0,
                                   dtype=jnp.float32, free_surface=fs)
        at, bt = tw._cpml_profiles((32, 20), 6, 1e-3, 10.0, 2000.0, 15.0,
                                   dtype=torch.float32, free_surface=fs)
        for a, b in zip(aj + bj, at + bt):
            assert tuple(b.shape) == a.shape
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def _boundary_energy(prop_kind, grid=(64, 64), width=10, port=True):
    """Fire a pulse at the centre, run long enough for the wavefront to hit
    the boundary and come back, and measure what is left in the interior
    against the peak: the boundary's reflection (tests/test_wavefd.py)."""
    n = grid[0]
    kw = dict(nt=300, dt=0.001, dx=10.0, freq=15.0, src_idx=n * (n // 2) + n // 2,
              rcv_idx=np.arange(n * n))
    if port:
        kw.update(dtype=F64, device=CPU)
        ctor = tw.cpml_wave_propagator if prop_kind == "cpml" else tw.wave_propagator
        c = torch.full(grid, 2000.0, dtype=F64)
    else:
        kw.update(dtype=jnp.float64)
        ctor = jw.cpml_wave_propagator if prop_kind == "cpml" else jw.wave_propagator
        c = jnp.full(grid, 2000.0, jnp.float64)
    F = (ctor(grid, pml_width=width, cmax=2000.0, **kw) if prop_kind == "cpml"
         else ctor(grid, sponge_width=width, **kw))
    traces = np.asarray(F(c))  # (nt, n*n) full wavefield snapshots
    peak = float(np.max(np.abs(traces)))
    inner = traces[-1].reshape(grid)[width + 4:-(width + 4), width + 4:-(width + 4)]
    return float(np.max(np.abs(inner))) / peak


def test_cpml_absorbs_better_than_sponge():
    r_cpml, r_sponge = _boundary_energy("cpml"), _boundary_energy("sponge")
    assert r_cpml < 5e-3              # < 0.5% residual reflection amplitude
    assert r_cpml < 0.05 * r_sponge   # and beats the sponge by > 20x
    np.testing.assert_allclose(r_cpml, _boundary_energy("cpml", port=False), rtol=1e-6)


def _cpml20(**extra):
    return _cpml_pair((20, 20), nt=40, dt=0.0008, dx=10.0, freq=18.0, src_idx=20 * 10 + 10,
                      pml_width=4, cmax=2500.0, **extra)


def test_cpml_forward_and_born_match_jax():
    Fj, Ft = _cpml20()
    c = 2000.0 + 30.0 * np.random.default_rng(0).standard_normal((20, 20))
    dc = np.random.default_rng(1).standard_normal((20, 20))
    _close(Ft(_T(c)).numpy(), Fj(jnp.asarray(c)))
    _close(Ft.linearize(_T(c))(_T(dc)).numpy(), Fj.linearize(jnp.asarray(c))(jnp.asarray(dc)))
    dd = np.random.default_rng(2).standard_normal(Ft.rng.shape)
    _close(Ft.linearize(_T(c)).H(_T(dd)).numpy(),
           Fj.linearize(jnp.asarray(c)).H(jnp.asarray(dd)))


def test_cpml_born_dot_product_gate():
    _, Ft = _cpml20()
    _gate(tw.born_operator(Ft, torch.full((20, 20), 2000.0, dtype=F64)), 2)


def test_cpml_linearization_taylor_decay():
    _, Ft = _cpml20()
    c0 = torch.full((20, 20), 2000.0, dtype=F64)
    dm = 50.0 * tt.Space((20, 20), F64, CPU).randn(torch.Generator().manual_seed(4))
    obs, exp = tt.linearization_test(Ft, c0, delta_m=dm, mu=(1.0, 0.5, 0.25, 0.125))
    np.testing.assert_allclose(obs.numpy(), exp.numpy(), rtol=0.35)


def test_high_order_cpml_gate():
    """space_order=8 CPML passes the adjoint gate and matches JAX."""
    Fj, Ft = _cpml_pair((20, 20), nt=32, dt=0.0006, dx=10.0, freq=18.0,
                        src_idx=20 * 10 + 10, pml_width=4, cmax=2500.0, space_order=8)
    c0 = np.full((20, 20), 2000.0)
    _gate(tw.born_operator(Ft, _T(c0)), 23)
    _close(Ft(_T(c0)).numpy(), Fj(jnp.asarray(c0)))


def test_cpml_3d_and_multishot_match_jax():
    """A 3-D CPML propagator, and ``multishot_wave_operator(boundary="cpml")``
    in both shot modes: each shot is the single-shot CPML run (bit for bit
    within the port), JAX's traces agree, the derived adjoint passes the
    gate, and ``store_adjoint`` or windows with CPML raise."""
    Fj, Ft = _cpml_pair((10, 12, 14), nt=20, dt=0.0008, dx=10.0, freq=18.0,
                        src_idx=int(np.ravel_multi_index((5, 6, 7), (10, 12, 14))),
                        rcv_idx=np.arange(10 * 12 * 14), pml_width=3, cmax=2500.0)
    c3 = 2000.0 + 20.0 * np.random.default_rng(5).standard_normal((10, 12, 14))
    _close(Ft(_T(c3)).numpy(), Fj(jnp.asarray(c3)))
    grid, srcs = (20, 20), [20 * 6 + 6, 20 * 13 + 12]
    kw = dict(nt=24, dt=0.0008, dx=10.0, freq=18.0, sponge_width=4, cmax=2500.0,
              boundary="cpml")
    Mj = jw.multishot_wave_operator(grid, srcs, dtype=jnp.float64, **kw)
    c = 2000.0 + 30.0 * np.random.default_rng(6).standard_normal(grid)
    dj = Mj(jnp.asarray(c))
    for shot_map in ("vmap", "map"):
        Mt = tw.multishot_wave_operator(grid, srcs, dtype=F64, device=CPU,
                                        shot_map=shot_map, **kw)
        Mt = tt.with_state(Mt, sstate={**Mt.jet.state["sstate"],
                                       "wavelet": _T(Mj.jet.state["sstate"]["wavelet"])})
        d = Mt(_T(c))
        _close(d.numpy(), dj)
        for k, s in enumerate(srcs):
            single = tw.cpml_wave_propagator(grid, nt=24, dt=0.0008, dx=10.0, freq=18.0,
                                             src_idx=s, pml_width=4, cmax=2500.0,
                                             dtype=F64, device=CPU)
            single = tt.with_state(single, wavelet=Mt.jet.state["sstate"]["wavelet"])
            assert torch.equal(d[k], single(_T(c)))
        _gate(Mt.linearize(_T(c)), 7)
    with pytest.raises(ValueError, match="store_adjoint is not available with CPML"):
        tw.multishot_wave_operator(grid, srcs, store_adjoint="int8", device=CPU, **kw)
    with pytest.raises(ValueError, match="ginsu windowing composes"):
        tw.multishot_wave_operator(grid, srcs, window_shape=(12, 12),
                                   window_corners=[[0, 0], [8, 8]], device=CPU, **kw)


# ---------------------------------------------------------------------- #
# free surface
# ---------------------------------------------------------------------- #


def test_free_surface_ghost_and_gates():
    """With free_surface the top boundary reflects (surface ghost) while the
    other edges stay absorbing; without it the top absorbs too."""
    n = 48
    kw = dict(nt=160, dt=0.001, dx=10.0, freq=15.0, src_idx=n * 6 + n // 2,
              rcv_idx=np.arange(n * n), sponge_width=8)
    F_fs = tw.wave_propagator((n, n), free_surface=True, dtype=F64, device=CPU, **kw)
    F_ab = tw.wave_propagator((n, n), free_surface=False, dtype=F64, device=CPU, **kw)
    c = torch.full((n, n), 2000.0, dtype=F64)
    d_fs, d_ab = F_fs(c), F_ab(c)
    prof = tw._sponge((n, n), 8, free_surface=True).numpy()
    assert np.all(prof[0, 8:-8] == 1.0)
    assert np.all(prof[-1, :] < 1.0) and np.all(prof[:, 0] < 1.0)
    late_fs = float(torch.linalg.vector_norm(d_fs[120:]))
    late_ab = float(torch.linalg.vector_norm(d_ab[120:]))
    assert late_fs > 1.4 * late_ab
    assert float(d_fs.abs().max()) > 0
    Fj = jw.wave_propagator((n, n), free_surface=True, dtype=jnp.float64, **kw)
    _close(_carried(F_fs, Fj)(c).numpy(), Fj(jnp.asarray(c.numpy())))
    _gate(tw.born_operator(F_fs, c), 29)


def test_free_surface_cpml():
    for dtype in (torch.float64, torch.float32):
        a_prof, _ = tw._cpml_profiles((32, 32), 6, 0.001, 10.0, 2000.0, 15.0, dtype=dtype,
                                      free_surface=True)
        a0, a1 = a_prof[0].numpy().ravel(), a_prof[1].numpy().ravel()
        assert np.all(a0[:16] == 0.0)      # no PML at the top of axis 0
        assert np.any(a0[-6:] != 0.0)      # bottom PML intact
        assert np.any(a1[:6] != 0.0)       # lateral PML on both sides
        assert np.any(a1[-6:] != 0.0)
    # and through the operator: the free-surface run keeps more late energy
    kw = dict(nt=120, dt=0.001, dx=10.0, freq=15.0, src_idx=32 * 5 + 16,
              rcv_idx=np.arange(32 * 32), pml_width=6, cmax=2000.0, dtype=F64, device=CPU)
    c = torch.full((32, 32), 2000.0, dtype=F64)
    d_fs = tw.cpml_wave_propagator((32, 32), free_surface=True, **kw)(c)
    d_ab = tw.cpml_wave_propagator((32, 32), **kw)(c)
    assert float(torch.linalg.vector_norm(d_fs[80:])) > float(
        torch.linalg.vector_norm(d_ab[80:]))


# ---------------------------------------------------------------------- #
# Ginsu windows (per-shot model subsetting)
# ---------------------------------------------------------------------- #

GRID, WIN = (24, 24), (12, 12)
CORNERS = np.array([[0, 0], [0, 12], [12, 0], [12, 12]])
GKW = dict(nt=24, dt=0.0008, dx=10.0, freq=18.0, sponge_width=3)


def _ginsu_pair(shot_map, corners=CORNERS, **extra):
    src = np.full((len(corners),), 12 * 6 + 6)  # window-relative centre
    rcv = np.arange(0, 144, 3)
    Fj = jw.multishot_wave_operator(GRID, src, rcv_idx=rcv, window_corners=corners,
                                    window_shape=WIN, dtype=jnp.float64, **GKW, **extra)
    Ft = tw.multishot_wave_operator(GRID, src, rcv_idx=rcv, window_corners=corners,
                                    window_shape=WIN, shot_map=shot_map, dtype=F64,
                                    device=CPU, **GKW, **extra)
    return Fj, _carried(Ft, Fj)


def _velocity24():
    return np.asarray(2000.0 + 100.0 * jt.Space(GRID, jnp.float64).rand(
        jax.random.PRNGKey(9)))


@pytest.mark.parametrize("shot_map", ["vmap", "map"])
def test_ginsu_matches_explicit_slice_and_gates(shot_map):
    Fj, Ft = _ginsu_pair(shot_map)
    c = _velocity24()
    d = Ft(_T(c))
    assert d.shape[0] == 4
    _close(d.numpy(), Fj(jnp.asarray(c)))
    # each shot equals a single propagator run on the sliced window
    Fw = tw.wave_propagator(WIN, src_idx=12 * 6 + 6, rcv_idx=np.arange(0, 144, 3),
                            dtype=F64, device=CPU, **GKW)
    Fw = tt.with_state(Fw, wavelet=Ft.jet.state["sstate"]["wavelet"],
                       sponge=Ft.jet.state["sstate"]["sponge"])
    for k, (i0, j0) in enumerate(CORNERS):
        assert torch.equal(d[k], Fw(_T(c[i0:i0 + 12, j0:j0 + 12])))
    # adjoint gate through the windowed stack (scatter-add placement)
    _gate(Ft.linearize(_T(c)), 10)
    dd = np.random.default_rng(11).standard_normal(Ft.rng.shape)
    _close(Ft.linearize(_T(c)).H(_T(dd)).numpy(),
           Fj.linearize(jnp.asarray(c)).H(jnp.asarray(dd)))


@pytest.mark.parametrize("shot_map", ["vmap", "map"])
def test_ginsu_stored_adjoint_scatters_window_gradients(shot_map):
    """With a stored history each shot's window gradient is scattered back
    into the full grid: the stack's adjoint equals the sum of single-shot
    gradients on the explicit slices placed at their corners (overlapping
    windows accumulate), the derived adjoint to roundoff, and JAX's."""
    corners = np.array([[0, 0], [6, 6], [12, 10], [4, 12]])  # overlapping
    Fj, Ft = _ginsu_pair(shot_map, corners, store_adjoint="f32")
    _, Fd = _ginsu_pair(shot_map, corners)
    c = _velocity24()
    dd = np.random.default_rng(12).standard_normal(Ft.rng.shape)
    g = Ft.linearize(_T(c)).H(_T(dd))
    Fw = tw.wave_propagator(WIN, src_idx=12 * 6 + 6, rcv_idx=np.arange(0, 144, 3),
                            store_adjoint="f32", dtype=F64, device=CPU, **GKW)
    Fw = tt.with_state(Fw, wavelet=Ft.jet.state["sstate"]["wavelet"],
                       sponge=Ft.jet.state["sstate"]["sponge"])
    want = torch.zeros(GRID, dtype=F64)
    for k, (i0, j0) in enumerate(corners):
        want[i0:i0 + 12, j0:j0 + 12] += Fw.linearize(_T(c[i0:i0 + 12, j0:j0 + 12])).H(
            _T(dd[k]))
    _close(g.numpy(), want.numpy(), rtol=1e-14)
    _close(g.numpy(), Fd.linearize(_T(c)).H(_T(dd)).numpy())
    _close(g.numpy(), Fj.linearize(jnp.asarray(c)).H(jnp.asarray(dd)))


def test_ginsu_window_validation():
    """Both-or-neither args, and corners must keep the window inside the
    grid (a gather past it would read another place of the model)."""
    grid, srcs = (16, 16), [5, 6]
    with pytest.raises(ValueError, match="BOTH"):
        tw.multishot_wave_operator(grid, srcs, nt=4, window_shape=(8, 8), device=CPU)
    with pytest.raises(ValueError, match="BOTH"):
        tw.multishot_wave_operator(grid, srcs, nt=4, window_corners=[[0, 0], [1, 1]],
                                   device=CPU)
    with pytest.raises(ValueError, match=r"\(nshots, ndim\)"):
        tw.multishot_wave_operator(grid, srcs, nt=4, window_shape=(8, 8),
                                   window_corners=[[0, 0]], device=CPU)
    with pytest.raises(ValueError, match=r"out of bounds for shots \[1\]"):
        tw.multishot_wave_operator(grid, srcs, nt=4, window_shape=(8, 8),
                                   window_corners=[[0, 0], [12, 0]], device=CPU)
    with pytest.raises(ValueError, match=r"out of bounds for shots \[0\]"):
        tw.multishot_wave_operator(grid, srcs, nt=4, window_shape=(8, 8),
                                   window_corners=[[-1, 0], [0, 0]], device=CPU)
    F = tw.multishot_wave_operator(grid, srcs, nt=4, window_shape=(8, 8),
                                   window_corners=[[0, 0], [8, 8]], device=CPU)
    assert F.dom.shape == grid


def test_ginsu_3d_windows_on_the_kernel_route_shape():
    """A 3-D float32 windowed stack in map mode: each window is a 3-D
    float32 grid the kernels take (on the card ``fused=None`` rides K4/K5;
    here the plain route), and the int8 stored gradient scatters back."""
    grid, win = (12, 16, 32), (12, 8, 16)
    corners = np.array([[0, 0, 0], [0, 8, 16], [0, 4, 8]])
    src = np.full(3, int(np.ravel_multi_index((6, 4, 8), win)))
    F = tw.multishot_wave_operator(grid, src, nt=12, dt=6e-4, dx=10.0, freq=16.0,
                                   sponge_width=2, window_shape=win,
                                   window_corners=corners, store_adjoint="int8",
                                   shot_map="map", device=CPU)
    assert cw.fits_wave_kernel(win, torch.float32, 2)
    c = torch.full(grid, 1500.0)
    d = F(c)
    _live(d.numpy())
    g = F.linearize(c).H(torch.ones_like(d))
    _live(g.numpy())
    outside = torch.ones(grid, dtype=torch.bool)
    for z, y, x in corners:
        outside[z:z + 12, y:y + 8, x:x + 16] = False
    assert bool((g[outside] == 0).all())  # nothing lands outside the windows


# ---------------------------------------------------------------------- #
# blocked rematerialization
# ---------------------------------------------------------------------- #


def _loss_grad(F, c, d_obs):
    c = c.clone().requires_grad_()
    r = F(c) - d_obs
    (g,) = torch.autograd.grad(0.5 * torch.sum(r * r), c)
    return g


def test_remat_blocks_value_and_gradient_equivalence():
    """Blocked checkpointing changes memory, not values: traces and the FWI
    gradient through torch.autograd are the same bits, the derived adjoint
    (torch.autograd through the segments) agrees with the unsegmented one
    (torch.func.vjp), and JAX's gradient agrees."""
    kw = dict(nt=48, dt=0.0008, dx=10.0, freq=18.0, src_idx=24 * 12 + 12, sponge_width=4)
    F1 = tw.wave_propagator((24, 24), remat_blocks=1, dtype=F64, device=CPU, **kw)
    F6 = tw.wave_propagator((24, 24), remat_blocks=6, dtype=F64, device=CPU, **kw)
    c0 = _T(np.asarray(2000.0 + 50.0 * jt.Space((24, 24), jnp.float64).rand(
        jax.random.PRNGKey(16))))
    d1, d6 = F1(c0), F6(c0)
    assert torch.equal(d1, d6)
    d_obs = d1 + 0.01 * torch.std(d1, correction=0)
    g1, g6 = _loss_grad(F1, c0, d_obs), _loss_grad(F6, c0, d_obs)
    _live(g1.numpy())
    assert torch.equal(g1, g6)
    with torch.enable_grad():  # the segments run under the tape...
        c = c0.clone().requires_grad_()
        assert torch.equal(F6(c), d1)
    r = d1 - d_obs
    _close(F6.linearize(c0).H(r).numpy(), F1.linearize(c0).H(r).numpy(), rtol=1e-13)
    Fj = jw.wave_propagator((24, 24), remat_blocks=6, dtype=jnp.float64, **kw)
    Ft = _carried(F6, Fj)
    dj = Fj(jnp.asarray(c0.numpy()))
    gj = jax.grad(lambda c: 0.5 * jnp.sum((Fj(c) - (dj + 0.01 * jnp.std(dj))) ** 2))(
        jnp.asarray(c0.numpy()))
    dt_ = Ft(c0)
    _close(_loss_grad(Ft, c0, dt_ + 0.01 * torch.std(dt_, correction=0)).numpy(), gj)


def test_remat_blocks_snaps_to_divisor():
    """A non-divisor remat_blocks warns and snaps to the nearest divisor of
    nt instead of silently losing the blocked memory saving."""
    F = tw.wave_propagator((8, 8), nt=30, dt=5e-4, dx=10.0, sponge_width=2,
                           remat_blocks=7, dtype=F64, device=CPU)
    c0 = torch.full((8, 8), 1500.0, dtype=F64)
    with pytest.warns(UserWarning, match="nearest divisor 6"):
        d = F(c0)
    assert d.shape[0] == 30
    F6 = tw.wave_propagator((8, 8), nt=30, dt=5e-4, dx=10.0, sponge_width=2,
                            remat_blocks=6, dtype=F64, device=CPU)
    assert torch.equal(d, F6(c0))
    with pytest.warns(UserWarning, match="nearest divisor 6"):  # under a tape too
        _loss_grad(F, c0, d)
    Fj = jw.wave_propagator((8, 8), nt=30, dt=5e-4, dx=10.0, sponge_width=2,
                            remat_blocks=7, dtype=jnp.float64)
    with pytest.warns(UserWarning, match="nearest divisor 6"):
        Fj(jnp.asarray(c0.numpy()))


def _kernel_route_remat_case(kind):
    """A 3-D float32 operator of ``kind`` on the kernel route (``fused=True``
    runs the kernels' autograd Functions through their plain versions on
    the CPU), its model and a receiver set on the source's x-line."""
    shape = (10, 8, 32)
    src = int(np.ravel_multi_index((5, 4, 16), shape))
    rcv = [int(np.ravel_multi_index((5, 4, x), shape)) for x in range(32)]
    kw = dict(nt=12, dt=6e-4, dx=10.0, freq=16.0, src_idx=src, rcv_idx=rcv,
              sponge_width=2, fused=True, device=CPU)
    c = torch.full(shape, 1500.0) + 20.0 * torch.randn(shape, generator=torch.Generator().
                                                      manual_seed(3))
    full = lambda v: torch.full(shape, v)  # noqa: E731
    if kind == "iso":
        return (lambda **r: tw.wave_propagator(shape, **kw, **r)), c
    if kind == "vti":
        ctor = lambda **r: tw.vti_wave_propagator(shape, **kw, **r)  # noqa: E731
        return ctor, tt.BlockVector((c, full(0.1), full(0.05)), ctor().dom)
    if kind == "tti":
        ctor = lambda **r: tw.tti_wave_propagator(shape, **kw, **r)  # noqa: E731
        return ctor, tt.BlockVector((c, full(0.1), full(0.05), full(0.2), full(0.7)),
                                    ctor().dom)
    ctor = lambda **r: tw.q_wave_propagator(shape, **kw, **r)  # noqa: E731
    return ctor, tt.BlockVector((c, full(40.0)), ctor().dom)


@pytest.mark.parametrize("kind", ["iso", "vti", "tti", "q"])
def test_remat_on_the_kernel_route(kind):
    """On the kernel route (K4, K8, K11, K14 inside their autograd
    Functions) the checkpointed segments recompute through the same steps:
    traces and the gradient of ½‖F(m) − d‖² over every model block are the
    same bits at remat_blocks 1 and 4, and the derived adjoint through the
    segments equals the one through torch.func.vjp to roundoff."""
    ctor, m = _kernel_route_remat_case(kind)
    F1, F4 = ctor(), ctor(remat_blocks=4)
    d = F1(m)
    _live(d.numpy())
    assert torch.equal(F4(m), d)
    d_obs = 0.9 * d

    def grads(F):
        leaves = [t.clone().requires_grad_() for t in pytree.tree_leaves(m)]
        mm = leaves[0] if len(leaves) == 1 else tt.BlockVector(leaves, m.space)
        r = F(mm) - d_obs
        return torch.autograd.grad(0.5 * torch.sum(r * r), leaves)

    for a, b in zip(grads(F1), grads(F4)):
        _live(a.numpy())
        assert torch.equal(a, b)
    r = d - d_obs
    ga, gb = F4.linearize(m).H(r), F1.linearize(m).H(r)
    for a, b in zip(pytree.tree_leaves(ga), pytree.tree_leaves(gb)):
        _close(a.numpy(), b.numpy(), rtol=1e-5)


def test_remat_multishot_derived_adjoint():
    """Multishot with remat_blocks > 1 derives the adjoint through its
    segments, in map mode per shot and in vmap mode over the whole stack:
    the same as without segments (vmap: the same bits), as the other mode's,
    and as JAX's."""
    grid, srcs = (20, 20), [20 * 6 + 6, 20 * 13 + 12]
    kw = dict(nt=24, dt=0.0008, dx=10.0, freq=18.0, sponge_width=4)
    Mj = jw.multishot_wave_operator(grid, srcs, remat_blocks=4, dtype=jnp.float64, **kw)
    c = 2000.0 + 30.0 * np.random.default_rng(8).standard_normal(grid)
    dd = np.random.default_rng(9).standard_normal((2, 24, 128))
    gj = Mj.linearize(jnp.asarray(c)).H(jnp.asarray(dd))
    outs = []
    for shot_map, remat in (("map", 4), ("map", 1), ("vmap", 4), ("vmap", 1)):
        Mt = _carried(tw.multishot_wave_operator(grid, srcs, remat_blocks=remat,
                                                 shot_map=shot_map, dtype=F64,
                                                 device=CPU, **kw), Mj)
        outs.append(Mt.linearize(_T(c)).H(_T(dd)).numpy())
        _close(outs[-1], gj)
    _close(outs[0], outs[1], rtol=1e-13)
    np.testing.assert_array_equal(outs[2], outs[3])


@pytest.mark.parametrize("kind", ["iso", "vti", "tti"])
def test_remat_multishot_autograd_gradient(kind):
    """The map-mode stacks pass ``remat_blocks`` to each shot's loop: traces
    and the autograd gradient over every block are the same bits at 1 and 4
    segments."""
    shape = (8, 16, 32)
    src = int(np.ravel_multi_index((4, 8, 16), shape))
    kw = dict(nt=24, dt=5e-4, dx=10.0, freq=15.0, sponge_width=2, shot_map="map",
              rcv_idx=[int(np.ravel_multi_index((4, 8, x), shape)) for x in range(32)],
              device=CPU)
    ctor = {"iso": tw.multishot_wave_operator, "vti": tw.multishot_vti_wave_operator,
            "tti": tw.multishot_tti_wave_operator}[kind]
    c = 1500.0 + 10.0 * torch.randn(shape, generator=torch.Generator().manual_seed(4))
    extra = {"iso": (), "vti": (0.1, 0.05), "tti": (0.1, 0.05, 0.2, 0.7)}[kind]
    outs = []
    for rb in (1, 4):
        F = ctor(shape, [src, src + 4], remat_blocks=rb, **kw)
        leaves = [c.clone().requires_grad_()] + [torch.full(shape, v).requires_grad_()
                                                 for v in extra]
        m = leaves[0] if kind == "iso" else tt.BlockVector(leaves, F.dom)
        d = F(m)
        outs.append((d.detach(), torch.autograd.grad(0.5 * torch.sum(d * d), leaves)))
    (da, ga), (db, gb) = outs
    _live(da.numpy())
    assert torch.equal(da, db)
    for a, b in zip(ga, gb):
        _live(a.numpy())
        assert torch.equal(a, b)
