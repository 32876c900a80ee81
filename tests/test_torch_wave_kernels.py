"""The port's wave kernels (jets_tpu_torch/ops/cuda_wave.py) held against the
JAX package's Pallas kernels (ops/pallas_wave.py) in interpret mode, on the
same numpy inputs.

The CUDA kernels K4 (``fused_leapfrog_step``) and K5 (``fused_adjoint_step``)
run only on a card, where ``chip_smoke.py`` holds them bitwise against the
plain versions tested here. Here every wrapper gets CPU tensors, so it
must take its plain version and launch nothing.

Tolerance: interpret-mode Pallas runs under ``jit``, where XLA on the CPU
contracts multiply-adds into FMAs, while the plain torch versions round
every multiply and add; they agree to ``rtol=1e-6, atol=1e-5·max|ref|``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jets_tpu.ops import pallas_wave as pw
from jets_tpu_torch.ops import cuda_wave as cw

SHAPE = (16, 8, 128)
ASHAPE = (16, 32, 128)  # int8 histories tile at (32, 128) on the TPU


def _close(got, ref):
    ref = np.asarray(ref)
    assert float(np.max(np.abs(ref))) > 0.0, "vacuous: reference is zero"
    np.testing.assert_allclose(np.asarray(got), ref, rtol=1e-6,
                               atol=1e-5 * float(np.max(np.abs(ref))))


def _fields(shape, seed, n):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(n)]


def _factors(shape):
    D, H, W = shape
    return (np.linspace(0.9, 1.0, D, dtype=np.float32),
            np.linspace(0.8, 1.0, H, dtype=np.float32),
            np.linspace(0.7, 1.0, W, dtype=np.float32))


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("order", [2, 4, 8])
def test_leapfrog_plain_matches_pallas(order):
    D, H, W = SHAPE
    up, u = _fields(SHAPE, 1, 2)
    c2 = (np.random.default_rng(2).random(SHAPE) + 0.5).astype(np.float32)
    sz, sy, sx = _factors(SHAPE)
    src = 5 * H * W + 3 * W + 17  # inside the grid
    s_t, amp = 0.37, 2.5e-7
    ref = pw.fused_leapfrog_step(
        jnp.asarray(up), jnp.asarray(u), jnp.asarray(c2), jnp.asarray(sz),
        jnp.asarray(sy).reshape(H, 1), jnp.asarray(sx).reshape(1, W),
        jnp.float32(s_t), src, jnp.float32(amp), order=order, interpret=True)
    tu, tup, tc2, tz, ty, tx = _t(u, up, c2, sz, sy, sx)
    got = cw.fused_leapfrog_step_torch(tup, tu, tc2, tz, ty, tx, torch.tensor(s_t),
                                       src, torch.tensor(amp), order=order)
    _close(got, ref)


@pytest.mark.parametrize("store,order,shape", [
    ("f32", 2, ASHAPE), ("bf16", 2, ASHAPE), ("int8", 2, ASHAPE),
    ("f32", 4, SHAPE), ("f32", 8, SHAPE)])
def test_adjoint_plain_matches_pallas(store, order, shape):
    D, H, W = shape
    a1, a2, gc2, u = _fields(shape, 3, 4)
    c2 = (np.random.default_rng(4).random(shape) + 0.5).astype(np.float32)
    sz, sy, sx = _factors(shape)
    tu = torch.from_numpy(u)
    if store == "f32":
        q_t, sc = tu, np.float32(1.0)
    elif store == "bf16":
        q_t, sc = tu.to(torch.bfloat16), np.float32(1.0)
    else:
        s = np.float32(np.max(np.abs(u)))
        q_t = torch.round(tu * (torch.tensor(127.0) / torch.tensor(s))).to(torch.int8)
        sc = np.float32(s / np.float32(127.0))
    q_j = (jnp.asarray(q_t.float().numpy()).astype(jnp.bfloat16) if store == "bf16"
           else jnp.asarray(q_t.numpy()))
    core_r, gc2_r = pw.fused_adjoint_step(
        jnp.asarray(a1), jnp.asarray(a2), jnp.asarray(gc2), jnp.asarray(c2), q_j,
        jnp.float32(sc), jnp.asarray(sz), jnp.asarray(sy).reshape(H, 1),
        jnp.asarray(sx).reshape(1, W), order=order, interpret=True)
    ta1, ta2, tg, tc2, tz, ty, tx = _t(a1, a2, gc2, c2, sz, sy, sx)
    core, gc2_n = cw.fused_adjoint_step_torch(ta1, ta2, tg, tc2, q_t,
                                              torch.tensor(sc), tz, ty, tx,
                                              order=order)
    _close(core, core_r)
    _close(gc2_n, gc2_r)


def test_source_lands_on_one_cell():
    D, H, W = SHAPE
    up, u = _t(*_fields(SHAPE, 5, 2))
    c2 = torch.full(SHAPE, 0.2)
    tz, ty, tx = _t(*_factors(SHAPE))
    src = 7 * H * W + 2 * W + 100
    a = cw.fused_leapfrog_step(up, u, c2, tz, ty, tx, 0.37, src, 0.125)
    b = cw.fused_leapfrog_step(up, u, c2, tz, ty, tx, 0.37, src, 0.0)
    d = (a - b).reshape(-1)
    np.testing.assert_allclose(float(d[src]), 0.37 * 0.125, rtol=1e-6)
    d[src] = 0.0
    assert not bool(d.any()), "the source must touch exactly one cell"


def test_wrappers_take_plain_versions_on_cpu_in_place():
    D, H, W = ASHAPE
    up, u, a1, a2, gc2 = _t(*_fields(ASHAPE, 6, 5))
    c2 = torch.full(ASHAPE, 0.3)
    tz, ty, tx = _t(*_factors(ASHAPE))
    s_t, amp, src = torch.tensor(0.5), torch.tensor(1e-3), 4 * H * W + 7
    cw.reset_launch_counts()
    ref = cw.fused_leapfrog_step_torch(up, u, c2, tz, ty, tx, s_t, src, amp, order=4)
    assert torch.equal(cw.fused_leapfrog_step(up, u, c2, tz, ty, tx, s_t, src, amp,
                                              order=4), ref)
    out = cw.fused_leapfrog_step(up, u, c2, tz, ty, tx, s_t, src, amp, order=4,
                                 out=up)
    assert out is up and torch.equal(up, ref)

    q = u.to(torch.int8)
    core_r, g_r = cw.fused_adjoint_step_torch(a1, a2, gc2, c2, q, 0.01, tz, ty, tx)
    core, g = cw.fused_adjoint_step(a1, a2, gc2, c2, q, 0.01, tz, ty, tx)
    assert torch.equal(core, core_r) and torch.equal(g, g_r)
    core, g = cw.fused_adjoint_step(a1, a2, gc2, c2, q, 0.01, tz, ty, tx, inplace=True)
    assert core is a2 and g is gc2
    assert torch.equal(a2, core_r) and torch.equal(gc2, g_r)
    assert cw.launch_counts() == {"fused_leapfrog_step": 0, "fused_adjoint_step": 0,
                                 "fused_q_step": 0}


def test_wrappers_reject_what_the_kernels_do_not_take():
    u = torch.zeros((4, 8, 32))
    up = torch.zeros_like(u)
    f = [torch.ones(n) for n in u.shape]
    args = (torch.zeros_like(u), f[0], f[1], f[2], 1.0, 0, 1.0)
    with pytest.raises(TypeError, match="float32"):
        cw.fused_leapfrog_step(up.double(), u.double(), u.double(), *f, 1.0, 0, 1.0)
    with pytest.raises(ValueError, match="contiguous"):
        cw.fused_leapfrog_step(up.transpose(0, 2).contiguous().transpose(0, 2), u,
                               *args)
    with pytest.raises(ValueError, match="D, H, W"):
        cw.fused_leapfrog_step(up[0], u[0], u[0], *f[1:], f[2], 1.0, 0, 1.0)
    with pytest.raises(ValueError, match="order"):
        cw.fused_leapfrog_step(up, u, *args, order=6)
    with pytest.raises(ValueError, match="sy must have shape"):
        cw.fused_leapfrog_step(up, u, u.clone(), f[0], f[0], f[2], 1.0, 0, 1.0)
    with pytest.raises(ValueError, match="distinct"):
        cw.fused_leapfrog_step(u, u, *args)
    with pytest.raises(ValueError, match="out must be"):
        cw.fused_leapfrog_step(up, u, *args, out=u.clone())
    with pytest.raises(ValueError, match="scalar"):
        cw.fused_leapfrog_step(up, u, u.clone(), *f, torch.ones(2), 0, 1.0)
    a1, a2, g, c2 = (torch.zeros_like(u) for _ in range(4))
    with pytest.raises(TypeError, match="history"):
        cw.fused_adjoint_step(a1, a2, g, c2, u.half(), 1.0, *f)
    with pytest.raises(ValueError, match="history"):
        cw.fused_adjoint_step(a1, a2, g, c2, u[:2].clone(), 1.0, *f)
    with pytest.raises(ValueError, match="distinct"):
        cw.fused_adjoint_step(a1, a1, g, c2, u, 1.0, *f)
    assert cw.launch_counts() == {"fused_leapfrog_step": 0, "fused_adjoint_step": 0,
                                 "fused_q_step": 0}


def test_fits_wave_kernel_is_the_hopper_shape_guard():
    assert cw.fits_wave_kernel((256, 256, 256), torch.float32, 8)
    assert cw.fits_wave_kernel((17, 33, 130), torch.float32, 2)  # no alignment rule
    assert not cw.fits_wave_kernel((64, 64), torch.float32, 2)
    assert not cw.fits_wave_kernel((8, 8, 8), torch.float64, 2)
    assert not cw.fits_wave_kernel((8, 8, 8), torch.float32, 6)
    assert not cw.fits_wave_kernel((70000, 8, 8), torch.float32, 2)
