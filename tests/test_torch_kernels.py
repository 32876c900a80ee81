"""The port's solver-tail kernels (jets_tpu_torch/ops/cuda_solver.py) held
against the JAX package's Pallas kernels (ops/pallas_solver.py) in
interpret mode, on the same numpy inputs.

The CUDA kernels themselves run only on a card (``chip_smoke.py`` holds
them against these plain versions there, bitwise). Here every wrapper gets
CPU tensors, so it must take its plain version and launch nothing.

Tolerances: interpret-mode Pallas runs under ``jit``, where XLA on the CPU
contracts multiply-adds into FMAs, so the plain torch versions (which round
every multiply and add) agree to ``rtol=1e-6, atol=1e-5·max|ref|``; sums of
squares to ``rtol=1e-5``. ``laplacian_nd`` has the same add tree in both
packages and is compared bitwise against the EAGER JAX function.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jets_tpu.ops import pallas_solver as pls
from jets_tpu.ops.stencil import laplacian_nd as jax_laplacian_nd
from jets_tpu_torch.ops import cuda_solver as cs
from jets_tpu_torch.ops.stencil import laplacian_nd


def _close(got, ref):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(got), ref, rtol=1e-6,
                               atol=1e-5 * float(np.max(np.abs(ref))))


def _f32(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("shape", [(16, 128), (8, 16, 128), (4, 8, 8, 128)])
def test_xw_update_plain_matches_pallas(shape):
    rng = np.random.default_rng(1)
    x, w, vh = (_f32(rng, shape) for _ in range(3))
    t1, t2, inv_a = 0.37, -0.21, 1.7
    xo, wo = pls.xw_update(jnp.asarray(x), jnp.asarray(w), jnp.asarray(vh),
                           t1, t2, inv_a, interpret=True)
    xt, wt = torch.from_numpy(x.copy()), torch.from_numpy(w.copy())
    rx, rw = cs.xw_update_torch(xt, wt, torch.from_numpy(vh),
                                torch.tensor(t1), torch.tensor(t2),
                                torch.tensor(inv_a))
    assert rx is xt and rw is wt  # in place
    _close(xt, xo)
    _close(wt, wo)


@pytest.mark.parametrize("shape", [(8, 16, 128), (12, 24, 256)])
def test_laplacian3d_plain_matches_pallas(shape):
    z = _f32(np.random.default_rng(2), shape)
    ref = pls.laplacian3d(jnp.asarray(z), interpret=True)
    _close(cs.laplacian3d_torch(torch.from_numpy(z)), ref)


@pytest.mark.parametrize("shape", [(8, 16, 128), (12, 24, 256)])
def test_lap3d_axpy_norm2_plain_matches_pallas(shape):
    rng = np.random.default_rng(3)
    z, v = _f32(rng, shape), _f32(rng, shape)
    s = -0.43
    vh_ref, n2_ref = pls.lap3d_axpy_norm2(jnp.asarray(z), jnp.asarray(v), s,
                                          interpret=True)
    vh, n2 = cs.lap3d_axpy_norm2_torch(torch.from_numpy(z), torch.from_numpy(v),
                                       torch.tensor(s))
    _close(vh, vh_ref)
    np.testing.assert_allclose(float(n2), float(n2_ref), rtol=1e-5)
    np.testing.assert_allclose(
        float(n2), float(np.sum(vh.numpy().astype(np.float64) ** 2)), rtol=1e-5)


@pytest.mark.parametrize("order", [2, 4, 8])
@pytest.mark.parametrize("shape,dtype", [
    ((64, 64), np.float32), ((8, 16, 128), np.float32), ((12, 10, 9), np.float64),
])
def test_laplacian_nd_bitwise_vs_eager_jax(shape, dtype, order):
    x = np.random.default_rng(4).standard_normal(shape).astype(dtype)
    ref = np.asarray(jax_laplacian_nd(jnp.asarray(x), order=order))
    got = laplacian_nd(torch.from_numpy(x), order=order).numpy()
    assert got.dtype == ref.dtype
    np.testing.assert_array_equal(got, ref)


def test_wrappers_take_plain_versions_on_cpu():
    rng = np.random.default_rng(5)
    shape = (8, 16, 128)
    z, v, x, w, vh = (torch.from_numpy(_f32(rng, shape)) for _ in range(5))
    s = torch.tensor(-0.43)
    cs.reset_launch_counts()

    got_vh, got_n2 = cs.lap3d_axpy_norm2(z, v, s)
    ref_vh, ref_n2 = cs.lap3d_axpy_norm2_torch(z, v, s)
    assert torch.equal(got_vh, ref_vh) and torch.equal(got_n2, ref_n2)
    assert torch.equal(cs.laplacian3d(z), cs.laplacian3d_torch(z))
    assert torch.equal(cs.laplacian3d(z), laplacian_nd(z))

    xp, wp = cs.xw_update_torch(x.clone(), w.clone(), vh, 0.37, -0.21, 1.7)
    xo, wo = cs.xw_update(x, w, vh, 0.37, -0.21, 1.7)
    assert xo is x and wo is w
    assert torch.equal(x, xp) and torch.equal(w, wp)

    assert cs.launch_counts() == {
        "xw_update": 0, "lap3d_axpy_norm2": 0, "laplacian3d": 0, "cg_update": 0,
        "p_update": 0, "lsmr_update": 0}


def test_wrappers_reject_what_the_kernels_do_not_take():
    z = torch.zeros((4, 8, 32))
    with pytest.raises(TypeError, match="float32"):
        cs.laplacian3d(z.double())
    with pytest.raises(ValueError, match="contiguous"):
        cs.laplacian3d(z.transpose(0, 2))
    with pytest.raises(ValueError, match="D, H, W"):
        cs.laplacian3d(z[0])
    with pytest.raises(ValueError, match="shapes"):
        cs.lap3d_axpy_norm2(z, torch.zeros((4, 8, 16)), 0.5)
    with pytest.raises(ValueError, match="distinct"):
        cs.xw_update(z, z, torch.ones_like(z), 1.0, 1.0, 1.0)
    with pytest.raises(ValueError, match="scalar"):
        cs.xw_update(z, z.clone(), z.clone(), torch.ones(2), 1.0, 1.0)
    assert cs.launch_counts() == {
        "xw_update": 0, "lap3d_axpy_norm2": 0, "laplacian3d": 0, "cg_update": 0,
        "p_update": 0, "lsmr_update": 0}
