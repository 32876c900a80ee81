"""The port's CG and LSMR solver-tail kernels (K6a ``cg_update``, K6b
``p_update``, K7 ``lsmr_update`` in jets_tpu_torch/ops/cuda_solver.py) held
against the JAX package's Pallas kernels (ops/pallas_solver.py) in
interpret mode, on the same numpy inputs.

The CUDA kernels run only on a card (``chip_smoke.py`` holds them bitwise
against these plain versions there). Here every wrapper gets CPU tensors,
so it must take its plain version, update its vectors in place, and launch
nothing.

Tolerances: interpret-mode Pallas runs under ``jit``, where XLA on the CPU
contracts multiply-adds into FMAs, while the plain versions round every
multiply and add: vectors agree to ``rtol=1e-6, atol=1e-5·max|ref|``. The
Pallas ``rho`` is a float32 sum per tile and the plain one ``torch.vdot``,
in another order: ``rtol=1e-5``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jets_tpu.ops import pallas_solver as pls
from jets_tpu_torch.ops import cuda_solver as cs

SHAPE = (16, 8, 128)
ZERO = {"xw_update": 0, "lap3d_axpy_norm2": 0, "laplacian3d": 0, "cg_update": 0,
        "p_update": 0, "lsmr_update": 0}


def _close(got, ref):
    ref = np.asarray(ref)
    assert float(np.max(np.abs(ref))) > 0.0, "vacuous: reference is zero"
    np.testing.assert_allclose(np.asarray(got), ref, rtol=1e-6,
                               atol=1e-5 * float(np.max(np.abs(ref))))


def _fields(seed, n, shape=SHAPE):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(n)]


def _t(*arrays):
    return [torch.from_numpy(a.copy()) for a in arrays]


@pytest.mark.parametrize("alpha", [0.37, -1.25])
def test_cg_update_plain_matches_pallas(alpha):
    x, r, p, q = _fields(1, 4)
    xo, ro, rho = pls.cg_update(*(jnp.asarray(a) for a in (x, r, p, q)), alpha,
                                interpret=True)
    tx, tr_, tp, tq = _t(x, r, p, q)
    gx, gr, grho = cs.cg_update_torch(tx, tr_, tp, tq, torch.tensor(alpha))
    assert gx is tx and gr is tr_  # in place
    _close(tx, xo)
    _close(tr_, ro)
    np.testing.assert_allclose(float(grho), float(rho), rtol=1e-5)
    np.testing.assert_allclose(float(grho), float(np.sum(tr_.double().numpy() ** 2)),
                               rtol=1e-5)


@pytest.mark.parametrize("beta", [0.61, 0.0])
def test_p_update_plain_matches_pallas(beta):
    r, p = _fields(2, 2)
    ref = pls.p_update(jnp.asarray(r), jnp.asarray(p), beta, interpret=True)
    tr_, tp = _t(r, p)
    assert cs.p_update_torch(tr_, tp, torch.tensor(beta)) is tp  # in place
    _close(tp, ref)


def test_lsmr_update_plain_matches_pallas():
    vh, h, hbar, x = _fields(3, 4)
    c_hb, c_x, c_h, inv_a = -0.31, 0.77, -0.52, 1.9
    ho, hbo, xo = pls.lsmr_update(*(jnp.asarray(a) for a in (vh, h, hbar, x)),
                                  c_hb, c_x, c_h, inv_a, interpret=True)
    tvh, th, thb, tx = _t(vh, h, hbar, x)
    out = cs.lsmr_update_torch(tvh, th, thb, tx,
                               *(torch.tensor(v) for v in (c_hb, c_x, c_h, inv_a)))
    assert out[0] is th and out[1] is thb and out[2] is tx  # in place
    _close(th, ho)
    _close(thb, hbo)
    _close(tx, xo)


@pytest.mark.parametrize("shape,off", [(SHAPE, 0), ((1000003,), 0), ((1000003,), 1)])
def test_wrappers_take_plain_versions_on_cpu_in_place(shape, off):
    """Any shape and any offset view (the kernels' vector path, scalar tail
    and unaligned path on a card): each wrapper is its plain version, in
    place, and launches nothing."""
    cs.reset_launch_counts()
    x, r, p, q, h, hb, vh = (torch.from_numpy(a)[off:]
                             for a in _fields(4, 7, (shape[0] + off,) + shape[1:]))
    ref = cs.cg_update_torch(x.clone(), r.clone(), p, q, torch.tensor(0.4))
    got = cs.cg_update(x, r, p, q, 0.4)
    assert got[0] is x and got[1] is r
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    assert got[2].shape == () and got[2].dtype == torch.float32

    ref = cs.p_update_torch(r, p.clone(), torch.tensor(-0.7))
    assert cs.p_update(r, p, -0.7) is p and torch.equal(p, ref)

    sc = (0.3, -0.2, 0.9, 1.1)
    ref = cs.lsmr_update_torch(vh, h.clone(), hb.clone(), x.clone(),
                               *(torch.tensor(v) for v in sc))
    got = cs.lsmr_update(vh, h, hb, x, *sc)
    assert got[0] is h and got[1] is hb and got[2] is x
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    assert cs.launch_counts() == ZERO


def test_lsmr_update_reads_h_before_writing_it():
    """``h' = inv_a·vh + c_h·h`` takes the OLD h, and ``x'`` the NEW hbar."""
    one = torch.ones(5)
    h, hb, x = 2.0 * one, 3.0 * one, 4.0 * one
    cs.lsmr_update(one, h, hb, x, 0.5, 10.0, 100.0, 1.0)
    assert torch.equal(hb, 3.5 * one)        # 2 + 0.5·3
    assert torch.equal(x, 39.0 * one)        # 4 + 10·3.5
    assert torch.equal(h, 201.0 * one)       # 1 + 100·2


@pytest.mark.parametrize("which", ["cg_update", "p_update", "lsmr_update"])
def test_wrappers_reject_what_the_kernels_do_not_take(which):
    z = torch.zeros((4, 8, 32))
    fn = getattr(cs, which)
    n = {"cg_update": 4, "p_update": 2, "lsmr_update": 4}[which]
    scal = {"cg_update": (0.5,), "p_update": (0.5,), "lsmr_update": (0.5,) * 4}[which]

    def vecs():
        return [z.clone() for _ in range(n)]

    with pytest.raises(TypeError, match="float32"):
        fn(*(v.double() for v in vecs()), *scal)
    bad = vecs()
    bad[-1] = torch.zeros((4, 8, 16))
    with pytest.raises(ValueError, match="shapes"):
        fn(*bad, *scal)
    bad = vecs()
    bad[-1] = torch.zeros((4, 8, 32), device="meta")
    with pytest.raises(ValueError, match="tensors on"):
        fn(*bad, *scal)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        fn(*(v.to("meta") for v in vecs()), *scal)
    bad = vecs()
    bad[1] = bad[0]
    with pytest.raises(ValueError, match="distinct"):
        fn(*bad, *scal)
    with pytest.raises(ValueError, match="contiguous"):
        fn(*(v.transpose(0, 2) for v in vecs()), *scal)
    with pytest.raises(ValueError, match="scalar"):
        fn(*vecs(), torch.ones(2), *scal[1:])
    assert cs.launch_counts() == ZERO
