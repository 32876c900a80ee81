"""The port's VTI kernels (jets_tpu_torch/ops/cuda_vti.py) held against the
JAX package on the same numpy inputs: their plain versions bitwise against
the eager JAX trees of ``ops/wave.py``'s XLA VTI steps at order 2, and
against the Pallas kernels of ``ops/pallas_wave.py`` in interpret mode.

The CUDA kernels K8 (``fused_vti_step``), K9 (``fused_vti_hist_step``) and
K10 (``fused_vti_adjoint_step``) run only on a card, where ``chip_smoke.py``
holds them bitwise against the plain versions tested here. Here every
wrapper gets CPU tensors, so it must take its plain version and launch
nothing.

Tolerances: eager JAX rounds every multiply and add as the plain versions
do, so those comparisons are bitwise. Interpret-mode Pallas runs under
``jit``, where XLA on the CPU contracts multiply-adds into FMAs; fields and
maxima then agree to ``rtol=1e-5, atol=1e-5·max|ref|`` (the JAX suite's own
kernel-vs-XLA tolerance is 2e-5), while the history codes, which involve
no add, are bitwise.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jets_tpu.ops import pallas_wave as pw
from jets_tpu.ops.wave import _d2_axis, _iota_src_mask
from jets_tpu_torch.ops import cuda_vti as cv

SHAPE = (16, 8, 128)
ASHAPE = (16, 32, 128)  # int8 histories tile at (32, 128) on the TPU
INV = np.float32(0.01)  # 1/dx² at dx = 10
ZERO = {k: 0 for k in ("fused_vti_step", "fused_vti_hist_step",
                       "fused_vti_adjoint_step")}


def _inputs(shape, seed):
    """Fields, physical coefficients and sponge factors as numpy f32."""
    rng = np.random.default_rng(seed)
    f = {k: rng.standard_normal(shape).astype(np.float32)
         for k in ("pp", "p", "qp", "q", "ap1", "aq1", "ap2", "aq2", "gC", "gah", "gav")}
    c = rng.uniform(1400.0, 4500.0, shape).astype(np.float32)
    f["C"] = (c * c) * np.float32(5e-4 * 5e-4)
    f["ah"] = np.float32(1.0) + np.float32(2.0) * rng.uniform(0, 0.3, shape).astype(np.float32)
    f["av"] = np.sqrt(np.float32(1.0) + np.float32(2.0)
                      * rng.uniform(-0.1, 0.2, shape).astype(np.float32))
    D, H, W = shape
    f["sz"] = np.linspace(0.9, 1.0, D, dtype=np.float32)
    f["sy"] = np.linspace(0.8, 1.0, H, dtype=np.float32)
    f["sx"] = np.linspace(0.7, 1.0, W, dtype=np.float32)
    return f


def _src(shape):
    D, H, W = shape
    return 5 * H * W + 3 * W + 17


def _T(f, *keys):
    return [torch.from_numpy(np.ascontiguousarray(f[k])) for k in keys]


def _J(f, *keys):
    return [jnp.asarray(f[k]) for k in keys]


def _live(x):
    assert float(np.max(np.abs(np.asarray(x, dtype=np.float32)))) > 0.0, "vacuous"


def _equal(got, ref):
    _live(ref)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))


def _close(got, ref):
    ref = np.asarray(ref)
    _live(ref)
    np.testing.assert_allclose(np.asarray(got), ref, rtol=1e-5,
                               atol=1e-5 * float(np.max(np.abs(ref))))


def _sponge_j(f):
    sz, sy, sx = _J(f, "sz", "sy", "sx")
    return (sz[:, None, None] * sy[None, :, None]) * sx.reshape(1, 1, -1)


def _lh_j(u):
    return _d2_axis(u, 1, jnp.float32(INV), 2) + _d2_axis(u, 2, jnp.float32(INV), 2)


def _dz_j(u):
    return _d2_axis(u, 0, jnp.float32(INV), 2)


def _step_j(f, s_t, amp, shape):
    """Eager (op-by-op) JAX tree of ops/wave._propagate_vti's XLA step."""
    pp, p, qp, q, C, ah, av = _J(f, "pp", "p", "qp", "q", "C", "ah", "av")
    lh, dzz = _lh_j(p), _dz_j(q)
    S = _sponge_j(f)
    mask = _iota_src_mask(shape, _src(shape), jnp.float32(amp))
    pn = (2.0 * p - pp + C * (ah * lh + av * dzz)) * S + jnp.float32(s_t) * mask
    qn = (2.0 * q - qp + C * (av * lh + dzz)) * S + jnp.float32(s_t) * mask
    return pn, qn


def _qf(f):
    """int8 quantization factors ``127/max|·|`` of p and q, as f32 divisions."""
    s = np.array([np.max(np.abs(f["p"])), np.max(np.abs(f["q"]))], np.float32)
    return np.float32(127.0) / s, s


def _step_args(f, shape):
    pp, p, qp, q, C, ah, av, sz, sy, sx = _T(f, "pp", "p", "qp", "q", "C", "ah", "av",
                                            "sz", "sy", "sx")
    return (pp, p, qp, q, C, ah, av, sz, sy, sx, torch.tensor(INV))


def test_step_plain_is_bitwise_the_eager_jax_tree():
    f = _inputs(SHAPE, 0)
    s_t, amp = -0.37, 2.5e-3
    pn_j, qn_j = _step_j(f, s_t, amp, SHAPE)
    pn, qn = cv.fused_vti_step_torch(*_step_args(f, SHAPE), torch.tensor(s_t),
                                     _src(SHAPE), torch.tensor(amp), order=2)
    _equal(pn, pn_j)
    _equal(qn, qn_j)


@pytest.mark.parametrize("store", ["f32", "bf16", "int8"])
def test_hist_step_plain_is_bitwise_the_eager_jax_tree(store):
    f = _inputs(ASHAPE, 1)
    s_t, amp = 0.61, 2.5e-3
    qf, _ = _qf(f) if store == "int8" else (np.ones(2, np.float32), None)
    pn_j, qn_j = _step_j(f, s_t, amp, ASHAPE)
    p_j, q_j = _J(f, "p", "q")
    if store == "int8":
        codes_j = [jnp.round(u * jnp.float32(s)).astype(jnp.int8)
                   for u, s in ((p_j, qf[0]), (q_j, qf[1]))]
    elif store == "bf16":
        codes_j = [u.astype(jnp.bfloat16) for u in (p_j, q_j)]
    else:
        codes_j = [p_j, q_j]
    scales_j = [jnp.maximum(jnp.max(jnp.abs(u)), jnp.float32(1e-30)) for u in (pn_j, qn_j)]
    pn, qn, pe, qe, scales = cv.fused_vti_hist_step_torch(
        *_step_args(f, ASHAPE), torch.tensor(s_t), _src(ASHAPE), torch.tensor(amp),
        torch.tensor(qf[0]), torch.tensor(qf[1]), store=store, order=2)
    _equal(pn, pn_j)
    _equal(qn, qn_j)
    for got, ref in zip((pe, qe), codes_j):
        assert got.dtype == {"f32": torch.float32, "bf16": torch.bfloat16,
                             "int8": torch.int8}[store]
        _equal(got.float(), np.asarray(ref.astype(jnp.float32)))
    _equal(scales, np.array([float(s) for s in scales_j], np.float32))


def _codes(f, store):
    """History codes of p and q and their decode scales ``s/127`` (int8)."""
    p, q = _T(f, "p", "q")
    if store == "int8":
        qf, s = _qf(f)
        codes = [torch.round(u * torch.tensor(k)).to(torch.int8) for u, k in ((p, qf[0]), (q, qf[1]))]
        return codes, s / np.float32(127.0)
    if store == "bf16":
        return [p.to(torch.bfloat16), q.to(torch.bfloat16)], np.ones(2, np.float32)
    return [p, q], np.ones(2, np.float32)


def _adjoint_t(f, codes, sc, order=2):
    ap1, aq1, ap2, aq2, gC, gah, gav, C, av, ah, sz, sy, sx = _T(
        f, "ap1", "aq1", "ap2", "aq2", "gC", "gah", "gav", "C", "av", "ah", "sz", "sy", "sx")
    return (ap1, aq1, ap2, aq2, gC, gah, gav, C, av, ah, codes[0], codes[1],
            torch.tensor(sc[0]), torch.tensor(sc[1]), torch.tensor(INV), sz, sy, sx)


@pytest.mark.parametrize("store", ["f32", "bf16", "int8"])
def test_adjoint_plain_is_bitwise_the_eager_jax_tree(store):
    f = _inputs(ASHAPE, 2)
    codes, sc = _codes(f, store)
    ap1, aq1, ap2, aq2, gC, gah, gav, C, av, ah = _J(
        f, "ap1", "aq1", "ap2", "aq2", "gC", "gah", "gav", "C", "av", "ah")
    # the XLA dec: q.astype(f32)·(s/127) for int8, the cast alone otherwise
    dec = [jnp.asarray(c.float().numpy()) for c in codes]
    if store == "int8":
        dec = [d * jnp.float32(s) for d, s in zip(dec, sc)]
    S = _sponge_j(f)
    ebp, ebq = ap1 * S, aq1 * S
    lh_k, dzz_k = _lh_j(dec[0]), _dz_j(dec[1])
    ref = (
        (2.0 * ebp + _lh_j(C * ah * ebp) + _lh_j(C * av * ebq)) - ap2 * S,
        (2.0 * ebq + _dz_j(C * av * ebp) + _dz_j(C * ebq)) - aq2 * S,
        gC + ((ah * lh_k + av * dzz_k) * ebp + (av * lh_k + dzz_k) * ebq),
        gah + (C * lh_k) * ebp,
        gav + C * (dzz_k * ebp + lh_k * ebq),
    )
    got = cv.fused_vti_adjoint_step_torch(*_adjoint_t(f, codes, sc), order=2)
    for g, r in zip(got, ref):
        _equal(g, r)


@pytest.mark.parametrize("order", [2, 4, 8])
def test_step_plain_matches_pallas(order):
    f = _inputs(SHAPE, 3)
    D, H, W = SHAPE
    s_t, amp = 0.3, 0.125
    ref = pw.fused_vti_step(*_J(f, "pp", "p", "qp", "q", "C", "ah", "av", "sz"),
                            jnp.asarray(f["sy"]).reshape(H, 1),
                            jnp.asarray(f["sx"]).reshape(1, W), jnp.float32(INV),
                            jnp.float32(s_t), _src(SHAPE), jnp.float32(amp), order=order,
                            interpret=True)
    got = cv.fused_vti_step_torch(*_step_args(f, SHAPE), torch.tensor(s_t), _src(SHAPE),
                                  torch.tensor(amp), order=order)
    for g, r in zip(got, ref):
        _close(g, r)


@pytest.mark.parametrize("store,order,shape", [
    ("f32", 2, SHAPE), ("bf16", 2, ASHAPE), ("int8", 2, ASHAPE), ("f32", 8, SHAPE)])
def test_hist_step_plain_matches_pallas(store, order, shape):
    f = _inputs(shape, 4)
    D, H, W = shape
    s_t, amp = -0.45, 0.125
    qf = _qf(f)[0] if store == "int8" else np.ones(2, np.float32)
    pn, qn, pe, qe, pmax, qmax = pw.fused_vti_hist_step(
        *_J(f, "pp", "p", "qp", "q", "C", "ah", "av", "sz"),
        jnp.asarray(f["sy"]).reshape(H, 1), jnp.asarray(f["sx"]).reshape(1, W),
        jnp.float32(INV), jnp.float32(s_t), _src(shape), jnp.float32(amp),
        jnp.float32(qf[0]), jnp.float32(qf[1]), store=store, order=order, interpret=True)
    got = cv.fused_vti_hist_step_torch(*_step_args(f, shape), torch.tensor(s_t),
                                       _src(shape), torch.tensor(amp), torch.tensor(qf[0]),
                                       torch.tensor(qf[1]), store=store, order=order)
    _close(got[0], pn)
    _close(got[1], qn)
    _equal(got[2].float(), np.asarray(pe.astype(jnp.float32)))
    _equal(got[3].float(), np.asarray(qe.astype(jnp.float32)))
    _close(got[4], np.array([np.max(pmax), np.max(qmax)], np.float32))


@pytest.mark.parametrize("store,order,shape", [
    ("f32", 2, SHAPE), ("int8", 2, ASHAPE), ("f32", 8, SHAPE)])
def test_adjoint_plain_matches_pallas(store, order, shape):
    f = _inputs(shape, 5)
    D, H, W = shape
    codes, sc = _codes(f, store)
    cj = [jnp.asarray(c.float().numpy()).astype(
        {"f32": jnp.float32, "bf16": jnp.bfloat16, "int8": jnp.int8}[store]) for c in codes]
    ref = pw.fused_vti_adjoint_step(
        *_J(f, "ap1", "aq1", "ap2", "aq2", "gC", "gah", "gav", "C", "av", "ah"), *cj,
        jnp.float32(sc[0]), jnp.float32(sc[1]), jnp.float32(INV), jnp.asarray(f["sz"]),
        jnp.asarray(f["sy"]).reshape(H, 1), jnp.asarray(f["sx"]).reshape(1, W),
        order=order, interpret=True)
    got = cv.fused_vti_adjoint_step_torch(*_adjoint_t(f, codes, sc), order=order)
    for g, r in zip(got, ref):
        _close(g, r)


def test_source_lands_on_one_cell_of_each_field():
    f = _inputs(SHAPE, 6)
    args = _step_args(f, SHAPE)
    src = _src(SHAPE)
    a = cv.fused_vti_step(*args, -0.37, src, 0.125)
    b = cv.fused_vti_step(*args, -0.37, src, 0.0)
    for x, y in zip(a, b):
        d = (x - y).reshape(-1)
        np.testing.assert_allclose(float(d[src]), -0.37 * 0.125, rtol=1e-6)
        d[src] = 0.0
        assert not bool(d.any()), "the source must touch exactly one cell"


def test_wrappers_take_plain_versions_on_cpu_in_place():
    f = _inputs(ASHAPE, 7)
    cv.reset_launch_counts()
    pp, p, qp, q, C, ah, av, sz, sy, sx, inv = _step_args(f, ASHAPE)
    kw = dict(s_t=torch.tensor(0.5), src_idx=_src(ASHAPE), amp=torch.tensor(1e-3), order=4)
    ref = cv.fused_vti_step_torch(pp, p, qp, q, C, ah, av, sz, sy, sx, inv, **kw)
    got = cv.fused_vti_step(pp, p, qp, q, C, ah, av, sz, sy, sx, inv, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    o = (pp.clone(), qp.clone())
    got = cv.fused_vti_step(o[0], p, o[1], q, C, ah, av, sz, sy, sx, inv, out=o, **kw)
    assert got[0] is o[0] and got[1] is o[1]
    assert all(torch.equal(a, b) for a, b in zip(o, ref))

    qf = torch.from_numpy(_qf(f)[0])
    ref = cv.fused_vti_hist_step_torch(pp, p, qp, q, C, ah, av, sz, sy, sx, inv,
                                       qfp=qf[0], qfq=qf[1], **kw)
    o = (pp.clone(), qp.clone())
    got = cv.fused_vti_hist_step(o[0], p, o[1], q, C, ah, av, sz, sy, sx, inv, qfp=qf[0],
                                 qfq=qf[1], out=o, **kw)
    assert got[0] is o[0] and got[1] is o[1]
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    for store in ("f32", "bf16"):  # the codes are buffers of their own
        _, _, pe, qe, _ = cv.fused_vti_hist_step(pp, p, qp, q, C, ah, av, sz, sy, sx, inv,
                                                 qfp=1.0, qfq=1.0, store=store, **kw)
        assert pe.data_ptr() != p.data_ptr() and torch.equal(pe.float(), p.to(pe.dtype).float())

    codes, sc = _codes(f, "int8")
    args = _adjoint_t(f, codes, sc, order=4)
    ref = cv.fused_vti_adjoint_step_torch(*args, order=4)
    assert all(torch.equal(a, b) for a, b in zip(cv.fused_vti_adjoint_step(*args, order=4),
                                                 ref))
    got = cv.fused_vti_adjoint_step(*args, order=4, inplace=True)
    assert all(a is b for a, b in zip(got, args[2:7]))
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    assert cv.launch_counts() == ZERO


def test_wrappers_reject_what_the_kernels_do_not_take():
    u = torch.zeros((4, 8, 32))
    f = [torch.ones(n) for n in u.shape]
    pp, p, qp, q, C, ah, av = (torch.zeros_like(u) for _ in range(7))
    rest = (*f, 0.01, 1.0, 0, 1.0)
    cv.reset_launch_counts()
    with pytest.raises(TypeError, match="float32"):
        cv.fused_vti_step(pp.double(), p, qp, q, C, ah, av, *rest)
    with pytest.raises(ValueError, match="contiguous"):
        cv.fused_vti_step(pp, p, qp, q.transpose(0, 2).contiguous().transpose(0, 2), C,
                          ah, av, *rest)
    with pytest.raises(ValueError, match="D, H, W"):
        cv.fused_vti_step(pp[0], p[0], qp[0], q[0], C[0], ah[0], av[0], *rest)
    with pytest.raises(ValueError, match="order"):
        cv.fused_vti_step(pp, p, qp, q, C, ah, av, *rest, order=6)
    with pytest.raises(ValueError, match="sx must have shape"):
        cv.fused_vti_step(pp, p, qp, q, C, ah, av, f[0], f[1], f[1], 0.01, 1.0, 0, 1.0)
    with pytest.raises(ValueError, match="distinct"):
        cv.fused_vti_step(p, p, qp, q, C, ah, av, *rest)
    with pytest.raises(ValueError, match="distinct"):
        cv.fused_vti_step(pp, p, qp, p, C, ah, av, *rest)
    with pytest.raises(ValueError, match="out must be"):
        cv.fused_vti_step(pp, p, qp, q, C, ah, av, *rest, out=(qp, pp))
    with pytest.raises(ValueError, match="scalar"):
        cv.fused_vti_step(pp, p, qp, q, C, ah, av, *f, torch.ones(2), 1.0, 0, 1.0)
    with pytest.raises(ValueError, match="store"):
        cv.fused_vti_hist_step(pp, p, qp, q, C, ah, av, *rest, 1.0, 1.0, store="int4")
    a = [torch.zeros_like(u) for _ in range(7)]
    hist = (u.to(torch.int8), u.to(torch.int8))
    tail = (1.0, 1.0, 0.01, *f)
    with pytest.raises(TypeError, match="history"):
        cv.fused_vti_adjoint_step(*a, C, av, ah, u.half(), u.half(), *tail)
    with pytest.raises(TypeError, match="two types"):
        cv.fused_vti_adjoint_step(*a, C, av, ah, hist[0], u.to(torch.bfloat16), *tail)
    with pytest.raises(ValueError, match="history"):
        cv.fused_vti_adjoint_step(*a, C, av, ah, hist[0][:2].clone(), hist[1], *tail)
    with pytest.raises(ValueError, match="distinct"):
        cv.fused_vti_adjoint_step(a[0], a[1], a[0], *a[3:], C, av, ah, *hist, *tail)
    assert cv.launch_counts() == ZERO
