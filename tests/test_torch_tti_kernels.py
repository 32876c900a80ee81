"""The port's TTI kernels (jets_tpu_torch/ops/cuda_tti.py) held against the
JAX package on the same numpy inputs: their plain versions bitwise against
the eager JAX trees of ``ops/wave.py``'s XLA TTI steps at order 2, and
against the Pallas kernels of ``ops/pallas_wave.py`` in interpret mode.

The CUDA kernels K11 (``fused_tti_step``), K12 (``fused_tti_hist_step``) and
K13 (``fused_tti_adjoint_step``) run only on a card, where ``chip_smoke.py``
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
from jets_tpu.ops.wave import _d1_axis, _d2_axis, _iota_src_mask
from jets_tpu_torch.ops import cuda_tti as ct

SHAPE = (16, 8, 128)
ASHAPE = (16, 32, 128)  # int8 histories tile at (32, 128) on the TPU
RAGGED = (5, 11, 37)  # no edge a multiple of the card kernels' tiles or z-chunks
INV2 = np.float32(0.01)  # 1/dx² at dx = 10
INV1 = np.float32(0.1)  # 1/dx
ZERO = {k: 0 for k in ("fused_tti_step", "fused_tti_hist_step",
                       "fused_tti_adjoint_step")}
COEFFS = ("ah", "av", "nz", "ny", "nx")
ACCS = ("gC", "gah", "gav", "gnz", "gny", "gnx")


def _inputs(shape, seed, coeff="f32"):
    """Fields, physical coefficients, the symmetry axis from tilt and azimuth
    angles, and sponge factors as numpy f32 (the five coefficient fields
    rounded to bf16 values with ``coeff="bf16"``)."""
    rng = np.random.default_rng(seed)
    f = {k: rng.standard_normal(shape).astype(np.float32)
         for k in ("pp", "p", "qp", "q", "ap1", "aq1", "ap2", "aq2") + ACCS}
    c = rng.uniform(1400.0, 4500.0, shape).astype(np.float32)
    f["C"] = (c * c) * np.float32(5e-4 * 5e-4)
    f["ah"] = np.float32(1.0) + np.float32(2.0) * rng.uniform(0, 0.3, shape).astype(np.float32)
    f["av"] = np.sqrt(np.float32(1.0) + np.float32(2.0)
                      * rng.uniform(-0.1, 0.2, shape).astype(np.float32))
    th = rng.uniform(-0.6, 0.6, shape)
    ph = rng.uniform(-3.0, 3.0, shape)
    f["nz"] = np.cos(th).astype(np.float32)
    st = np.sin(th).astype(np.float32)
    f["ny"] = st * np.cos(ph).astype(np.float32)
    f["nx"] = st * np.sin(ph).astype(np.float32)
    if coeff == "bf16":
        for k in COEFFS:
            f[k] = np.array(jnp.asarray(f[k]).astype(jnp.bfloat16).astype(jnp.float32))
    D, H, W = shape
    f["sz"] = np.linspace(0.9, 1.0, D, dtype=np.float32)
    f["sy"] = np.linspace(0.8, 1.0, H, dtype=np.float32)
    f["sx"] = np.linspace(0.7, 1.0, W, dtype=np.float32)
    return f


def _src(shape):
    D, H, W = shape
    return min(5, D - 1) * H * W + 3 * W + 17


def _T(f, *keys):
    return [torch.from_numpy(np.ascontiguousarray(f[k])) for k in keys]


def _J(f, *keys):
    return [jnp.asarray(f[k]) for k in keys]


def _coeffs_t(f, coeff):
    """The five coefficient fields as the kernels take them."""
    dt = torch.bfloat16 if coeff == "bf16" else torch.float32
    return [t.to(dt) for t in _T(f, *COEFFS)]


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


def _derivs_j(u):
    """The JAX package's ``derivs`` (ops/wave._adjoint_stored_tti3d), eager."""
    i2, i1 = jnp.float32(INV2), jnp.float32(INV1)

    def dij(v, i, j):
        return _d1_axis(_d1_axis(v, i, i1, 2), j, i1, 2)

    return (_d2_axis(u, 0, i2, 2), _d2_axis(u, 1, i2, 2), _d2_axis(u, 2, i2, 2),
            dij(u, 0, 1), dij(u, 0, 2), dij(u, 1, 2))


def _dirs_j(f):
    nz, ny, nx = _J(f, "nz", "ny", "nx")
    return (nz * nz, ny * ny, nx * nx, 2.0 * nz * ny, 2.0 * nz * nx, 2.0 * ny * nx)


def _h_j(d6, cf):
    czz, cyy, cxx, czy, czx, cyx = cf
    uzz, uyy, uxx, uzy, uzx, uyx = d6
    return ((1.0 - czz) * uzz + (1.0 - cyy) * uyy + (1.0 - cxx) * uxx
            - czy * uzy - czx * uzx - cyx * uyx)


def _v_j(d6, cf):
    czz, cyy, cxx, czy, czx, cyx = cf
    uzz, uyy, uxx, uzy, uzx, uyx = d6
    return czz * uzz + cyy * uyy + cxx * uxx + czy * uzy + czx * uzx + cyx * uyx


def _step_j(f, s_t, amp, shape):
    """Eager (op-by-op) JAX tree of ops/wave._propagate_tti3d's XLA step."""
    pp, p, qp, q, C, ah, av = _J(f, "pp", "p", "qp", "q", "C", "ah", "av")
    cf = _dirs_j(f)
    Hp, Vq = _h_j(_derivs_j(p), cf), _v_j(_derivs_j(q), cf)
    S = _sponge_j(f)
    mask = _iota_src_mask(shape, _src(shape), jnp.float32(amp))
    pn = (2.0 * p - pp + C * (ah * Hp + av * Vq)) * S + jnp.float32(s_t) * mask
    qn = (2.0 * q - qp + C * (av * Hp + Vq)) * S + jnp.float32(s_t) * mask
    return pn, qn


def _qf(f):
    """int8 quantization factors ``127/max|·|`` of p and q, as f32 divisions."""
    s = np.array([np.max(np.abs(f["p"])), np.max(np.abs(f["q"]))], np.float32)
    return np.float32(127.0) / s, s


def _step_args(f, coeff="f32"):
    pp, p, qp, q, C, sz, sy, sx = _T(f, "pp", "p", "qp", "q", "C", "sz", "sy", "sx")
    return (pp, p, qp, q, C, *_coeffs_t(f, coeff), sz, sy, sx, torch.tensor(INV2),
            torch.tensor(INV1))


def _pallas_step_args(f, shape):
    D, H, W = shape
    return (*_J(f, "pp", "p", "qp", "q", "C", *COEFFS, "sz"),
            jnp.asarray(f["sy"]).reshape(H, 1), jnp.asarray(f["sx"]).reshape(1, W),
            jnp.float32(INV2), jnp.float32(INV1))


@pytest.mark.parametrize("coeff", ["f32", "bf16"])
def test_step_plain_is_bitwise_the_eager_jax_tree(coeff):
    f = _inputs(SHAPE, 0, coeff)
    s_t, amp = -0.37, 2.5e-3
    pn_j, qn_j = _step_j(f, s_t, amp, SHAPE)
    pn, qn = ct.fused_tti_step_torch(*_step_args(f, coeff), torch.tensor(s_t),
                                     _src(SHAPE), torch.tensor(amp), order=2)
    _equal(pn, pn_j)
    _equal(qn, qn_j)


@pytest.mark.parametrize("store,coeff,shape", [
    ("f32", "f32", ASHAPE), ("bf16", "f32", ASHAPE), ("int8", "f32", ASHAPE),
    ("int8", "bf16", ASHAPE), ("int8", "bf16", RAGGED)], ids=[
    "f32-f32", "bf16-f32", "int8-f32", "int8-bf16", "int8-bf16-ragged"])
def test_hist_step_plain_is_bitwise_the_eager_jax_tree(store, coeff, shape):
    f = _inputs(shape, 1, coeff)
    s_t, amp = 0.61, 2.5e-3
    qf = _qf(f)[0] if store == "int8" else np.ones(2, np.float32)
    pn_j, qn_j = _step_j(f, s_t, amp, shape)
    p_j, q_j = _J(f, "p", "q")
    if store == "int8":
        codes_j = [jnp.round(u * jnp.float32(s)).astype(jnp.int8)
                   for u, s in ((p_j, qf[0]), (q_j, qf[1]))]
    elif store == "bf16":
        codes_j = [u.astype(jnp.bfloat16) for u in (p_j, q_j)]
    else:
        codes_j = [p_j, q_j]
    scales_j = [jnp.maximum(jnp.max(jnp.abs(u)), jnp.float32(1e-30)) for u in (pn_j, qn_j)]
    pn, qn, pe, qe, scales = ct.fused_tti_hist_step_torch(
        *_step_args(f, coeff), torch.tensor(s_t), _src(shape), torch.tensor(amp),
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
        codes = [torch.round(u * torch.tensor(k)).to(torch.int8)
                 for u, k in ((p, qf[0]), (q, qf[1]))]
        return codes, s / np.float32(127.0)
    if store == "bf16":
        return [p.to(torch.bfloat16), q.to(torch.bfloat16)], np.ones(2, np.float32)
    return [p, q], np.ones(2, np.float32)


def _adjoint_t(f, codes, sc, coeff="f32"):
    t = _T(f, "ap1", "aq1", "ap2", "aq2", *ACCS, "C")
    sz, sy, sx = _T(f, "sz", "sy", "sx")
    return (*t, *_coeffs_t(f, coeff), codes[0], codes[1], torch.tensor(sc[0]),
            torch.tensor(sc[1]), torch.tensor(INV2), torch.tensor(INV1), sz, sy, sx)


@pytest.mark.parametrize("store,coeff,shape", [
    ("f32", "f32", ASHAPE), ("bf16", "f32", ASHAPE), ("int8", "f32", ASHAPE),
    ("int8", "bf16", ASHAPE), ("int8", "bf16", RAGGED)], ids=[
    "f32-f32", "bf16-f32", "int8-f32", "int8-bf16", "int8-bf16-ragged"])
def test_adjoint_plain_is_bitwise_the_eager_jax_tree(store, coeff, shape):
    f = _inputs(shape, 2, coeff)
    codes, sc = _codes(f, store)
    ap1, aq1, ap2, aq2, gC, gah, gav, gnz, gny, gnx, C, ah, av, nz, ny, nx = _J(
        f, "ap1", "aq1", "ap2", "aq2", *ACCS, "C", *COEFFS)
    # the XLA dec: q.astype(f32)·(s/127) for int8, the cast alone otherwise
    dec = [jnp.asarray(c.float().numpy()) for c in codes]
    if store == "int8":
        dec = [d * jnp.float32(s) for d, s in zip(dec, sc)]
    S = _sponge_j(f)
    ebp, ebq = ap1 * S, aq1 * S
    cf = _dirs_j(f)
    dp6, dq6 = _derivs_j(dec[0]), _derivs_j(dec[1])
    Hp, Vq = _h_j(dp6, cf), _v_j(dq6, cf)
    dz = [C * ((av * q_d - ah * p_d) * ebp + (q_d - av * p_d) * ebq)
          for p_d, q_d in zip(dp6, dq6)]
    czz, cyy, cxx, czy, czx, cyx = cf
    i2, i1 = jnp.float32(INV2), jnp.float32(INV1)

    def dij(v, i, j):
        return _d1_axis(_d1_axis(v, i, i1, 2), j, i1, 2)

    def HT(w):
        return (_d2_axis((1.0 - czz) * w, 0, i2, 2) + _d2_axis((1.0 - cyy) * w, 1, i2, 2)
                + _d2_axis((1.0 - cxx) * w, 2, i2, 2) - dij(czy * w, 0, 1)
                - dij(czx * w, 0, 2) - dij(cyx * w, 1, 2))

    def VT(w):
        return (_d2_axis(czz * w, 0, i2, 2) + _d2_axis(cyy * w, 1, i2, 2)
                + _d2_axis(cxx * w, 2, i2, 2) + dij(czy * w, 0, 1)
                + dij(czx * w, 0, 2) + dij(cyx * w, 1, 2))

    ref = (
        (2.0 * ebp + HT(C * ah * ebp + C * av * ebq)) - ap2 * S,
        (2.0 * ebq + VT(C * av * ebp + C * ebq)) - aq2 * S,
        gC + ((ah * Hp + av * Vq) * ebp + (av * Hp + Vq) * ebq),
        gah + (C * Hp) * ebp,
        gav + C * (Vq * ebp + Hp * ebq),
        gnz + (2.0 * nz * dz[0] + 2.0 * ny * dz[3] + 2.0 * nx * dz[4]),
        gny + (2.0 * ny * dz[1] + 2.0 * nz * dz[3] + 2.0 * nx * dz[5]),
        gnx + (2.0 * nx * dz[2] + 2.0 * nz * dz[4] + 2.0 * ny * dz[5]),
    )
    got = ct.fused_tti_adjoint_step_torch(*_adjoint_t(f, codes, sc, coeff), order=2)
    for g, r in zip(got, ref):
        _equal(g, r)


@pytest.mark.parametrize("order,coeff", [(2, "f32"), (8, "f32"), (2, "bf16")])
def test_step_plain_matches_pallas(order, coeff):
    f = _inputs(SHAPE, 3, coeff)
    s_t, amp = 0.3, 0.125
    args = list(_pallas_step_args(f, SHAPE))
    if coeff == "bf16":  # the kernel streams the coefficients at half width
        args[5:10] = [a.astype(jnp.bfloat16) for a in args[5:10]]
    ref = pw.fused_tti_step(*args, jnp.float32(s_t), _src(SHAPE), jnp.float32(amp),
                            order=order, interpret=True)
    got = ct.fused_tti_step_torch(*_step_args(f, coeff), torch.tensor(s_t), _src(SHAPE),
                                  torch.tensor(amp), order=order)
    for g, r in zip(got, ref):
        _close(g, r)


@pytest.mark.parametrize("store", ["f32", "bf16", "int8"])
def test_hist_step_plain_matches_pallas(store):
    f = _inputs(ASHAPE, 4)
    s_t, amp = -0.45, 0.125
    qf = _qf(f)[0] if store == "int8" else np.ones(2, np.float32)
    pn, qn, pe, qe, pmax, qmax = pw.fused_tti_hist_step(
        *_pallas_step_args(f, ASHAPE), jnp.float32(s_t), _src(ASHAPE), jnp.float32(amp),
        jnp.float32(qf[0]), jnp.float32(qf[1]), store=store, order=2, interpret=True)
    got = ct.fused_tti_hist_step_torch(*_step_args(f), torch.tensor(s_t), _src(ASHAPE),
                                       torch.tensor(amp), torch.tensor(qf[0]),
                                       torch.tensor(qf[1]), store=store, order=2)
    _close(got[0], pn)
    _close(got[1], qn)
    _equal(got[2].float(), np.asarray(pe.astype(jnp.float32)))
    _equal(got[3].float(), np.asarray(qe.astype(jnp.float32)))
    _close(got[4], np.array([np.max(pmax), np.max(qmax)], np.float32))


@pytest.mark.parametrize("store", ["f32", "int8"])
def test_adjoint_plain_matches_pallas(store):
    f = _inputs(ASHAPE, 5)
    D, H, W = ASHAPE
    codes, sc = _codes(f, store)
    cj = [jnp.asarray(c.float().numpy()).astype(
        {"f32": jnp.float32, "int8": jnp.int8}[store]) for c in codes]
    ref = pw.fused_tti_adjoint_step(
        *_J(f, "ap1", "aq1", "ap2", "aq2", *ACCS, "C", *COEFFS), *cj,
        jnp.float32(sc[0]), jnp.float32(sc[1]), jnp.float32(INV2), jnp.float32(INV1),
        jnp.asarray(f["sz"]), jnp.asarray(f["sy"]).reshape(H, 1),
        jnp.asarray(f["sx"]).reshape(1, W), order=2, interpret=True)
    got = ct.fused_tti_adjoint_step_torch(*_adjoint_t(f, codes, sc), order=2)
    for g, r in zip(got, ref):
        _close(g, r)


def test_source_lands_on_one_cell_of_each_field():
    f = _inputs(SHAPE, 6)
    args = _step_args(f)
    src = _src(SHAPE)
    a = ct.fused_tti_step(*args, -0.37, src, 0.125)
    b = ct.fused_tti_step(*args, -0.37, src, 0.0)
    for x, y in zip(a, b):
        d = (x - y).reshape(-1)
        np.testing.assert_allclose(float(d[src]), -0.37 * 0.125, rtol=1e-6)
        d[src] = 0.0
        assert not bool(d.any()), "the source must touch exactly one cell"


def test_wrappers_take_plain_versions_on_cpu_in_place():
    f = _inputs(ASHAPE, 7)
    ct.reset_launch_counts()
    pp, p, qp, q, C, *co, sz, sy, sx, i2, i1 = _step_args(f, "bf16")
    kw = dict(s_t=torch.tensor(0.5), src_idx=_src(ASHAPE), amp=torch.tensor(1e-3), order=4)
    ref = ct.fused_tti_step_torch(pp, p, qp, q, C, *co, sz, sy, sx, i2, i1, **kw)
    got = ct.fused_tti_step(pp, p, qp, q, C, *co, sz, sy, sx, i2, i1, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    o = (pp.clone(), qp.clone())
    got = ct.fused_tti_step(o[0], p, o[1], q, C, *co, sz, sy, sx, i2, i1, out=o, **kw)
    assert got[0] is o[0] and got[1] is o[1]
    assert all(torch.equal(a, b) for a, b in zip(o, ref))

    qf = torch.from_numpy(_qf(f)[0])
    ref = ct.fused_tti_hist_step_torch(pp, p, qp, q, C, *co, sz, sy, sx, i2, i1,
                                       qfp=qf[0], qfq=qf[1], **kw)
    o = (pp.clone(), qp.clone())
    got = ct.fused_tti_hist_step(o[0], p, o[1], q, C, *co, sz, sy, sx, i2, i1, qfp=qf[0],
                                 qfq=qf[1], out=o, **kw)
    assert got[0] is o[0] and got[1] is o[1]
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    for store in ("f32", "bf16"):  # the codes are buffers of their own
        _, _, pe, _, _ = ct.fused_tti_hist_step(pp, p, qp, q, C, *co, sz, sy, sx, i2, i1,
                                                qfp=1.0, qfq=1.0, store=store, **kw)
        assert pe.data_ptr() != p.data_ptr() and torch.equal(pe.float(),
                                                             p.to(pe.dtype).float())

    codes, sc = _codes(f, "int8")
    args = _adjoint_t(f, codes, sc, "bf16")
    ref = ct.fused_tti_adjoint_step_torch(*args, order=4)
    assert all(torch.equal(a, b)
               for a, b in zip(ct.fused_tti_adjoint_step(*args, order=4), ref))
    got = ct.fused_tti_adjoint_step(*args, order=4, inplace=True)
    assert all(a is b for a, b in zip(got, args[2:10]))
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    assert ct.launch_counts() == ZERO


def test_wrappers_reject_what_the_kernels_do_not_take():
    u = torch.zeros((4, 8, 32))
    f = [torch.ones(n) for n in u.shape]
    pp, p, qp, q, C, ah, av, nz, ny, nx = (torch.zeros_like(u) for _ in range(10))
    co = (ah, av, nz, ny, nx)
    rest = (*f, 0.01, 0.1, 1.0, 0, 1.0)
    ct.reset_launch_counts()
    with pytest.raises(TypeError, match="float32"):
        ct.fused_tti_step(pp.double(), p, qp, q, C, *co, *rest)
    with pytest.raises(TypeError, match="coefficients must be"):
        ct.fused_tti_step(pp, p, qp, q, C, *(t.half() for t in co), *rest)
    with pytest.raises(TypeError, match="two types"):
        ct.fused_tti_step(pp, p, qp, q, C, ah, av.to(torch.bfloat16), nz, ny, nx, *rest)
    with pytest.raises(ValueError, match="coefficient"):
        ct.fused_tti_step(pp, p, qp, q, C, ah, av, nz, ny, nx[:2].clone(), *rest)
    with pytest.raises(ValueError, match="contiguous"):
        ct.fused_tti_step(pp, p, qp, q.transpose(0, 2).contiguous().transpose(0, 2), C,
                          *co, *rest)
    with pytest.raises(ValueError, match="D, H, W"):
        ct.fused_tti_step(pp[0], p[0], qp[0], q[0], C[0], *(t[0] for t in co), *rest)
    with pytest.raises(ValueError, match="order"):
        ct.fused_tti_step(pp, p, qp, q, C, *co, *rest, order=6)
    with pytest.raises(ValueError, match="sx must have shape"):
        ct.fused_tti_step(pp, p, qp, q, C, *co, f[0], f[1], f[1], 0.01, 0.1, 1.0, 0, 1.0)
    with pytest.raises(ValueError, match="distinct"):
        ct.fused_tti_step(p, p, qp, q, C, *co, *rest)
    with pytest.raises(ValueError, match="distinct"):
        ct.fused_tti_step(pp, p, qp, p, C, *co, *rest)
    with pytest.raises(ValueError, match="distinct"):
        ct.fused_tti_step(nz, p, qp, q, C, *co, *rest)
    with pytest.raises(ValueError, match="out must be"):
        ct.fused_tti_step(pp, p, qp, q, C, *co, *rest, out=(qp, pp))
    with pytest.raises(ValueError, match="scalar"):
        ct.fused_tti_step(pp, p, qp, q, C, *co, *f, 0.01, torch.ones(2), 1.0, 0, 1.0)
    with pytest.raises(ValueError, match="store"):
        ct.fused_tti_hist_step(pp, p, qp, q, C, *co, *rest, 1.0, 1.0, store="int4")
    a = [torch.zeros_like(u) for _ in range(10)]
    hist = (u.to(torch.int8), u.to(torch.int8))
    tail = (1.0, 1.0, 0.01, 0.1, *f)
    with pytest.raises(TypeError, match="history"):
        ct.fused_tti_adjoint_step(*a, C, *co, u.half(), u.half(), *tail)
    with pytest.raises(TypeError, match="two types"):
        ct.fused_tti_adjoint_step(*a, C, *co, hist[0], u.to(torch.bfloat16), *tail)
    with pytest.raises(ValueError, match="history"):
        ct.fused_tti_adjoint_step(*a, C, *co, hist[0][:2].clone(), hist[1], *tail)
    with pytest.raises(ValueError, match="distinct"):
        ct.fused_tti_adjoint_step(a[0], a[1], a[0], *a[3:], C, *co, *hist, *tail)
    with pytest.raises(TypeError, match="coefficients must be"):
        ct.fused_tti_adjoint_step(*a, C, *(t.double() for t in co), *hist, *tail)
    assert ct.launch_counts() == ZERO
