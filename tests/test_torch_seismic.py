"""The seismic flagship operator of the port held against jets_tpu's, on
the same operator: the per-shot weights ``wr`` (and, for an irregular
geometry, the receiver indices) are lifted from the built JAX operator.

Tolerances: the forward of the regular-geometry paths has the same add
tree in both packages and is compared bitwise against the eager JAX
operator; sums over shots or stencil stamps may be ordered differently,
so adjoints and the stamp forward use ``rtol=1e-6, atol=1e-5·max|ref|``
(float32) or ``rtol=1e-12`` (float64).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jets_tpu_torch as tt
from jets_tpu.models.seismic import make_seismic_operator as jax_make_seismic_operator
from jets_tpu.models.seismic import _receiver_grid as jax_receiver_grid
from jets_tpu_torch.models import seismic as ts
from jets_tpu_torch.models.seismic import seismic_operator_from_arrays
from jets_tpu_torch.parallel.sharded import make_block_mesh, stacked_block_operator

CPU = torch.device("cpu")  # the tests build on the CPU, as a caller asks


def lift(A_jax):
    """``(wr, rcv)`` of a jets_tpu seismic operator as numpy arrays (rcv is
    None where the geometry is a regular subgrid)."""
    S = A_jax.jet.state["ops"][0] if "ops" in A_jax.jet.state else A_jax
    st = S.jet.state
    wr = np.asarray(st["bstate"]["wr"])
    if "rcv" in st["sstate"]:
        return wr, np.asarray(st["sstate"]["rcv"])
    if "sidx" in st["sstate"]:
        return wr, np.asarray(st["sstate"]["sidx"])[0]  # stamp row 0 = receivers
    return wr, None


def _pair(shape, nshots, nrecv, impl, dtype=np.float32):
    A_j = jax_make_seismic_operator(shape, nshots, nrecv, jax.random.PRNGKey(3),
                                    impl=impl, dtype=dtype)
    wr, rcv = lift(A_j)
    tdtype = torch.float32 if dtype == np.float32 else torch.float64
    A_t = seismic_operator_from_arrays(shape, nshots, nrecv, wr=wr, rcv=rcv,
                                       impl=impl, dtype=tdtype, device=CPU)
    return A_j, A_t


def _close(got, ref, dtype):
    ref = np.asarray(ref)
    if dtype == np.float64:
        np.testing.assert_allclose(np.asarray(got), ref, rtol=1e-12,
                                   atol=1e-12 * float(np.max(np.abs(ref))))
    else:
        np.testing.assert_allclose(np.asarray(got), ref, rtol=1e-6,
                                   atol=1e-5 * float(np.max(np.abs(ref))))


CASES = [
    # (grid, receivers, impl, regular subgrid?)
    ((16, 16, 128), 64, "fused", True),
    ((16, 16, 128), 64, "composed", True),
    ((64, 64), 64, "fused", True),
    ((64, 64), 64, "composed", True),
    ((16, 16, 128), 127, "fused", False),   # 127 > 126: no subgrid fits
    ((16, 16, 128), 127, "composed", False),
    ((64, 64), 67, "fused", False),
]


@pytest.mark.parametrize("shape,nrecv,impl,regular", CASES)
def test_seismic_operator_matches_jax(shape, nrecv, impl, regular):
    assert (jax_receiver_grid(shape, nrecv) is not None) == regular
    assert (ts._receiver_grid(shape, nrecv) is not None) == regular
    A_j, A_t = _pair(shape, 4, nrecv, impl)
    rng = np.random.default_rng(0)
    m = rng.standard_normal(shape).astype(np.float32)
    d = rng.standard_normal((4, nrecv)).astype(np.float32)
    fwd_t = A_t(torch.from_numpy(m)).numpy()
    fwd_j = np.asarray(A_j(jnp.asarray(m)))
    if regular:
        np.testing.assert_array_equal(fwd_t, fwd_j)
    else:
        _close(fwd_t, fwd_j, np.float32)
    _close(A_t.H(torch.from_numpy(d)).numpy(), np.asarray(A_j.H(jnp.asarray(d))),
           np.float32)
    g = torch.Generator().manual_seed(1)
    lhs, rhs = tt.dot_product_test(A_t, A_t.dom.randn(g), A_t.rng.randn(g))
    np.testing.assert_allclose(float(lhs), float(rhs), rtol=1e-4)


@pytest.mark.parametrize("shape,nrecv", [((16, 16, 128), 64), ((64, 64), 67)])
def test_seismic_operator_matches_jax_f64(shape, nrecv):
    A_j, A_t = _pair(shape, 4, nrecv, "fused", np.float64)
    rng = np.random.default_rng(1)
    m = rng.standard_normal(shape)
    d = rng.standard_normal((4, nrecv))
    _close(A_t(torch.from_numpy(m)).numpy(), A_j(jnp.asarray(m)), np.float64)
    _close(A_t.H(torch.from_numpy(d)).numpy(), A_j.H(jnp.asarray(d)), np.float64)
    g = torch.Generator().manual_seed(2)
    lhs, rhs = tt.dot_product_test(A_t, A_t.dom.randn(g), A_t.rng.randn(g))
    np.testing.assert_allclose(float(lhs), float(rhs), rtol=1e-12)


def test_fused_equals_composed_and_hook_matches_generic_adjoint():
    shape, nrecv = (16, 16, 128), 64
    A_j, A_f = _pair(shape, 4, nrecv, "fused")
    wr, _ = lift(A_j)
    A_c = seismic_operator_from_arrays(shape, 4, nrecv, wr=wr, impl="composed", device=CPU)
    A_h = seismic_operator_from_arrays(shape, 4, nrecv, wr=wr, epilogue_hook=True, device=CPU)
    rng = np.random.default_rng(2)
    m = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    dd = torch.from_numpy(rng.standard_normal((4, nrecv)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    assert torch.equal(A_f(m), A_c(m))
    np.testing.assert_allclose(A_f.H(dd).numpy(), A_c.H(dd).numpy(), rtol=1e-6,
                               atol=1e-6)
    hook = A_h.jet.state["adjoint_axpy_norm"]
    s = torch.tensor(-0.3)
    vh, nrm = hook(dd, v, s, A_h.jet.state)
    ref = s * v + A_f.H(dd)
    assert torch.equal(vh, ref)
    np.testing.assert_allclose(float(nrm), float(A_f.dom.norm(ref)), rtol=1e-6)
    # the hook is 3-D only, and opt-in
    assert "adjoint_axpy_norm" not in A_f.jet.state
    A2 = seismic_operator_from_arrays((64, 64), 4, 64, wr=np.ones((4, 64)),
                                      epilogue_hook=True, device=CPU)
    assert "adjoint_axpy_norm" not in A2.jet.state


def test_make_seismic_problem_is_seeded_and_validates():
    A, m, d = ts.make_seismic_problem((16, 16, 128), 4, 64, seed=5, noise=0.1, device=CPU)
    A2, m2, d2 = ts.make_seismic_problem((16, 16, 128), 4, 64, seed=5, noise=0.1, device=CPU)
    assert torch.equal(m, m2) and torch.equal(d, d2)
    assert d.shape == (4, 64) and m.shape == (16, 16, 128)
    assert int((m > 0.5).sum()) == (16 * 16 * 128) // 200  # the spikes
    A3, _, _ = ts.make_seismic_problem((64, 64), 3, 67, seed=0, impl="composed", device=CPU)
    assert A3.rng.shape == (3, 67)
    # explicit arrays are taken as given
    wr = np.random.default_rng(3).random((4, 67))
    rcv = np.arange(67) * 61
    A4 = ts.make_seismic_operator((64, 64), 4, 67, wr=wr, rcv=rcv, device=CPU)
    A5 = seismic_operator_from_arrays((64, 64), 4, 67, wr=wr, rcv=rcv, device=CPU)
    x = torch.from_numpy(np.random.default_rng(4).standard_normal((64, 64))
                         .astype(np.float32))
    assert torch.equal(A4(x), A5(x))
    with pytest.raises(ValueError, match="impl"):
        seismic_operator_from_arrays((64, 64), 4, 64, wr=np.ones((4, 64)),
                                     impl="bogus", device=CPU)
    with pytest.raises(ValueError, match="wr has shape"):
        seismic_operator_from_arrays((64, 64), 4, 64, wr=np.ones((3, 64)), device=CPU)
    with pytest.raises(ValueError, match="rcv"):
        seismic_operator_from_arrays((64, 64), 4, 67, wr=np.ones((4, 67)), device=CPU)
    # mesh= on a world of one: the same operator and problem, bitwise
    mesh = make_block_mesh(device=CPU)
    A6 = ts.make_seismic_operator((64, 64), 4, 67, wr=wr, rcv=rcv, mesh=mesh)
    assert A6.dom.device == CPU and A6.rng.shape == (4, 67)
    assert torch.equal(A6(x), A4(x)) and torch.equal(A6.H(A4(x)), A4.H(A4(x)))
    A7, m7, d7 = ts.make_seismic_problem((16, 16, 128), 4, 64, seed=5, noise=0.1, mesh=mesh)
    assert torch.equal(m7, m) and torch.equal(d7, d)
    assert "adjoint_axpy_norm" not in ts.make_seismic_operator(
        (16, 16, 128), 4, 64, mesh=mesh, epilogue_hook=True).jet.state


def _block_op(shot_map, derived, mesh=None):
    """A stacked operator whose child kernels are batched over shots:
    d[b] = w[b] * (M m) with M shared."""
    rng = np.random.default_rng(4)
    M = torch.from_numpy(rng.standard_normal((5, 7)))
    w = torch.from_numpy(rng.standard_normal((3, 5)))

    def df(dm, m0, s):
        return s["w"] * (s["M"] @ dm)[None, :]

    def dft(dd, m0, s):
        return (s["w"] * dd) @ s["M"]  # (blocks, 7): per-block contributions

    return stacked_block_operator(
        nblocks=3, dom=tt.Space((7,), torch.float64, device=CPU),
        rng_block=tt.Space((5,), torch.float64, device=CPU), bstate={"w": w},
        sstate={"M": M}, df=df, dft=None if derived else dft, shot_map=shot_map, mesh=mesh)


@pytest.mark.parametrize("shot_map", ["vmap", "map"])
@pytest.mark.parametrize("derived", [False, True])
def test_stacked_block_operator_modes_agree(shot_map, derived):
    ref = _block_op("vmap", False)
    op = _block_op(shot_map, derived)
    m = torch.arange(7.0, dtype=torch.float64)
    d = torch.linspace(-1, 1, 15, dtype=torch.float64).reshape(3, 5)
    assert op.rng.shape == (3, 5)
    np.testing.assert_allclose(op(m).numpy(), ref(m).numpy(), rtol=1e-12)
    np.testing.assert_allclose(op.H(d).numpy(), ref.H(d).numpy(), rtol=1e-12)
    g = torch.Generator().manual_seed(0)
    lhs, rhs = tt.dot_product_test(op, op.dom.randn(g), op.rng.randn(g))
    np.testing.assert_allclose(float(lhs), float(rhs), rtol=1e-12)


def test_stacked_block_operator_validation():
    kw = dict(nblocks=3, dom=tt.Space((7,), device=CPU), rng_block=tt.Space((5,), device=CPU),
              df=lambda dm, m0, s: dm)
    with pytest.raises(ValueError, match="shot_map"):
        stacked_block_operator(bstate={}, shot_map="scan", **kw)
    with pytest.raises(ValueError, match="both bstate and sstate"):
        stacked_block_operator(bstate={"w": torch.ones(3)},
                               sstate={"w": torch.ones(3)}, **kw)
    with pytest.raises(ValueError, match="leading dim"):
        stacked_block_operator(bstate={"w": torch.ones(4)}, **kw)
    mesh = make_block_mesh(device=CPU)  # a world of one: the mesh path, bitwise
    for shot_map, derived in (("vmap", False), ("vmap", True), ("map", True)):
        ref, op = _block_op(shot_map, derived), _block_op(shot_map, derived, mesh)
        m = torch.arange(7.0, dtype=torch.float64)
        d = torch.linspace(-1, 1, 15, dtype=torch.float64).reshape(3, 5)
        assert op.rng.local_shape == (3, 5) and op.rng.mesh is mesh
        assert torch.equal(op(m), ref(m)) and torch.equal(op.H(d), ref.H(d))
