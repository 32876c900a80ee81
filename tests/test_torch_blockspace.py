"""The port's block spaces (jets_tpu_torch/core/blockspace.py) held against
jets_tpu.core.blockspace on the same numpy blocks, and the core layers that
take a BlockSpace domain (gates, derived adjoints, pytree maps, stacked
block operators).

Tolerances: float64 on both sides (the test session runs JAX with x64) at
``rtol=1e-12``; elementwise arithmetic is compared bitwise.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

import jets_tpu_torch as tt
from jets_tpu.core.blockspace import BlockSpace as JBlockSpace
from jets_tpu.core.blockspace import BlockVector as JBlockVector
from jets_tpu.core.spaces import Space as JSpace
from jets_tpu_torch import BlockSpace, BlockVector
from jets_tpu_torch.parallel.sharded import stacked_block_operator
from jets_tpu_torch.utils.tree import axpy, tmap

CPU = torch.device("cpu")  # the tests build on the CPU, as a caller asks

SHAPES = [(3, 4), (5,), (2, 3, 2)]


def _blocks(seed, shapes=SHAPES):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s) for s in shapes]


def _pair(blocks):
    js = JBlockSpace([JSpace(b.shape, jnp.float64) for b in blocks])
    ts = BlockSpace([tt.Space(b.shape, torch.float64, device=CPU) for b in blocks])
    return (JBlockVector([jnp.asarray(b) for b in blocks], js),
            BlockVector([torch.from_numpy(b) for b in blocks], ts))


def _same(tv, jv):
    assert isinstance(tv, BlockVector) and tv.nblocks == len(jv.blocks)
    for a, b in zip(tv.blocks, jv.blocks):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_arithmetic_matches_jax():
    jx, tx = _pair(_blocks(0))
    jy, ty = _pair(_blocks(1))
    ty = BlockVector(ty.blocks, tx.space)  # the same space, rebuilt
    for op in (lambda a, b: a + b, lambda a, b: a - b, lambda a, b: a * b,
               lambda a, b: a / b, lambda a, b: 2.5 * a - b, lambda a, b: -a + 0.5,
               lambda a, b: 1.0 - a * 3.0, lambda a, b: a / 4.0):
        _same(op(tx, ty), op(jx, jy))
    np.testing.assert_array_equal(tx.ravel().numpy(), np.asarray(jx.ravel()))
    _same(tx.fill(0.25), jx.fill(0.25))
    for a, b in zip(tx.extrema(), jx.extrema()):
        assert float(a) == float(b)
    assert len(tx) == len(jx) == 12 + 5 + 12
    new = np.full((5,), 7.0)
    _same(tx.setblock(1, torch.from_numpy(new)), jx.setblock(1, jnp.asarray(new)))
    assert torch.equal(tx.getblock(2), tx[2]) and len(list(tx)) == 3
    with pytest.raises(ValueError, match="shape"):
        tx.setblock(0, torch.zeros(4, 3))
    other = BlockSpace([tt.Space(s, torch.float64, device=CPU) for s in SHAPES[::-1]])
    with pytest.raises(ValueError, match="mismatch"):
        tx + BlockVector(other.zeros().blocks, other)


@pytest.mark.parametrize("p", [2, float("inf"), float("-inf"), 1, 0, 3])
def test_dot_and_norm_match_jax(p):
    jx, tx = _pair(_blocks(2))
    jy, ty = _pair(_blocks(3))
    ty = BlockVector(ty.blocks, tx.space)
    np.testing.assert_allclose(float(tx.dot(ty)), float(jx.dot(jy)), rtol=1e-12)
    np.testing.assert_allclose(float(tx.norm(p)), float(jx.norm(p)), rtol=1e-12)


def test_reshape_ravel_and_identity_match_jax():
    flat = np.random.default_rng(4).standard_normal(29)
    jx, tx = _pair(_blocks(5))
    _same(tx.space.reshape(torch.from_numpy(flat)), jx.space.reshape(jnp.asarray(flat)))
    assert tx.space.reshape(tx) is tx
    np.testing.assert_array_equal(tx.space.ravel(tx).numpy(), np.asarray(jx.space.ravel(jx)))
    sp = tx.space
    assert sp.nblocks == 3 and sp.size == 29 and sp.shape == (29,)
    assert [sp.indices(i) for i in range(3)] == [jx.space.indices(i) for i in range(3)]
    assert sp.subspace(1) == tt.Space((5,), torch.float64, device=CPU)
    assert sp == BlockSpace(sp.spaces) and hash(sp) == hash(BlockSpace(sp.spaces))
    assert sp != BlockSpace(sp.spaces[:2])
    with pytest.raises(ValueError, match="reshape"):
        sp.reshape(torch.zeros(28))
    with pytest.raises(TypeError, match="dtype"):
        BlockSpace([tt.Space(3, torch.float32, device=CPU), tt.Space(3, torch.float64, device=CPU)])
    with pytest.raises(ValueError, match="device"):
        BlockSpace([tt.Space(3, torch.float64, "cpu"), tt.Space(3, torch.float64, "meta")])
    with pytest.raises(ValueError, match="at least one"):
        BlockSpace([])
    z, o = sp.zeros(), sp.ones()
    assert all(bool((b == 0).all()) for b in z) and all(bool((b == 1).all()) for b in o)


def test_random_members_draw_blocks_in_order():
    sp = BlockSpace([tt.Space(s, torch.float32, device=CPU) for s in SHAPES])
    for draw in ("randn", "rand"):
        got = getattr(sp, draw)(torch.Generator().manual_seed(9))
        g = torch.Generator().manual_seed(9)
        want = [getattr(s, draw)(g) for s in sp.spaces]
        assert all(torch.equal(a, b) for a, b in zip(got.blocks, want))
        assert [tuple(b.shape) for b in got] == SHAPES
        assert all(b.dtype == torch.float32 for b in got)
    u = sp.rand(torch.Generator().manual_seed(1))
    assert all(bool(((b >= 0) & (b < 1)).all()) for b in u)


def _fn_t(m):
    a, b, c = m.blocks
    return torch.sin(a).sum(0) * b[:4] + (c * c).reshape(-1)[:4]


def _fn_j(m):
    a, b, c = m.blocks
    return jnp.sin(a).sum(0) * b[:4] + (c * c).reshape(-1)[:4]


def test_jvp_and_vjp_through_a_blockvector_match_jax():
    jx, tx = _pair(_blocks(6))
    jd, td = _pair(_blocks(7))
    td = BlockVector(td.blocks, tx.space)
    (yj, tj) = jax.jvp(_fn_j, (jx,), (JBlockVector(jd.blocks, jx.space),))
    yt, tt_ = torch.func.jvp(_fn_t, (tx,), (td,))
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=1e-12)
    np.testing.assert_allclose(tt_.numpy(), np.asarray(tj), rtol=1e-12)
    w = np.random.default_rng(8).standard_normal(4)
    _, vj = jax.vjp(_fn_j, jx)
    (gj,) = vj(jnp.asarray(w))
    _, vt = torch.func.vjp(_fn_t, tx)
    (gt,) = vt(torch.from_numpy(w))
    assert isinstance(gt, BlockVector) and gt.space == tx.space
    for a, b in zip(gt.blocks, gj.blocks):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-12)


def test_blockvector_is_a_pytree_node():
    _, tx = _pair(_blocks(10))
    leaves, spec = pytree.tree_flatten(tx)
    assert len(leaves) == 3 and all(a is b for a, b in zip(leaves, tx.blocks))
    back = pytree.tree_unflatten([2 * t for t in leaves], spec)
    assert isinstance(back, BlockVector) and back.space == tx.space
    y = tmap(lambda t: t + 1, tx)
    assert isinstance(y, BlockVector) and torch.equal(y[1], tx[1] + 1)
    z = axpy(2.0, tx, y)
    assert torch.equal(z[2], 2.0 * tx[2] + y[2])
    other = BlockSpace([tt.Space(s, torch.float64, device=CPU) for s in SHAPES[::-1]])
    assert pytree.tree_structure(tx) != pytree.tree_structure(other.zeros())


def _mixer(sp):
    """Nonlinear ``(a, b) -> a·b + a²`` on a two-block space, its tangent,
    and no adjoint (derived with ``torch.func.vjp``)."""
    rng = tt.Space(sp.subspace(0).shape, sp.dtype, device=CPU)

    def f(m, s):
        return m[0] * m[1] + m[0] ** 2

    def df(dm, m0, s):
        return dm[0] * m0[1] + m0[0] * dm[1] + 2 * m0[0] * dm[0]

    return tt.Operator(tt.Jet(dom=sp, rng=rng, f=f, df=df))


def test_gates_and_derived_adjoint_on_a_blockspace_domain():
    sp = BlockSpace([tt.Space((4, 5), torch.float64, device=CPU)] * 2)
    g = torch.Generator().manual_seed(0)
    F = _mixer(sp)
    m0 = sp.randn(g)
    J = F.linearize(m0)
    lhs, rhs = tt.dot_product_test(J, sp.randn(g), J.rng.randn(g))
    np.testing.assert_allclose(float(lhs), float(rhs), rtol=1e-12)
    mask = sp.ones().setblock(1, torch.zeros(4, 5, dtype=torch.float64))
    lhs, rhs = tt.dot_product_test(J, sp.randn(g), J.rng.randn(g), mmask=mask)
    np.testing.assert_allclose(float(lhs), float(rhs), rtol=1e-12)
    a, b = tt.linearity_test(J, g)
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-12, atol=1e-12)
    obs, exp = tt.linearization_test(F, m0, generator=g)
    np.testing.assert_allclose(obs.numpy(), exp.numpy(), rtol=1e-6)
    M = tt.materialize(J)
    assert M.shape == (20, 40)
    d = J.rng.randn(g)
    adj = J.H(d)
    assert isinstance(adj, BlockVector)
    np.testing.assert_allclose(adj.ravel().numpy(), (M.T @ d.reshape(-1)).numpy(),
                               rtol=1e-12)
    S = 3.0 * J
    np.testing.assert_allclose(tt.materialize(S).numpy(), 3.0 * M.numpy(), rtol=1e-12)
    np.testing.assert_allclose(S.H(d).ravel().numpy(), 3.0 * adj.ravel().numpy(),
                               rtol=1e-12)


@pytest.mark.parametrize("shot_map", ["vmap", "map"])
@pytest.mark.parametrize("given", [False, True])
def test_stacked_block_operator_with_a_blockvector_model(shot_map, given):
    """Two "shots" ``d_b = w_b·a + b`` of one two-block model; the adjoint
    (given per block, or derived) sums a BlockVector over the shots."""
    sp = BlockSpace([tt.Space(6, torch.float64, device=CPU)] * 2)
    w = torch.from_numpy(np.random.default_rng(11).standard_normal((2, 6)))

    def df(dm, m0, bs):
        return bs["w"] * dm[0] + dm[1]

    def dft(d, m0, bs):
        return BlockVector((bs["w"] * d, d), sp)

    A = stacked_block_operator(nblocks=2, dom=sp, rng_block=tt.Space(6, torch.float64, device=CPU),
                               bstate={"w": w}, df=df, dft=dft if given else None,
                               shot_map=shot_map)
    g = torch.Generator().manual_seed(2)
    m, d = sp.randn(g), A.rng.randn(g)
    np.testing.assert_allclose(A(m).numpy(), (w * m[0] + m[1]).numpy(), rtol=1e-12)
    adj = A.H(d)
    assert isinstance(adj, BlockVector)
    np.testing.assert_allclose(adj[0].numpy(), (w * d).sum(0).numpy(), rtol=1e-12)
    np.testing.assert_allclose(adj[1].numpy(), d.sum(0).numpy(), rtol=1e-12)
    lhs, rhs = tt.dot_product_test(A, m, d)
    np.testing.assert_allclose(float(lhs), float(rhs), rtol=1e-12)
