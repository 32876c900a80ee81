"""Block operators (jets_tpu_torch/core/block.py) and random algebra trees
of the ported operators held against jets_tpu on the same numpy arrays:
the cases of tests/test_block_shapes.py (singleton, tall-and-skinny,
short-and-fat and vectorized block operators, masked dot-product tests,
``*`` composition, sums of compositions, ``getblock`` through a
composition) and of tests/test_property_compositions.py (random compose /
sum / scale / adjoint trees and blocks of them), plus ``nblocks`` and
``getblock`` through adjoints, ``zero_block`` elision, ``dadom`` and a
nonlinear child.

Tolerances: float64 on both sides; dense matrices and actions at
``rtol=1e-12`` (``1e-10`` for the random trees, whose materializations
sum in other orders), dot-product gates at ``rtol=1e-12`` (trees
``1e-10``). ``test_vec_preserves_symmetric_space_semantics`` waits for
``SymmetricSpace`` (ROADMAP queue 1 item 8).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jets_tpu as jt
import jets_tpu_torch as tt
from jets_tpu.core.jet import Jet as JJet
from jets_tpu.core.jet import Operator as JOperator
from jets_tpu.ops import conv1d_operator as j_conv1d
from jets_tpu.ops import convnd_operator as j_convnd
from jets_tpu.ops import derivative_operator as j_derivative
from jets_tpu.ops import diagonal_operator as j_diagonal
from jets_tpu.ops import matrix_operator as j_matrix
from jets_tpu.ops.stencil import laplacian_operator as j_laplacian
from jets_tpu.ops.stencil import stencil_operator as j_stencil
from jets_tpu_torch.ops import (
    conv1d_operator,
    convnd_operator,
    derivative_operator,
    diagonal_operator,
    laplacian_operator,
    matrix_operator,
    stencil_operator,
)

CPU = torch.device("cpu")  # the tests build on the CPU, as a caller asks
N = 16
JSP = jt.Space((N,), jnp.float64)
TSP = tt.Space((N,), torch.float64, device=CPU)


def _close(a, b, rtol=1e-12):
    a, b = np.asarray(a), np.asarray(b)
    np.testing.assert_allclose(a, b, rtol=rtol, atol=rtol * max(np.abs(b).max(), 1.0))


def _mats(ja, ta):
    return np.asarray(jt.materialize(ja)), tt.materialize(ta).numpy()


def _matrix(rng, nr, nc):
    M = rng.standard_normal((nr, nc))
    return j_matrix(jnp.asarray(M)), matrix_operator(M, device=CPU), M


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _gate(B, seed=0, rtol=1e-12):
    lhs, rhs = tt.dot_product_test(B, B.dom.randn(_gen(seed)), B.rng.randn(_gen(seed + 1)))
    assert float(lhs) == pytest.approx(float(rhs), rel=rtol, abs=1e-12)


# -- the cases of tests/test_block_shapes.py ----------------------------------------


def test_block_singleton():
    jA, tA, M = _matrix(np.random.default_rng(11), 7, 7)
    jB, tB = jt.block_operator([[jA]]), tt.block_operator([[tA]])
    assert tt.nblocks(tB) == jt.nblocks(jB) == (1, 1)
    x = np.random.default_rng(0).standard_normal(7)
    y = tB(torch.from_numpy(x))
    assert isinstance(y, tt.BlockVector)
    _close(tB.rng.ravel(y).numpy(), M @ x)
    _close(tB.rng.ravel(y).numpy(), np.asarray(jB.rng.ravel(jB(jnp.asarray(x)))))


def test_block_tall_and_skinny():
    rng = np.random.default_rng(12)
    (jA1, tA1, M1), (jA2, tA2, M2), (jA3, tA3, M3) = (
        _matrix(rng, r, 6) for r in (4, 5, 3))
    jB = jt.block_operator([[jA1], [jA2], [jA3]])
    tB = tt.block_operator([[tA1], [tA2], [tA3]])
    assert tt.nblocks(tB) == (3, 1) and tB.dom == tt.Space((6,), torch.float64, device=CPU)
    a, b = _mats(jB, tB)
    _close(b, np.vstack([M1, M2, M3]))
    _close(b, a)
    _gate(tB)


def test_block_short_and_fat():
    rng = np.random.default_rng(13)
    (jA1, tA1, M1), (jA2, tA2, M2) = _matrix(rng, 4, 6), _matrix(rng, 4, 3)
    jB, tB = jt.block_operator([[jA1, jA2]]), tt.block_operator([[tA1, tA2]])
    assert tt.nblocks(tB) == (1, 2) and isinstance(tB.dom, tt.BlockSpace)
    dense = np.hstack([M1, M2])
    a, b = _mats(jB, tB)
    _close(b, dense)
    _close(b, a)
    d = tB.rng.randn(_gen(2))
    adj = tt.adjoint(tB)(d)
    assert isinstance(adj, tt.BlockVector) and adj.nblocks == 2
    _close(tB.dom.ravel(adj).numpy(), dense.T @ tB.rng.ravel(d).numpy())


def test_vectorized_block_operator():
    rng = np.random.default_rng(14)
    (jA1, tA1, M1), (jA2, tA2, M2) = _matrix(rng, 4, 6), _matrix(rng, 5, 6)
    jBv = jt.vec(jt.block_operator([[jA1], [jA2]]))
    tBv = tt.vec(tt.block_operator([[tA1], [tA2]]))
    assert tBv.dom.ndim == tBv.rng.ndim == 1 and type(tBv.rng) is tt.Space
    x = rng.standard_normal(6)
    y = tBv(torch.from_numpy(x))
    assert isinstance(y, torch.Tensor)
    _close(y.numpy(), np.vstack([M1, M2]) @ x)
    _close(y.numpy(), np.asarray(jBv(jnp.asarray(x))))
    _gate(tBv)


def test_dot_product_test_masks():
    w = np.random.default_rng(15).uniform(0.5, 1.5, 16)
    A = diagonal_operator(w, device=CPU)
    jA = j_diagonal(jnp.asarray(w))
    m, d = A.dom.randn(_gen(1)), A.dom.randn(_gen(2))
    mmask = torch.cat([torch.ones(8), torch.zeros(8)]).double()
    dmask = torch.cat([torch.zeros(4), torch.ones(12)]).double()
    lhs, rhs = tt.dot_product_test(A, m, d, mmask=mmask, dmask=dmask)
    assert float(lhs) == pytest.approx(float(rhs), rel=1e-12)
    jl, jr = jt.dot_product_test(jA, jnp.asarray(m.numpy()), jnp.asarray(d.numpy()),
                                 mmask=jnp.asarray(mmask.numpy()),
                                 dmask=jnp.asarray(dmask.numpy()))
    assert float(lhs) == pytest.approx(float(jl), rel=1e-12)
    lhs_full, _ = tt.dot_product_test(A, m, d)
    assert abs(float(lhs_full) - float(lhs)) > 1e-8


def test_star_composes_operators():
    rng = np.random.default_rng(16)
    (jA, tA, MA), (jB, tB, MB) = _matrix(rng, 5, 5), _matrix(rng, 5, 5)
    a, b = _mats(jA * jB, tA * tB)
    _close(b, MA @ MB)
    _close(b, a)
    x = rng.standard_normal(5)
    _close((tA * torch.from_numpy(x)).numpy(), MA @ x)


def test_sum_of_compositions():
    rng = np.random.default_rng(17)
    (j1, t1, M1), (j2, t2, M2), (j3, t3, M3), (j4, t4, M4) = (
        _matrix(rng, 6, 6) for _ in range(4))
    a, b = _mats(j1 @ j2 + j3 @ j4, t1 @ t2 + t3 @ t4)
    _close(b, M1 @ M2 + M3 @ M4)
    _close(b, a)
    _gate(t1 @ t2 + t3 @ t4)


def test_block_of_compositions_getblock():
    rng = np.random.default_rng(18)
    pairs = [_matrix(rng, 4, 4) for _ in range(4)]
    (jA11, tA11, _), (jA22, tA22, M22), (jB11, tB11, _), (jB22, tB22, N22) = pairs
    jz, tz = jt.zero_block(jA11.dom, jA11.rng), tt.zero_block(tA11.dom, tA11.rng)
    jC = jt.block_operator([[jA11, jz], [jz, jA22]]) @ jt.block_operator(
        [[jB11, jz], [jz, jB22]])
    tC = tt.block_operator([[tA11, tz], [tz, tA22]]) @ tt.block_operator(
        [[tB11, tz], [tz, tB22]])
    assert tt.nblocks(tC) == jt.nblocks(jC) == (2, 2)
    a, b = _mats(jt.getblock(jC, 1, 1), tt.getblock(tC, 1, 1))
    _close(b, M22 @ N22)
    _close(b, a)


# -- block introspection, zero blocks, dadom, nonlinear children --------------------------


def test_nblocks_and_getblock_through_adjoints():
    rng = np.random.default_rng(19)
    pairs = [[_matrix(rng, r, c) for c in (3, 5)] for r in (4, 2, 6)]
    jB = jt.block_operator([[p[0] for p in row] for row in pairs])
    tB = tt.block_operator([[p[1] for p in row] for row in pairs])
    assert tt.nblocks(tB) == jt.nblocks(jB) == (3, 2)
    assert tt.nblocks(tB.H) == jt.nblocks(jB.H) == (2, 3)
    assert tt.is_block_op(tB) and not tt.is_block_op(pairs[0][0][1])
    for i in range(3):
        for j in range(2):
            assert tt.getblock(tB, i, j) is pairs[i][j][1]
            a, b = _mats(jt.getblock(jB.H, j, i), tt.getblock(tB.H, j, i))
            _close(b, pairs[i][j][2].T)
            _close(b, a)
    # a composition counts the most rows and columns among its blocky
    # factors, and composes their (i, j) blocks
    assert tt.nblocks(tB.H @ tB) == jt.nblocks(jB.H @ jB) == (3, 3)
    for i in range(2):
        a, b = _mats(jt.getblock(jB.H @ jB, i, i), tt.getblock(tB.H @ tB, i, i))
        _close(b, pairs[i][i][2].T @ pairs[i][i][2])
        _close(b, a)
    M = pairs[0][0][1]
    assert tt.nblocks(M) == (1, 1) and tt.getblock(M, 0, 0) is M
    with pytest.raises(IndexError):
        tt.getblock(M, 1, 0)


def test_zero_block_elision_and_dadom():
    rng = np.random.default_rng(20)
    (jA, tA, MA), (jC, tC, MC) = _matrix(rng, 4, 3), _matrix(rng, 5, 3)
    tz = tt.zero_block(tA.dom, tt.Space((5,), torch.float64, device=CPU))
    jz = jt.zero_block(jA.dom, jt.Space((5,), jnp.float64))
    assert tt.is_zero_block(tz) and not tt.is_zero_block(tA)
    # a zero row: its range block is zeros, and its adjoint contributes none
    tB = tt.block_operator([[tA], [tz]])
    jB = jt.block_operator([[jA], [jz]])
    a, b = _mats(jB, tB)
    _close(b, np.vstack([MA, np.zeros((5, 3))]))
    _close(b, a)
    # dadom: one column, yet a block domain
    tD = tt.block_operator([[tA], [tC]], dadom=True)
    jD = jt.block_operator([[jA], [jC]], dadom=True)
    assert isinstance(tD.dom, tt.BlockSpace) and tD.dom.nblocks == 1
    x = tD.dom.randn(_gen(3))
    assert isinstance(tD.H(tD(x)), tt.BlockVector)
    a, b = _mats(jD, tD)
    _close(b, a)
    _gate(tD)
    # an all-zero column: the adjoint returns zeros of that domain block
    tE = tt.block_operator([[tA, tt.zero_block(tt.Space((2,), torch.float64, device=CPU),
                                               tA.rng)]])
    y = tE.H(tE.rng.randn(_gen(4)))
    assert torch.equal(y.getblock(1), torch.zeros(2, dtype=torch.float64))
    for rows in ([[tA], [tA, tA]], [[tA, tC]], [[tA], [tt.zero_block(
            tt.Space((2,), torch.float64, device=CPU), tA.rng)]]):
        with pytest.raises(ValueError):
            tt.block_operator(rows)


def test_nonlinear_child_block_operator_linearizes_like_jax():
    w = np.random.default_rng(21).uniform(0.5, 1.5, 6)
    jsq = JOperator(JJet(dom=jt.Space((6,), jnp.float64), rng=jt.Space((6,), jnp.float64),
                         f=lambda m, s: m ** 2, df=lambda dm, m0, s: 2 * m0 * dm,
                         dft="self"))
    tsq = tt.Operator(tt.Jet(dom=tt.Space((6,), torch.float64, device=CPU),
                             rng=tt.Space((6,), torch.float64, device=CPU),
                             f=lambda m, s: m ** 2, df=lambda dm, m0, s: 2 * m0 * dm,
                             dft="self"))
    jB = jt.block_operator([[jsq, j_diagonal(jnp.asarray(w))]])
    tB = tt.block_operator([[tsq, diagonal_operator(w, device=CPU)]])
    assert not isinstance(tB, tt.LinearOperator)
    m0 = tB.dom.randn(_gen(5))
    jm0 = jB.dom.reshape(jnp.asarray(tB.dom.ravel(m0).numpy()))
    _close(tB.rng.ravel(tB(m0)).numpy(), np.asarray(jB.rng.ravel(jB(jm0))))
    tJ, jJ = tt.linearize(tB, m0), jt.linearize(jB, jm0)
    a, b = _mats(jJ, tJ)
    _close(b, a)
    _gate(tJ)
    with pytest.raises(ValueError, match="linearize"):
        tB.jet.apply_df(m0)


# -- random algebra trees (tests/test_property_compositions.py) ---------------------------


def _pool(rng):
    """Square N→N linear operators of the ported packs, one pair each."""
    w = rng.uniform(0.5, 1.5, N)
    M = rng.standard_normal((N, N)) / 4.0
    k = rng.standard_normal(4) / 2.0
    s = rng.standard_normal(3) / 2.0
    return [
        (j_diagonal(jnp.asarray(w)), diagonal_operator(w, device=CPU)),
        (j_matrix(jnp.asarray(M)), matrix_operator(M, device=CPU)),
        (j_matrix(jnp.eye(N)), matrix_operator(np.eye(N), device=CPU)),
        (j_conv1d(jnp.asarray([0.25, 0.5, 0.25]), N, jnp.float64),
         conv1d_operator([0.25, 0.5, 0.25], N, torch.float64, device=CPU)),
        (j_derivative(N, 0.5, jnp.float64), derivative_operator(N, 0.5, torch.float64,
                                                                device=CPU)),
        (j_convnd(jnp.asarray(k), JSP), convnd_operator(k, TSP)),
        (j_stencil(JSP, jnp.asarray(s)), stencil_operator(TSP, s)),
        (j_laplacian((N,), jnp.float64), laplacian_operator((N,), torch.float64,
                                                            device=CPU)),
    ]


def _random_tree(rng, depth=0):
    pool = _pool(rng)
    jop, top = pool[rng.integers(0, len(pool))]
    if depth >= 3:
        return jop, top
    roll = rng.random()
    if roll < 0.35:
        ja, ta = _random_tree(rng, depth + 1)
        return jop @ ja, top @ ta
    if roll < 0.55:
        ja, ta = _random_tree(rng, depth + 1)
        return jop + ja, top + ta
    if roll < 0.65:
        ja, ta = _random_tree(rng, depth + 1)
        return jop - ja, top - ta
    if roll < 0.75:
        a = float(rng.uniform(0.5, 2.0))
        ja, ta = _random_tree(rng, depth + 1)
        return a * ja, a * ta
    if roll < 0.85:
        ja, ta = _random_tree(rng, depth + 1)
        return jt.adjoint(ja), tt.adjoint(ta)
    return jop, top


@pytest.mark.parametrize("seed", range(12))
def test_random_algebra_tree_matches_jax(seed):
    jA, tA = _random_tree(np.random.default_rng(seed))
    assert tA.dom == TSP and tA.rng == TSP
    _gate(tA, seed, rtol=1e-10)
    a, b = _mats(jA, tA)
    _close(b, a, rtol=1e-10)
    m, d = tA.dom.randn(_gen(seed)), tA.rng.randn(_gen(seed + 100))
    _close(tA(m).numpy(), b @ m.numpy(), rtol=1e-10)
    _close(tt.adjoint(tA)(d).numpy(), b.T @ d.numpy(), rtol=1e-10)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_block_of_trees_matches_jax(seed):
    rng = np.random.default_rng(100 + seed)
    (j11, t11), (j12, t12), (j21, t21), (j22, t22) = (_random_tree(rng) for _ in range(4))
    jB = jt.block_operator([[j11, j12], [j21, j22]])
    tB = tt.block_operator([[t11, t12], [t21, t22]])
    _gate(tB, seed, rtol=1e-10)
    a, b = _mats(jB, tB)
    _close(b, a, rtol=1e-10)
    m = tB.dom.randn(_gen(seed))
    _close(tB.rng.ravel(tB(m)).numpy(), b @ tB.dom.ravel(m).numpy(), rtol=1e-10)
