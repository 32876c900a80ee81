"""Heterogeneous block distribution of the port
(jets_tpu_torch/parallel/hetero.py) on 2 and 4 gloo ranks, held against
jets_tpu's (tests/test_hetero.py): mixed-shape rows group-stacked, the
groups the mesh axis divides sharded, forward and adjoint against the
plain ``block_operator`` of the JAX package's rows, the dot-product gate,
LSQR, and a group left unsharded.

Each world runs once per module (``tests/_torch_mp_worker.py``, battery
``hetero``) on numpy draws that both packages' rows are built from.
Tolerances are those of tests/test_hetero.py: forward ``rtol 1e-12, atol
1e-12``, adjoint ``rtol 1e-10, atol 1e-12``, gate ``rtol 1e-11``, LSQR
``rtol 1e-8, atol 1e-10`` against the unsharded solve and ``rtol 1e-6,
atol 1e-8`` against the true model.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_mp_worker import spawn
from jets_tpu.core.block import block_operator
from jets_tpu.ops.diagonal import diagonal_operator
from jets_tpu.ops.matrix import matrix_operator
from jets_tpu.solvers import lsqr
from jets_tpu_torch.ops.diagonal import diagonal_operator as t_diagonal_operator
from jets_tpu_torch.parallel.hetero import distribute_block_rows
from jets_tpu_torch.parallel.sharded import make_block_mesh

N = 24  # the shared model dimension
WORLDS = [2, 4]


def _mixed(seed, nmat=16, ndiag=8, mrows=10):
    rng = np.random.default_rng(seed)
    mats = np.stack([rng.standard_normal((mrows, N)) / np.sqrt(N) for _ in range(nmat)])
    diags = np.stack([0.5 + rng.random(N) for _ in range(ndiag)])
    return mats, diags


def _jax_ref(mats, diags):
    rows = [matrix_operator(jnp.asarray(a)) for a in mats] + \
        [diagonal_operator(jnp.asarray(a)) for a in diags]
    return block_operator([[r] for r in rows])


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    inp, ref = {}, {}
    inp["mix_mats"], inp["mix_diags"] = _mixed(0)
    R = _jax_ref(inp["mix_mats"], inp["mix_diags"])
    inp["mix_m"] = np.asarray(R.dom.randn(jax.random.PRNGKey(1)))
    d = R(jnp.asarray(inp["mix_m"]))
    ref["fwd"] = [np.asarray(d.getblock(i)) for i in range(24)]
    inp["ref_d_mats"] = np.stack(ref["fwd"][:16])
    inp["ref_d_diags"] = np.stack(ref["fwd"][16:])
    ref["adj"] = np.asarray(R.adjoint_apply(d))

    inp["gate_mats"], inp["gate_diags"] = _mixed(3)

    inp["lsqr_mats"], inp["lsqr_diags"] = _mixed(5)
    R5 = _jax_ref(inp["lsqr_mats"], inp["lsqr_diags"])
    m_true = R5.dom.randn(jax.random.PRNGKey(7))
    d5 = R5(m_true)
    inp["lsqr_b_mats"] = np.stack([np.asarray(d5.getblock(i)) for i in range(16)])
    inp["lsqr_b_diags"] = np.stack([np.asarray(d5.getblock(i)) for i in range(16, 24)])
    ref["lsqr_x"] = np.asarray(lsqr(R5, d5, maxiter=60, tol=1e-13).x)
    ref["m_true"] = np.asarray(m_true)

    rng = np.random.default_rng(9)
    inp["fallback_mats"] = np.stack([rng.standard_normal((7, N)) for _ in range(3)])
    inp["fallback_diags"] = np.stack([1.0 + rng.random(N) for _ in range(8)])
    R9 = _jax_ref(inp["fallback_mats"], inp["fallback_diags"])
    inp["fallback_m"] = np.asarray(R9.dom.randn(jax.random.PRNGKey(4)))
    d9 = R9(jnp.asarray(inp["fallback_m"]))
    ref["fallback"] = [np.asarray(d9.getblock(i)) for i in range(11)]

    tmp = tmp_path_factory.mktemp("hetero")
    return inp, ref, {w: spawn("hetero", w, tmp, inp) for w in WORLDS}


@pytest.mark.parametrize("world", WORLDS)
def test_grouping_and_sharding(case, world):
    """Two structure groups (16 matrix rows, 8 diagonal rows), both sharded
    (the mesh axis divides 16 and 8), rows in their original order."""
    for r in case[2][world]:
        assert list(r["groups"]) == [16, 8]
        assert list(r["group_rows"]) == list(range(24))
        assert list(r["sharded"]) == [True, True]


@pytest.mark.parametrize("world", WORLDS)
def test_forward_adjoint_match_single_device(case, world):
    _, ref, out = case
    for r in out[world]:
        got = list(r["fwd"]) + list(r["fwd_diag"])
        for i in range(24):
            np.testing.assert_allclose(got[i], ref["fwd"][i], rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(r["adj"], ref["adj"], rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("world", WORLDS)
def test_dot_product_gate_on_distributed_operator(case, world):
    for r in case[2][world]:
        np.testing.assert_allclose(r["gate"][0], r["gate"][1], rtol=1e-11)


@pytest.mark.parametrize("world", WORLDS)
def test_lsqr_converges_on_distributed_hetero_operator(case, world):
    _, ref, out = case
    for r in out[world]:
        np.testing.assert_allclose(r["lsqr_x"], ref["lsqr_x"], rtol=1e-8, atol=1e-10)
        np.testing.assert_allclose(r["lsqr_x"], ref["m_true"], rtol=1e-6, atol=1e-8)


@pytest.mark.parametrize("world", WORLDS)
def test_unsharded_fallback_group(case, world):
    """A group of 3 rows (the mesh axis does not divide it) stays unsharded
    on every rank and still computes correctly."""
    _, ref, out = case
    for r in out[world]:
        assert list(r["fallback_sharded"]) == [False, True]
        got = list(r["fallback_fwd_mats"]) + list(r["fallback_fwd_diags"])
        for i in range(11):
            np.testing.assert_allclose(got[i], ref["fallback"][i], rtol=1e-12, atol=1e-12)


def test_rejects_nonlinear_and_mixed_domains():
    mesh = make_block_mesh(device="cpu")
    rows = [t_diagonal_operator(np.ones(N), device="cpu") for _ in range(2)]
    with pytest.raises(ValueError, match="one model domain"):
        distribute_block_rows(rows + [t_diagonal_operator(np.ones(5), device="cpu")], mesh)
    with pytest.raises(TypeError, match="adjoint"):
        distribute_block_rows([rows[0].H], mesh)
    with pytest.raises(ValueError, match="no rows"):
        distribute_block_rows([], mesh)
    lay = distribute_block_rows(rows, mesh)  # a world of one: every group shards
    assert lay.sharded == [True]
    m = torch.ones(N, dtype=torch.float64)
    assert torch.equal(lay.operator.H(lay.operator(m)), 2.0 * m)
