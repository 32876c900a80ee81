"""The port's distribution layer (jets_tpu_torch/parallel) on 2 and 4 gloo
ranks, held against jets_tpu's on its 8 virtual devices: the checks of
tests/test_parallel.py — the stacked operator sharded against the
unsharded one, its dot-product gate under the mesh, the seismic operator,
distributed LSQR, the runner, Chebyshev, and map-mode multishot against the
vmapped stack — plus the VTI and TTI multishots on the mesh, and the
derived adjoints, which must count each rank's contribution once (one
``all_reduce`` whose backward does not reduce again).

Each world runs once per module (``tests/_torch_mp_worker.py``, battery
``parallel``) on inputs made here: numpy draws, and the JAX package's
operators' weights and geometry lifted from them.

Tolerances: float64 stacked and seismic operators and every dot-product
gate ``rtol 1e-12`` (the seismic gate ``1e-10``, as tests/test_parallel.py);
LSQR the criteria of tests/test_parallel.py:104-128; Chebyshev ``rtol 1e-6,
atol 1e-9`` (tests/test_parallel.py); the float64 isotropic, VTI and TTI
multishot operators ``rtol 1e-12`` of the peak (the ranks sum a different
subset of shots, and JAX's scan contracts multiply-adds); their Jacobian
gate ``rtol 1e-9`` (tests/test_parallel.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_mp_worker import spawn
from jets_tpu.models.seismic import make_seismic_operator, make_seismic_problem
from jets_tpu.ops.wave import (multishot_tti_wave_operator, multishot_vti_wave_operator,
                               multishot_wave_operator)
from jets_tpu.parallel.sharded import make_block_mesh as jax_block_mesh
from jets_tpu.parallel.sharded import shard_blocks as jax_shard_blocks
from jets_tpu.solvers import chebyshev, estimate_spectral_bounds, lsqr, normal_operator
from jets_tpu_torch.parallel.sharded import (BlockMesh, ShardedSpace, block_sharding,
                                             make_block_mesh, shard_blocks)

WORLDS = [2, 4]
MS_GRID = (24, 24)
MS_SRCS = np.array([24 * 6 + 6, 24 * 6 + 17, 24 * 17 + 6, 24 * 17 + 17])
MS_KW = dict(nt=20, dt=0.0008, dx=10.0, freq=18.0, sponge_width=3, dtype=jnp.float64)
ANISO_GRID = (20, 20)
ANISO_SRCS = np.array([20 * 5 + 5, 20 * 5 + 14, 20 * 14 + 5, 20 * 14 + 14])


def lift(A):
    """``(wr, rcv)`` of a jets_tpu seismic operator as numpy arrays (rcv
    None for a regular subgrid geometry)."""
    st = A.jet.state
    wr = np.asarray(st["bstate"]["wr"])
    if "rcv" in st["sstate"]:
        return wr, np.asarray(st["sstate"]["rcv"])
    if "sidx" in st["sstate"]:
        return wr, np.asarray(st["sstate"]["sidx"])[0]
    return wr, None


def _seis_inputs(inp, key, A, grid):
    wr, rcv = lift(A)
    inp[f"{key}_grid"], inp[f"{key}_wr"] = np.array(grid), wr
    if rcv is not None:
        inp[f"{key}_rcv"] = rcv


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """The inputs, the JAX references (on the 8-device mesh where
    tests/test_parallel.py runs them there) and each world's results."""
    rng = np.random.default_rng(0)
    inp, ref = {}, {}
    inp["stk_w"] = rng.standard_normal((8, 12))
    inp["stk_m"], inp["stk_dd"] = rng.standard_normal(12), rng.standard_normal((8, 12))

    mesh8 = jax_block_mesh(8)
    A = make_seismic_operator((12, 12), 8, 15, jax.random.PRNGKey(0), mesh=mesh8,
                              dtype=jnp.float64)
    _seis_inputs(inp, "seis", A, (12, 12))
    inp["seis_m"], inp["seis_d"] = rng.standard_normal((12, 12)), rng.standard_normal((8, 15))
    ref["seis_fwd"] = np.asarray(A(jnp.asarray(inp["seis_m"])))
    ref["seis_adj"] = np.asarray(A.H(jax_shard_blocks(jnp.asarray(inp["seis_d"]), mesh8)))

    A0, _, d_obs = make_seismic_problem((12, 12), 16, 30, seed=1, dtype=jnp.float64)
    _seis_inputs(inp, "lsqr", A0, (12, 12))
    inp["lsqr_d"] = np.asarray(d_obs)
    r0 = lsqr(A0, d_obs, maxiter=50, tol=1e-12)
    ref["lsqr_x"], ref["lsqr_resnorm"] = np.asarray(r0.x), float(r0.resnorm)
    ref["lsqr_bnorm"] = float(A0.rng.norm(d_obs))
    ref["lsqr_true_res"] = float(A0.rng.norm(A0(r0.x) - d_obs))
    ref["lsqr_op"] = A0

    Ac, _, dc = make_seismic_problem((12, 12), 16, 30, seed=5, dtype=jnp.float64)
    _seis_inputs(inp, "cheb", Ac, (12, 12))
    inp["cheb_d"] = np.asarray(dc)
    N0 = normal_operator(Ac, damp=0.5)
    b0 = Ac.adjoint_apply(dc)
    lmin, lmax = estimate_spectral_bounds(N0)
    lmin = max(float(lmin), 0.5**2)  # the damped spectrum's analytic floor
    inp["cheb_bounds"] = np.array([lmin, float(lmax)])
    ref["cheb_x"] = np.asarray(chebyshev(N0, b0, lmin, float(lmax), maxiter=200, tol=1e-10,
                                         check_every=10).x)

    Fv = multishot_wave_operator(MS_GRID, jnp.asarray(MS_SRCS), **MS_KW)
    c = jnp.full(MS_GRID, 2000.0, jnp.float64)
    inp["ms_grid"], inp["ms_srcs"] = np.array(MS_GRID), MS_SRCS
    inp["ms_dd"] = rng.standard_normal((4, 20, 128))
    ref["ms_fwd"] = np.asarray(Fv(c))
    ref["ms_adj"] = np.asarray(Fv.linearize(c).H(jnp.asarray(inp["ms_dd"])))

    inp["aniso_grid"], inp["aniso_srcs"] = np.array(ANISO_GRID), ANISO_SRCS
    akw = dict(nt=24, dt=8e-4, dx=10.0, freq=18.0, sponge_width=3, dtype=jnp.float64)
    for name, make, means in (("vti", multishot_vti_wave_operator, (0.1, 0.05)),
                              ("tti", multishot_tti_wave_operator, (0.1, 0.05, 0.3))):
        F = make(ANISO_GRID, jnp.asarray(ANISO_SRCS), **akw)
        blocks = [2000.0 + 20.0 * rng.standard_normal(ANISO_GRID)] + [
            v + 0.01 * rng.standard_normal(ANISO_GRID) for v in means]
        inp[f"{name}_m"] = np.stack(blocks)
        inp[f"{name}_dd"] = rng.standard_normal(F.rng.shape)
        m = F.dom.zeros()
        for i, b in enumerate(blocks):
            m = m.setblock(i, jnp.asarray(b))
        ref[f"{name}_fwd"] = np.asarray(F(m))
        g = F.linearize(m).H(jnp.asarray(inp[f"{name}_dd"]))
        ref[f"{name}_adj"] = np.stack([np.asarray(g.getblock(i)) for i in range(len(blocks))])

    tmp = tmp_path_factory.mktemp("parallel")
    return inp, ref, {w: spawn("parallel", w, tmp, inp) for w in WORLDS}


def _rel12(got, want, rtol=1e-12):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * float(np.max(np.abs(want))))


def _replicated(res, key):
    for r in res[1:]:
        np.testing.assert_array_equal(r[key], res[0][key])
    return res[0][key]


@pytest.mark.parametrize("world", WORLDS)
def test_stacked_sharded_matches_unsharded(case, world):
    inp, _, out = case
    res = out[world]
    w, m, dd = inp["stk_w"], inp["stk_m"], inp["stk_dd"]
    _rel12(_replicated(res, "stk_hand_fwd"), w * m[None, :])
    _rel12(_replicated(res, "stk_hand_adj"), np.sum(w * dd, axis=0))


@pytest.mark.parametrize("mode", ["derived_vmap", "derived_map"])
@pytest.mark.parametrize("world", WORLDS)
def test_derived_adjoint_counts_each_rank_once(case, world, mode):
    """The derived adjoint is the local vjp then one all_reduce: the sum
    over every block once, not ``world`` times."""
    inp, _, out = case
    res = out[world]
    _rel12(_replicated(res, f"stk_{mode}_fwd"), inp["stk_w"] * inp["stk_m"][None, :])
    _rel12(_replicated(res, f"stk_{mode}_adj"), np.sum(inp["stk_w"] * inp["stk_dd"], axis=0))


@pytest.mark.parametrize("mode", ["hand", "derived_vmap", "derived_map"])
@pytest.mark.parametrize("world", WORLDS)
def test_sharded_adjoint_gate(case, world, mode):
    lhs, rhs = _replicated(case[2][world], f"stk_{mode}_gate")
    np.testing.assert_allclose(lhs, rhs, rtol=1e-12)


@pytest.mark.parametrize("world", WORLDS)
def test_seismic_sharded_matches_jax(case, world):
    _, ref, out = case
    res = out[world]
    _rel12(_replicated(res, "seis_fwd"), ref["seis_fwd"])
    _rel12(_replicated(res, "seis_adj"), ref["seis_adj"])
    lhs, rhs = _replicated(res, "seis_gate")
    np.testing.assert_allclose(lhs, rhs, rtol=1e-10)


@pytest.mark.parametrize("world", WORLDS)
def test_distributed_lsqr_converges(case, world):
    """Config 4 scaled down: multi-shot LSQR over the ranks matches the
    single-device JAX solve by the criteria of tests/test_parallel.py."""
    _, ref, out = case
    res = out[world]
    x = _replicated(res, "lsqr_x")
    rn, true_res = float(res[0]["lsqr_resnorm"]), float(res[0]["lsqr_true_res"])
    bnorm = ref["lsqr_bnorm"]
    assert abs(ref["lsqr_resnorm"] - rn) < 1e-3 * bnorm
    A0 = ref["lsqr_op"]  # the port's true residual is that of JAX's operator
    true_res_j = float(A0.rng.norm(A0(jnp.asarray(x)) - jnp.asarray(case[0]["lsqr_d"])))
    assert abs(true_res_j - true_res) < 1e-9 * bnorm
    assert abs(ref["lsqr_true_res"] - true_res) < 1e-3 * bnorm
    assert abs(true_res - rn) < 1e-9 * bnorm
    np.testing.assert_allclose(x, ref["lsqr_x"], rtol=0.5,
                               atol=1e-2 * float(np.max(np.abs(ref["lsqr_x"]))))
    assert rn < 0.1 * bnorm


@pytest.mark.parametrize("world", WORLDS)
def test_runner_local_block_range_and_assemble(case, world):
    """Each rank's range is its contiguous, genuinely partial slab; the
    slabs tile the blocks; a count the mesh does not divide and a slab of
    the wrong shape are refused."""
    res = case[2][world]
    data = np.arange(16 * 3, dtype=np.float32).reshape(16, 3)
    per = 16 // world
    for r, rr in enumerate(res):
        assert tuple(rr["runner_range"]) == (r * per, (r + 1) * per)
        np.testing.assert_array_equal(rr["runner_slab"], data[r * per:(r + 1) * per])
        assert bool(rr["runner_refuses_15"]) and bool(rr["runner_refuses_shape"])


@pytest.mark.parametrize("world", WORLDS)
def test_distributed_chebyshev_reduction_free_solve(case, world):
    _, ref, out = case
    np.testing.assert_allclose(_replicated(out[world], "cheb_x"), ref["cheb_x"], rtol=1e-6,
                               atol=1e-9)


@pytest.mark.parametrize("world", WORLDS)
def test_shot_map_sequential_matches_vmap(case, world):
    """``shot_map="map"`` on the mesh (each rank's shots one after another,
    on the kernels where they apply) against JAX's vmapped stack: forward,
    the derived adjoint summed over the ranks once, and the Jacobian gate."""
    _, ref, out = case
    res = out[world]
    assert float(np.max(np.abs(ref["ms_fwd"]))) > 0
    _rel12(_replicated(res, "ms_fwd"), ref["ms_fwd"])
    _rel12(_replicated(res, "ms_adj"), ref["ms_adj"])
    lhs, rhs = _replicated(res, "ms_gate")
    np.testing.assert_allclose(lhs, rhs, rtol=1e-9)


@pytest.mark.parametrize("shot_map", ["map", "vmap"])
@pytest.mark.parametrize("physics", ["vti", "tti"])
@pytest.mark.parametrize("world", WORLDS)
def test_anisotropic_multishot_on_the_mesh_matches_jax(case, world, physics, shot_map):
    """The VTI and TTI multishot operators with ``mesh=`` (4 shots, each
    rank its slab of them) against JAX's unsharded stack: the forward and
    the derived adjoint, every model block, float64."""
    _, ref, out = case
    res = out[world]
    _rel12(_replicated(res, f"{physics}_{shot_map}_fwd"), ref[f"{physics}_fwd"])
    adj = _replicated(res, f"{physics}_{shot_map}_adj")
    for got, want in zip(adj, ref[f"{physics}_adj"]):
        _rel12(got, want)


def test_block_mesh_in_one_process():
    """Without a launcher, ``make_block_mesh`` makes a world of one: the
    sharded space is the whole space, and a mesh of another size is
    refused."""
    mesh = make_block_mesh(device="cpu")
    assert isinstance(mesh, BlockMesh) and mesh.shape == {"block": 1} and mesh.rank == 0
    assert mesh.backend == "gloo" and mesh.device == torch.device("cpu")
    with pytest.raises(ValueError, match="every rank"):
        make_block_mesh(2, device="cpu")
    sp = ShardedSpace((6, 3), torch.float64, mesh)
    assert sp.local_shape == sp.shape == (6, 3) and sp.zeros().shape == (6, 3)
    x = torch.arange(18.0, dtype=torch.float64).reshape(6, 3)
    assert torch.equal(shard_blocks(x, mesh), x)
    assert float(sp.norm(x)) == float(torch.linalg.vector_norm(x))
    assert float(sp.norm(x, float("inf"))) == 17.0
    g1, g2 = torch.Generator().manual_seed(3), torch.Generator().manual_seed(3)
    assert torch.equal(sp.randn(g1), torch.randn((6, 3), generator=g2, dtype=torch.float64))
    ws = block_sharding(mesh, "grid")
    assert ws.mesh is mesh and ws.spec == ("grid",)
