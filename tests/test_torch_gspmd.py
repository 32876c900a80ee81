"""The block × grid mesh of the port (``jets_tpu_torch.parallel.gspmd``)
held against tests/test_gspmd.py: each of its nine tests, at its shapes and
seeds, on a world of one in this process and on the (2, 2) and (1, 4)
meshes of 4 gloo ranks (``tests/_torch_mp_worker.py``, battery ``gspmd``,
one spawn). The reference is the JAX package's run of the same test on its
8 virtual devices (``make_mesh_2d(4, 2)``, ``make_mesh_2d(2, 4)`` or
``make_block_mesh(8, "grid")``, jitted on sharded inputs), the inputs
carried across as numpy arrays.

tests/test_gspmd.py's tolerances: seismic forward and adjoint ``rtol
1e-12`` in float64; LSQR ``resnorm`` within ``1e-9·‖b‖`` and x ``rtol 1e-6,
atol 1e-9``; CGLS x ``rtol 1e-6, atol 1e-9``; traces ``rtol 2e-6``;
gradients and adjoints ``atol 1e-5`` of their scale. Every wave check
keeps its live-signal guard. Where the JAX test looks for halo collectives
in the compiled program, each rank here counts its halo exchanges
(``collectives.halo_counts``), and every rank holds its slab only.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from _torch_mp_worker import gspmd_on, spawn
from jets_tpu.models.seismic import make_seismic_problem
from jets_tpu.ops.wave import (multishot_vti_wave_operator, multishot_wave_operator,
                               tti_wave_propagator, vti_wave_propagator, wave_propagator)
from jets_tpu.parallel.gspmd import make_mesh_2d, shard_data, shard_model
from jets_tpu.parallel.sharded import make_block_mesh
from jets_tpu.solvers import cgls, lsqr

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")

MESHES = ["1x1", "2x2", "1x4"]
SHAPE = (16, 8, 16)
GRID, SRCS = (16, 16), [16 * 8 + 2, 16 * 8 + 6, 16 * 8 + 10, 16 * 8 + 13]


def _wave_kw(shape, src, nt=14):
    return dict(nt=nt, dt=8e-4, dx=10.0, freq=18.0, sponge_width=3, dtype=jnp.float32,
                src_idx=int(np.ravel_multi_index(src, shape)),
                rcv_idx=jnp.asarray([np.ravel_multi_index((8, 4, x), shape)
                                     for x in range(shape[2])], jnp.int32))


def _jax_runs():
    """The inputs and the JAX package's sharded results, test by test."""
    inp, ref = {}, {}
    mesh42 = make_mesh_2d(4, 2)
    A, m, d = make_seismic_problem((16, 16), 8, 32, seed=3, dtype=jnp.float64)
    inp.update(fa_wr=np.asarray(A.jet.state["bstate"]["wr"]), fa_m=np.asarray(m),
               fa_d=np.asarray(d))
    ref["fa_fwd"] = np.asarray(jax.jit(lambda op, x: op(x))(A, shard_model(m, mesh42)))
    ref["fa_adj"] = np.asarray(jax.jit(lambda op, x: op.H(x))(A, shard_data(d, mesh42)))

    A, _, d = make_seismic_problem((16, 16), 8, 32, seed=4, noise=0.02, dtype=jnp.float64)
    inp.update(ls_wr=np.asarray(A.jet.state["bstate"]["wr"]), ls_d=np.asarray(d))
    r = lsqr(A, shard_data(d, mesh42), maxiter=25, tol=0.0)
    ref.update(ls_x=np.asarray(r.x), ls_resnorm=float(r.resnorm),
               ls_bnorm=float(A.rng.norm(d)))

    mesh24 = make_mesh_2d(2, 4)
    A, _, d = make_seismic_problem((8, 10, 6), 4, 24, seed=5, noise=0.02, dtype=jnp.float64)
    inp.update(cg_wr=np.asarray(A.jet.state["bstate"]["wr"]), cg_d=np.asarray(d))
    ref["cg_x"] = np.asarray(cgls(A, shard_data(d, mesh24), x0=shard_model(A.dom.zeros(),
                                                                          mesh24),
                                  maxiter=15, tol=0.0).x)

    ws = NamedSharding(make_block_mesh(8, axis="grid"), P("grid"))
    kw = _wave_kw(SHAPE, (8, 4, 8))
    c = jnp.full(SHAPE, 1500.0, jnp.float32) + 20.0 * jax.random.normal(
        jax.random.PRNGKey(9), SHAPE, jnp.float32)
    Fs = wave_propagator(SHAPE, wavefield_sharding=ws, **kw)
    c_sh = jax.device_put(c, ws)
    F0 = wave_propagator(SHAPE, **kw)
    d = F0.rng.randn(jax.random.PRNGKey(10)).astype(jnp.float32)
    inp.update(iso_c=np.asarray(c), iso_d=np.asarray(d))
    ref["iso_fwd"] = np.asarray(jax.jit(lambda x: Fs(x))(c_sh))
    ref["iso_grad"] = np.asarray(jax.jit(jax.grad(lambda x: jnp.sum(Fs(x) ** 2)))(c_sh))
    Fss = wave_propagator(SHAPE, wavefield_sharding=ws, store_adjoint="f32", **kw)
    ref["iso_adj"] = np.asarray(jax.jit(lambda dd: Fss.linearize(c_sh).H(dd))(d))

    mesh2 = make_mesh_2d(4, 2)
    mkw = dict(nt=12, dt=8e-4, dx=10.0, freq=18.0, sponge_width=3, dtype=jnp.float32)
    for key, make, vals in (("ms", multishot_wave_operator, None),
                            ("msv", multishot_vti_wave_operator, (1500.0, 0.1, 0.05))):
        F = make(GRID, jnp.array(SRCS), **mkw)
        if vals is None:
            m = jnp.full(GRID, 1500.0, jnp.float32)
            m_sh = shard_model(m, mesh2)
        else:
            m = F.dom.zeros()
            for b, v in enumerate(vals):
                m = m.setblock(b, jnp.full(GRID, v, jnp.float32))
            m_sh = m.setblock(0, shard_model(m.getblock(0), mesh2))
        d0 = F(m)
        inp[f"{key}_d0"] = np.asarray(d0)
        ref[f"{key}_fwd"] = np.asarray(jax.jit(lambda x: F(x))(m_sh))
        a = jax.jit(lambda dd: F.linearize(m_sh).H(dd))(shard_data(d0, mesh2))
        ref[f"{key}_adj"] = np.asarray(a) if vals is None else np.stack(
            [np.asarray(a.getblock(b)) for b in range(3)])

    for key, make, vals, seed in (
            ("vti", vti_wave_propagator, (1500.0, 0.1, 0.05), 11),
            ("tti", tti_wave_propagator, (1500.0, 0.1, 0.05, 0.2, 0.7), 12)):
        kwp = _wave_kw(SHAPE, (8, 4, 8), nt=14 if key == "vti" else 12)
        F0 = make(SHAPE, **kwp)
        m = F0.dom.zeros()
        for b, v in enumerate(vals):
            m = m.setblock(b, jnp.full(SHAPE, v, jnp.float32))
        m_sh = m.setblock(0, jax.device_put(m.getblock(0), ws))
        Fs = make(SHAPE, wavefield_sharding=ws, **kwp)
        ref[f"{key}_fwd"] = np.asarray(jax.jit(lambda x: Fs(x))(m_sh))
        d = F0.rng.randn(jax.random.PRNGKey(seed)).astype(jnp.float32)
        inp[f"{key}_d"] = np.asarray(d)
        Fss = make(SHAPE, wavefield_sharding=ws, store_adjoint="f32", **kwp)
        a = jax.jit(lambda dd: Fss.linearize(m_sh).H(dd))(d)
        ref[f"{key}_adj"] = np.stack([np.asarray(a.getblock(b)) for b in range(len(vals))])

    shape = (16, 8, 128)
    kw = _wave_kw(shape, (8, 4, 64))
    c = jnp.full(shape, 1500.0, jnp.float32) + 20.0 * jax.random.normal(
        jax.random.PRNGKey(13), shape, jnp.float32)
    inp["fu_c"] = np.asarray(c)
    Ff = wave_propagator(shape, wavefield_sharding=ws, fused=True, **kw)
    c_sh = jax.device_put(c, ws)
    ref["fu_fwd"] = np.asarray(jax.jit(lambda x: Ff(x))(c_sh))
    ref["fu_grad"] = np.asarray(jax.jit(jax.grad(lambda x: jnp.sum(Ff(x) ** 2)))(c_sh))
    return inp, ref


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """``(ref, {mesh: [rank results]})``: the 4-rank spawn and, in this
    process, the world of one."""
    inp, ref = _jax_runs()
    res = spawn("gspmd", 4, tmp_path_factory.mktemp("gspmd"), inp, timeout=240)
    out = {k: [{key.split(":", 1)[1]: v for key, v in r.items()
                if key.startswith(k + ":")} for r in res] for k in MESHES[1:]}
    out["world"] = res
    from jets_tpu_torch.parallel.gspmd import make_mesh_2d as port_mesh_2d

    one = gspmd_on(inp, port_mesh_2d(1, 1, device="cpu"))
    out["1x1"] = [{k: v.detach().numpy() if isinstance(v, torch.Tensor) else v
                   for k, v in one.items()}]
    return ref, out


def _replicated(res, key):
    for r in res[1:]:
        np.testing.assert_array_equal(r[key], res[0][key])
    return res[0][key]


def _max_close(got, ref, atol=1e-5):
    scale = float(np.max(np.abs(ref)))
    assert scale > 0.0, "vacuous: the reference is zero"
    np.testing.assert_allclose(got / scale, ref / scale, rtol=0, atol=atol)


def _halos_moved(res, key, mesh):
    """Every rank moved halos where the grid axis splits the model."""
    if mesh != "1x1":
        assert all(int(r[f"{key}_halos"]) > 0 for r in res), key


@pytest.mark.parametrize("mesh", MESHES)
def test_forward_adjoint_match_on_2d_mesh(runs, mesh):
    ref, out = runs
    res = out[mesh]
    np.testing.assert_allclose(_replicated(res, "fa_fwd"), ref["fa_fwd"], rtol=1e-12)
    np.testing.assert_allclose(_replicated(res, "fa_adj"), ref["fa_adj"], rtol=1e-12)
    _halos_moved(res, "fa_fwd", mesh)


@pytest.mark.parametrize("mesh", MESHES)
def test_lsqr_on_2d_mesh_matches_unsharded(runs, mesh):
    ref, out = runs
    res = out[mesh]
    assert abs(float(_replicated(res, "ls_resnorm")) - ref["ls_resnorm"]) \
        < 1e-9 * ref["ls_bnorm"]
    np.testing.assert_allclose(_replicated(res, "ls_x"), ref["ls_x"], rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("mesh", MESHES)
def test_3d_grid_sharded_cgls(runs, mesh):
    ref, out = runs
    np.testing.assert_allclose(_replicated(out[mesh], "cg_x"), ref["cg_x"], rtol=1e-6,
                               atol=1e-9)


@pytest.mark.parametrize("mesh", MESHES)
def test_grid_sharded_wave_propagator_parity_and_halo(runs, mesh):
    """Forward, autodiff gradient through the halo exchanges and the stored
    f32 adjoint; ``fused=True`` under a sharding K4 cannot take (the port's
    K4 takes W = 16, so the JAX test's lane case is a y-sharding here)
    raises."""
    ref, out = runs
    res = out[mesh]
    assert float(np.max(np.abs(ref["iso_fwd"]))) > 0.0, "vacuous"
    np.testing.assert_allclose(_replicated(res, "iso_fwd"), ref["iso_fwd"], rtol=2e-6,
                               atol=1e-30)
    _halos_moved(res, "iso_fwd", mesh)
    _max_close(_replicated(res, "iso_grad"), ref["iso_grad"])
    _max_close(_replicated(res, "iso_adj"), ref["iso_adj"])
    msg = str(res[0]["iso_refusal"])
    assert msg.startswith("ValueError") and "wavefield_sharding" in msg


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("physics", ["ms", "msv"])
def test_grid_sharded_multishot_block_by_grid(runs, mesh, physics):
    """The isotropic (tests/test_gspmd.py:127) and VTI (:311) multishots,
    shots over "block" and each shot's wavefield over "grid": forward and
    derived adjoint, per model block."""
    ref, out = runs
    res = out[mesh]
    assert float(np.max(np.abs(ref[f"{physics}_fwd"]))) > 0.0
    np.testing.assert_allclose(_replicated(res, f"{physics}_fwd"), ref[f"{physics}_fwd"],
                               rtol=2e-6, atol=1e-30)
    _halos_moved(res, f"{physics}_fwd", mesh)
    got, want = _replicated(res, f"{physics}_adj"), ref[f"{physics}_adj"]
    for g, w in zip(got.reshape((-1,) + GRID), want.reshape((-1,) + GRID)):
        _max_close(g, w)


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("physics", ["vti", "tti"])
def test_grid_sharded_anisotropic_propagator_parity(runs, mesh, physics):
    """tests/test_gspmd.py:154 (VTI) and :209 (TTI): forward, the stored
    two-field-history f32 adjoint of every model block, halos moved;
    ``fused=True`` under the sharding raises naming ``wavefield_sharding``,
    and TTI on a 2-D grid raises "3-D only"."""
    ref, out = runs
    res = out[mesh]
    assert float(np.max(np.abs(ref[f"{physics}_fwd"]))) > 0.0, "vacuous"
    np.testing.assert_allclose(_replicated(res, f"{physics}_fwd"), ref[f"{physics}_fwd"],
                               rtol=2e-6, atol=1e-30)
    _halos_moved(res, f"{physics}_fwd", mesh)
    for b, (g, w) in enumerate(zip(_replicated(res, f"{physics}_adj"),
                                   ref[f"{physics}_adj"])):
        assert float(np.max(np.abs(w))) > 0.0, f"vacuous adjoint block {b}"
        _max_close(g, w)
    msg = str(res[0][f"{physics}_refusal"])
    assert msg.startswith("ValueError") and "wavefield_sharding" in msg
    if physics == "tti":
        assert "3-D only" in str(res[0]["tti_2d_refusal"])


@pytest.mark.parametrize("mesh", MESHES)
def test_fused_sharded_step_parity_and_collectives(runs, mesh):
    """K4 (its plain version here) under the z-slab sharding against the
    JAX package's fused sharded run, bitwise the port's plain sharded step,
    its autodiff gradient; a sharding K4 cannot take still raises."""
    ref, out = runs
    res = out[mesh]
    assert float(np.max(np.abs(ref["fu_fwd"]))) > 0.0, "vacuous"
    np.testing.assert_allclose(_replicated(res, "fu_fwd"), ref["fu_fwd"], rtol=2e-6,
                               atol=1e-30)
    assert all(float(r["fu_vs_plain"]) == 0.0 for r in res)
    _halos_moved(res, "fu_fwd", mesh)
    _max_close(_replicated(res, "fu_grad"), ref["fu_grad"])
    msg = str(res[0]["fu_refusal"])
    assert msg.startswith("ValueError") and "wavefield_sharding" in msg


def test_mesh_2d_spans_the_world(runs):
    """``make_mesh_2d`` on 4 ranks: a mesh larger than the world raises with
    the JAX package's words; a smaller one raises too (one process runs one
    rank, so a rank outside the mesh would have nothing to do)."""
    for r in runs[1]["world"]:
        big, small = str(r["mesh_too_big"]), str(r["mesh_too_small"])
        assert big.startswith("ValueError") and "mesh 2x4 needs 8 devices, have 4" in big
        assert small.startswith("ValueError") and "spans every rank" in small
