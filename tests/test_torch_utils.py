"""The port's ``utils`` layer (jets_tpu_torch/utils: hashing, checkpoint,
guards, profiling, shot-gather loader) held against jets_tpu.utils on the
CPU: the nine cases of tests/test_utils.py, each run on the port and held
against the JAX package's function on the same inputs.

Exact, unless a test says otherwise: CRC32C values, leaf byte chains,
cost models, stored arrays and error messages are the same in both
packages. A whole ``tree_hash`` differs by design (each package hashes its
own structure string first); the leaf chain after it is compared. Solver
iterates are the port's own bits on resume and agree with JAX's CG to
``rtol=1e-10``.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import checkify

import jets_tpu_torch as tt
from jets_tpu.ops.diagonal import diagonal_operator as j_diag
from jets_tpu.ops import wave as jw
from jets_tpu.ops.matrix import matrix_operator as j_matrix
from jets_tpu.solvers import cg as j_cg
from jets_tpu.utils import checkpoint as jck
from jets_tpu.utils import dataloader as jdl
from jets_tpu.utils import guards as jg
from jets_tpu.utils import hashing as jh
from jets_tpu.utils import profiling as jp
from jets_tpu_torch.ops.diagonal import diagonal_operator
from jets_tpu_torch.ops import wave as tw
from jets_tpu_torch.ops.matrix import matrix_operator
from jets_tpu_torch.solvers import cg
from jets_tpu_torch.utils import checkpoint as tck
from jets_tpu_torch.utils import dataloader as tdl
from jets_tpu_torch.utils import guards as tg
from jets_tpu_torch.utils import hashing as th
from jets_tpu_torch.utils import profiling as tp

CPU = torch.device("cpu")  # the tests build on the CPU, as a caller asks


def test_crc32c_known_vector():
    # RFC 3720 test vector: crc32c of 32 zero bytes
    for data, want in ((b"\x00" * 32, 0x8A9136AA), (b"123456789", 0xE3069283)):
        assert th.crc32c(data) == jh.crc32c(data) == want
    data = np.random.default_rng(0).bytes(1001)
    for seed in (0, 1, 0xDEADBEEF):
        assert th.crc32c(data, seed=seed) == jh.crc32c(data, seed=seed)


def test_native_lib_matches_python():
    assert th.native(), "native crc32c failed to build (g++ present?)"
    data = bytes(range(256)) * 7 + b"tail"
    tbl = th._py_table()
    assert tbl == jh._py_table()
    crc = 0xFFFFFFFF
    for b in data:
        crc = (crc >> 8) ^ tbl[(crc ^ b) & 0xFF]
    assert th.crc32c(data) == (~crc) & 0xFFFFFFFF == jh.crc32c(data)


def test_tree_hash_sensitivity():
    x = {"a": torch.arange(10.0), "b": torch.ones((3, 3))}
    h1 = th.tree_hash(x)
    assert th.tree_hash(x) == h1  # deterministic
    y = {"a": torch.arange(10.0).index_fill(0, torch.tensor([3]), 5.0),
         "b": torch.ones((3, 3))}
    assert th.tree_hash(y) != h1  # value change
    z = {"a": torch.arange(10.0), "c": torch.ones((3, 3))}
    assert th.tree_hash(z) != h1  # structure change
    # the leaf chain is JAX's over the same arrays, bfloat16 included
    rng = np.random.default_rng(1)
    arrs = [rng.standard_normal((4, 5)), rng.standard_normal(7).astype(np.float32),
            np.arange(6, dtype=np.int64)]
    leaves_t = [torch.from_numpy(a) for a in arrs] + [
        torch.from_numpy(arrs[1]).to(torch.bfloat16)]
    leaves_j = [jnp.asarray(a) for a in arrs] + [jnp.asarray(arrs[1]).astype(jnp.bfloat16)]
    ht = hj = 12345
    for lt, lj in zip(leaves_t, leaves_j):
        assert th._leaf_bytes(lt) == jh._array_bytes(lj)
        ht, hj = th.crc32c(th._leaf_bytes(lt), seed=ht), jh.crc32c(jh._array_bytes(lj), seed=hj)
        assert ht == hj


def _spd(n):
    M = np.array(jax.random.normal(jax.random.PRNGKey(0), (n, n), jnp.float64))
    b = np.array(jax.random.normal(jax.random.PRNGKey(1), (n,), jnp.float64))
    return M @ M.T + n * np.eye(n), b


def test_checkpoint_solver_resume(tmp_path):
    A_np, b_np = _spd(32)
    A, b = matrix_operator(A_np, device=CPU), torch.from_numpy(b_np)
    half = cg(A, b, maxiter=10, tol=0.0)
    p = os.path.join(tmp_path, "cg_state.npz")
    h = tck.save_checkpoint(p, half.state, meta={"iteration": int(half.iterations)})
    assert h == th.tree_hash(half.state)
    state, meta = tck.load_checkpoint(p, like=half.state)
    assert meta["crc32c"] == h and meta["iteration"] == 10
    assert type(state) is type(half.state) and state.i == half.state.i
    resumed = cg(A, b, maxiter=20, tol=0.0, state=state)
    full = cg(A, b, maxiter=20, tol=0.0)
    assert torch.equal(resumed.x, full.x)
    # the same npz layout as the JAX package's, and JAX's CG
    with np.load(p) as z:
        assert {"__treedef__", "__meta__"} <= set(z.files)
        np.testing.assert_array_equal(z["leaf_0"], half.state.x.numpy())
    jfull = j_cg(j_matrix(jnp.asarray(A_np)), jnp.asarray(b_np), maxiter=20, tol=0.0)
    ref = np.asarray(jfull.x)
    np.testing.assert_allclose(full.x.numpy(), ref, rtol=0,
                               atol=1e-10 * np.max(np.abs(ref)))


def test_checkpoint_detects_corruption(tmp_path):
    x = {"m": torch.arange(64.0, dtype=torch.float64)}
    p, pj = os.path.join(tmp_path, "m.npz"), os.path.join(tmp_path, "mj.npz")
    tck.save_checkpoint(p, x)
    jck.save_checkpoint(pj, {"m": jnp.arange(64.0)})
    with np.load(p) as z, np.load(pj) as zj:
        np.testing.assert_array_equal(z["leaf_0"], zj["leaf_0"])  # the same stored leaf
        data = dict(z)
    data["leaf_0"] = data["leaf_0"].copy()
    data["leaf_0"][0] = 999.0
    with open(p, "wb") as f:
        np.savez(f, **data)
    with pytest.raises(ValueError, match="hash mismatch"):
        tck.load_checkpoint(p, like=x)
    # a bfloat16 leaf round-trips bit for bit; None stores no leaf, as in JAX
    y = {"n": None, "w": torch.linspace(-3, 3, 11).to(torch.bfloat16)}
    tck.save_checkpoint(p, y)
    jck.save_checkpoint(pj, {"n": None, "w": jnp.linspace(-3, 3, 11).astype(jnp.bfloat16)})
    with np.load(p) as z, np.load(pj) as zj:
        assert sorted(z.files) == sorted(zj.files)
    got, _ = tck.load_checkpoint(p, like=y)
    assert got["n"] is None and got["w"].dtype == torch.bfloat16
    assert torch.equal(got["w"], y["w"])
    assert th.tree_hash(y) == th.tree_hash({"n": None, "w": got["w"].clone()})


def test_instrument_perfstat():
    w = np.arange(1.0, 9.0)
    D = diagonal_operator(w, device=CPU)
    Di = tp.instrument(D)
    stat = tt.perfstat(Di)
    assert stat["bytes_in"] == 8 * 8 and stat["bytes_out"] == 8 * 8
    assert stat == jp.op_cost(j_diag(jnp.asarray(w)))
    assert tp.op_cost(D, flops_per_elem=3.0) == jp.op_cost(j_diag(jnp.asarray(w)),
                                                           flops_per_elem=3.0)
    # surfaces through combinators like the reference perfstat
    C = D @ Di
    assert tt.perfstat(C) == stat
    with pytest.raises(TypeError):
        tp.instrument(D.H)


def test_guards_detect_nonfinite():
    bad = diagonal_operator(np.array([1.0, np.inf, 3.0]), device=CPU)
    ok = diagonal_operator(np.array([1.0, 2.0, 3.0]), device=CPU)
    m = torch.ones(3, dtype=torch.float64)
    err, _ = checkify.checkify(lambda: jg.checked(j_diag(jnp.array([1.0, jnp.inf, 3.0])),
                                                  "bad")(jnp.ones(3)))()
    with pytest.raises(Exception) as ej:
        err.throw()
    with pytest.raises(FloatingPointError) as et:  # a linear apply is its tangent
        tg.checked(bad, "bad")(m)
    assert str(et.value) == "non-finite output of bad.tangent"
    assert str(et.value) in str(ej.value)
    with pytest.raises(FloatingPointError, match="non-finite output of bad.adjoint"):
        tg.checked(bad, "bad").H(m)
    nan_m = torch.tensor([1.0, float("nan"), 1.0], dtype=torch.float64)
    with pytest.raises(FloatingPointError, match="non-finite output of ok.tangent"):
        tg.checked(ok, "ok")(nan_m)
    # a nonlinear operator's apply is its forward; its Jacobian's adjoint is derived
    kw = dict(nt=4, sponge_width=1, src_idx=27)
    Fj = jg.checked(jw.wave_propagator((8, 8), dtype=jnp.float64, **kw), "F")
    err, _ = checkify.checkify(lambda: Fj(jnp.full((8, 8), jnp.nan)))()
    with pytest.raises(Exception) as ej:
        err.throw()
    F = tg.checked(tw.wave_propagator((8, 8), dtype=torch.float64, device=CPU, **kw), "F")
    c = torch.full((8, 8), 1500.0, dtype=torch.float64)
    with pytest.raises(FloatingPointError) as et:
        F(torch.full_like(c, float("nan")))
    assert str(et.value) == "non-finite output of F.forward" and str(et.value) in str(ej.value)
    with pytest.raises(FloatingPointError, match="non-finite output of F.adjoint"):
        F.linearize(c).H(torch.full(F.rng.shape, float("inf"), dtype=torch.float64))
    assert torch.equal(F(c), tw.wave_propagator((8, 8), dtype=torch.float64, device=CPU,
                                                **kw)(c))
    out = tg.checked(ok, "ok")(m)
    assert torch.equal(out, ok(m)) and torch.equal(tg.checked(ok, "ok").H(m), ok.H(m))
    with pytest.raises(TypeError):
        tg.checked(ok.H, "okH")
    with pytest.raises(FloatingPointError, match="NaN") as et:
        tg.assert_finite({"x": torch.tensor([1.0, float("nan")])}, "state")
    with pytest.raises(FloatingPointError) as ej:
        jg.assert_finite({"x": jnp.array([1.0, jnp.nan])}, "state")
    assert str(et.value) == str(ej.value)


def test_shot_gather_loader_roundtrip(tmp_path):
    data = np.arange(16 * 5 * 7, dtype=np.float32).reshape(16, 5, 7)
    p = os.path.join(tmp_path, "shots.bin")
    store = tdl.ShotGatherStore.create(p, torch.from_numpy(data))
    loader = tdl.ShotGatherLoader(store, batch_shots=4, queue_depth=2)
    assert loader.native, "native loader failed to build"
    got = {}
    for idx, block in loader:
        assert block.shape == (4, 5, 7)
        got[idx] = block
    assert sorted(got) == [0, 1, 2, 3]
    np.testing.assert_array_equal(np.concatenate([got[i] for i in range(4)]), data)
    # second pass works (fresh handle), bad batch size raises
    assert sum(1 for _ in loader) == 4
    with pytest.raises(ValueError):
        tdl.ShotGatherLoader(store, batch_shots=3)
    # device_put: tensors on the device asked for
    for idx, block in tdl.ShotGatherLoader(store, batch_shots=8, device_put=True,
                                           device="cpu"):
        assert isinstance(block, torch.Tensor) and block.device == CPU
        assert torch.equal(block, torch.from_numpy(data[8 * idx:8 * idx + 8]))
    # each package reads the other's stores
    pj = os.path.join(tmp_path, "shots_jax.bin")
    jdl.ShotGatherStore.create(pj, jnp.asarray(data))
    for a, b in ((tdl.ShotGatherStore(pj), jdl.ShotGatherLoader),
                 (jdl.ShotGatherStore(p), tdl.ShotGatherLoader)):
        blocks = [blk for _, blk in b(a, batch_shots=4)]
        np.testing.assert_array_equal(np.concatenate(blocks), data)
    with open(p + ".json") as f, open(pj + ".json") as fj:
        assert f.read() == fj.read()


@pytest.mark.parametrize("loader_of", [tdl, jdl], ids=["port", "jax"])
def test_loader_short_read_raises(tmp_path, loader_of):
    # a truncated/corrupt store written by the port must surface an error,
    # never yield zero-filled data as if it were real observations, in the
    # port's loader and in the JAX package's
    data = np.arange(4 * 8, dtype=np.float32).reshape(4, 8)
    path = str(tmp_path / "shots.bin")
    tdl.ShotGatherStore.create(path, data)
    with open(path, "r+b") as f:
        f.truncate(int(2.5 * 8 * 4))  # 2.5 blocks
    loader = loader_of.ShotGatherLoader(loader_of.ShotGatherStore(path), batch_shots=1)
    seen = []
    with pytest.raises((IOError, ValueError)):
        for idx, block in loader:
            seen.append(idx)
            np.testing.assert_array_equal(block[0], data[idx])
    assert len(seen) <= 2  # only the intact blocks were delivered


def test_profiling_trace_writes_a_chrome_trace(tmp_path):
    D = diagonal_operator(np.arange(1.0, 9.0), device=CPU)
    with tp.trace(str(tmp_path)) as prof:
        D(torch.ones(8, dtype=torch.float64))
    files = os.listdir(tmp_path)
    assert len(files) == 1 and files[0].endswith(".json")
    assert any("aten::mul" in e.key for e in prof.key_averages())
