"""The sharded propagators of the port (``wavefield_sharding=``) on 2 and 4
gloo ranks, held against jets_tpu's sharded runs (tests/test_gspmd.py:63,
:154, :209 and :256) and against the port's own unsharded run.

Each world runs once per module (``tests/_torch_mp_worker.py``, battery
``slab``). On the 1-D mesh: the isotropic z-slab on two grids, (16, 8, 16)
and (16, 8, 128), each on the plain step and on the K4 route (its plain
version on the CPU), forward, tangent, autodiff gradient of ``Σ F(c)²`` and
the stored f32 and int8 adjoints. On a 2-D mesh ((1, 2) on 2 ranks, (2, 2)
on 4): iso, VTI and TTI at (16, 8, 16) under ``P(None, "grid")``, the
pencil ``P("block", "grid")`` and ``P(("block", "grid"))``, and the 2-D iso
and VTI grids (16, 16) under the pencil, nt 10: traces against the JAX
package's run on the same sharding of its 8 devices (``make_mesh_2d(4,
2)``), the int8 stored adjoint against JAX's, both bitwise the port's
unsharded plain run.

Tolerances: forwards ``rtol 2e-6`` against JAX (as tests/test_gspmd.py
holds its sharded runs) and bitwise against the port's unsharded route
(the per-point arithmetic of a slab step is the unsharded step's; the
halos bring the neighbours' exact values); gradients and stored adjoints
``atol 1e-5`` of the max against JAX. The stored adjoints are also
bitwise the port's unsharded ones: the int8 scale is the global max (one
MAX ``all_reduce`` per snapshot) and every reverse-sweep point sees the
same operands.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from jax.sharding import NamedSharding, PartitionSpec as P

from _torch_mp_worker import SPECS, spawn
from jets_tpu.ops.wave import tti_wave_propagator, vti_wave_propagator
from jets_tpu.ops.wave import wave_propagator as jax_wave_propagator
from jets_tpu.parallel.gspmd import make_mesh_2d

WORLDS = [2, 4]
CASES = {"a": ((16, 8, 16), 9), "b": ((16, 8, 128), 13)}
NT = 14


def _kw(shape):
    return dict(nt=NT, dt=8e-4, dx=10.0, freq=18.0, sponge_width=3,
                src_idx=int(np.ravel_multi_index((8, 4, shape[2] // 2), shape)),
                rcv_idx=np.array([np.ravel_multi_index((8, 4, x), shape)
                                  for x in range(shape[2])]))


def _inputs():
    inp = {}
    for case, (shape, seed) in CASES.items():
        rng = np.random.default_rng(seed)
        kw = _kw(shape)
        inp[f"{case}_shape"] = np.array(shape)
        inp[f"{case}_src"] = np.array(kw["src_idx"])
        inp[f"{case}_rcv"] = kw["rcv_idx"]
        inp[f"{case}_c"] = (1500.0 + 20.0 * rng.standard_normal(shape)).astype(np.float32)
        inp[f"{case}_dd"] = rng.standard_normal((NT, shape[2])).astype(np.float32)
        inp[f"{case}_dm"] = (50.0 * rng.standard_normal(shape)).astype(np.float32)
    for i, case in enumerate(S2_CASES):
        shape = S2_SHAPES[case]
        rng = np.random.default_rng(20 + i)
        mid = tuple(n // 2 for n in shape)
        inp[f"s2_{case}_shape"] = np.array(shape)
        inp[f"s2_{case}_src"] = np.array(np.ravel_multi_index(mid, shape))
        inp[f"s2_{case}_rcv"] = np.array([np.ravel_multi_index(mid[:-1] + (x,), shape)
                                          for x in range(shape[-1])])
        inp[f"s2_{case}_c"] = (1500.0 + 20.0 * rng.standard_normal(shape)).astype(np.float32)
        inp[f"s2_{case}_dd"] = rng.standard_normal((S2_NT, shape[-1])).astype(np.float32)
    return inp


S2_CASES = ("iso", "vti", "tti", "iso2d", "vti2d")
S2_SHAPES = {"iso": (16, 8, 16), "vti": (16, 8, 16), "tti": (16, 8, 16), "iso2d": (16, 16),
             "vti2d": (16, 16)}
S2_NT = 10
S2_MAKE = {"iso": jax_wave_propagator, "vti": vti_wave_propagator, "tti": tti_wave_propagator}
S2_VALS = {"iso": (), "vti": (0.1, 0.05), "tti": (0.1, 0.05, 0.2, 0.7)}


def _s2_jax(inp, ref):
    """The JAX package's run of each 2-D-mesh case: the traces on its 8
    devices under the case's sharding (jitted, the velocity sharded as
    tests/test_gspmd.py shards it), the int8 stored adjoint unsharded."""
    mesh = make_mesh_2d(4, 2)
    for case in S2_CASES:
        physics, shape = case[:3], S2_SHAPES[case]
        kw = dict(nt=S2_NT, dt=8e-4, dx=10.0, freq=18.0, sponge_width=3, dtype=jnp.float32,
                  src_idx=int(inp[f"s2_{case}_src"]),
                  rcv_idx=jnp.asarray(inp[f"s2_{case}_rcv"], jnp.int32))
        make = S2_MAKE[physics]
        c = jnp.asarray(inp[f"s2_{case}_c"])
        F0 = make(shape, **kw)
        m = c
        if physics != "iso":
            m = F0.dom.zeros().setblock(0, c)
            for b, v in enumerate(S2_VALS[physics], start=1):
                m = m.setblock(b, jnp.full(shape, v, jnp.float32))
        a = make(shape, store_adjoint="int8", **kw).linearize(m).H(
            jnp.asarray(inp[f"s2_{case}_dd"]))
        ref[f"s2_{case}_adj"] = np.stack([np.asarray(a)] if physics == "iso" else [
            np.asarray(a.getblock(b)) for b in range(1 + len(S2_VALS[physics]))])
        for sname in (SPECS if case in ("iso", "vti", "tti") else ("pencil",)):
            ws = NamedSharding(mesh, P(*SPECS[sname]))
            Fs = make(shape, wavefield_sharding=ws, **kw)
            m_sh = (jax.device_put(m, ws) if physics == "iso"
                    else m.setblock(0, jax.device_put(c, ws)))
            ref[f"s2_{case}_{sname}_fwd"] = np.asarray(jax.jit(lambda x: Fs(x))(m_sh))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    inp = _inputs()
    tmp = tmp_path_factory.mktemp("slab")
    return inp, {w: spawn("slab", w, tmp, inp) for w in WORLDS}


@pytest.fixture(scope="module")
def jax_ref(ranks):
    inp, _ = ranks
    ref = {}
    for case, (shape, _) in CASES.items():
        kw = dict(_kw(shape), rcv_idx=jnp.asarray(_kw(shape)["rcv_idx"], jnp.int32),
                  dtype=jnp.float32)
        c = jnp.asarray(inp[f"{case}_c"])
        dd = jnp.asarray(inp[f"{case}_dd"])
        F0 = jax_wave_propagator(shape, **kw)
        ref[f"{case}_fwd"] = np.asarray(F0(c))
        ref[f"{case}_grad"] = np.asarray(jax.grad(lambda c_: jnp.sum(F0(c_) ** 2))(c))
        for store in ("f32", "int8"):
            Fs = jax_wave_propagator(shape, store_adjoint=store, **kw)
            ref[f"{case}_{store}_adj"] = np.asarray(Fs.linearize(c).H(dd))
    _s2_jax(inp, ref)
    return ref


def _max_close(got, ref, atol):
    scale = float(np.max(np.abs(ref)))
    assert scale > 0.0, "vacuous: the reference is zero"
    np.testing.assert_allclose(got / scale, ref / scale, rtol=0, atol=atol)


def _same_on_every_rank(res, key):
    for r in res[1:]:
        np.testing.assert_array_equal(r[key], res[0][key])


@pytest.mark.parametrize("route", ["plain", "k4"])
@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("world", WORLDS)
def test_slab_forward_matches_jax_and_unsharded(ranks, jax_ref, world, case, route):
    res = ranks[1][world]
    tag = f"{case}_{route}"
    _same_on_every_rank(res, f"{tag}_fwd")  # the traces are replicated
    ref = jax_ref[f"{case}_fwd"]
    assert float(np.max(np.abs(ref))) > 0.0, "vacuous"
    np.testing.assert_allclose(res[0][f"{tag}_fwd"], ref, rtol=2e-6, atol=1e-30)
    assert all(bool(r[f"{tag}_fwd_bitwise"]) for r in res)
    assert all(bool(r[f"{tag}_jvp_bitwise"]) for r in res)


@pytest.mark.parametrize("route", ["plain", "k4"])
@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("world", WORLDS)
def test_slab_gradient_matches_jax(ranks, jax_ref, world, case, route):
    """Autodiff through the halo exchanges and the one trace all-reduce:
    each rank's slab of the gradient, assembled, is JAX's gradient."""
    res = ranks[1][world]
    _same_on_every_rank(res, f"{case}_{route}_grad")
    _max_close(res[0][f"{case}_{route}_grad"], jax_ref[f"{case}_grad"], 1e-5)


@pytest.mark.parametrize("store", ["f32", "int8"])
@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("world", WORLDS)
def test_slab_stored_adjoint_matches_jax_and_unsharded(ranks, jax_ref, world, case, store):
    res = ranks[1][world]
    for route in ("plain", "k4"):
        key = f"{case}_{route}_{store}_adj"
        _max_close(res[0][key], jax_ref[f"{case}_{store}_adj"], 1e-5)
        assert all(float(r[f"{key}_vs_unsharded"]) == 0.0 for r in res)


@pytest.mark.parametrize("world", WORLDS)
def test_slab_refuses_what_k4_cannot_take(ranks, world):
    """The port's conditions for a sharding (its K4 takes W = 16, so the TPU
    lane rule of tests/test_gspmd.py:86-87 does not apply): a slab count
    that divides its dimension, slabs no thinner than the halo, a
    sharding object. A 2-D grid and a sharding that is not z-only build
    (their parity is :func:`test_2d_mesh_slabs_match_jax_and_unsharded`);
    K4 takes neither (``fits_fused_sharded`` is False), nor float64."""
    r = ranks[1][world][0]
    msgs = dict(s.split("=", 1) for s in r["refusals"])
    for name in ("indivisible", "thin_slab", "not_a_sharding"):
        assert msgs[name].startswith("ValueError") and "wavefield_sharding" in msgs[name]
    assert msgs["not_3d"] == "none" and msgs["not_z_only"].startswith("ValueError")
    assert "twice" in msgs["not_z_only"]  # ("grid", "grid") names one axis twice
    assert bool(r["fits_ok"])
    for name in ("not_3d", "indivisible", "thin_slab", "not_z_only", "f64"):
        assert not bool(r[f"fits_{name}"])


S2_RUNS = [(case, sname) for case in S2_CASES
           for sname in (SPECS if case in ("iso", "vti", "tti") else ("pencil",))]


@pytest.mark.parametrize("case, spec", S2_RUNS)
@pytest.mark.parametrize("world", WORLDS)
def test_2d_mesh_slabs_match_jax_and_unsharded(ranks, jax_ref, world, case, spec):
    """Iso, VTI and TTI under ``P(None, "grid")``, the pencil and
    ``P(("block", "grid"))`` (and the 2-D grids under the pencil): the traces
    against the JAX package's sharded run, ``rtol 2e-6``; the int8 stored
    adjoint of every model block against JAX's, ``atol 1e-5`` of its
    scale; both bitwise the port's unsharded plain run; every rank holds its
    slab and moved halos."""
    res = ranks[1][world]
    tag = f"s2_{case}_{spec}"
    _same_on_every_rank(res, f"{tag}_fwd")
    ref = jax_ref[f"{tag}_fwd"]
    assert float(np.max(np.abs(ref))) > 0.0, "vacuous"
    np.testing.assert_allclose(res[0][f"{tag}_fwd"], ref, rtol=2e-6, atol=1e-30)
    for b, (got, want) in enumerate(zip(res[0][f"{tag}_adj"], jax_ref[f"s2_{case}_adj"])):
        _max_close(got, want, 1e-5)
    for r in res:
        assert bool(r[f"{tag}_fwd_bitwise"]) and bool(r[f"{tag}_adj_bitwise"])
        assert int(r[f"{tag}_halos"]) > 0
        assert np.prod(r[f"{tag}_local"]) < np.prod(S2_SHAPES[case])


@pytest.mark.parametrize("world", WORLDS)
def test_2d_mesh_refusals(ranks, world):
    """What stays refused, as in the JAX package: ``fused=True`` under a
    VTI or TTI sharding (JAX ``ops/wave.py:2848``), TTI on a 2-D grid ("3-D
    only"), a slab count that does not divide its dimension, a slab thinner
    than the halo, a mesh axis the mesh lacks."""
    r = ranks[1][world][0]
    for name in ("vti_fused", "tti_fused", "tti_2d", "vti_indivisible", "tti_thin",
                 "unknown_axis"):
        msg = str(r[f"s2_refuse_{name}"])
        assert msg.startswith("ValueError"), (name, msg)
        assert ("3-D only" if name == "tti_2d" else "wavefield_sharding") in msg, (name, msg)
