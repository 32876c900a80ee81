"""The isotropic z-slab propagator of the port (``wave_propagator(
wavefield_sharding=block_sharding(mesh, "grid"))``) on 2 and 4 gloo ranks,
held against jets_tpu's wave propagator (tests/test_gspmd.py:63 and :256,
for the isotropic z-slab only) and against the port's own unsharded run.

Each world runs once per module (``tests/_torch_mp_worker.py``, battery
``slab``): two grids, (16, 8, 16) and (16, 8, 128), each on the plain step
and on the K4 route (its plain version on the CPU), forward, tangent,
autodiff gradient of ``Σ F(c)²`` and the stored f32 and int8 adjoints.

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

from _torch_mp_worker import spawn
from jets_tpu.ops.wave import wave_propagator as jax_wave_propagator

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
    return inp


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
    """The port's own conditions (its K4 takes W = 16, so the TPU lane rule
    of tests/test_gspmd.py:86-87 does not apply): a 3-D grid, a slab count
    that divides D, slabs no thinner than the halo; a sharding that is not
    z-only stays ROADMAP queue 1 item 18."""
    r = ranks[1][world][0]
    msgs = dict(s.split("=", 1) for s in r["refusals"])
    for name in ("not_3d", "indivisible", "thin_slab", "not_a_sharding"):
        assert msgs[name].startswith("ValueError") and "wavefield_sharding" in msgs[name]
    assert msgs["not_z_only"].startswith("NotImplementedError")
    assert "queue 1 item 18" in msgs["not_z_only"]
    assert bool(r["fits_ok"])
    for name in ("not_3d", "indivisible", "thin_slab", "not_z_only", "f64"):
        assert not bool(r[f"fits_{name}"])
