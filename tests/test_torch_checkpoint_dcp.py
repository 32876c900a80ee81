"""The sharded checkpoint pair of the port (``utils.checkpoint.
save_checkpoint_orbax`` / ``load_checkpoint_orbax``, the names of the JAX
package's orbax pair over ``torch.distributed.checkpoint``).

In one process with no group: tests/test_precond.py:75's tree (the JAX
package's draw of ``x``, ones, a 0-d int) comes back with equal values,
ints and 0-d tensors included. Across worlds (``tests/_torch_mp_worker.py``,
batteries ``dcp_save`` and ``dcp_load``): the LSQR state of the
grid-sharded seismic problem, saved by 2 gloo ranks on a (1, 2) mesh (each
its slabs), is loaded by a world of one into whole tensors and by 4 ranks
on a (2, 2) mesh into their slabs, each equal to the state the 2 ranks
gathered; LSQR resumed from the 4-rank load runs on.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jets_tpu as jt
from _torch_mp_worker import spawn
from jets_tpu_torch.solvers.krylov import LSQRState
from jets_tpu_torch.utils import load_checkpoint_orbax, save_checkpoint_orbax

KEY = jax.random.PRNGKey(0)


def test_orbax_checkpoint_roundtrip(tmp_path):
    sp = jt.Space((16, 8), jnp.float32)
    x = torch.from_numpy(np.array(sp.randn(KEY)))
    state = {"x": x, "r": torch.ones(16, 8), "i": torch.tensor(7), "n": 3}
    path = str(tmp_path / "ckpt")
    save_checkpoint_orbax(path, state)
    like = {"x": torch.zeros(16, 8), "r": torch.zeros(16, 8), "i": torch.tensor(0), "n": 0}
    back = load_checkpoint_orbax(path, like)
    for k in ("x", "r", "i"):
        assert back[k].dtype == state[k].dtype and torch.equal(back[k], state[k])
    assert back["n"] == 3 and type(back["n"]) is int
    with pytest.raises(ValueError, match="structure"):
        load_checkpoint_orbax(path, {"x": torch.zeros(16, 8)})


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dcp")
    inp = {"path": np.array(str(tmp / "lsqr_state"))}
    saved = spawn("dcp_save", 2, tmp, inp)
    loaded = spawn("dcp_load", 4, tmp, inp)
    return str(tmp / "lsqr_state"), saved, loaded


def _equal(got, want):
    for k in ("x", "u", "v", "w", "alpha", "phibar", "rhobar"):
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=k)
    assert int(got["i"]) == int(want["i"]) == 5


def test_two_rank_checkpoint_loads_in_a_world_of_one(worlds):
    path, saved, _ = worlds
    for r in saved[1:]:
        _equal(r, saved[0])
    z = lambda *s: torch.zeros(s, dtype=torch.float64)  # noqa: E731
    like = LSQRState(x=z(8, 10, 6), u=z(4, 24), v=z(8, 10, 6), w=z(8, 10, 6),
                     alpha=z(), phibar=z(), rhobar=z(), i=0)
    back = load_checkpoint_orbax(path, like)
    assert type(back) is LSQRState and type(back.i) is int
    _equal({k: getattr(back, k).numpy() if k != "i" else back.i for k in LSQRState._fields},
           saved[0])


def test_two_rank_checkpoint_reshards_onto_four_ranks(worlds):
    _, saved, loaded = worlds
    for r in loaded:
        _equal(r, saved[0])
        np.testing.assert_array_equal(r["resumed_x"], loaded[0]["resumed_x"])
    assert np.all(np.isfinite(loaded[0]["resumed_x"]))
    assert not np.array_equal(loaded[0]["resumed_x"], saved[0]["x"])
