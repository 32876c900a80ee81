"""The REAL multi-process path of the port's distribution layer
(tests/test_multiprocess.py for the port): 2 and 4 gloo ranks, each with
a genuinely partial block range, creating only its own shots' data
(host-local IO), assembling its slab and running a distributed LSQR; the
result is held against the JAX package's single-process solve on its 8
virtual devices with the same weights (lifted from the JAX operator) and
the same per-shot data.

The two runs share the math but not the reduction order (each rank sums
its shots, then the ranks add), so agreement is up to Krylov rounding
sensitivity, with the tolerances of tests/test_multiprocess.py: the
residual norm ``rtol 1e-7``, the iterate ``atol 5e-3`` of its max.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_mp_worker import spawn
from jets_tpu.models.seismic import make_seismic_operator
from jets_tpu.parallel import runner
from jets_tpu.parallel.sharded import make_block_mesh
from jets_tpu.solvers import lsqr

NSHOTS, NRECV, GRID = 16, 64, (12, 12)


@pytest.fixture(scope="module")
def reference():
    """The single-process solve on the 8 virtual devices, and its weights."""
    mesh = make_block_mesh(8)
    A = make_seismic_operator(GRID, NSHOTS, NRECV, jax.random.PRNGKey(3), mesh=mesh,
                              dtype=jnp.float64)
    d_local = np.stack([np.random.default_rng(1000 + s).standard_normal(NRECV)
                        for s in range(NSHOTS)])
    d = runner.assemble_global(d_local, (NSHOTS, NRECV), mesh)
    res = lsqr(A, d, maxiter=40, tol=0.0)
    wr = np.asarray(A.jet.state["bstate"]["wr"])
    return wr, np.asarray(res.x.addressable_data(0)), float(res.resnorm)


@pytest.mark.parametrize("nprocs", [2, 4])
def test_multi_process_lsqr_matches_single_process(tmp_path, reference, nprocs):
    wr, want_x, want_rn = reference
    res = spawn("multiprocess", nprocs, tmp_path, {"wr": wr, "grid": np.array(GRID)})
    per = NSHOTS // nprocs
    for r, got in enumerate(res):
        # each rank loaded only its own slab of shots
        assert (int(got["lo"]), int(got["hi"])) == (r * per, (r + 1) * per)
        # the model is replicated: every rank holds the whole solution
        np.testing.assert_array_equal(got["x"], res[0]["x"])
        np.testing.assert_allclose(float(got["resnorm"]), want_rn, rtol=1e-7)
        np.testing.assert_allclose(got["x"], want_x, atol=5e-3 * float(np.abs(want_x).max()))
