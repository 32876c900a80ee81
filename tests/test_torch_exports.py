"""Name parity of the port's public surface with the JAX package's: every
name ``jets_tpu`` exports at its top level, from ``jets_tpu.ops``, from
``jets_tpu.utils`` (and its ``checkpoint`` module) and from
``jets_tpu.parallel.gspmd`` the port exports too, apart from the names
listed here as not ported yet (none now), each with its ROADMAP item."""
import jets_tpu
import jets_tpu.ops
import jets_tpu.utils
import jets_tpu.parallel.gspmd
import jets_tpu.utils.checkpoint
import numpy as np
import pytest
import torch

import jets_tpu_torch
import jets_tpu_torch.ops
import jets_tpu_torch.utils
import jets_tpu_torch.parallel.gspmd
import jets_tpu_torch.utils.checkpoint

# every public name is ported (the orbax pair keeps its names over
# torch.distributed.checkpoint)
NOT_PORTED = {}


def _public(mod):
    names = getattr(mod, "__all__", None)
    return set(names if names is not None else
               (n for n in dir(mod) if not n.startswith("_")))


@pytest.mark.parametrize("ref, port", [
    (jets_tpu, jets_tpu_torch),
    (jets_tpu.ops, jets_tpu_torch.ops),
    (jets_tpu.utils, jets_tpu_torch.utils),
    (jets_tpu.utils.checkpoint, jets_tpu_torch.utils.checkpoint),
    (jets_tpu.parallel.gspmd, jets_tpu_torch.parallel.gspmd),
], ids=["top", "ops", "utils", "utils.checkpoint", "parallel.gspmd"])
def test_port_exports_every_name_of_the_jax_package(ref, port):
    missing = _public(ref) - _public(port) - set(NOT_PORTED)
    assert not missing, sorted(missing)
    for name in _public(ref) - set(NOT_PORTED):
        assert getattr(port, name) is not None


def test_not_ported_names_are_still_missing():
    """The list above names only what the port really lacks: nothing, and
    the checkpoint pair it once listed is exported by both modules."""
    port = _public(jets_tpu_torch.utils.checkpoint) | _public(jets_tpu_torch.utils)
    assert not set(NOT_PORTED) & port and not NOT_PORTED
    assert {"save_checkpoint_orbax", "load_checkpoint_orbax"} <= (
        _public(jets_tpu_torch.utils.checkpoint) & _public(jets_tpu_torch.utils))


def test_wave_exports_and_reshape():
    from jets_tpu_torch.ops import (born_operator, multishot_tti_wave_operator,
                                    multishot_vti_wave_operator, multishot_wave_operator,
                                    tti_wave_propagator, vti_wave_propagator,
                                    wave_propagator)
    from jets_tpu_torch.ops import wave
    for f in (born_operator, multishot_tti_wave_operator, multishot_vti_wave_operator,
              multishot_wave_operator, tti_wave_propagator, vti_wave_propagator,
              wave_propagator):
        assert getattr(wave, f.__name__) is f
    sp = jets_tpu_torch.Space((3, 4), torch.float64, "cpu")
    x = np.arange(12.0)
    got = jets_tpu_torch.reshape(x, sp)
    ref = jets_tpu.reshape(x, jets_tpu.Space((3, 4)))
    assert got.shape == (3, 4) and got.dtype == torch.float64
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    with pytest.raises(ValueError, match="cannot reshape"):
        jets_tpu_torch.reshape(np.arange(5.0), sp)
