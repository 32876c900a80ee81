"""Every public constructor of the port builds on the CUDA card unless the
caller asks for another device: ``device`` defaults to None, which
:func:`jets_tpu_torch.core.spaces.resolve_device` turns into
``torch.device("cuda")``. Where there is no card, leaving the device out
raises; nothing falls back to the CPU.

The tests decide nothing at import time: the card's presence is patched
inside each test, so every worker collects the same tests.
"""
import inspect

import numpy as np
import pytest
import torch

import jets_tpu_torch as tt
from jets_tpu_torch.core.spaces import resolve_device
from jets_tpu_torch.models import configs, seismic
from jets_tpu_torch.ops import conv, diagonal, matrix, sampling, stencil, wave

CONSTRUCTORS = {
    "Space": tt.Space,
    "laplacian_operator": stencil.laplacian_operator,
    "seismic_operator_from_arrays": seismic.seismic_operator_from_arrays,
    "make_seismic_operator": seismic.make_seismic_operator,
    "make_seismic_problem": seismic.make_seismic_problem,
    "wave_propagator": wave.wave_propagator,
    "multishot_wave_operator": wave.multishot_wave_operator,
    "vti_wave_propagator": wave.vti_wave_propagator,
    "multishot_vti_wave_operator": wave.multishot_vti_wave_operator,
    "tti_wave_propagator": wave.tti_wave_propagator,
    "multishot_tti_wave_operator": wave.multishot_tti_wave_operator,
    "q_wave_propagator": wave.q_wave_propagator,
    "cpml_wave_propagator": wave.cpml_wave_propagator,
    "vd_wave_propagator": wave.vd_wave_propagator,
    "vdq_wave_propagator": wave.vdq_wave_propagator,
    "offgrid_wave_propagator": wave.offgrid_wave_propagator,
    "kaiser_sinc_matrix": sampling.kaiser_sinc_matrix,
    "diagonal_operator": diagonal.diagonal_operator,
    "matrix_operator": matrix.matrix_operator,
    "conv1d_operator": conv.conv1d_operator,
    "derivative_operator": conv.derivative_operator,
    "blur2d_operator": stencil.blur2d_operator,
    "config1_spd_cg": configs.config1_spd_cg,
    "config2_deconv_lsqr": configs.config2_deconv_lsqr,
    "config3_deblur_cgls": configs.config3_deblur_cgls,
    "config4_distributed_lsqr": configs.config4_distributed_lsqr,
    "config5_seismic3d_pod": configs.config5_seismic3d_pod,
}

# the smallest call of each constructor, device left out
CALLS = {
    "Space": lambda **kw: tt.Space((3, 4), **kw),
    "laplacian_operator": lambda **kw: stencil.laplacian_operator((4, 5), **kw),
    "seismic_operator_from_arrays": lambda **kw: seismic.seismic_operator_from_arrays(
        (16, 16), 2, 16, wr=np.ones((2, 16)), **kw),
    "make_seismic_operator": lambda **kw: seismic.make_seismic_operator((16, 16), 2, 16,
                                                                        **kw),
    "make_seismic_problem": lambda **kw: seismic.make_seismic_problem((16, 16), 2, 16,
                                                                      **kw),
    "wave_propagator": lambda **kw: wave.wave_propagator((8, 8), nt=4, **kw),
    "multishot_wave_operator": lambda **kw: wave.multishot_wave_operator(
        (8, 8), [9, 20], nt=4, **kw),
    "vti_wave_propagator": lambda **kw: wave.vti_wave_propagator((8, 8), nt=4, **kw),
    "multishot_vti_wave_operator": lambda **kw: wave.multishot_vti_wave_operator(
        (8, 8), [9, 20], nt=4, **kw),
    "tti_wave_propagator": lambda **kw: wave.tti_wave_propagator((4, 8, 8), nt=4, **kw),
    "multishot_tti_wave_operator": lambda **kw: wave.multishot_tti_wave_operator(
        (8, 8), [9, 20], nt=4, **kw),
    "q_wave_propagator": lambda **kw: wave.q_wave_propagator((4, 8, 8), nt=4, **kw),
    "cpml_wave_propagator": lambda **kw: wave.cpml_wave_propagator((8, 8), nt=4, **kw),
    "vd_wave_propagator": lambda **kw: wave.vd_wave_propagator((8, 8), nt=4, **kw),
    "vdq_wave_propagator": lambda **kw: wave.vdq_wave_propagator((8, 8), nt=4, **kw),
    "offgrid_wave_propagator": lambda **kw: wave.offgrid_wave_propagator(
        (8, 8), src_pos=(3.5, 4.2), rcv_depth=2.5, rcv_coords=[1.5, 5.5], nt=4, **kw),
    "kaiser_sinc_matrix": lambda **kw: sampling.kaiser_sinc_matrix(8, [2.5], **kw),
    "diagonal_operator": lambda **kw: diagonal.diagonal_operator(np.ones((3, 4)), **kw),
    "matrix_operator": lambda **kw: matrix.matrix_operator(np.ones((3, 4)), **kw),
    "conv1d_operator": lambda **kw: conv.conv1d_operator([1.0, 2.0], 5, **kw),
    "derivative_operator": lambda **kw: conv.derivative_operator(5, **kw),
    "blur2d_operator": lambda **kw: stencil.blur2d_operator((6, 6), **kw),
    "config1_spd_cg": lambda **kw: configs.config1_spd_cg(n=8, **kw),
    "config2_deconv_lsqr": lambda **kw: configs.config2_deconv_lsqr(n=200, **kw),
    "config3_deblur_cgls": lambda **kw: configs.config3_deblur_cgls(side=16, **kw),
    "config4_distributed_lsqr": lambda **kw: configs.config4_distributed_lsqr(
        nblocks=2, grid=(16, 16), nrecv=16, **kw),
    "config5_seismic3d_pod": lambda **kw: configs.config5_seismic3d_pod(
        nshots=2, grid=(8, 8, 8), nrecv=8, **kw),
}


def _no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.mark.parametrize("name", sorted(CONSTRUCTORS))
def test_device_defaults_to_none(name):
    param = inspect.signature(CONSTRUCTORS[name]).parameters["device"]
    assert param.default is None


@pytest.mark.parametrize("name", sorted(CALLS))
def test_leaving_the_device_out_without_a_card_raises(name, monkeypatch):
    _no_card(monkeypatch)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CALLS[name]()


@pytest.mark.parametrize("name", sorted(CALLS))
def test_asking_for_the_cpu_builds_there(name):
    op = CALLS[name](device="cpu")
    if isinstance(op, tuple):  # make_seismic_problem (A, m, d), configs (A, solve, d, info)
        op = op[0]
    sp = op if isinstance(op, (tt.Space, torch.Tensor)) else op.dom  # a tensor: the matrix
    assert sp.device == torch.device("cpu")


def test_resolve_device_is_the_card_and_never_falls_back(monkeypatch):
    assert resolve_device("cpu") == torch.device("cpu")
    assert resolve_device(torch.device("cuda", 1)) == torch.device("cuda", 1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert resolve_device(None) == torch.device("cuda")
    assert tt.Space((2,)).device == torch.device("cuda")
    _no_card(monkeypatch)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device(None)
