"""Every public constructor of the port builds on the CUDA card unless the
caller asks for another device: ``device`` defaults to None, which
:func:`jets_tpu_torch.core.spaces.resolve_device` turns into
``torch.device("cuda")``. Where there is no card, leaving the device out
raises; nothing falls back to the CPU. A constructor that takes a space
builds on the space's device (its tables too), so its call builds the
space with the device keywords.

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
from jets_tpu_torch.ops import (acquisition, causal, conv, diagonal, dsp, elementwise, fft,
                                interp, matrix, radon, sampling, stencil, transforms, wave,
                                wavelet)

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
    "SymmetricSpace": tt.SymmetricSpace,
    "MappedSymmetricSpace": tt.MappedSymmetricSpace,
    "symspace": tt.symspace,
    "radon_operator": radon.radon_operator,
    "blend_operator": acquisition.blend_operator,
    "projection_operator": transforms.projection_operator,
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
    "SymmetricSpace": lambda **kw: tt.SymmetricSpace((5,), (8,), **kw),
    "MappedSymmetricSpace": lambda **kw: tt.MappedSymmetricSpace(
        (3,), (4,), index_map=lambda out: ((4 - out[0]) % 4,), **kw),
    "symspace": lambda **kw: tt.symspace((3,), (4,), index_map=lambda out: ((4 - out[0]) % 4,),
                                         **kw),
    "radon_operator": lambda **kw: radon.radon_operator(8, [0.0, 10.0], [0.0, 1e-3], **kw),
    "blend_operator": lambda **kw: acquisition.blend_operator(2, 4, [0, 3], 8, **kw),
    "projection_operator": lambda **kw: transforms.projection_operator(np.ones((1, 4)), **kw),
}


def _on(build):
    """A constructor that takes a space: the space is built with the
    device keywords, so leaving them out builds on the card."""
    return lambda **kw: build(tt.Space((4, 8), **kw))


def _on_complex(build):
    return lambda **kw: build(tt.Space((4, 8), torch.complex64, **kw))


# every constructor of the operator packs that takes a space
CALLS.update({
    "fft_operator": _on_complex(fft.fft_operator),
    "rfft_operator": _on(fft.rfft_operator),
    "dct_operator": _on(transforms.dct_operator),
    "identity_operator": _on(transforms.identity_operator),
    "pad_operator": _on(lambda sp: transforms.pad_operator(sp, [(1, 0), (0, 2)])),
    "restriction_operator": _on(lambda sp: transforms.restriction_operator(sp, [(0, 2), (1, 5)])),
    "reshape_operator": _on(lambda sp: transforms.reshape_operator(sp, (8, 4))),
    "real_operator": _on_complex(transforms.real_operator),
    "imag_operator": _on_complex(transforms.imag_operator),
    "transpose_operator": _on(lambda sp: transforms.transpose_operator(sp, (1, 0))),
    "flip_operator": _on(lambda sp: transforms.flip_operator(sp, (1,))),
    "permutation_operator": _on(lambda sp: transforms.permutation_operator(sp, np.arange(32))),
    "circshift_operator": _on(lambda sp: transforms.circshift_operator(sp, (1, -2))),
    "taper_operator": _on(lambda sp: dsp.taper_operator(sp, (1, 2))),
    "bandpass_operator": _on(lambda sp: dsp.bandpass_operator(sp, 0.004, 5.0, 40.0)),
    "shift_operator": _on(lambda sp: dsp.shift_operator(sp, 1.5)),
    "resample_operator": _on(lambda sp: dsp.resample_operator(sp, 4)),
    "mute_operator": _on(lambda sp: dsp.mute_operator(sp, np.ones((4, 8)))),
    "mix_operator": _on(lambda sp: dsp.mix_operator(sp, (1, 3))),
    "roughness_operator": _on(lambda sp: dsp.roughness_operator(sp, (3, 1))),
    "envelope_operator": _on(dsp.envelope_operator),
    "translation_operator": _on(lambda sp: dsp.translation_operator(sp, (1.0, 0.5))),
    "integration_operator": _on(lambda sp: causal.integration_operator(sp, 0.9)),
    "difference_operator": _on(causal.difference_operator),
    "nim_operator": _on(causal.nim_operator),
    "wavelet_operator": _on(lambda sp: wavelet.wavelet_operator(sp, "haar", 2)),
    "interp_operator": _on(lambda sp: interp.interp_operator(sp, [0.5, 2.5, 2.5])),
    "lmo_operator": _on(lambda sp: acquisition.lmo_operator(sp, 0.004, np.arange(4.0), 1e-3)),
    "reghost_operator": _on(lambda sp: acquisition.reghost_operator(sp, 0.004, 10.0, 5.0)),
    "square_operator": _on(elementwise.square_operator),
    "power_operator": _on(lambda sp: elementwise.power_operator(sp, 3.0)),
    "nonlinear_elementwise": _on(lambda sp: elementwise.nonlinear_elementwise(
        sp, torch.exp, torch.exp)),
    **{name: _on(getattr(elementwise, name))
       for name in ("exp_operator", "log_operator", "sqrt_operator", "tanh_operator",
                    "sigmoid_operator", "atan_operator", "sin_operator", "cos_operator")},
})


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
    if isinstance(op, tt.LinearOperator):  # its tables live there too
        assert op(op.dom.ones()).device == torch.device("cpu")


def test_resolve_device_is_the_card_and_never_falls_back(monkeypatch):
    assert resolve_device("cpu") == torch.device("cpu")
    assert resolve_device(torch.device("cuda", 1)) == torch.device("cuda", 1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert resolve_device(None) == torch.device("cuda")
    assert tt.Space((2,)).device == torch.device("cuda")
    _no_card(monkeypatch)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device(None)
