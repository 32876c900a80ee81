"""Operator packs of the port: the dense matrix operator (``matrix``), the
convolution, derivative and gradient operators (``conv``), the Laplacian,
constant-coefficient stencil and blur operators (``stencil``), the diagonal
operator, the FFT operators onto symmetric spaces (``fft``), the DCT and
the structural operators (``transforms``), the signal-processing chain
(``dsp``: taper, bandpass, shift, resample, mute, mix, roughness, envelope,
translation), the causal integration, difference and normalized
integration (``causal``), the orthonormal wavelets (``wavelet``), the
linear Radon transform (``radon``), linear interpolation (``interp``),
blending, linear moveout and the receiver ghost (``acquisition``), the
elementwise nonlinear operators (``elementwise``), the off-grid
Kaiser-sinc sampling operators (``sampling``), the isotropic (sponge or
CPML boundaries, off-grid acquisition), variable-density, VTI, TTI and
constant-Q acoustic wave operators (``wave``), and the hand-written CUDA
kernels of the solver tails (``cuda_solver``), of the isotropic and
constant-Q wave steps (``cuda_wave``), of the VTI steps (``cuda_vti``) and
of the TTI steps (``cuda_tti``)."""
from .acquisition import blend_operator, lmo_operator, reghost_operator
from .causal import difference_operator, integration_operator, nim_operator
from .conv import conv1d_operator, convnd_operator, derivative_operator, gradient_operator
from .diagonal import diagonal_operator
from .dsp import (bandpass_operator, envelope_operator, mix_operator, mute_operator,
                  resample_operator, roughness_operator, shift_operator, taper_operator,
                  translation_operator)
from .elementwise import (atan_operator, cos_operator, exp_operator, log_operator,
                          nonlinear_elementwise, power_operator, sigmoid_operator,
                          sin_operator, sqrt_operator, square_operator, tanh_operator)
from .fft import fft_operator, rfft_operator
from .interp import interp_operator
from .matrix import matrix_operator
from .radon import radon_operator
from .sampling import kaiser_sinc_matrix, sinc_point_sampling_operator, sinc_sampling_operator
from .stencil import blur2d_operator, laplacian_nd, laplacian_operator, stencil_operator
from .transforms import (circshift_operator, dct_operator, flip_operator, identity_operator,
                         imag_operator, pad_operator, permutation_operator,
                         projection_operator, real_operator, reshape_operator,
                         restriction_operator, transpose_operator)
from .wave import (born_operator, cpml_wave_propagator, multishot_tti_wave_operator,
                   multishot_vti_wave_operator, multishot_wave_operator,
                   offgrid_wave_propagator, q_wave_propagator, tti_wave_propagator,
                   vd_wave_propagator, vdq_wave_propagator, vti_wave_propagator,
                   wave_propagator)
from .wavelet import WAVELETS, wavelet_operator

__all__ = ["WAVELETS", "atan_operator", "bandpass_operator", "blend_operator",
           "blur2d_operator", "born_operator", "circshift_operator", "conv1d_operator",
           "convnd_operator",
           "cos_operator", "cpml_wave_propagator", "dct_operator", "derivative_operator",
           "diagonal_operator", "difference_operator", "envelope_operator", "exp_operator",
           "fft_operator", "flip_operator", "gradient_operator", "identity_operator",
           "imag_operator", "integration_operator", "interp_operator", "kaiser_sinc_matrix",
           "laplacian_nd", "laplacian_operator", "lmo_operator", "log_operator",
           "matrix_operator", "mix_operator", "multishot_tti_wave_operator",
           "multishot_vti_wave_operator", "multishot_wave_operator", "mute_operator",
           "nim_operator",
           "nonlinear_elementwise", "offgrid_wave_propagator", "pad_operator",
           "permutation_operator", "power_operator", "projection_operator",
           "q_wave_propagator", "radon_operator", "real_operator", "reghost_operator",
           "resample_operator", "reshape_operator", "restriction_operator",
           "rfft_operator", "roughness_operator", "shift_operator", "sigmoid_operator",
           "sin_operator", "sinc_point_sampling_operator", "sinc_sampling_operator",
           "sqrt_operator", "square_operator", "stencil_operator", "tanh_operator",
           "taper_operator", "translation_operator", "transpose_operator",
           "tti_wave_propagator", "vd_wave_propagator", "vdq_wave_propagator",
           "vti_wave_propagator", "wave_propagator", "wavelet_operator"]
