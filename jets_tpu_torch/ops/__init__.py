"""Operator packs ported so far: the dense matrix operator (``matrix``), the
convolution, derivative and gradient operators (``conv``), the Laplacian,
constant-coefficient stencil and blur operators (``stencil``), the diagonal
operator, the off-grid Kaiser-sinc sampling operators (``sampling``), the
isotropic (sponge or CPML boundaries, off-grid acquisition), variable-density,
VTI, TTI and constant-Q acoustic wave operators (``wave``), and the
hand-written CUDA kernels of the solver tails (``cuda_solver``), of the
isotropic and constant-Q wave steps (``cuda_wave``), of the VTI steps
(``cuda_vti``) and of the TTI steps (``cuda_tti``)."""
from .conv import conv1d_operator, convnd_operator, derivative_operator, gradient_operator
from .diagonal import diagonal_operator
from .matrix import matrix_operator
from .sampling import kaiser_sinc_matrix, sinc_point_sampling_operator, sinc_sampling_operator
from .stencil import blur2d_operator, laplacian_nd, laplacian_operator, stencil_operator
from .wave import (cpml_wave_propagator, offgrid_wave_propagator, q_wave_propagator,
                   vd_wave_propagator, vdq_wave_propagator)

__all__ = ["blur2d_operator", "conv1d_operator", "convnd_operator", "cpml_wave_propagator",
           "derivative_operator", "diagonal_operator", "gradient_operator",
           "kaiser_sinc_matrix", "laplacian_nd", "laplacian_operator", "matrix_operator",
           "offgrid_wave_propagator", "q_wave_propagator", "sinc_point_sampling_operator",
           "sinc_sampling_operator", "stencil_operator", "vd_wave_propagator",
           "vdq_wave_propagator"]
