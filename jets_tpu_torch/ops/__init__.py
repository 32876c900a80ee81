"""Operator packs ported so far: the Laplacian stencil, the diagonal
operator, the isotropic, VTI, TTI and constant-Q acoustic wave operators
(``wave``), and the hand-written CUDA kernels of the solver tails
(``cuda_solver``), of the isotropic and constant-Q wave steps
(``cuda_wave``), of the VTI steps (``cuda_vti``) and of the TTI steps
(``cuda_tti``)."""
from .diagonal import diagonal_operator
from .stencil import laplacian_nd, laplacian_operator
from .wave import q_wave_propagator

__all__ = ["diagonal_operator", "laplacian_nd", "laplacian_operator",
           "q_wave_propagator"]
