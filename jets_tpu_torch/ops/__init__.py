"""Operator packs ported so far: the Laplacian stencil, the isotropic and
VTI acoustic wave operators (``wave``), and the hand-written CUDA kernels
of the solver tail (``cuda_solver``), of the isotropic wave steps
(``cuda_wave``) and of the VTI steps (``cuda_vti``)."""
from .stencil import laplacian_nd, laplacian_operator

__all__ = ["laplacian_nd", "laplacian_operator"]
