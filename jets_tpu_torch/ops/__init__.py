"""Operator packs ported so far: the Laplacian stencil, the isotropic
acoustic wave operators (``wave``), and the hand-written CUDA kernels of
the solver tail (``cuda_solver``) and of the wave steps (``cuda_wave``)."""
from .stencil import laplacian_nd, laplacian_operator

__all__ = ["laplacian_nd", "laplacian_operator"]
