"""Operator packs ported so far: the Laplacian stencil, and the
hand-written CUDA solver-tail kernels (``cuda_solver``)."""
from .stencil import laplacian_nd, laplacian_operator

__all__ = ["laplacian_nd", "laplacian_operator"]
