"""jets_tpu_torch — the PyTorch/CUDA port of ``jets_tpu``.

The same matrix-free operator-and-solver framework, for one NVIDIA H100
(Hopper, ``sm_90a``): spaces with an explicit device, immutable jets and
operators, the operator algebra, the correctness gates, the seismic
flagship and its LSQR solver, block spaces, and the isotropic and VTI
anisotropic wave operators of FWI (:mod:`jets_tpu_torch.ops.wave`). Plain
tensor code is PyTorch; the Pallas kernels of the JAX package on these
paths are hand-written CUDA C++ in ``csrc/`` (see
:mod:`jets_tpu_torch.ops.cuda_solver`, :mod:`jets_tpu_torch.ops.cuda_wave`
and :mod:`jets_tpu_torch.ops.cuda_vti`), built with ``nvcc`` at first use
on a machine that has a card. This package never imports JAX.
"""
from .core.spaces import Space, space_of, zeros, ones, rand, randn
from .core.blockspace import BlockSpace, BlockVector
from .core.jet import (
    Jet,
    Operator,
    LinearOperator,
    AdjointOperator,
    jet_of,
    point,
    linearize,
    jacobian,
    adjoint,
    state,
    with_state,
    perfstat,
    close,
)
from .core.algebra import compose, add, subtract, scale, vec, is_composite, is_sum
from .core.verify import (
    dot_product_test,
    linearity_test,
    linearization_test,
    materialize,
)
from .kernels import has_cuda
from .ops.wave import vti_wave_propagator, multishot_vti_wave_operator
from . import utils  # noqa: E402

__version__ = "0.1.0"
