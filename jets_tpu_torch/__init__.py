"""jets_tpu_torch — the PyTorch/CUDA port of ``jets_tpu``.

The same matrix-free operator-and-solver framework, for one NVIDIA H100
(Hopper, ``sm_90a``): dense, symmetric (rfft) and block spaces with an
explicit device, immutable jets and
operators, the operator algebra (raw matrices auto-wrapped), block
operators, the correctness gates, the operator packs of the five BASELINE
configurations (matrix, convolution, derivative, gradient, stencil and blur
operators; :mod:`jets_tpu_torch.models.configs`), the FFT, DCT, structural,
signal-processing, causal, wavelet, Radon, interpolation, acquisition and
elementwise operator packs (:mod:`jets_tpu_torch.ops`), the seismic flagship, the
Krylov solvers (CG, CGLS, LSQR, LSMR, MINRES, BiCGStab, GMRES, Chebyshev)
with the normal operator and the Jacobi preconditioner
(:mod:`jets_tpu_torch.solvers`), the diagonal operator, block spaces, and
the isotropic (sponge or CPML boundaries, Ginsu windows, blocked
rematerialization, off-grid Kaiser-sinc acquisition), variable-density
(IsoDenQ), VTI and TTI anisotropic (with static Q) and constant-Q
visco-acoustic wave operators of FWI (:mod:`jets_tpu_torch.ops.wave`), the
off-grid sampling operators (:mod:`jets_tpu_torch.ops.sampling`), and the nonlinear
solvers that invert them: NLCG and L-BFGS with box bounds on the
least-squares objective, and Gauss–Newton. Plain tensor code is
PyTorch; the Pallas kernels of the JAX package are hand-written CUDA C++ in
``csrc/`` (see :mod:`jets_tpu_torch.ops.cuda_solver`,
:mod:`jets_tpu_torch.ops.cuda_wave`, :mod:`jets_tpu_torch.ops.cuda_vti` and
:mod:`jets_tpu_torch.ops.cuda_tti`), built with ``nvcc`` at first use on a
machine that has a card. Every constructor builds on the card unless the
caller passes ``device="cpu"`` (or another device). This package never
imports JAX.
"""
from .core.spaces import (
    Space,
    SymmetricSpace,
    MappedSymmetricSpace,
    symspace,
    space_of,
    zeros,
    ones,
    rand,
    randn,
    randperm,
    reshape,
)
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
from .core.block import (
    block_operator,
    zero_block,
    is_zero_block,
    is_block_op,
    nblocks,
    getblock,
)
from .core.verify import (
    dot_product_test,
    linearity_test,
    linearization_test,
    materialize,
)
from .kernels import has_cuda
from .ops.diagonal import diagonal_operator
from .ops.wave import (
    cpml_wave_propagator,
    multishot_q_wave_operator,
    multishot_tti_wave_operator,
    multishot_vti_wave_operator,
    offgrid_wave_propagator,
    q_wave_propagator,
    tti_wave_propagator,
    vd_wave_propagator,
    vdq_wave_propagator,
    vti_wave_propagator,
)
from . import utils  # noqa: E402

__version__ = "0.1.0"
