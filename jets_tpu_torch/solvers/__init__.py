from .krylov import (
    BiCGStabState,
    CGLSState,
    CGState,
    ChebyshevState,
    GMRESState,
    LSMRState,
    LSQRState,
    MINRESState,
    SolveResult,
    bicgstab,
    cg,
    cgls,
    chebyshev,
    estimate_spectral_bounds,
    gmres,
    lsmr,
    lsqr,
    minres,
)
from .gauss_newton import GNResult, gauss_newton
from .nonlinear import (
    LBFGSState,
    NLCGState,
    OptResult,
    lbfgs,
    least_squares_objective,
    nlcg,
)
from .precond import estimate_diagonal, jacobi_preconditioner, normal_operator

__all__ = ["cg", "cgls", "lsqr", "lsmr", "minres", "gmres", "bicgstab",
           "chebyshev", "estimate_spectral_bounds",
           "CGState", "CGLSState", "LSQRState", "LSMRState", "MINRESState",
           "GMRESState", "BiCGStabState", "ChebyshevState", "SolveResult",
           "normal_operator", "estimate_diagonal", "jacobi_preconditioner",
           "nlcg", "lbfgs", "least_squares_objective", "NLCGState", "LBFGSState",
           "OptResult", "gauss_newton", "GNResult"]
