from .krylov import (
    CGLSState,
    CGState,
    LSMRState,
    LSQRState,
    SolveResult,
    cg,
    cgls,
    lsmr,
    lsqr,
)
from .precond import estimate_diagonal, jacobi_preconditioner, normal_operator

__all__ = ["cg", "cgls", "lsqr", "lsmr", "CGState", "CGLSState", "LSQRState",
           "LSMRState", "SolveResult", "normal_operator", "estimate_diagonal",
           "jacobi_preconditioner"]
