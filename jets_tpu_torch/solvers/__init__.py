from .krylov import LSQRState, SolveResult, lsqr

__all__ = ["lsqr", "LSQRState", "SolveResult"]
