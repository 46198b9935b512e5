"""Krylov solvers and the pressure MG-PCG."""

from .krylov import KrylovResult, bicgstab_batched, cg, cg_batched, jacobi_preconditioner
from .solver import KSPSolver

__all__ = [
    "KrylovResult",
    "KSPSolver",
    "bicgstab_batched",
    "cg",
    "cg_batched",
    "jacobi_preconditioner",
]
