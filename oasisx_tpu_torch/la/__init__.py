"""Krylov solvers, Chebyshev-Jacobi and its bounds, and the pressure PCGs."""

from .krylov import (
    KrylovResult,
    bicgstab,
    bicgstab_batched,
    cg,
    cg_batched,
    chebyshev_preconditioner,
    estimate_lmax,
    gmres,
    jacobi_preconditioner,
    validated_cheb_bounds,
)
from .solver import KSPSolver

__all__ = [
    "KrylovResult",
    "KSPSolver",
    "bicgstab",
    "bicgstab_batched",
    "cg",
    "cg_batched",
    "chebyshev_preconditioner",
    "estimate_lmax",
    "gmres",
    "jacobi_preconditioner",
    "validated_cheb_bounds",
]
