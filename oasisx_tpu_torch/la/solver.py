"""PETSc-options-shaped solver configuration.

The option mapping of the JAX package's ``KSPSolver``
(``oasisx_tpu/la/solver.py``), itself the equivalent of the reference's
``KSPSolver`` (src/oasisx/ksp.py:14-91): plain nested dicts with PETSc
option names, translated to a Krylov method and tolerances.

    ksp_type: cg | bcgs/bicgstab | gmres/fgmres | preonly
    pc_type:  jacobi | none | lu   (lu / preonly -> tight Krylov)
              | lumped (the velocity-update family only: the weighted-
                gradient lumped update in place of the mass solve)
    ksp_rtol / ksp_atol / ksp_max_it / ksp_gmres_restart

``solve`` runs the chosen method on an operator given by ``setOperators``
(a callable and its diagonal for Jacobi); ``converged_reason`` gives
PETSc's reason of a result.
"""

from __future__ import annotations

import logging
from typing import Callable

import torch

from .krylov import KrylovResult, _reason, bicgstab, cg, gmres, jacobi_preconditioner


class KSPSolver:
    """Config container and dispatcher for one linear solve family."""

    def __init__(self, options: dict | None = None, prefix: str = "", symmetric: bool = True):
        self.prefix = prefix
        self.symmetric = symmetric
        self.options: dict = dict(options or {})
        self._matvec: Callable | None = None
        self._pc: Callable | None = None

    def setOperators(self, matvec: Callable, diag: torch.Tensor | None = None) -> None:
        """The operator of ``solve`` and its diagonal, for Jacobi."""
        self._matvec = matvec
        self._pc = None if diag is None else jacobi_preconditioner(diag)

    # --- resolved solve parameters ------------------------------------------
    @property
    def method(self) -> str:
        default = "cg" if self.symmetric else "bcgs"
        kt = str(self.options.get("ksp_type", default)).lower()
        pc = str(self.options.get("pc_type", "jacobi")).lower()
        if kt == "preonly" or pc == "lu":
            return default
        if kt in ("bcgs", "bicgstab"):
            return "bcgs"
        if kt == "cg":
            return "cg"
        if kt in ("gmres", "fgmres", "lgmres", "dgmres", "pgmres"):
            return "gmres"
        logging.getLogger("oasisx_tpu_torch").info(
            "ksp_type %r is not implemented; using %s for the %s solves",
            kt, default, self.prefix or "unnamed",
        )
        return default

    @property
    def lumped(self) -> bool:
        """The lumped (weighted-gradient) update in place of a Krylov
        solve; meaningful for the velocity update's mass solves only."""
        return (str(self.options.get("pc_type", "")).lower() == "lumped"
                or bool(self.options.get("lumped", False)))

    @property
    def gmres_restart(self) -> int:
        return int(self.options.get("ksp_gmres_restart", 30))

    @property
    def rtol(self) -> float:
        if "ksp_rtol" in self.options:
            return float(self.options["ksp_rtol"])
        kt = str(self.options.get("ksp_type", "")).lower()
        pc = str(self.options.get("pc_type", "")).lower()
        if kt == "preonly" or pc == "lu":
            return 1e-13
        return 1e-8

    @property
    def atol(self) -> float:
        return float(self.options.get("ksp_atol", 1e-50))

    @property
    def maxiter(self) -> int:
        return int(self.options.get("ksp_max_it", 5000))

    def use_jacobi(self) -> bool:
        return str(self.options.get("pc_type", "jacobi")).lower() not in ("none",)

    # --- solve ----------------------------------------------------------------
    def solve(self, b: torch.Tensor, x0: torch.Tensor | None = None,
              nullspace: bool = False) -> KrylovResult:
        if self._matvec is None:
            raise RuntimeError("setOperators must be called before solve")
        M = self._pc if (self._pc is not None and self.use_jacobi()) else None
        kw = dict(x0=x0, M=M, rtol=self.rtol, atol=self.atol, maxiter=self.maxiter)
        if self.method == "cg":
            return cg(self._matvec, b, project_nullspace=nullspace, **kw)
        if self.method == "gmres":
            return gmres(self._matvec, b, restart=self.gmres_restart, **kw)
        return bicgstab(self._matvec, b, **kw)

    @staticmethod
    def converged_reason(result: KrylovResult) -> torch.Tensor:
        """PETSc-style reason: 2 (rtol) if converged, else -3 (max_it)."""
        return _reason(result.converged, torch.zeros_like(result.converged))
