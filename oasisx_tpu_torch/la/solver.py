"""PETSc-options-shaped solver configuration.

The option mapping of the JAX package's ``KSPSolver``
(``oasisx_tpu/la/solver.py``), itself the equivalent of the reference's
``KSPSolver`` (src/oasisx/ksp.py:14-91): plain nested dicts with PETSc
option names, translated to a Krylov method and tolerances.

    ksp_type: cg | bcgs/bicgstab | gmres/fgmres | preonly
    pc_type:  jacobi | none | lu   (lu / preonly -> tight Krylov)
    ksp_rtol / ksp_atol / ksp_max_it
"""

from __future__ import annotations

import logging


class KSPSolver:
    """Config container for one linear solve family."""

    def __init__(self, options: dict | None = None, prefix: str = "", symmetric: bool = True):
        self.prefix = prefix
        self.symmetric = symmetric
        self.options: dict = dict(options or {})

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
