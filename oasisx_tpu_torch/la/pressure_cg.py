"""Jacobi- and Chebyshev-Jacobi-preconditioned CG for the pressure Poisson.

The plain-tensor counterpart of the whole-solve TPU kernel
``make_pressure_cg(..., mg=None)`` (``oasisx_tpu/assembly/pallas_ops.py``),
the pressure solve of a structured grid that does not coarsen (any odd
cell count) or of ``options["pallas_pressure_pc"] != "mg"``:

- preconditioner z = D^-1 r (``cheb_degree`` 0), or a degree-``cheb_degree``
  Chebyshev acceleration of Jacobi with bounds [lmin, lmax] of D^-1 A
  (``krylov.chebyshev_preconditioner``, the recurrence the MG-PCG's
  coarsest level runs too); z is not demeaned;
- the singular Neumann operator handled by demeaning b, every operator
  application and the final iterate;
- the result ``(x, iters, resnorm, converged)``.

``solve`` sends a CUDA tensor to the whole-solve kernel of
``csrc/krylov_ops.cu`` (K1's non-MG modes: the CG loop, the Chebyshev
recurrence and every reduction on the card, no host read; its products on
the P1 stencil tile, two grid barriers an iteration where the Chebyshev
steps' box fits, ``oasisx_pressure_cg_plan``; a work buffer of 9 vectors)
and a CPU tensor to ``solve_plain``, the plain version: ``krylov.cg`` with the nullspace
projection, its loop in Python on the CPU, every ``Ap`` application through the
operator it is given (by default the constant-cube kernel's wrapper
``assembly.kernels.matvec_const``).  Launches and plain calls count under
``pressure_cg`` in ``assembly.kernels``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..assembly import kernels as kn
from .krylov import KrylovResult, cg, chebyshev_preconditioner


class PressureCG:
    """``solve(b, x0)`` on the P1 pressure grid vector (npad_q,).

    ``inv_diag`` is the Jacobi inverse diagonal, kept in the operator's
    dtype; ``cheb_degree`` 0 is Jacobi, and a degree above 0 needs
    ``lmin < lmax``."""

    def __init__(self, sm_q, Ap_c: torch.Tensor, inv_diag, rtol: float, maxiter: int,
                 cheb_degree: int = 0, lmin: float = 0.0, lmax: float = 0.0):
        if cheb_degree < 0 or (cheb_degree > 0 and not lmin < lmax):
            raise ValueError(f"Chebyshev degree {cheb_degree} with bounds [{lmin}, {lmax}]")
        self.sm = sm_q
        self.d = len(sm_q[1])
        self.cells = tuple(int(c) for c in sm_q[1])
        self.n = int(np.prod(sm_q[0]))
        self.Ap_c = Ap_c.contiguous()
        self.invd = torch.as_tensor(inv_diag, device=Ap_c.device).to(Ap_c.dtype).reshape(-1)
        self.invd = self.invd.contiguous()
        self.rtol = float(rtol)
        self.maxiter = int(maxiter)
        self.cheb_degree = int(cheb_degree)
        self.lmin, self.lmax = float(lmin), float(lmax)

    def solve(self, b: torch.Tensor, x0: torch.Tensor) -> KrylovResult:
        """K1 on a CUDA tensor, ``solve_plain`` on the CPU."""
        if not kn._route(b, x0, self.Ap_c):
            return self.solve_plain(b, x0)
        with torch.cuda.device(b.device):
            return self._solve_kernel(b, x0)

    def _solve_kernel(self, b: torch.Tensor, x0: torch.Tensor) -> KrylovResult:
        dev, dt = b.device, b.dtype
        n = self.n
        kn._check(b, "b", dt, (n,))
        kn._check(x0, "x0", dt, (n,))
        kn._check(self.Ap_c, "Ap_c", dt, tuple(self.Ap_c.shape))
        kn._check(self.invd, "invd", dt, (n,))
        x = torch.empty(n, dtype=dt, device=dev)
        work = torch.empty(9 * n, dtype=dt, device=dev)
        red = torch.empty(2 * 8 * kn.coop_capacity(dev), dtype=dt, device=dev)
        iters = torch.empty(1, dtype=torch.int32, device=dev)
        rnorm = torch.empty(1, dtype=dt, device=dev)
        conv = torch.empty(1, dtype=torch.int32, device=dev)
        p = kn._ptr
        cells = self.cells + (0,) * (3 - self.d)
        kn._call("pressure_cg", p(self.Ap_c), p(b), p(x0), p(self.invd), p(x), p(work), p(red),
                 red.numel() // 16, p(iters), p(rnorm), p(conv), int(dt == torch.float64),
                 self.d, *cells, self.cheb_degree, self.lmin, self.lmax, self.rtol,
                 self.maxiter, kn._stream(b))
        return KrylovResult(x, iters[0], rnorm[0], conv[0] != 0, 0)

    def solve_plain(self, b: torch.Tensor, x0: torch.Tensor, matvec=None) -> KrylovResult:
        """The plain version of K1's non-MG modes; ``matvec(x (1, n), C, sm)``
        applies the operator (default ``assembly.kernels.matvec_const``)."""
        kn.plain_calls["pressure_cg"] += 1
        mv = matvec or kn.matvec_const
        A = lambda v: mv(v.view(1, -1), self.Ap_c, self.sm).view(-1)
        if self.cheb_degree == 0:
            M = lambda r: self.invd * r
        else:
            M = chebyshev_preconditioner(A, self.invd, self.lmin, self.lmax, self.cheb_degree)
        return cg(A, b, x0, M, rtol=self.rtol, maxiter=self.maxiter, project_nullspace=True)
