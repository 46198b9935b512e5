"""L2 projection: ``Projector`` and ``LumpedProject``.

Counterpart of ``oasisx_tpu/function.py``: solves (u, v) dx = (expr, v) dx
on a target space with its own solver options, re-assembles the right-hand
side after coefficient updates, and takes Dirichlet BCs with symmetric
lifting.  ``LumpedProject`` divides by the row-sum lumped mass instead.

The mass matrix is the scalar space's, assembled once into ELL form
(``parallel.graph``); Dirichlet rows and columns are folded into its values
at set-up (identity rows, zero columns: ``engine.bc_symmetric_matvec``'s
operator).  Every product with it is K14 (``la.ell.ell_matvec``).  The
default solve, CG with Jacobi, runs the components of a vector space
together in one K16 launch (``la.ell.ell_cg``) at batch ``bs``, warm-started
from the last projection; any other ``ksp_type`` runs ``KSPSolver``'s
Krylov loop (a Python loop outside a captured step) on K14, a component
at a time.  On the CPU both run their plain
versions.
"""

from __future__ import annotations

import numpy as np
import torch

from .assembly import engine as eng
from .bcs import DirichletBC, bc_mask_and_values
from .config import real_dtype, resolve_device
from .forms.expr import Expr, QPEvaluator, _components, as_expr, padded_coordinates
from .la import KSPSolver, ell
from .la.krylov import _effective_rtol, _reason
from .parallel.graph import build_ell_assembly, ell_values
from .spaces.functionspace import Function, FunctionSpace


def fold_bc_rows(vals: torch.Tensor, cols: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """ELL values (K, n) with the rows and columns of the masked dofs
    zeroed and 1 on their diagonal slot: the operator of
    ``engine.bc_symmetric_matvec``.  The diagonal slot of a row is the one
    whose column is the row and whose value is not 0 (a padded slot holds
    0)."""
    rows = torch.arange(vals.shape[1], device=vals.device)
    diag = (cols == rows[None]) & (vals != 0)
    folded = torch.where(mask[None] | mask[cols], torch.zeros_like(vals), vals)
    return torch.where(diag & mask[None], torch.ones_like(vals), folded)


class Projector:
    """Project an expression into a (possibly vector) Lagrange/DG space.

    Args:
        function: Expr tree / Function / callable f(x) of the (3, nc, nq)
            zero-padded NumPy quadrature points, evaluated on the host.
        space: target FunctionSpace.
        bcs: optional list of DirichletBC on the target space (each
            component gets the same values).
        petsc_options: solver options (PETSc names, see la.solver).
        metadata: {'quadrature_degree': int} override.
        dtype, device: of every tensor (default: float32 on the card).
    """

    def __init__(
        self,
        function,
        space: FunctionSpace,
        bcs: list[DirichletBC] | None = None,
        petsc_options: dict | None = None,
        jit_options: dict | None = None,
        form_compiler_options: dict | None = None,
        metadata: dict | None = None,
        dtype=None,
        device=None,
    ):
        self.space = space
        self._dtype = real_dtype(dtype)
        self._device = dev = resolve_device(device)
        scalar = space.scalar_space()
        mesh = space.mesh
        deg = space.element.degree
        qdeg = (metadata or {}).get("quadrature_degree", 2 * deg + 2)
        cd, n = scalar.dofmap.cell_dofs, scalar.num_dofs
        self._ctx, _ = eng.build_device_context(mesh, scalar.element, cd, n, scalar.element, cd,
                                                n, self._dtype, dev, qdegree=qdeg)
        self._elems = eng.mass_elems(self._ctx)
        self._diag = eng.diagonal_v(self._ctx, self._elems)
        self._bcs = bcs or []
        for bc in self._bcs:
            bc.create_bc(scalar)
        mask, vals = bc_mask_and_values(self._bcs, n)
        self._mask = torch.as_tensor(mask, device=dev)
        self._bc_vals = torch.as_tensor(vals, device=dev).to(self._dtype)
        self._have_bcs = bool(mask.any())

        self._ell = build_ell_assembly(cd, n, dev)
        self._vals = ell_values(self._elems, self._ell)
        if self._have_bcs:
            self._vals = fold_bc_rows(self._vals, self._ell.cols, self._mask)

        self._function = function
        self._evaluator = QPEvaluator(mesh, qdeg, self._dtype, dev)
        self._x = Function(space, "projection", dtype=self._dtype, device=dev)
        self._b = torch.zeros((space.bs, n), dtype=self._dtype, device=dev)

        self._solver = KSPSolver(petsc_options or {}, prefix="oasis_projector", symmetric=True)
        diag = torch.where(self._mask, torch.ones_like(self._diag), self._diag)
        self._solver.setOperators(self._matvec, diag=diag)
        ones = torch.ones_like(diag)
        self._invd = torch.where(diag != 0, 1.0 / torch.where(diag != 0, diag, ones), ones)

    def _matvec(self, x):
        """The mass product with the folded BC rows and columns: K14."""
        return ell.ell_matvec(self._vals, self._ell.cols, self._ell.widths, x)

    def _rhs_qp_values(self) -> torch.Tensor:
        """The expression's values at the quadrature points, (bs, nc, nq)."""
        f = self._function
        bs = self.space.bs
        on = lambda a: torch.as_tensor(np.asarray(a, np.float64), device=self._device).to(
            self._dtype)
        if callable(f) and not isinstance(f, (Expr, Function)):
            vals = on(f(padded_coordinates(self._evaluator.xq_host)))
            return vals[None] if bs == 1 else vals
        e = as_expr(f)
        if bs == 1:
            return self._evaluator.eval(e)[None]
        comps = _components(e)
        if len(comps) != bs:
            raise ValueError(f"expression has {len(comps)} components, space has {bs}")
        return torch.stack([self._evaluator.eval(c) for c in comps])

    def assemble_rhs(self) -> None:
        """Re-assemble the right-hand side (reference function.py:108-119),
        with symmetric BC lifting: b -= M g, then b = g on the BC rows."""
        b = eng.source_load_vec_v(self._ctx, self._rhs_qp_values())
        if self._have_bcs:
            g = torch.where(self._mask, self._bc_vals, torch.zeros_like(self._bc_vals))
            b = b - eng.matvec_v(self._ctx, self._elems, g)
            b = torch.where(self._mask, self._bc_vals, b)
        self._b.copy_(b)

    def solve(self, assemble_rhs: bool = True) -> int:
        """Returns a PETSc-style converged reason (>0 on success), the least
        over the components."""
        if assemble_rhs:
            self.assemble_rhs()
        bs = self.space.bs
        x = self._x.x.array.view(-1, bs)
        x0 = x.T.contiguous()
        s = self._solver
        if s.method == "cg":
            invd = self._invd if s.use_jacobi() else torch.ones_like(self._invd)
            r0 = self._b - self._matvec(x0)
            res = ell.ell_cg(self._vals, self._ell.cols, self._ell.widths, r0, x0, invd,
                             torch.linalg.vector_norm(self._b, dim=-1),
                             _effective_rtol(s.rtol, self._dtype), s.maxiter, s.atol)
            out, conv = res.x, res.converged
        else:
            runs = [s.solve(self._b[i], x0=x0[i]) for i in range(bs)]
            out = torch.stack([r.x for r in runs])
            conv = torch.stack([r.converged for r in runs])
        x.copy_(out.T)
        return int(torch.min(_reason(conv, torch.zeros_like(conv))))

    @property
    def x(self) -> Function:
        return self._x


class LumpedProject:
    """Projection with a lumped (row-sum) mass matrix: a diagonal solve, no
    Krylov iteration.  Implements the reference's declared-but-unimplemented
    API (function.py:146-153)."""

    def __init__(
        self,
        function,
        space: FunctionSpace,
        bcs: list[DirichletBC] | None = None,
        metadata: dict | None = None,
        dtype=None,
        device=None,
    ):
        self._inner = Projector(function, space, bcs=bcs, metadata=metadata, dtype=dtype,
                                device=device)
        # lumped mass = M @ 1 (row sums)
        ones = torch.ones_like(self._inner._diag)
        self._lumped = eng.matvec_v(self._inner._ctx, self._inner._elems, ones)

    def solve(self) -> None:
        self._inner.assemble_rhs()
        bs = self._inner.space.bs
        self._inner._x.x.array.view(-1, bs).copy_((self._inner._b / self._lumped).T)

    @property
    def x(self) -> Function:
        return self._inner._x
