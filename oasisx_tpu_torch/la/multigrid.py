"""Geometric multigrid V-cycle for the P1 pressure Poisson, in tensor ops.

Counterpart of ``oasisx_tpu/la/multigrid.py``'s ``StructuredPoissonMG``, the
JAX package's XLA MG (not K1's: ROADMAP known difference a).  On structured
generator meshes the P1 pressure grids form a nested hierarchy (the Kuhn /
right-diagonal splits are self-similar under halving), so linear
interpolation is exact nesting and restriction its transpose:

- level meshes at halved cell counts while they stay even (coarsest 2 cells
  an axis at least), each with its cube Laplacian on its structured grid;
- damped Jacobi smoothing (omega 0.8, 2 sweeps before and after), so the
  V-cycle is symmetric and serves as a CG preconditioner;
- ``prolong``: the fine values at points odd along some axes average the
  two corners of the (sub-)cube diagonal they lie on; ``restrict`` is its
  transpose;
- the coarsest level solved by the dense pseudo-inverse of its operator
  (the singular pure-Neumann Laplacian).

A level's product goes through ``assembly.kernels.matvec_const`` (K12 on the
card, its plain version on the CPU).  The slab path runs the V-cycle on the
gathered global grid (``fracstep``'s gathered MG apply).
"""

from __future__ import annotations

import itertools

import numpy as np
import torch
import torch.nn.functional as F

from ..config import real_dtype


def _parity_block(Xc: torch.Tensor, p_axes: tuple) -> torch.Tensor:
    """Fine values at points odd in ``p_axes``: on Kuhn simplex meshes each
    such point lies on the main diagonal of its (sub-)cube, so P1
    interpolation averages the two diagonal corners."""
    if not p_axes:
        return Xc
    lo, hi = Xc, Xc
    for ax in p_axes:
        lo = lo.narrow(ax, 0, lo.shape[ax] - 1)
        hi = hi.narrow(ax, 1, hi.shape[ax] - 1)
    return 0.5 * (lo + hi)


def _interleave_blocks(E: torch.Tensor, O: torch.Tensor, ax: int) -> torch.Tensor:
    """Merge even (m) and odd (m-1) blocks along ax -> 2m-1."""
    E0 = E.movedim(ax, 0)
    O0 = O.movedim(ax, 0)
    m = E0.shape[0]
    body = torch.stack([E0[:-1], O0], dim=1).reshape((2 * (m - 1),) + tuple(E0.shape[1:]))
    return torch.cat([body, E0[-1:]], dim=0).movedim(0, ax)


def prolong(xc: torch.Tensor, shape_c: tuple) -> torch.Tensor:
    """Exact P1 interpolation, coarse -> fine (nested simplicial spaces)."""
    Xc = xc.reshape(shape_c)
    d = len(shape_c)

    def build(bits: tuple, ax: int) -> torch.Tensor:
        if ax == d:
            return _parity_block(Xc, tuple(i for i, b in enumerate(bits) if b))
        return _interleave_blocks(build(bits + (0,), ax + 1), build(bits + (1,), ax + 1), ax)

    return build((), 0).reshape(-1)


def restrict(rf: torch.Tensor, shape_f: tuple) -> torch.Tensor:
    """Transpose of :func:`prolong` (residual restriction): each odd-parity
    component's two half weights placed by shifted pads."""
    Xf = rf.reshape(shape_f)
    d = len(shape_f)
    out = None
    for bits in itertools.product((0, 1), repeat=d):
        comp = Xf[tuple(slice(b, None, 2) for b in bits)]
        p_axes = tuple(i for i, b in enumerate(bits) if b)
        if not p_axes:
            out = comp
            continue
        out = out + F.pad(0.5 * comp, _pad(d, p_axes, (0, 1)))
        out = out + F.pad(0.5 * comp, _pad(d, p_axes, (1, 0)))
    return out.reshape(-1)


def _pad(d: int, axes: tuple, lohi: tuple) -> list:
    """F.pad's list (last axis first) padding ``axes`` by (low, high)."""
    pad = []
    for k in reversed(range(d)):
        pad += list(lohi) if k in axes else [0, 0]
    return pad


class StructuredPoissonMG:
    """V-cycle preconditioner for the P1 Poisson operator on a structured
    generator mesh.  Built on the host once; ``vcycle`` runs on ``device``."""

    def __init__(self, mesh, nsmooth: int = 2, omega: float = 0.8, coarsest: int = 4,
                 dtype=None, *, device):
        from ..assembly.cubes import build_cube_ops, diag_cube
        from ..assembly.geometry import compute_cell_geometry
        from ..assembly.reference_tensors import build_reference_tensors
        from ..assembly.structured import build_structured_map
        from ..elements.element import make_element
        from ..meshes.generation import create_box, create_interval, create_rectangle
        from ..spaces.functionspace import FunctionSpace

        info = mesh.structured
        if info is None:
            raise ValueError("StructuredPoissonMG requires a structured mesh")
        dtype = real_dtype(dtype)
        self.omega = omega
        self.nsmooth = nsmooth
        d = mesh.dim
        shape = tuple(info.shape)
        origin = np.asarray(info.origin)
        extent = origin + np.asarray(info.spacing) * np.asarray(shape)

        # level resolutions: halve while even and above the coarsest size
        res = [shape]
        while all(n % 2 == 0 and n // 2 >= max(2, coarsest // 2) for n in res[-1]):
            res.append(tuple(n // 2 for n in res[-1]))
        if len(res) < 2:
            raise ValueError("mesh resolution does not coarsen (need even cell counts)")
        ncoarse = int(np.prod([n + 1 for n in res[-1]]))
        if ncoarse > 20000:
            raise ValueError(f"coarsest level too large for a dense solve ({ncoarse} dofs)")

        t = lambda a: torch.as_tensor(np.asarray(a, np.float64), device=device).to(dtype)
        self.levels = []
        for n in res:
            if d == 1:
                m = create_interval(n[0], origin[0], extent[0])
            elif d == 2:
                m = create_rectangle(tuple(origin), tuple(extent), n)
            else:
                m = create_box(tuple(origin), tuple(extent), n)
            el = make_element(("Lagrange", 1), mesh.cell_type)
            Q = FunctionSpace(m, el)
            r = build_structured_map(m, el, Q.dofmap)
            if r is None:
                raise ValueError("level mesh is not lattice-compatible")
            sm, gridflat, _ = r
            refs = build_reference_tensors(el, el)
            cu = build_cube_ops(m, refs, sm, sm, torch.float64, device="cpu")
            if cu is None:
                raise ValueError("level mesh has no uniform cube geometry")
            diag = diag_cube(cu.Ap_c, sm).numpy()
            self.levels.append(dict(
                sm=sm,
                Ap_c=t(cu.Ap_c.numpy()),
                inv_diag=t(np.where(diag != 0, 1.0 / np.where(diag != 0, diag, 1.0), 0.0)),
                grid_shape=tuple(k + 1 for k in n),
                gridflat=gridflat,
                mesh=m,
                cell_dofs=Q.dofmap.cell_dofs,
                refs=refs,
            ))

        # coarse pseudo-inverse in grid order, assembled from float64 elements
        L = self.levels[-1]
        m, cd, gf = L["mesh"], L["cell_dofs"], L["gridflat"]
        geo = compute_cell_geometry(m.x, m.cells, d)
        elems = np.einsum("c,cab,abij->cij", geo.detJ, geo.G, L["refs"].stiffness_q)
        nlast = len(gf)
        A = np.zeros((nlast, nlast))
        np.add.at(A, (cd[:, :, None], cd[:, None, :]), elems)
        Qc = int(np.prod(L["grid_shape"]))
        Agrid = np.zeros((Qc, Qc))
        Agrid[np.ix_(gf, gf)] = A
        self._coarse_pinv = t(np.linalg.pinv(Agrid))
        for lvl in self.levels:
            for k in ("mesh", "cell_dofs", "refs"):
                del lvl[k]

    def _matvec(self, li: int, x: torch.Tensor) -> torch.Tensor:
        from ..assembly import kernels as kn

        L = self.levels[li]
        return kn.matvec_const(x, L["Ap_c"], L["sm"])

    def _smooth(self, li: int, z: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
        L = self.levels[li]
        for _ in range(self.nsmooth):
            z = z + self.omega * L["inv_diag"] * (r - self._matvec(li, z))
        return z

    def _cycle(self, li: int, r: torch.Tensor) -> torch.Tensor:
        if li == len(self.levels) - 1:
            return self._coarse_pinv @ r
        z = self._smooth(li, torch.zeros_like(r), r)
        res = r - self._matvec(li, z)
        zc = self._cycle(li + 1, restrict(res, self.levels[li]["grid_shape"]))
        z = z + prolong(zc, self.levels[li + 1]["grid_shape"])
        return self._smooth(li, z, r)

    def vcycle(self, r: torch.Tensor) -> torch.Tensor:
        """One symmetric V-cycle on the finest grid vector: M^-1 r."""
        return self._cycle(0, r)

    @property
    def num_levels(self) -> int:
        return len(self.levels)
