"""Boundary conditions: DirichletBC (velocity) and PressureBC (outlet).

Re-provides the reference's BC surface (src/oasisx/bcs.py):

- ``DirichletBC``: deferred creation (``create_bc``), geometric or
  topological dof location, float/Constant/callable values and
  time-dependent re-interpolation (``update_bc``).  Dof sets and values
  stay NumPy on the host; the solver turns them into a boolean mask and a
  value tensor on its device, re-uploading only when ``_version`` changes.
- ``PressureBC(value, (meshtags, id))``: the surface forms
  ``int h n_i dv/dx_i ds`` of the tentative-velocity right-hand side
  (assembly/facets.py) and the homogeneous Dirichlet condition on the
  pressure correction over the same facets.
"""

from __future__ import annotations

from enum import Enum

import numpy as np

import torch

from .assembly.facets import FacetContext, build_facet_context, facet_eval_q
from .meshes.tags import MeshTags
from .spaces.functionspace import Constant, Function, FunctionSpace

__all__ = ["DirichletBC", "LocatorMethod", "PressureBC", "bc_mask_and_values"]


class LocatorMethod(Enum):
    """Search methods for Dirichlet BCs."""

    GEOMETRICAL = 1
    TOPOLOGICAL = 2


LocatorMethod.TOPOLOGICAL.__doc__ = "Topological search for dofs"
LocatorMethod.GEOMETRICAL.__doc__ = "Geometrical search for dofs"


class DirichletBC:
    """Strong Dirichlet condition on a scalar (velocity-component) space.

    Args:
        value: float, Constant, or callable ``f(x)`` with ``x`` of shape
            (3, n) (zero-padded), returning dof values.
        method: LocatorMethod.GEOMETRICAL or .TOPOLOGICAL.
        marker: geometric predicate, or ``(MeshTags, tag_value)``.
    """

    def __init__(self, value, method: LocatorMethod, marker):
        self._method = method
        self._value = value
        if method == LocatorMethod.GEOMETRICAL:
            self._locator = marker
        elif method == LocatorMethod.TOPOLOGICAL:
            self._entities = marker[0].find(marker[1])
            self._e_dim = marker[0].dim
        else:
            raise ValueError(method)
        self._dofs: np.ndarray | None = None
        self._V: FunctionSpace | None = None
        self._vals: np.ndarray | None = None
        # bumped whenever dofs/values change, so the solver re-uploads its
        # value tensor only then
        self._version = 0

    def _locate_dofs(self, V: FunctionSpace) -> None:
        if self._method == LocatorMethod.GEOMETRICAL:
            self._dofs = V.locate_dofs_geometrical(self._locator)
        else:
            self._dofs = V.locate_dofs_topological(self._e_dim, self._entities)

    def create_bc(self, V: FunctionSpace) -> None:
        if self._dofs is None:
            self._locate_dofs(V)
        self._V = V
        self.update_bc()

    def update_bc(self) -> None:
        """Re-evaluate a time-dependent callable value (reference bcs.py:128-133)."""
        if self._V is None:
            return
        old = self._vals
        if callable(self._value):
            x = self._V.dof_coords[self._dofs]
            pad = np.zeros((3, x.shape[0]))
            pad[: x.shape[1]] = x.T
            self._vals = np.asarray(self._value(pad), dtype=np.float64)
        else:
            v = self._value.value if isinstance(self._value, Constant) else self._value
            self._vals = np.full(len(self._dofs), float(v))
        if old is None or old.shape != self._vals.shape or not np.array_equal(old, self._vals):
            self._version += 1

    @property
    def dofs(self) -> np.ndarray:
        if self._dofs is None:
            raise RuntimeError("create_bc must be called first")
        return self._dofs

    @property
    def values(self) -> np.ndarray:
        if self._vals is None:
            raise RuntimeError("create_bc must be called first")
        return self._vals


def bc_mask_and_values(bcs: list[DirichletBC], ndofs: int) -> tuple[np.ndarray, np.ndarray]:
    """Combine a list of DirichletBCs into (bool mask, value vector).

    Later BCs in the list win on overlapping dofs, matching sequential
    ``set_bc`` application order."""
    mask = np.zeros(ndofs, dtype=bool)
    vals = np.zeros(ndofs, dtype=np.float64)
    for bc in bcs:
        mask[bc.dofs] = True
        vals[bc.dofs] = bc.values
    return mask, vals


class PressureBC:
    """Outlet pseudo-traction condition (reference bcs.py:142-268).

    Contributes ``int h n_i dv/dx_i ds`` to each tentative-velocity
    right-hand side and a homogeneous Dirichlet condition on the pressure
    correction over the tagged facets.
    """

    def __init__(self, value, marker: tuple[MeshTags, int]):
        self._subdomain_data, self._subdomain_id = marker
        self._value = value
        self._fctx: FacetContext | None = None
        self._u: Function | None = None
        self._dofs_q: np.ndarray | None = None

    def create_bcs(self, V: FunctionSpace, Q: FunctionSpace, dtype: torch.dtype,
                   device: torch.device) -> None:
        """V: the collapsed scalar velocity space; Q: the pressure space.
        The facet tables live on ``device`` in ``dtype``."""
        mesh = V.mesh
        if isinstance(self._subdomain_id, tuple):
            facets = self._subdomain_data.indices[
                np.isin(self._subdomain_data.values, np.asarray(self._subdomain_id))
            ]
        else:
            facets = self._subdomain_data.find(int(self._subdomain_id))
        self._facets = np.asarray(facets, dtype=np.int32)
        self._fctx = build_facet_context(
            mesh, V.element, Q.element, self._facets, V.dofmap.cell_dofs,
            dtype=dtype, device=device,
        )
        if callable(self._value):
            self._u = Function(Q, name="pressure_bc", dtype=dtype, device=device)
            self._u.interpolate(self._value)
        self._dofs_q = Q.locate_dofs_topological(mesh.dim - 1, self._facets)

    def update_bc(self) -> None:
        if self._u is not None:
            self._u.interpolate(self._value)

    @property
    def facet_context(self) -> FacetContext:
        if self._fctx is None:
            raise RuntimeError("create_bcs must be called first")
        return self._fctx

    @property
    def dofs(self) -> np.ndarray:
        """Pressure-correction dofs carrying the homogeneous condition."""
        if self._dofs_q is None:
            raise RuntimeError("create_bcs must be called first")
        return self._dofs_q

    def value_at_facet_qp(self, ctx, fctx: FacetContext | None = None,
                          local=None) -> torch.Tensor:
        """The outlet value h at the facet quadrature points: (nf, nqf).
        ``fctx`` (default: this condition's) and ``local`` (the map of a
        canonical Q vector into ``ctx``'s dof layout) give a rank's facets
        under graph-halo."""
        f = self.facet_context if fctx is None else fctx
        if self._u is not None:
            h = self._u.x.array
            return facet_eval_q(ctx, f, h if local is None else local(h))
        v = self._value.value if isinstance(self._value, Constant) else self._value
        return torch.full((f.nfacets, f.qw.shape[0]), float(v), dtype=f.scale.dtype,
                          device=f.scale.device)
