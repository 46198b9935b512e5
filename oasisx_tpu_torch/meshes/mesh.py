"""Host-side simplex mesh: fixed-topology int32/f64 arrays.

Replaces the exercised DOLFINx mesh surface
(reference, SURVEY §2b: create_unit_square/create_rectangle/
create_unit_cube, exterior_facet_indices, meshtags, topology connectivity,
cell sizes ``mesh.h``). All arrays are NumPy at setup; device code receives
them as static inputs.

Local facet convention (matches DOLFINx): facet ``i`` of a simplex is the
facet opposite vertex ``i``:
  triangle facets:     [1,2], [0,2], [0,1]
  tetrahedron facets:  [1,2,3], [0,2,3], [0,1,3], [0,1,2]
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import cached_property

import numpy as np

CELL_FACETS = {
    "interval": np.array([[1], [0]]),
    "triangle": np.array([[1, 2], [0, 2], [0, 1]]),
    "tetrahedron": np.array([[1, 2, 3], [0, 2, 3], [0, 1, 3], [0, 1, 2]]),
}

CELL_DIM = {"interval": 1, "triangle": 2, "tetrahedron": 3}


@dataclass
class Topology:
    """Facet topology derived from the cell-vertex array."""

    facets: np.ndarray  # (nfacets, dim) int32, sorted vertex ids per facet
    facet_cells: np.ndarray  # (nfacets, 2) int32, owning cells; -1 if boundary
    facet_local: np.ndarray  # (nfacets, 2) int32, local facet index in cell; -1
    exterior_facets: np.ndarray  # (next,) int32 facet ids with a single cell

    def create_connectivity(self, d0: int, d1: int) -> None:
        """Compatibility no-op: all connectivity is precomputed."""


@dataclass
class StructuredInfo:
    """Present on meshes from the structured generators: records the
    regular macro-grid so assembly gather/scatter can use strided slices
    instead of unstructured gathers (assembly/structured.py — the TPU fast
    path). Guarantee: ``cells`` is ordered shape-major (the ``nshapes``
    simplices per quad/cube form contiguous blocks), each block C-order
    over the (ix[, iy[, iz]]) cell lattice."""

    origin: np.ndarray  # (gdim,)
    spacing: np.ndarray  # (gdim,) macro-cell size per axis
    shape: tuple  # cells per axis, e.g. (nx, ny) or (nx, ny, nz)
    nshapes: int  # simplices per macro-cell (2 in 2D, 6 in 3D)


@dataclass
class Mesh:
    """Simplex mesh: vertex coordinates + cell-vertex connectivity."""

    x: np.ndarray  # (npoints, gdim) float64
    cells: np.ndarray  # (ncells, nverts) int32
    cell_type: str
    structured: StructuredInfo | None = None

    def __post_init__(self):
        self.x = np.ascontiguousarray(self.x, dtype=np.float64)
        self.cells = np.ascontiguousarray(self.cells, dtype=np.int32)

    @property
    def dim(self) -> int:
        return CELL_DIM[self.cell_type]

    # dolfinx-style aliases used by the reference demos
    @property
    def tdim(self) -> int:
        return self.dim

    @property
    def gdim(self) -> int:
        return self.x.shape[1]

    @property
    def num_cells(self) -> int:
        return self.cells.shape[0]

    @property
    def num_vertices(self) -> int:
        return self.x.shape[0]

    @cached_property
    def topology(self) -> Topology:
        return _build_topology(self)

    def h(self, dim: int | np.ndarray | None = None, entities: np.ndarray | None = None) -> np.ndarray:
        """Cell diameters (max edge length). Accepts both ``h()``/``h(entities)``
        and the dolfinx signature ``h(dim, entities)`` (reference usage
        demo/taylor_green.py:219)."""
        if dim is not None and entities is None and not np.isscalar(dim):
            entities = np.asarray(dim)
        elif dim is not None and np.isscalar(dim) and int(dim) != self.dim:
            raise ValueError("h() supports cell entities only")
        cells = self.cells if entities is None else self.cells[entities]
        pts = self.x[cells]  # (n, nv, gdim)
        nv = pts.shape[1]
        h = np.zeros(pts.shape[0])
        for i in range(nv):
            for j in range(i + 1, nv):
                h = np.maximum(h, np.linalg.norm(pts[:, i] - pts[:, j], axis=1))
        return h

    def cell_volumes(self) -> np.ndarray:
        pts = self.x[self.cells]
        v = pts[:, 1:] - pts[:, :1]
        if self.dim == 1:
            return np.abs(v[:, 0, 0])
        dets = np.linalg.det(v[:, :, : self.dim])
        fact = 2.0 if self.dim == 2 else 6.0
        return np.abs(dets) / fact

    def exterior_facet_indices(self) -> np.ndarray:
        """Boundary facet ids (reference: dolfinx.mesh.exterior_facet_indices,
        demo/taylor_green.py:136)."""
        return self.topology.exterior_facets

    def midpoints(self, dim: int, entities: np.ndarray) -> np.ndarray:
        if dim == self.dim:
            return self.x[self.cells[entities]].mean(axis=1)
        if dim == self.dim - 1:
            return self.x[self.topology.facets[entities]].mean(axis=1)
        if dim == 0:
            return self.x[entities]
        raise ValueError(f"unsupported entity dim {dim}")


def _build_topology(mesh: Mesh) -> Topology:
    cells = mesh.cells
    lf = CELL_FACETS[mesh.cell_type]  # (nlf, dim)

    # NumPy path (the JAX package's native C++ kernel gives the same
    # numbering; tests/test_native.py holds the two against each other)
    nlf = lf.shape[0]
    ncells = cells.shape[0]
    all_facets = cells[:, lf]  # (ncells, nlf, dim)
    flat = np.sort(all_facets.reshape(ncells * nlf, -1), axis=1)
    uniq, inverse = np.unique(flat, axis=0, return_inverse=True)
    nfac = uniq.shape[0]
    facet_cells = np.full((nfac, 2), -1, dtype=np.int32)
    facet_local = np.full((nfac, 2), -1, dtype=np.int32)
    cell_ids = np.repeat(np.arange(ncells, dtype=np.int32), nlf)
    local_ids = np.tile(np.arange(nlf, dtype=np.int32), ncells)
    # stable fill: first hit goes to slot 0, second to slot 1
    order = np.argsort(inverse, kind="stable")
    inv_sorted = inverse[order]
    first_mask = np.ones(len(inv_sorted), dtype=bool)
    first_mask[1:] = inv_sorted[1:] != inv_sorted[:-1]
    slot = np.where(first_mask, 0, 1)
    facet_cells[inv_sorted, slot] = cell_ids[order]
    facet_local[inv_sorted, slot] = local_ids[order]
    exterior = np.where(facet_cells[:, 1] == -1)[0].astype(np.int32)
    return Topology(
        facets=uniq.astype(np.int32),
        facet_cells=facet_cells,
        facet_local=facet_local,
        exterior_facets=exterior,
    )
