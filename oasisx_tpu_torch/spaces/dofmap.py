"""Continuous/discontinuous Lagrange dofmap construction.

The NumPy equivalent of DOLFINx's C++ dofmap construction (SURVEY §2b:
``functionspace``, ``V.sub(i).collapse()``, ``locate_dofs_*``). Global dof
identity is established by *exact integer* lattice-barycentric entity
classification — every local node belongs to a vertex, edge, face, or cell
interior, and its index on a shared entity is canonicalized by the global
vertex ordering of that entity. No floating-point coordinate matching.

Numbering layout (degree p, mesh with nv vertices, ne edges, nf faces):
    [vertex dofs | edge dofs (p-1 per edge) | face dofs | cell-interior dofs]
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..elements.element import FiniteElement
from ..elements.nodes import CELL_EDGES, lattice_multi_index
from ..meshes.mesh import CELL_FACETS, Mesh


def _unique_entities(cells: np.ndarray, local: np.ndarray):
    """Unique sorted-vertex entities over all cells.

    Returns (entities (nent, k), cell_entity_ids (ncells, nlocal)).
    """
    ent = np.sort(cells[:, local], axis=2)
    flat = ent.reshape(-1, ent.shape[2])
    uniq, inverse = np.unique(flat, axis=0, return_inverse=True)
    return uniq, inverse.reshape(cells.shape[0], -1).astype(np.int64)


def _face_interior_rank(j2: np.ndarray, j3: np.ndarray, degree: int) -> np.ndarray:
    """Rank of interior triangle-lattice point (j1,j2,j3), all >=1, sum=degree,
    enumerated lexicographically in (j2, j3)."""
    t = j2 - 1
    return (t * (2 * degree - 4 - t + 1)) // 2 + (j3 - 1)


@dataclass
class DofMap:
    """Scalar dofmap: per-cell global dof ids plus entity bookkeeping."""

    cell_dofs: np.ndarray  # (ncells, nd) int32
    num_dofs: int
    dof_coords: np.ndarray  # (num_dofs, gdim) float64
    # slices of the global numbering per entity class
    offsets: dict  # {"vertex":0, "edge":..., "face":..., "interior":...}
    edges: np.ndarray | None  # (ne, 2) global vertex pairs (sorted)
    edge_lookup: tuple[np.ndarray, np.ndarray] | None  # (sorted keys, perm)
    faces: np.ndarray | None  # (nfc, 3) for tets
    face_lookup: tuple[np.ndarray, np.ndarray] | None


def build_dofmap(mesh: Mesh, element: FiniteElement) -> DofMap:
    if element.cell != mesh.cell_type:
        raise ValueError("element cell does not match mesh cell type")
    cells = mesh.cells.astype(np.int64)
    ncells = cells.shape[0]
    deg = element.degree
    dim = mesh.dim
    nverts_mesh = mesh.num_vertices
    lam = lattice_multi_index(element.cell, max(deg, 1))  # (nd, nverts_cell)
    nd = element.ndofs

    # physical node coordinates per cell (affine map)
    ref_nodes = element.nodes  # (nd, dim)
    v0 = mesh.x[mesh.cells[:, 0]]  # (ncells, gdim)
    J = np.stack(
        [mesh.x[mesh.cells[:, i + 1]] - v0 for i in range(dim)], axis=2
    )  # (ncells, gdim, dim)
    phys = v0[:, None, :] + np.einsum("cgd,nd->cng", J, ref_nodes)

    if not element.continuous:
        cell_dofs = np.arange(ncells * nd, dtype=np.int32).reshape(ncells, nd)
        coords = phys.reshape(ncells * nd, -1)
        return DofMap(cell_dofs, ncells * nd, coords, {"interior": 0}, None, None, None, None)

    # --- entity tables -----------------------------------------------------
    local_edges = np.array(CELL_EDGES[element.cell])
    edges, cell_edge_ids = (None, None)
    faces, cell_face_ids = (None, None)
    n_edge_int = deg - 1
    n_face_int = (deg - 1) * (deg - 2) // 2 if dim == 3 else 0
    if deg >= 2:
        edges, cell_edge_ids = _unique_entities(cells, local_edges)
    if dim == 3 and deg >= 3:
        faces, cell_face_ids = _unique_entities(cells, np.asarray(CELL_FACETS["tetrahedron"]))

    ne = 0 if edges is None else edges.shape[0]
    nfc = 0 if faces is None else faces.shape[0]
    if dim == 2:
        n_cell_int = (deg - 1) * (deg - 2) // 2
    elif dim == 3:
        n_cell_int = (deg - 1) * (deg - 2) * (deg - 3) // 6
    else:
        n_cell_int = deg - 1

    off_vertex = 0
    off_edge = nverts_mesh
    off_face = off_edge + ne * n_edge_int
    off_int = off_face + nfc * n_face_int
    num_dofs = off_int + ncells * n_cell_int
    offsets = {"vertex": off_vertex, "edge": off_edge, "face": off_face, "interior": off_int}

    cell_dofs = np.zeros((ncells, nd), dtype=np.int64)
    interior_counter = 0
    for n in range(nd):
        li = lam[n]  # integer barycentrics of this local node
        support = np.where(li > 0)[0]
        if len(support) == 1:
            cell_dofs[:, n] = cells[:, support[0]]
        elif len(support) == 2:
            a, b = support
            # which local edge is (a, b)?
            (eloc,) = np.where((local_edges == sorted((a, b))).all(axis=1))
            eid = cell_edge_ids[:, eloc[0]]
            ga, gb = cells[:, a], cells[:, b]
            # index measured from the endpoint with the smaller global id
            t = np.where(ga < gb, li[b], li[a])
            cell_dofs[:, n] = off_edge + eid * n_edge_int + (t - 1)
        elif len(support) == 3 and dim == 3:
            a, b, c = support
            lf = np.asarray(CELL_FACETS["tetrahedron"])
            (floc,) = np.where((lf == sorted((a, b, c))).all(axis=1))
            fid = cell_face_ids[:, floc[0]]
            gl = np.stack([cells[:, a], cells[:, b], cells[:, c]], axis=1)
            lat = np.array([li[a], li[b], li[c]])
            order = np.argsort(gl, axis=1)
            j = lat[order]  # (ncells, 3) lattice indices sorted by global id
            rank = _face_interior_rank(j[:, 1], j[:, 2], deg)
            cell_dofs[:, n] = off_face + fid * n_face_int + rank
        else:
            cell_dofs[:, n] = off_int + np.arange(ncells) * n_cell_int + interior_counter
            interior_counter += 1

    coords = np.zeros((num_dofs, mesh.gdim))
    coords[cell_dofs.reshape(-1)] = phys.reshape(-1, mesh.gdim)

    def lookup(entities):
        if entities is None:
            return None
        keys = _encode(entities, nverts_mesh)
        perm = np.argsort(keys)
        return keys[perm], perm

    return DofMap(
        cell_dofs.astype(np.int32),
        num_dofs,
        coords,
        offsets,
        edges,
        lookup(edges),
        faces,
        lookup(faces),
    )


def _encode(entities: np.ndarray, base: int) -> np.ndarray:
    keys = np.zeros(entities.shape[0], dtype=np.int64)
    for k in range(entities.shape[1]):
        keys = keys * base + entities[:, k]
    return keys


def _lookup_ids(keys_sorted: np.ndarray, perm: np.ndarray, keys: np.ndarray) -> np.ndarray:
    """Resolve entity keys to entity ids with a membership check: a facet
    whose edge/face key is absent (malformed entity list) must raise, not
    silently map to an arbitrary entity."""
    pos = np.searchsorted(keys_sorted, keys)
    bad = (pos >= len(keys_sorted)) | (keys_sorted[np.minimum(pos, len(keys_sorted) - 1)] != keys)
    if bad.any():
        raise ValueError(
            f"{int(bad.sum())} queried sub-entities are not in the mesh entity list "
            "(malformed facet/entity indices passed to topological dof location)"
        )
    return perm[pos]


def entity_closure_dofs(
    mesh: Mesh, dofmap: DofMap, element: FiniteElement, edim: int, entities: np.ndarray
) -> np.ndarray:
    """All dofs whose node lies on the closure of the given entities.

    The equivalent of dolfinx ``locate_dofs_topological``
    (reference src/oasisx/bcs.py:112-114). Supports facet (dim-1) and
    vertex (0) entities.
    """
    entities = np.asarray(entities, dtype=np.int64)
    deg = element.degree
    if not element.continuous:
        raise NotImplementedError("topological dof location requires a continuous space")
    dofs: list[np.ndarray] = []
    nverts_mesh = mesh.num_vertices
    if edim == 0:
        return np.unique(entities).astype(np.int32)
    if edim != mesh.dim - 1:
        raise ValueError("only facet or vertex entities supported")
    fverts = mesh.topology.facets[entities].astype(np.int64)  # (n, dim)
    dofs.append(fverts.reshape(-1))
    if deg >= 2 and dofmap.edges is not None:
        keys_sorted, perm = dofmap.edge_lookup
        if mesh.dim == 2:
            pairs = np.sort(fverts, axis=1)
            eids = _lookup_ids(keys_sorted, perm, _encode(pairs, nverts_mesh))
            base = dofmap.offsets["edge"] + eids[:, None] * (deg - 1)
            dofs.append((base + np.arange(deg - 1)[None, :]).reshape(-1))
        else:
            # tet facet: three edges
            for a, b in [(0, 1), (0, 2), (1, 2)]:
                pairs = np.sort(fverts[:, [a, b]], axis=1)
                eids = _lookup_ids(keys_sorted, perm, _encode(pairs, nverts_mesh))
                base = dofmap.offsets["edge"] + eids[:, None] * (deg - 1)
                dofs.append((base + np.arange(deg - 1)[None, :]).reshape(-1))
    if mesh.dim == 3 and deg >= 3 and dofmap.faces is not None:
        keys_sorted, perm = dofmap.face_lookup
        tri = np.sort(fverts, axis=1)
        fids = _lookup_ids(keys_sorted, perm, _encode(tri, nverts_mesh))
        nfi = (deg - 1) * (deg - 2) // 2
        base = dofmap.offsets["face"] + fids[:, None] * nfi
        dofs.append((base + np.arange(nfi)[None, :]).reshape(-1))
    return np.unique(np.concatenate(dofs)).astype(np.int32)
