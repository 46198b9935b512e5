"""Mesh entity tagging and geometric entity location.

Equivalents of dolfinx.mesh.meshtags / locate_entities_boundary /
locate_entities exercised by the reference
(test/test_tentative_velocity.py:113-128, demo/taylor_green.py:135-140).

Marker callables follow the reference convention: they receive coordinates
as an array of shape (3, npoints) — x[0], x[1], x[2] — padded with zeros
beyond the geometric dimension, and return a boolean mask.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .mesh import Mesh


@dataclass
class MeshTags:
    """Tagged mesh entities of a single dimension."""

    mesh: Mesh
    dim: int
    indices: np.ndarray  # (n,) int32, entity ids (sorted)
    values: np.ndarray  # (n,) int32

    def find(self, value: int) -> np.ndarray:
        return self.indices[self.values == value]

    @property
    def topology(self):
        return self.mesh.topology


def meshtags(mesh: Mesh, dim: int, indices: np.ndarray, values: np.ndarray) -> MeshTags:
    indices = np.asarray(indices, dtype=np.int32)
    values = np.asarray(values, dtype=np.int32)
    order = np.argsort(indices)
    return MeshTags(mesh, dim, indices[order], values[order])


def _pad3(x: np.ndarray) -> np.ndarray:
    """(n, gdim) -> (3, n) zero-padded, the reference's marker convention."""
    out = np.zeros((3, x.shape[0]))
    out[: x.shape[1]] = x.T
    return out


def locate_entities_boundary(mesh: Mesh, dim: int, marker) -> np.ndarray:
    """Boundary entities of dimension ``dim`` whose vertices all satisfy marker."""
    top = mesh.topology
    vmask = marker(_pad3(mesh.x))
    if dim == mesh.dim - 1:
        fverts = top.facets[top.exterior_facets]
        hit = vmask[fverts].all(axis=1)
        return top.exterior_facets[hit].astype(np.int32)
    if dim == 0:
        bverts = np.unique(top.facets[top.exterior_facets])
        return bverts[vmask[bverts]].astype(np.int32)
    raise ValueError(f"unsupported entity dimension {dim}")


def locate_entities(mesh: Mesh, dim: int, marker) -> np.ndarray:
    """All entities of dimension ``dim`` whose vertices all satisfy marker."""
    vmask = marker(_pad3(mesh.x))
    if dim == mesh.dim:
        ent_verts = mesh.cells
        n = mesh.num_cells
    elif dim == mesh.dim - 1:
        ent_verts = mesh.topology.facets
        n = ent_verts.shape[0]
    elif dim == 0:
        return np.where(vmask)[0].astype(np.int32)
    else:
        raise ValueError(f"unsupported entity dimension {dim}")
    hit = vmask[ent_verts].all(axis=1)
    return np.arange(n, dtype=np.int32)[hit]
