"""Interpolation node sets for Lagrange elements on unit simplices.

Two variants, mirroring the reference's use of
``basix.LagrangeVariant.gll_warped`` (reference src/oasisx/fracstep.py:170):

- ``equispaced``: barycentric lattice nodes.
- ``gll_warped``: warp-and-blend nodes (Hesthaven-Warburton style with
  blend exponent alpha=0, applied edge-wise): every edge carries exact
  Gauss-Lobatto-Legendre points; interior nodes are smoothly warped.
  This is a symmetric, unisolvent, well-conditioned family equivalent in
  role to basix's gll_warped (node positions differ in cell interiors).

Node ordering convention: cell vertices first (in reference-vertex order),
then the remaining lattice points in lexicographic order. Node identity
across neighbouring cells is established downstream by coordinate matching
(spaces/dofmap.py), so only symmetry of the node set matters, which both
variants satisfy.
"""

from __future__ import annotations

import numpy as np

from .jacobi import gauss_lobatto_points
from .tabulation import cell_dim

REFERENCE_VERTICES = {
    "interval": np.array([[0.0], [1.0]]),
    "triangle": np.array([[0.0, 0.0], [1.0, 0.0], [0.0, 1.0]]),
    "tetrahedron": np.array(
        [[0.0, 0.0, 0.0], [1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]]
    ),
}

# Cell edges as (vertex, vertex) pairs
CELL_EDGES = {
    "interval": [(0, 1)],
    "triangle": [(0, 1), (0, 2), (1, 2)],
    "tetrahedron": [(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)],
}


def lattice_multi_index(cell: str, degree: int) -> np.ndarray:
    """Integer barycentric lattice multi-indices (ndofs, nverts), rows sum to
    ``degree``, ordered vertices-first then lexicographic — the canonical
    local node ordering shared by tabulation nodes and the dofmap."""
    dim = cell_dim(cell)
    n = degree
    if dim == 1:
        idx = [(n - i, i) for i in range(n + 1)]
    elif dim == 2:
        idx = [(n - i - j, i, j) for j in range(n + 1) for i in range(n + 1 - j)]
    else:
        idx = [
            (n - i - j - k, i, j, k)
            for k in range(n + 1)
            for j in range(n + 1 - k)
            for i in range(n + 1 - j - k)
        ]
    lam = np.array(idx, dtype=np.int64)
    # reorder: vertices first. Vertex v has lam[v] == degree.
    nverts = dim + 1
    order = []
    for v in range(nverts):
        (pos,) = np.where(lam[:, v] == n)
        order.append(pos[0])
    rest = [i for i in range(lam.shape[0]) if i not in order]
    return lam[np.array(order + rest, dtype=int)]


def _lattice_barycentric(dim: int, degree: int) -> np.ndarray:
    """Barycentric lattice coordinates (ndofs, nverts), vertices first."""
    cell = {1: "interval", 2: "triangle", 3: "tetrahedron"}[dim]
    return lattice_multi_index(cell, degree).astype(np.float64) / degree


def _warp_1d(degree: int, r: np.ndarray) -> np.ndarray:
    """Warp function w(r) on [-1,1]: blend-normalized GLL displacement.

    w satisfies: for r on an edge parameterization, 4*lam_a*lam_b*w(r)
    reproduces exact GLL node displacement on that edge.
    """
    gll = gauss_lobatto_points(degree)
    req = np.linspace(-1.0, 1.0, degree + 1)
    # Lagrange interpolation (on equispaced nodes) of the displacement gll-req
    # evaluated at r, then divided by (1 - r^2).
    disp = gll - req
    # evaluate sum_i disp[i] * L_i(r) where L_i are Lagrange polys on req
    vals = np.zeros_like(r)
    for i in range(degree + 1):
        li = np.ones_like(r)
        for k in range(degree + 1):
            if k != i:
                li *= (r - req[k]) / (req[i] - req[k])
        vals += disp[i] * li
    sf = 1.0 - r**2
    safe = np.abs(sf) > 1e-12
    out = np.where(safe, vals / np.where(safe, sf, 1.0), 0.0)
    return out


def lagrange_nodes(cell: str, degree: int, variant: str = "gll_warped") -> np.ndarray:
    """Node coordinates on the unit reference cell, shape (ndofs, dim)."""
    dim = cell_dim(cell)
    verts = REFERENCE_VERTICES[cell]
    if degree == 0:
        # DG0: single node at barycenter
        return verts.mean(axis=0, keepdims=True)
    lam = _lattice_barycentric(dim, degree)
    x_eq = lam @ verts
    if variant == "equispaced" or degree < 3 and cell == "interval" or degree < 2:
        return x_eq
    if variant != "gll_warped":
        raise ValueError(f"unknown Lagrange variant {variant!r}")
    if cell == "interval":
        g = (gauss_lobatto_points(degree) + 1.0) / 2.0
        order = np.argsort(np.linspace(0, 1, degree + 1))
        x = np.zeros_like(x_eq)
        # match lattice ordering: vertices first then interior lex
        lat = _lattice_barycentric(1, degree)[:, 1]  # x-coordinates
        gs = np.sort(g)
        # map each lattice coordinate i/degree to i-th sorted GLL point
        ranks = np.round(lat * degree).astype(int)
        x[:, 0] = gs[ranks]
        return x
    # warp-and-blend, edge-wise, alpha = 0
    x = x_eq.copy()
    for a, b in CELL_EDGES[cell]:
        r = lam[:, b] - lam[:, a]
        blend = 4.0 * lam[:, a] * lam[:, b]
        w = _warp_1d(degree, r)
        x += (blend * w)[:, None] * (verts[b] - verts[a])[None, :] / 2.0
    return x
