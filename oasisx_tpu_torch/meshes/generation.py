"""Structured simplex mesh generators.

NumPy equivalents of the DOLFINx generators the reference exercises:
create_unit_square / create_rectangle / create_unit_cube / create_box
(reference demo/taylor_green.py:126, test/* throughout).
"""

from __future__ import annotations

import numpy as np

from .mesh import Mesh, StructuredInfo


def create_interval(n: int, a: float = 0.0, b: float = 1.0) -> Mesh:
    x = np.linspace(a, b, n + 1)[:, None]
    cells = np.stack([np.arange(n), np.arange(1, n + 1)], axis=1)
    info = StructuredInfo(
        origin=np.array([a]), spacing=np.array([(b - a) / n]), shape=(n,), nshapes=1
    )
    return Mesh(x, cells, "interval", structured=info)


def create_rectangle(
    p0: tuple[float, float],
    p1: tuple[float, float],
    n: tuple[int, int],
    diagonal: str = "right",
) -> Mesh:
    """Triangulated rectangle [p0, p1] with n[0] x n[1] quads, 2 triangles each."""
    nx, ny = n
    xs = np.linspace(p0[0], p1[0], nx + 1)
    ys = np.linspace(p0[1], p1[1], ny + 1)
    X, Y = np.meshgrid(xs, ys, indexing="ij")
    pts = np.stack([X.ravel(), Y.ravel()], axis=1)

    def vid(i, j):
        return i * (ny + 1) + j

    I, J = np.meshgrid(np.arange(nx), np.arange(ny), indexing="ij")
    v00 = vid(I, J).ravel()
    v10 = vid(I + 1, J).ravel()
    v01 = vid(I, J + 1).ravel()
    v11 = vid(I + 1, J + 1).ravel()
    if diagonal == "right":
        t1 = np.stack([v00, v10, v11], axis=1)
        t2 = np.stack([v00, v11, v01], axis=1)
    elif diagonal == "left":
        t1 = np.stack([v00, v10, v01], axis=1)
        t2 = np.stack([v10, v11, v01], axis=1)
    else:
        raise ValueError(f"unknown diagonal {diagonal!r}")
    cells = np.concatenate([t1, t2], axis=0)
    info = StructuredInfo(
        origin=np.array([p0[0], p0[1]], dtype=float),
        spacing=np.array([(p1[0] - p0[0]) / nx, (p1[1] - p0[1]) / ny]),
        shape=(nx, ny),
        nshapes=2,
    )
    return Mesh(pts, cells, "triangle", structured=info)


def create_unit_square(nx: int, ny: int | None = None) -> Mesh:
    ny = nx if ny is None else ny
    return create_rectangle((0.0, 0.0), (1.0, 1.0), (nx, ny))


def create_box(
    p0: tuple[float, float, float],
    p1: tuple[float, float, float],
    n: tuple[int, int, int],
) -> Mesh:
    """Tetrahedralized box: each hex cell split into 6 tets (Kuhn split).

    The Kuhn split triangulates every cube identically along the main
    diagonal, so facet triangulations agree between adjacent cubes.
    """
    nx, ny, nz = n
    xs = np.linspace(p0[0], p1[0], nx + 1)
    ys = np.linspace(p0[1], p1[1], ny + 1)
    zs = np.linspace(p0[2], p1[2], nz + 1)
    X, Y, Z = np.meshgrid(xs, ys, zs, indexing="ij")
    pts = np.stack([X.ravel(), Y.ravel(), Z.ravel()], axis=1)

    def vid(i, j, k):
        return (i * (ny + 1) + j) * (nz + 1) + k

    I, J, K = np.meshgrid(np.arange(nx), np.arange(ny), np.arange(nz), indexing="ij")
    I, J, K = I.ravel(), J.ravel(), K.ravel()
    c = {}
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                c[(dx, dy, dz)] = vid(I + dx, J + dy, K + dz)
    # Kuhn: for each permutation (e1,e2,e3) of unit steps, the tet
    # [000, e1, e1+e2, 111]
    import itertools

    tets = []
    for perm in itertools.permutations([(1, 0, 0), (0, 1, 0), (0, 0, 1)]):
        a = (0, 0, 0)
        b = perm[0]
        cc = tuple(np.add(perm[0], perm[1]))
        d = (1, 1, 1)
        tets.append(np.stack([c[a], c[b], c[cc], c[d]], axis=1))
    cells = np.concatenate(tets, axis=0)
    info = StructuredInfo(
        origin=np.array(p0, dtype=float),
        spacing=np.array(
            [(p1[0] - p0[0]) / nx, (p1[1] - p0[1]) / ny, (p1[2] - p0[2]) / nz]
        ),
        shape=(nx, ny, nz),
        nshapes=6,
    )
    return Mesh(pts, cells, "tetrahedron", structured=info)


def create_unit_cube(nx: int, ny: int | None = None, nz: int | None = None) -> Mesh:
    ny = nx if ny is None else ny
    nz = nx if nz is None else nz
    return create_box((0.0, 0.0, 0.0), (1.0, 1.0, 1.0), (nx, ny, nz))


def create_cylinder_channel(
    res: int = 40,
    length: float = 2.2,
    height: float = 0.41,
    center: tuple[float, float] = (0.2, 0.2),
    radius: float = 0.05,
) -> Mesh:
    """Channel with a circular obstacle (DFG 2D cylinder benchmark geometry).

    Construction: uniform triangulated rectangle, remove cells whose
    centroid falls inside the circle, then project the ring of vertices
    inside/near the circle onto it. Produces an unstructured mesh (no
    ``structured`` fast path) exercising the general assembly engine.
    """
    ny = res
    nx = int(round(res * length / height))
    base = create_rectangle((0.0, 0.0), (length, height), (nx, ny))
    c = np.asarray(center)
    pts = base.x.copy()
    d_v = np.linalg.norm(pts - c, axis=1)

    centroid = pts[base.cells].mean(axis=1)
    d_c = np.linalg.norm(centroid - c, axis=1)
    keep = d_c > radius
    cells = base.cells[keep]

    # project interior/near-circle vertices used by remaining cells onto it
    used = np.unique(cells)
    h = height / ny
    snap = np.zeros(len(pts), dtype=bool)
    snap[used] = d_v[used] < radius + 0.35 * h
    r_safe = np.where(d_v > 1e-12, d_v, 1.0)
    proj = c + (pts - c) * (radius / r_safe)[:, None]
    pts[snap] = proj[snap]

    # compact vertex numbering
    remap = -np.ones(len(pts), dtype=np.int64)
    remap[used] = np.arange(len(used))
    pts_u, cells_u = pts[used], remap[cells]

    # --- unfold + equidistribute the circle polygon -----------------------
    # Snapping a lattice band onto the circle can FOLD the boundary: two
    # lattice vertices land at nearly the same angle, connected through
    # the interior rather than directly — near-duplicate boundary dofs
    # that destroy conditioning (and, under refinement, the solve).  Walk
    # the circle boundary cycle and re-space its vertices uniformly in
    # angle along the cycle order; then Laplacian-smooth the nearby
    # interior vertices against the new positions.
    nvu = len(pts_u)
    edges = np.vstack([
        np.sort(cells_u[:, [1, 2]], axis=1),
        np.sort(cells_u[:, [0, 2]], axis=1),
        np.sort(cells_u[:, [0, 1]], axis=1),
    ])
    ek, cnt = np.unique(edges[:, 0] * nvu + edges[:, 1], return_counts=True)
    bed = np.stack([ek[cnt == 1] // nvu, ek[cnt == 1] % nvu], axis=1)
    du = np.linalg.norm(pts_u - c, axis=1)
    # the hole polygon mixes snapped (on-circle) and near-circle vertices;
    # walk the whole cycle and enforce MONOTONE angles with a minimum
    # angular gap (radii untouched): folds collapse two vertices to
    # near-identical angles without a connecting edge, which crowds dofs
    # and makes refinement-time circle projection create near-duplicate
    # vertices that blow up the solve
    onc = du < radius + 1.5 * h
    cyc_ed = bed[onc[bed[:, 0]] & onc[bed[:, 1]]]
    if len(cyc_ed):
        nbr: dict[int, list[int]] = {}
        for a, b in cyc_ed:
            nbr.setdefault(int(a), []).append(int(b))
            nbr.setdefault(int(b), []).append(int(a))
        if all(len(v) == 2 for v in nbr.values()):
            start = min(nbr)
            cycle = [start, nbr[start][0]]
            while cycle[-1] != start:
                a, b = nbr[cycle[-1]]
                cycle.append(a if a != cycle[-2] else b)
            cycle = cycle[:-1]
            if len(cycle) == len(nbr):
                n_cyc = len(cycle)
                th = np.arctan2(*(pts_u[cycle] - c).T[::-1])
                steps = np.angle(np.exp(1j * np.diff(np.r_[th, th[0]])))
                sgn = 1.0 if steps.sum() > 0 else -1.0
                th_m = sgn * th  # monotone-increasing walk direction
                gmin = 0.25 * 2 * np.pi / n_cyc
                th_fix = th_m.copy()
                for i in range(1, n_cyc):
                    th_fix[i] = th_fix[i - 1] + max(
                        gmin, np.angle(np.exp(1j * (th_m[i] - th_fix[i - 1])))
                    )
                # rescale so the cycle still closes over exactly 2*pi
                span = th_fix[-1] - th_fix[0] + max(
                    gmin, np.angle(np.exp(1j * (th_m[0] - th_fix[-1])))
                )
                th_new = sgn * (
                    th_fix[0] + (th_fix - th_fix[0]) * 2 * np.pi / span
                )
                d_cyc = du[cycle]
                pts_u[cycle, 0] = c[0] + d_cyc * np.cos(th_new)
                pts_u[cycle, 1] = c[1] + d_cyc * np.sin(th_new)

    mesh = Mesh(pts_u, cells_u, "triangle")
    vols = mesh.cell_volumes()
    if vols.min() <= 1e-12 * vols.max():
        raise ValueError(
            "degenerate cells after cylinder projection; increase resolution"
        )
    return mesh


def refine_triangles(mesh: Mesh, mark: np.ndarray, project=None) -> Mesh:
    """Conforming red-green refinement of a triangle mesh.

    ``mark``: boolean per cell.  Marked cells are red-split into 4
    children via edge midpoints; closure: any cell with >= 2 split edges
    is promoted to red, cells with exactly one split edge are green-split
    into 2 (no hanging nodes).  ``project(pts) -> pts`` is applied to
    midpoints of edges whose BOTH endpoints it moves (within 1e-12), so
    curved boundaries (e.g. the DFG cylinder circle) regain their shape
    at every level instead of freezing the coarse polygon.

    The reference gets graded boundary-fitted meshes from Gmsh via
    DOLFINx; this is the in-repo equivalent for locally resolving the
    cylinder boundary layer (FIDELITY: Cd/Cl vs the Schaefer-Turek band).
    """
    cells = np.asarray(mesh.cells)
    pts = np.asarray(mesh.x)
    nc = len(cells)
    mark = np.asarray(mark, bool).copy()

    # cell edges as sorted vertex pairs; edge key = min * nv + max
    nv = len(pts)
    e_local = [(1, 2), (0, 2), (0, 1)]  # edge i is opposite vertex i
    cell_edges = np.stack(
        [np.sort(cells[:, list(le)], axis=1) for le in e_local], axis=1
    )  # (nc, 3, 2)
    keys = cell_edges[:, :, 0].astype(np.int64) * nv + cell_edges[:, :, 1]
    ukeys, inv, ucnt = np.unique(keys, return_inverse=True, return_counts=True)
    inv = inv.reshape(nc, 3)

    # closure iteration: split all edges of marked cells; promote cells
    # with >= 2 split edges to marked
    split = np.zeros(len(ukeys), dtype=bool)
    while True:
        split[inv[mark].ravel()] = True
        nsplit = split[inv].sum(axis=1)
        promote = (~mark) & (nsplit >= 2)
        if not promote.any():
            break
        mark |= promote

    # midpoint vertices for split edges
    eidx = np.where(split)[0]
    mid_id = np.full(len(ukeys), -1, dtype=np.int64)
    mid_id[eidx] = nv + np.arange(len(eidx))
    va = (ukeys[eidx] // nv).astype(np.int64)
    vb = (ukeys[eidx] % nv).astype(np.int64)
    mids = 0.5 * (pts[va] + pts[vb])
    if project is not None and len(mids):
        pa, pb = project(pts[va].copy()), project(pts[vb].copy())
        on_a = np.linalg.norm(pa - pts[va], axis=1) < 1e-12
        on_b = np.linalg.norm(pb - pts[vb], axis=1) < 1e-12
        # BOUNDARY edges only: an interior secant whose endpoints both lie
        # on the curve must keep its straight midpoint (projecting it
        # would park a new vertex on top of the boundary polygon)
        curved = on_a & on_b & (ucnt[eidx] == 1)
        if curved.any():
            mids[curved] = project(mids[curved].copy())
    new_pts = np.vstack([pts, mids])

    new_cells = []
    red = np.where(mark)[0]
    green1 = np.where((~mark) & (split[inv].sum(axis=1) == 1))[0]
    keep = np.where((~mark) & (split[inv].sum(axis=1) == 0))[0]
    new_cells.append(cells[keep])
    # red: 4 children from (v0, v1, v2) and midpoints (m0, m1, m2)
    if len(red):
        v = cells[red]
        m = mid_id[inv[red]]
        assert (m >= 0).all()
        new_cells.append(np.stack([v[:, 0], m[:, 2], m[:, 1]], axis=1))
        new_cells.append(np.stack([v[:, 1], m[:, 0], m[:, 2]], axis=1))
        new_cells.append(np.stack([v[:, 2], m[:, 1], m[:, 0]], axis=1))
        new_cells.append(m)
    # green: bisect by connecting the split edge's midpoint to the
    # opposite vertex
    if len(green1):
        v = cells[green1]
        m = mid_id[inv[green1]]
        which = np.argmax(m >= 0, axis=1)
        rows = np.arange(len(green1))
        mm = m[rows, which]
        vo = v[rows, which]  # opposite vertex of the split edge
        e = np.asarray(e_local)[which]
        v1 = v[rows, e[:, 0]]
        v2 = v[rows, e[:, 1]]
        new_cells.append(np.stack([vo, v1, mm], axis=1))
        new_cells.append(np.stack([vo, mm, v2], axis=1))
    all_cells = np.vstack(new_cells)

    # quality guard: projecting a midpoint onto the curve can land it
    # (nearly) on top of an existing snapped vertex, creating sliver
    # cells that blow up the solve.  Scale-invariant quality
    # q = 2*vol/lmax^2; for cells with q < 0.05 revert their midpoint
    # vertices to the straight edge midpoints (isolated flat spots on the
    # polygon are harmless; slivers are not).
    def quality(p, cl):
        a, b, cc = p[cl[:, 0]], p[cl[:, 1]], p[cl[:, 2]]
        vol = 0.5 * np.abs(
            (b[:, 0] - a[:, 0]) * (cc[:, 1] - a[:, 1])
            - (b[:, 1] - a[:, 1]) * (cc[:, 0] - a[:, 0])
        )
        lmax = np.maximum(
            np.maximum(
                ((b - a) ** 2).sum(1), ((cc - b) ** 2).sum(1)
            ),
            ((a - cc) ** 2).sum(1),
        )
        return 2.0 * vol / np.maximum(lmax, 1e-300)

    if project is not None and len(mids):
        straight = 0.5 * (pts[va] + pts[vb])
        for _ in range(3):
            q = quality(new_pts, all_cells)
            bad = q < 0.05
            if not bad.any():
                break
            bad_verts = np.unique(all_cells[bad])
            bad_mids = bad_verts[bad_verts >= nv] - nv
            if not len(bad_mids):
                break
            new_pts[nv + bad_mids] = straight[bad_mids]

    out = Mesh(new_pts, all_cells, "triangle")
    vols = out.cell_volumes()
    # orientation repair: children inherit parent orientation up to
    # midpoint ordering; flip any negatively-oriented cells
    if (vols <= 0).any():
        neg = vols <= 0
        c = out.cells.copy()
        c[neg] = c[neg][:, [0, 2, 1]]
        out = Mesh(new_pts, c, "triangle")
        vols = out.cell_volumes()
    assert (vols > 0).all()
    return out
