"""I/O: mesh import and export, time-series field output, checkpoint and
resume.

Counterpart of ``oasisx_tpu/io.py``, on the host (none of this is on a
step's path):

- ``import_mesh`` / ``import_mesh_with_tags``: .npz (points, cells, optional
  facet tags), Gmsh ASCII .msh v2.2 and v4.1 with physical groups as facet
  tags, and a 10x10 unit square for a missing file.
- ``write_gmsh22`` and ``write_vtu``: the same bytes as the JAX package's
  writers for the same mesh and data.
- ``VTXWriter``: a VTU series (P1 vertex data), a ParaView ``.pvd``
  collection and one lossless ``.npz`` of the full dof vectors a step.
- ``Checkpoint``: the solver state (t, step, p, dp, u{i}, u1_{i}, u2_{i})
  in the canonical dof order, the JAX package's keys, so a checkpoint
  written by either package restores into the other.

Function tensors are read on the host as float64 (``.cpu()``), the JAX
package's storage type; ``Checkpoint.load`` writes them back into the
solver's Functions on its device with ``copy_``, which the solver's state
check sees, so the next ``run`` starts from the loaded state.
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np
import torch

from .meshes.generation import create_unit_square
from .meshes.mesh import Mesh

_VTK_CELL = {"interval": 3, "triangle": 5, "tetrahedron": 10}


def _host(a) -> np.ndarray:
    """A Function's values on the host in float64."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().double().numpy()
    return np.asarray(a)


def import_mesh(path: str | os.PathLike) -> Mesh:
    """Import a mesh from .npz (points, cells, cell_type) or Gmsh .msh
    (ASCII v2.2 or v4.1).

    Falls back to a 10x10 unit square when the file is missing, as the
    JAX package does."""
    return import_mesh_with_tags(path)[0]


def import_mesh_with_tags(path: str | os.PathLike):
    """Import a mesh plus its tagged boundary facets (Gmsh physical groups
    mapped onto mesh facet indices): returns (Mesh, MeshTags | None).

    .npz files may carry ``facet_tags_indices`` / ``facet_tags_values``
    arrays; .msh files (ASCII v2.2 and v4.1) read physical surface/line
    groups (the vessel demo's inlet, wall and outlet surfaces)."""
    from .meshes.tags import MeshTags

    p = Path(path) if path is not None else None
    if p is None or not p.exists():
        if p is not None:
            import logging

            logging.getLogger("oasisx_tpu_torch").warning(
                "mesh file %s not found; falling back to a 10x10 unit square", p
            )
        return create_unit_square(10, 10), None
    if p.suffix == ".npz":
        data = np.load(p, allow_pickle=False)
        cell_type = str(data["cell_type"]) if "cell_type" in data else None
        cells = data["cells"]
        if cell_type is None:
            cell_type = {2: "interval", 3: "triangle", 4: "tetrahedron"}[cells.shape[1]]
        mesh = Mesh(data["points"], cells, cell_type)
        tags = None
        if "facet_tags_indices" in data:
            tags = MeshTags(
                mesh, mesh.dim - 1,
                np.asarray(data["facet_tags_indices"], dtype=np.int32),
                np.asarray(data["facet_tags_values"], dtype=np.int32),
            )
        return mesh, tags
    if p.suffix == ".msh":
        head = p.read_text().splitlines()
        version = "2.2"
        for i, line in enumerate(head[:5]):
            if line.strip() == "$MeshFormat":
                version = head[i + 1].split()[0]
                break
        if version.startswith("4"):
            mesh, fverts, fvals = _read_gmsh4(p)
        else:
            mesh, fverts, fvals = _read_gmsh22(p)
        return mesh, _facet_tags_from_vertex_sets(mesh, fverts, fvals)
    raise ValueError(f"unsupported mesh format: {p.suffix}")


def _facet_tags_from_vertex_sets(mesh: Mesh, fverts, fvals):
    """Map tagged boundary entities (given by vertex sets) onto the mesh's
    facet numbering."""
    from .meshes.tags import MeshTags

    if not fverts:
        return None
    top = mesh.topology
    keys = np.sort(top.facets, axis=1)
    order = np.lexsort(keys.T[::-1])
    keys_sorted = keys[order]
    q = np.sort(np.asarray(fverts, dtype=keys.dtype), axis=1)
    # row-wise binary search
    pos = np.searchsorted(
        _row_keys(keys_sorted, mesh.num_vertices), _row_keys(q, mesh.num_vertices)
    )
    nkeys = keys_sorted.shape[0]
    ok = pos < nkeys
    ok[ok] &= (keys_sorted[pos[ok]] == q[ok]).all(axis=1)
    if not ok.all():
        import logging

        logging.getLogger("oasisx_tpu_torch").warning(
            "%d tagged gmsh facets not found in the mesh facet list (skipped)",
            int((~ok).sum()),
        )
    idx = order[pos[ok]].astype(np.int32)
    vals = np.asarray(fvals, dtype=np.int32)[ok]
    srt = np.argsort(idx)
    return MeshTags(mesh, mesh.dim - 1, idx[srt], vals[srt])


def _row_keys(rows: np.ndarray, base: int) -> np.ndarray:
    keys = np.zeros(rows.shape[0], dtype=np.int64)
    for k in range(rows.shape[1]):
        keys = keys * base + rows[:, k]
    return keys


def _read_gmsh22(path: Path):
    """Gmsh ASCII v2.2 reader: nodes + highest-dim elements + tagged
    boundary elements (physical group = first tag)."""
    lines = path.read_text().splitlines()
    i = 0
    nodes = {}
    elems = {4: [], 2: [], 1: []}  # gmsh type -> vertex lists (tet, tri, line)
    while i < len(lines):
        line = lines[i].strip()
        if line == "$Nodes":
            n = int(lines[i + 1])
            for k in range(n):
                parts = lines[i + 2 + k].split()
                nodes[int(parts[0])] = [float(x) for x in parts[1:4]]
            i += n + 2
        elif line == "$Elements":
            n = int(lines[i + 1])
            for k in range(n):
                parts = lines[i + 2 + k].split()
                etype = int(parts[1])
                ntags = int(parts[2])
                verts = [int(v) for v in parts[3 + ntags :]]
                phys = int(parts[3]) if ntags >= 1 else 0
                if etype in elems:
                    elems[etype].append((verts, phys))
            i += n + 2
        else:
            i += 1
    ids = sorted(nodes)
    remap = {nid: j for j, nid in enumerate(ids)}
    pts = np.array([nodes[nid] for nid in ids])
    if elems[4]:
        cells = np.array([[remap[v] for v in e] for e, _ in elems[4]], dtype=np.int32)
        fverts = [[remap[v] for v in e] for e, ph in elems[2] if ph]
        fvals = [ph for _, ph in elems[2] if ph]
        return Mesh(pts, cells, "tetrahedron"), fverts, fvals
    if elems[2]:
        cells = np.array([[remap[v] for v in e] for e, _ in elems[2]], dtype=np.int32)
        fverts = [[remap[v] for v in e] for e, ph in elems[1] if ph]
        fvals = [ph for _, ph in elems[1] if ph]
        return Mesh(pts[:, :2], cells, "triangle"), fverts, fvals
    raise ValueError(f"no triangles or tetrahedra found in {path}")


def _read_gmsh4(path: Path):
    """Gmsh ASCII v4.1 reader: $Entities physical tags, block-format
    $Nodes/$Elements; returns (Mesh, tagged facet vertex sets, values)."""
    lines = path.read_text().splitlines()
    i = 0
    sections: dict[str, tuple[int, int]] = {}
    while i < len(lines):
        t = lines[i].strip()
        if t.startswith("$") and not t.startswith("$End"):
            name = t[1:]
            j = i + 1
            while j < len(lines) and lines[j].strip() != f"$End{name}":
                j += 1
            sections[name] = (i + 1, j)
            i = j + 1
        else:
            i += 1

    # entity (dim, tag) -> physical tag (first one)
    ent_phys: dict[tuple[int, int], int] = {}
    if "Entities" in sections:
        a, b = sections["Entities"]
        counts = [int(x) for x in lines[a].split()]  # nPoints nCurves nSurf nVol
        row = a + 1
        for dim, cnt in enumerate(counts):
            for _ in range(cnt):
                parts = lines[row].split()
                tag = int(parts[0])
                # points: tag x y z numPhys phys...; others: tag box(6) numPhys ...
                off = 4 if dim == 0 else 7
                nphys = int(parts[off])
                if nphys > 0:
                    ent_phys[(dim, tag)] = int(parts[off + 1])
                row += 1

    a, b = sections["Nodes"]
    hdr = [int(x) for x in lines[a].split()]
    nblocks = hdr[0]
    row = a + 1
    node_ids: list[int] = []
    coords: list[list[float]] = []
    for _ in range(nblocks):
        _ed, _et, _param, nn = [int(x) for x in lines[row].split()]
        row += 1
        ids = [int(lines[row + k]) for k in range(nn)]
        row += nn
        for k in range(nn):
            coords.append([float(x) for x in lines[row + k].split()[:3]])
        row += nn
        node_ids.extend(ids)
    remap = {nid: j for j, nid in enumerate(node_ids)}
    pts = np.asarray(coords)

    a, b = sections["Elements"]
    hdr = [int(x) for x in lines[a].split()]
    nblocks = hdr[0]
    row = a + 1
    cells3, cells2, tagged = [], [], {2: ([], []), 1: ([], [])}
    for _ in range(nblocks):
        edim, etag, etype, ne = [int(x) for x in lines[row].split()]
        row += 1
        phys = ent_phys.get((edim, etag), 0)
        for k in range(ne):
            parts = [int(x) for x in lines[row + k].split()]
            verts = [remap[v] for v in parts[1:]]
            if etype == 4:
                cells3.append(verts)
            elif etype == 2:
                cells2.append(verts)
                if phys:
                    tagged[2][0].append(verts)
                    tagged[2][1].append(phys)
            elif etype == 1 and phys:
                tagged[1][0].append(verts)
                tagged[1][1].append(phys)
        row += ne
    if cells3:
        return (
            Mesh(pts, np.asarray(cells3, dtype=np.int32), "tetrahedron"),
            tagged[2][0],
            tagged[2][1],
        )
    if cells2:
        return (
            Mesh(pts[:, :2], np.asarray(cells2, dtype=np.int32), "triangle"),
            tagged[1][0],
            tagged[1][1],
        )
    raise ValueError(f"no triangles or tetrahedra found in {path}")


def write_gmsh22(path: str | os.PathLike, mesh: Mesh, tags=None) -> None:
    """Write a Gmsh ASCII v2.2 file: nodes, highest-dim elements, and —
    when ``tags`` (a facet MeshTags) is given — tagged boundary elements
    with their physical group as the first element tag.  Round-trips
    through :func:`import_mesh_with_tags`; the export half of the gmsh
    pipeline, for tagged meshes of the vessel demo."""
    cell_etype = {"triangle": 2, "tetrahedron": 4}[mesh.cell_type]
    facet_etype = {"triangle": 1, "tetrahedron": 2}[mesh.cell_type]
    pts3 = np.zeros((mesh.num_vertices, 3))
    pts3[:, : mesh.gdim] = mesh.x
    lines = ["$MeshFormat", "2.2 0 8", "$EndMeshFormat"]
    lines.append("$Nodes")
    lines.append(str(mesh.num_vertices))
    for i, p in enumerate(pts3):
        lines.append(f"{i + 1} {p[0]:.16g} {p[1]:.16g} {p[2]:.16g}")
    lines.append("$EndNodes")
    fac = []
    if tags is not None:
        fverts = mesh.topology.facets[np.asarray(tags.indices)]
        fac = list(zip(fverts.tolist(), np.asarray(tags.values).tolist()))
    lines.append("$Elements")
    lines.append(str(mesh.num_cells + len(fac)))
    eid = 1
    for verts, phys in fac:
        vs = " ".join(str(v + 1) for v in verts)
        lines.append(f"{eid} {facet_etype} 2 {phys} {phys} {vs}")
        eid += 1
    for c in mesh.cells:
        vs = " ".join(str(v + 1) for v in c)
        lines.append(f"{eid} {cell_etype} 2 0 0 {vs}")
        eid += 1
    lines.append("$EndElements")
    Path(path).write_text("\n".join(lines) + "\n")


def write_vtu(path: str | os.PathLike, mesh: Mesh, point_data: dict | None = None) -> None:
    """Write a VTU (XML unstructured grid, ASCII) file with vertex data.

    Fields are sampled at mesh vertices (for P>=1 Lagrange the vertex dofs
    are the leading block of the dof vector — spaces/dofmap.py layout)."""
    nv = mesh.num_vertices
    nc = mesh.num_cells
    pts3 = np.zeros((nv, 3))
    pts3[:, : mesh.gdim] = mesh.x
    nverts = mesh.cells.shape[1]
    with open(path, "w") as f:
        f.write('<?xml version="1.0"?>\n')
        f.write('<VTKFile type="UnstructuredGrid" version="0.1" byte_order="LittleEndian">\n')
        f.write(f'<UnstructuredGrid><Piece NumberOfPoints="{nv}" NumberOfCells="{nc}">\n')
        f.write('<Points><DataArray type="Float64" NumberOfComponents="3" format="ascii">\n')
        np.savetxt(f, pts3, fmt="%.10g")
        f.write("</DataArray></Points>\n<Cells>\n")
        f.write('<DataArray type="Int32" Name="connectivity" format="ascii">\n')
        np.savetxt(f, mesh.cells, fmt="%d")
        f.write('</DataArray>\n<DataArray type="Int32" Name="offsets" format="ascii">\n')
        np.savetxt(f, np.arange(1, nc + 1) * nverts, fmt="%d")
        f.write('</DataArray>\n<DataArray type="UInt8" Name="types" format="ascii">\n')
        np.savetxt(f, np.full(nc, _VTK_CELL[mesh.cell_type]), fmt="%d")
        f.write("</DataArray>\n</Cells>\n<PointData>\n")
        for name, arr in (point_data or {}).items():
            arr = _host(arr)
            ncomp = 1 if arr.ndim == 1 else arr.shape[1]
            if ncomp == 2:  # pad 2D vectors for ParaView
                arr = np.column_stack([arr, np.zeros(len(arr))])
                ncomp = 3
            f.write(
                f'<DataArray type="Float64" Name="{name}" '
                f'NumberOfComponents="{ncomp}" format="ascii">\n'
            )
            np.savetxt(f, arr, fmt="%.10g")
            f.write("</DataArray>\n")
        f.write("</PointData>\n</Piece></UnstructuredGrid></VTKFile>\n")


class VTXWriter:
    """Time-series writer (``VTXWriter(filename, [functions]); write(t);
    close()``).  Produces ``<stem>_NNNNN.vtu`` files plus a ParaView
    ``.pvd`` collection and an ``.npz`` per step with the full dof vectors
    (float64, lossless for either dtype).  Each write reads the Functions'
    tensors on the host."""

    def __init__(self, filename: str | os.PathLike, functions: list, engine: str = "vtu"):
        self._stem = Path(filename).with_suffix("")
        self._stem.parent.mkdir(parents=True, exist_ok=True)
        self._functions = functions
        self._steps: list[tuple[float, str]] = []

    def write(self, t: float) -> None:
        idx = len(self._steps)
        mesh = self._functions[0].function_space.mesh
        nv = mesh.num_vertices
        point_data = {}
        raw = {}
        for f in self._functions:
            V = f.function_space
            arr = _host(f.x.array)
            raw[f.name] = arr
            if V.bs == 1:
                point_data[f.name] = arr[:nv]
            else:
                point_data[f.name] = arr.reshape(-1, V.bs)[:nv]
        fname = f"{self._stem.name}_{idx:05d}.vtu"
        write_vtu(self._stem.parent / fname, mesh, point_data)
        np.savez(self._stem.parent / f"{self._stem.name}_{idx:05d}.npz", t=t, **raw)
        self._steps.append((t, fname))

    def close(self) -> None:
        pvd = ['<?xml version="1.0"?>', '<VTKFile type="Collection" version="0.1">', "<Collection>"]
        for t, fname in self._steps:
            pvd.append(f'<DataSet timestep="{t}" part="0" file="{fname}"/>')
        pvd += ["</Collection>", "</VTKFile>"]
        (self._stem.parent / f"{self._stem.name}.pvd").write_text("\n".join(pvd))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class Checkpoint:
    """Solver state checkpoint/resume (u, u1, u2, p, dp, t, step), the JAX
    package's file: either package's solver loads the other's."""

    def __init__(self, path: str | os.PathLike):
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)

    def save(self, solver, t: float, step: int) -> None:
        data = dict(t=t, step=step, p=_host(solver._p.x.array), dp=_host(solver._dp.x.array))
        for i in range(solver._mesh.dim):
            data[f"u{i}"] = _host(solver._u[i].x.array)
            data[f"u1_{i}"] = _host(solver._u1[i].x.array)
            data[f"u2_{i}"] = _host(solver._u2[i].x.array)
        np.savez(self.path, **data)

    def load(self, solver) -> tuple[float, int]:
        data = np.load(self.path)
        put = lambda f, key: f.x.array.copy_(torch.as_tensor(data[key]))
        put(solver._p, "p")
        put(solver._dp, "dp")
        for i in range(solver._mesh.dim):
            put(solver._u[i], f"u{i}")
            put(solver._u1[i], f"u1_{i}")
            put(solver._u2[i], f"u2_{i}")
        return float(data["t"]), int(data["step"])
