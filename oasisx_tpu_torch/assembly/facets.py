"""Exterior-facet (surface) assembly: the outlet pressure condition and
the surface traction.

Counterpart of ``oasisx_tpu/assembly/facets.py``: the form
``p * n_i * v.dx(i) * ds(tag)`` of the pseudo-traction outlet, and the
traction integral over a tagged facet set (``surface_traction``: the DFG
cylinder's drag and lift).  Host setup
per tagged facet set: owning cell, local facet index, surface scale,
outward unit normal, and per-local-facet tabulations of the cell bases at
facet quadrature points.  Assembly is a batched contraction over facets and
a deterministic scatter: the facets' contributions to each touched dof are
summed through a transpose map, in a fixed order, as the cell scatter of
``engine.py`` does.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..elements.element import FiniteElement
from ..elements.nodes import REFERENCE_VERTICES
from ..elements.quadrature import quadrature
from ..meshes.mesh import CELL_FACETS, Mesh
from ..parallel.graph import halo_refresh
from .engine import DeviceContext, build_transpose_map, fold, transpose_scatter


@dataclass
class FacetContext:
    """Tensors for one tagged exterior-facet set."""

    cells: torch.Tensor  # (nf,) int64 owning cell
    local: torch.Tensor  # (nf,) int64 local facet id
    scale: torch.Tensor  # (nf,) surface jacobian scale
    normal: torch.Tensor  # (nf, d) outward unit normal
    qw: torch.Tensor  # (nqf,)
    dphi_v: torch.Tensor  # (nlf, nqf, d, ndv)
    phi_q: torch.Tensor  # (nlf, nqf, ndq)
    # the V dofs of the facets' cells and their transpose map
    dofs_v: torch.Tensor  # (nt,) the touched V dofs
    pos_v: torch.Tensor  # (nt, m) positions into the flattened (nf*ndv) values
    nfacets: int


def build_facet_context(
    mesh: Mesh,
    el_v: FiniteElement,
    el_q: FiniteElement,
    facet_ids: np.ndarray,
    cd_v: np.ndarray,
    dtype: torch.dtype,
    device: torch.device,
    qdegree: int | None = None,
) -> FacetContext:
    top = mesh.topology
    facet_ids = np.asarray(facet_ids, dtype=np.int64)
    cells = top.facet_cells[facet_ids, 0]
    local = top.facet_local[facet_ids, 0]
    if (top.facet_cells[facet_ids, 1] >= 0).any():
        raise ValueError("surface assembly expects exterior facets")
    d = mesh.dim
    if qdegree is None:
        qdegree = max(el_v.degree + el_q.degree, 2 * el_v.degree, 2)

    # physical scale and outward normal (affine facets)
    fverts = mesh.x[top.facets[facet_ids]]  # (nf, d, gdim)
    if d == 2:
        t = fverts[:, 1] - fverts[:, 0]
        scale = np.linalg.norm(t, axis=1)
        n = np.stack([t[:, 1], -t[:, 0]], axis=1) / scale[:, None]
    elif d == 3:
        cr = np.cross(fverts[:, 1] - fverts[:, 0], fverts[:, 2] - fverts[:, 0])
        scale = np.linalg.norm(cr, axis=1)  # = 2*area; ref-tri weights sum to 1/2
        n = cr / scale[:, None]
    else:
        scale = np.ones(len(facet_ids))
        n = np.ones((len(facet_ids), 1))
    # orient outward: away from the cell centroid
    centroids = mesh.x[mesh.cells[cells]].mean(axis=1)
    fmid = fverts.mean(axis=1)
    flip = np.einsum("fg,fg->f", n, fmid - centroids) < 0
    n[flip] *= -1.0

    # reference-facet quadrature mapped into the cell, per local facet
    fcell = "interval" if d == 2 else ("triangle" if d == 3 else None)
    if fcell is None:
        qf, wf = np.zeros((1, 0)), np.ones(1)
    else:
        qf, wf = quadrature(fcell, qdegree)
    ref_verts = REFERENCE_VERTICES[mesh.cell_type]
    lf_dtab_v, lf_tab_q = [], []
    for lf in range(d + 1):
        FV = ref_verts[CELL_FACETS[mesh.cell_type][lf]]  # (d, d)
        X = FV[0][None, :] + qf @ (FV[1:] - FV[0][None, :])  # (nqf, d)
        _, dv = el_v.tabulate(X)
        pq, _ = el_q.tabulate(X)
        lf_dtab_v.append(dv)
        lf_tab_q.append(pq)

    # transpose map over the touched dofs only
    fcd = np.asarray(cd_v)[cells]  # (nf, ndv)
    dofs, inv = np.unique(fcd.reshape(-1), return_inverse=True)
    pos = build_transpose_map(inv.reshape(fcd.shape), len(dofs))

    a = lambda x: torch.as_tensor(np.asarray(x, np.float64), device=device).to(dtype)
    i = lambda x: torch.as_tensor(np.asarray(x, np.int64), device=device)
    return FacetContext(
        cells=i(cells),
        local=i(local),
        scale=a(scale),
        normal=a(n),
        qw=a(wf),
        dphi_v=a(np.stack(lf_dtab_v)),
        phi_q=a(np.stack(lf_tab_q)),
        dofs_v=i(dofs),
        pos_v=i(pos),
        nfacets=int(len(facet_ids)),
    )


def pressure_surface_vecs(
    ctx: DeviceContext, fctx: FacetContext, p_qvals: torch.Tensor
) -> torch.Tensor:
    """r_i = int_ds p n_i dv/dx_i for every component i: (d, ndofs_v).

    ``p_qvals``: the pressure at the facet quadrature points, (nf, nqf)."""
    Kc = ctx.Kinv[fctx.cells]  # (nf, b, g)
    dphi = fctx.dphi_v[fctx.local]  # (nf, nqf, b, j)
    core = torch.einsum("q,fq,fqbj->fbj", fctx.qw, p_qvals, dphi)
    re = torch.einsum("f,fg,fbg,fbj->gfj", fctx.scale, fctx.normal, Kc, core)
    out = re.new_zeros((re.shape[0], ctx.ndofs_v))
    out[:, fctx.dofs_v] = transpose_scatter(re, fctx.pos_v)
    return fold(ctx, out, ctx.halo_v)


def facet_eval_q(ctx: DeviceContext, fctx: FacetContext, p: torch.Tensor) -> torch.Tensor:
    """Values of a Q-function at the facet quadrature points: (nf, nqf)."""
    if ctx.halo_q is not None:
        p = halo_refresh(p, ctx.halo_q, ctx.comm)
    pe = p[ctx.cd_q[fctx.cells]]  # (nf, m)
    phi = fctx.phi_q[fctx.local]  # (nf, nqf, m)
    return torch.einsum("fqm,fm->fq", phi, pe)


def facet_area(fctx: FacetContext) -> torch.Tensor:
    """The measure of the facet set, a 0-d tensor."""
    return torch.sum(fctx.scale) * torch.sum(fctx.qw)


def surface_traction(ctx: DeviceContext, fctx: FacetContext, u: torch.Tensor, p: torch.Tensor,
                     nu) -> torch.Tensor:
    """Traction integral F_i = int_S [nu (du_i/dx_j + du_j/dx_i) n_j - p n_i]
    ds over the facet set, n the domain-outward normal: the force the
    surroundings exert on the fluid, (d,).  The force on an immersed body is
    its negative (the DFG cylinder's drag and lift).  ``u``: (d, ndofs_v)
    velocity components in the canonical dof order; ``p``: (ndofs_q,).
    Density 1."""
    Kc = ctx.Kinv[fctx.cells]  # (nf, b, g)
    dphi = fctx.dphi_v[fctx.local]  # (nf, nqf, b, j)
    ue = u[:, ctx.cd_v[fctx.cells]]  # (i, nf, j)
    gu = torch.einsum("fbg,fqbj,ifj->ifqg", Kc, dphi, ue)  # grad u at the facet points
    pq = facet_eval_q(ctx, fctx, p)  # (nf, nqf)
    n = fctx.normal  # (nf, g)
    # sigma_ij n_j = nu (du_i/dx_j + du_j/dx_i) n_j - p n_i
    visc = nu * (torch.einsum("ifqg,fg->ifq", gu, n) + torch.einsum("gfqi,fg->ifq", gu, n))
    press = pq[None, :, :] * n.T[:, :, None]  # (i, nf, nqf)
    return torch.einsum("ifq,q,f->i", visc - press, fctx.qw, fctx.scale)
