"""General (unstructured) assembly on tensors: element stacks, gathers and
deterministic scatters.

Counterpart of ``oasisx_tpu/assembly/engine.py`` on one device.  Matrices
are stored element-matrix stacks (ncells, nd, nd); a linear combination of
operators on the shared sparsity is an elementwise combination of stacks;
an operator application is gather -> batched small matmul -> scatter; a
Dirichlet row is a mask applied at matvec time.

The scatter is the JAX package's transpose gather: each dof has a row of
the positions in the flattened per-cell value array that contribute to it
(``build_transpose_map``, padded with a position that holds 0), and its
value is the sum of that row, taken in the row's fixed order.  So a run
repeats bit for bit on the card, where ``index_add_`` would sum with
floating-point atomics in an order that changes between runs.

Every function takes a leading batch of vectors where the JAX one takes
one: ``gather_v(ctx, x)`` for x of shape (..., ndofs_v) gives
(..., ncells, ndv), and ``scatter_v`` the reverse.

Under the graph-halo mode (``parallel/sharding.py``) a context holds one
rank's cells, its dof vectors are the rank's ``[owned | halo | sentinel]``
blocks, and ``halo_v`` / ``halo_q`` (``graph.HaloRounds``) with ``comm``
are set: a gather refreshes the halo slots first, a scatter folds the
halo contributions into their owners after (zeroing the halo), and a
scalar integral is summed over the ranks, as in the JAX package's engine.
Under the replicated mode a context holds one rank's block of cells with
the canonical dofmaps and ``comm`` alone is set: dof vectors are whole on
every rank, a gather is local, and a scatter ends in one sum of the whole
vector over the ranks (``Comm.sum``: the same bits on every rank), as the
integrals do.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..elements.element import FiniteElement
from ..meshes.mesh import Mesh
from ..parallel.graph import halo_fold, halo_refresh
from .geometry import compute_cell_geometry
from .reference_tensors import ReferenceTensors, build_reference_tensors


@dataclass
class DeviceContext:
    """Static per-problem tensors for assembly on one cell batch."""

    cd_v: torch.Tensor  # (nc, ndv) int64, velocity-component cell dofs
    cd_q: torch.Tensor  # (nc, ndq) int64, pressure cell dofs
    detJ: torch.Tensor  # (nc,)
    Kinv: torch.Tensor  # (nc, d, d)
    G: torch.Tensor  # (nc, d, d)
    qw: torch.Tensor  # (nq,)
    phi_v: torch.Tensor  # (nq, ndv)
    dphi_v: torch.Tensor  # (nq, d, ndv)
    phi_q: torch.Tensor  # (nq, ndq)
    dphi_q: torch.Tensor  # (nq, d, ndq)
    mass_ref: torch.Tensor
    massq_ref: torch.Tensor
    stiff_ref: torch.Tensor
    stiffq_ref: torch.Tensor
    conv_ref: torch.Tensor
    mixed_ref: torch.Tensor
    gradq_ref: torch.Tensor
    load_ref: torch.Tensor
    # transpose-gather scatter maps: (ndofs, m) positions into the flattened
    # per-cell value array, padded with nc*nd (an appended zero)
    pos_v: torch.Tensor
    pos_q: torch.Tensor
    ndofs_v: int
    ndofs_q: int
    dim: int
    # the graph-halo mode: this rank's exchange of each space and its Comm;
    # the replicated mode: the Comm alone
    halo_v: object = None
    halo_q: object = None
    comm: object = None


def build_transpose_map(cell_dofs: np.ndarray, num_dofs: int) -> np.ndarray:
    """Invert a (nc, nd) cell-dof map: (num_dofs, m) positions into the
    flattened (nc*nd) per-cell value array, sentinel-padded with nc*nd.
    Within a row the positions ascend (the fixed summation order)."""
    cd = np.asarray(cell_dofs).reshape(-1)
    order = np.argsort(cd, kind="stable")
    counts = np.bincount(cd, minlength=num_dofs)
    m = int(counts.max()) if len(cd) else 1
    sentinel = cd.shape[0]
    pos = np.full((num_dofs, m), sentinel, dtype=np.int64)
    starts = np.zeros(num_dofs + 1, dtype=np.int64)
    np.cumsum(counts, out=starts[1:])
    col = np.arange(len(cd)) - starts[cd[order]]
    pos[cd[order], col] = order
    return pos


def build_device_context(
    mesh: Mesh,
    el_v: FiniteElement,
    cd_v: np.ndarray,
    ndofs_v: int,
    el_q: FiniteElement,
    cd_q: np.ndarray,
    ndofs_q: int,
    dtype: torch.dtype,
    device: torch.device,
    qdegree: int | None = None,
    cells: np.ndarray | None = None,
) -> tuple[DeviceContext, ReferenceTensors]:
    """The context of the mesh's cells, or of the cells ``cells`` (indices,
    in that order) with ``cd_v`` / ``cd_q`` their dofmap rows."""
    geo = compute_cell_geometry(mesh.x, mesh.cells if cells is None else mesh.cells[cells],
                                mesh.dim)
    refs = build_reference_tensors(el_v, el_q, qdegree)
    a = lambda x: torch.as_tensor(np.asarray(x, np.float64), device=device).to(dtype)
    i = lambda x: torch.as_tensor(np.asarray(x, np.int64), device=device)
    ctx = DeviceContext(
        cd_v=i(cd_v),
        cd_q=i(cd_q),
        detJ=a(geo.detJ),
        Kinv=a(geo.Kinv),
        G=a(geo.G),
        qw=a(refs.qweights),
        phi_v=a(refs.phi_v),
        dphi_v=a(refs.dphi_v),
        phi_q=a(refs.phi_q),
        dphi_q=a(refs.dphi_q),
        mass_ref=a(refs.mass),
        massq_ref=a(refs.mass_q),
        stiff_ref=a(refs.stiffness),
        stiffq_ref=a(refs.stiffness_q),
        conv_ref=a(refs.convection),
        mixed_ref=a(refs.mixed_grad),
        gradq_ref=a(refs.grad_q),
        load_ref=a(refs.load),
        pos_v=i(build_transpose_map(cd_v, ndofs_v)),
        pos_q=i(build_transpose_map(cd_q, ndofs_q)),
        ndofs_v=int(ndofs_v),
        ndofs_q=int(ndofs_q),
        dim=mesh.dim,
    )
    return ctx, refs


# ---------------------------------------------------------------------------
# gather / scatter
# ---------------------------------------------------------------------------


def transpose_scatter(vals: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """Sum per-cell values (..., nc, nd) into dofs through a transpose map
    (ndofs, m): gather the contributing positions, then a row sum."""
    lead = vals.shape[:-2]
    flat = vals.reshape(lead + (-1,))
    flat = torch.cat([flat, flat.new_zeros(lead + (1,))], dim=-1)
    return flat[..., pos].sum(dim=-1)


def fold(ctx: DeviceContext, y: torch.Tensor, halo) -> torch.Tensor:
    """A scatter's rank-local sums made global: folded into their owners
    under graph-halo (``halo``: the space's rounds), summed over the ranks
    under the replicated mode."""
    if halo is not None:
        return halo_fold(y, halo, ctx.comm)
    return y if ctx.comm is None else ctx.comm.sum(y)


def scatter_v(ctx: DeviceContext, vals: torch.Tensor) -> torch.Tensor:
    """Per-cell V-local values (..., nc, ndv) -> dof vectors (..., ndofs_v)."""
    return fold(ctx, transpose_scatter(vals, ctx.pos_v), ctx.halo_v)


def scatter_q(ctx: DeviceContext, vals: torch.Tensor) -> torch.Tensor:
    return fold(ctx, transpose_scatter(vals, ctx.pos_q), ctx.halo_q)


def gather_v(ctx: DeviceContext, x: torch.Tensor) -> torch.Tensor:
    """Dof vectors (..., ndofs_v) -> per-cell local values (..., nc, ndv)."""
    if ctx.halo_v is not None:
        x = halo_refresh(x, ctx.halo_v, ctx.comm)
    return x[..., ctx.cd_v]


def gather_q(ctx: DeviceContext, x: torch.Tensor) -> torch.Tensor:
    if ctx.halo_q is not None:
        x = halo_refresh(x, ctx.halo_q, ctx.comm)
    return x[..., ctx.cd_q]


# ---------------------------------------------------------------------------
# element stacks
# ---------------------------------------------------------------------------


def mass_elems(ctx: DeviceContext) -> torch.Tensor:
    """(u, v) dx on V."""
    return ctx.detJ[:, None, None] * ctx.mass_ref[None]


def mass_q_elems(ctx: DeviceContext) -> torch.Tensor:
    """(p, q) dx on Q."""
    return ctx.detJ[:, None, None] * ctx.massq_ref[None]


def stiffness_elems(ctx: DeviceContext) -> torch.Tensor:
    """(grad u, grad v) dx on V."""
    return torch.einsum("c,cab,abij->cij", ctx.detJ, ctx.G, ctx.stiff_ref)


def stiffness_q_elems(ctx: DeviceContext) -> torch.Tensor:
    """(grad p, grad q) dx on Q: the pressure Laplacian."""
    return torch.einsum("c,cab,abij->cij", ctx.detJ, ctx.G, ctx.stiffq_ref)


def convection_elems(ctx: DeviceContext, uab: torch.Tensor) -> torch.Tensor:
    """((uab . grad) u, v) dx for the convecting velocity uab (d, ndofs_v)."""
    ue = gather_v(ctx, uab)  # (g, nc, k)
    # per-cell geometry and coefficients first, (nc, b*k), then one matmul
    # with the reference tensor reshaped to (b*k, i*j)
    w = torch.einsum("c,cbg,gck->cbk", ctx.detJ, ctx.Kinv, ue)
    b, ni, nj, nk = ctx.conv_ref.shape
    R = ctx.conv_ref.permute(0, 3, 1, 2).reshape(b * nk, ni * nj)
    return (w.reshape(-1, b * nk) @ R).reshape(-1, ni, nj)


def pressure_gradient_mats(ctx: DeviceContext) -> torch.Tensor:
    """Element matrices of p * v.dx(i): (d, nc, ndv, ndq)."""
    return torch.einsum("c,cbg,bjm->gcjm", ctx.detJ, ctx.Kinv, ctx.mixed_ref)


def grad_p_mats(ctx: DeviceContext) -> torch.Tensor:
    """Element matrices of p.dx(i) * v: (d, nc, ndv, ndq)."""
    return torch.einsum("c,cbg,bjm->gcjm", ctx.detJ, ctx.Kinv, ctx.gradq_ref)


# ---------------------------------------------------------------------------
# operator application through the element stacks
# ---------------------------------------------------------------------------


def matvec_v(ctx: DeviceContext, elems: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """y = A x on the velocity-component space; x (..., ndofs_v)."""
    return scatter_v(ctx, torch.einsum("cij,...cj->...ci", elems, gather_v(ctx, x)))


def matvec_q(ctx: DeviceContext, elems: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return scatter_q(ctx, torch.einsum("cij,...cj->...ci", elems, gather_q(ctx, x)))


def matvec_vq(ctx: DeviceContext, elems: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """y_V = B p for mixed element matrices (..., nc, ndv, ndq); a leading
    batch of matrices gives a batch of outputs."""
    return scatter_v(ctx, torch.einsum("...cjm,cm->...cj", elems, gather_q(ctx, p)))


def matvec_qv(ctx: DeviceContext, elems: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """y_Q = D u for mixed element matrices (nc, ndq, ndv)."""
    return scatter_q(ctx, torch.einsum("cmj,...cj->...cm", elems, gather_v(ctx, u)))


def diagonal_v(ctx: DeviceContext, elems: torch.Tensor) -> torch.Tensor:
    return scatter_v(ctx, torch.diagonal(elems, dim1=-2, dim2=-1))


def diagonal_q(ctx: DeviceContext, elems: torch.Tensor) -> torch.Tensor:
    return scatter_q(ctx, torch.diagonal(elems, dim1=-2, dim2=-1))


# ---------------------------------------------------------------------------
# direct vector assembly (the low_memory_version=True strategy)
# ---------------------------------------------------------------------------


def pressure_gradient_vecs(ctx: DeviceContext, p: torch.Tensor) -> torch.Tensor:
    """r_i = assemble(p * v.dx(i) dx) for every component: (d, ndofs_v)."""
    t = torch.einsum("bjm,cm->cbj", ctx.mixed_ref, gather_q(ctx, p))
    sc = ctx.detJ[:, None, None] * ctx.Kinv  # (c, b, g)
    return scatter_v(ctx, torch.einsum("cbg,cbj->gcj", sc, t))


def divergence_vec(ctx: DeviceContext, u: torch.Tensor) -> torch.Tensor:
    """assemble(div(u) q dx) for u (d, ndofs_v): (ndofs_q,)."""
    w = torch.einsum("c,cbg,gcj->cbj", ctx.detJ, ctx.Kinv, gather_v(ctx, u))
    b, nj, nm = ctx.mixed_ref.shape
    return scatter_q(ctx, w.reshape(-1, b * nj) @ ctx.mixed_ref.reshape(b * nj, nm))


def grad_p_vecs(ctx: DeviceContext, dp: torch.Tensor) -> torch.Tensor:
    """r_i = assemble(dp.dx(i) * v dx) for every component: (d, ndofs_v)."""
    t = torch.einsum("bjm,cm->cbj", ctx.gradq_ref, gather_q(ctx, dp))
    sc = ctx.detJ[:, None, None] * ctx.Kinv
    return scatter_v(ctx, torch.einsum("cbg,cbj->gcj", sc, t))


def weighted_nodal_grad_p(ctx: DeviceContext, dp: torch.Tensor, gtab: torch.Tensor) -> torch.Tensor:
    """The mass-weighted nodal gradient of a Q-function at the V nodes, (d,
    ndofs_v): num_i = sum over the cells c of dof i of detJ_c Mref_jj
    (grad dp)|_c(x_j).  Divided by diag(M), the same sum of weights, it is
    a convex combination of the cells' gradients at each velocity node:
    the lumped velocity update.  ``gtab``: the Q basis's reference
    gradients at the V reference nodes, (ndv, d, ndq)."""
    r = torch.einsum("jbm,cm->cjb", gtab, gather_q(ctx, dp))  # reference gradient at V nodes
    w = ctx.detJ[:, None] * torch.diagonal(ctx.mass_ref)[None]  # (c, j)
    return scatter_v(ctx, w[None] * torch.einsum("cbg,cjb->gcj", ctx.Kinv, r))


def constant_load_vec(ctx: DeviceContext, f: float) -> torch.Tensor:
    """assemble(f * v dx) for a constant scalar f: (ndofs_v,)."""
    return scatter_v(ctx, f * ctx.detJ[:, None] * ctx.load_ref[None, :])


def source_load_vec_q(ctx: DeviceContext, vals_qp: torch.Tensor) -> torch.Tensor:
    """assemble(g * q dx) from the values of g at the quadrature points
    (..., nc, nq): (..., ndofs_q)."""
    ve = torch.einsum("...cq,q,qm,c->...cm", vals_qp, ctx.qw, ctx.phi_q, ctx.detJ)
    return scatter_q(ctx, ve)


def source_load_vec_v(ctx: DeviceContext, vals_qp: torch.Tensor) -> torch.Tensor:
    """assemble(g * v dx) from the values of g at the quadrature points
    (..., nc, nq): (..., ndofs_v)."""
    ve = torch.einsum("...cq,q,qj,c->...cj", vals_qp, ctx.qw, ctx.phi_v, ctx.detJ)
    return scatter_v(ctx, ve)


# ---------------------------------------------------------------------------
# quadrature-point values and scalar functionals
# ---------------------------------------------------------------------------


def eval_v_at_qp(ctx: DeviceContext, x: torch.Tensor) -> torch.Tensor:
    """Values of a V-function at every quadrature point: (..., nc, nq)."""
    return torch.einsum("qj,...cj->...cq", ctx.phi_v, gather_v(ctx, x))


def eval_q_at_qp(ctx: DeviceContext, x: torch.Tensor) -> torch.Tensor:
    """Values of a Q-function at every quadrature point: (nc, nq)."""
    return torch.einsum("qm,cm->cq", ctx.phi_q, gather_q(ctx, x))


def grad_v_at_qp(ctx: DeviceContext, x: torch.Tensor) -> torch.Tensor:
    """Physical gradient of a V-function at the quadrature points:
    (..., nc, nq, d)."""
    return torch.einsum("cbg,qbj,...cj->...cqg", ctx.Kinv, ctx.dphi_v, gather_v(ctx, x))


def grad_q_at_qp(ctx: DeviceContext, x: torch.Tensor) -> torch.Tensor:
    """Physical gradient of a Q-function at the quadrature points:
    (..., nc, nq, d)."""
    return torch.einsum("cbg,qbm,...cm->...cqg", ctx.Kinv, ctx.dphi_q, gather_q(ctx, x))


def div_v_at_qp(ctx: DeviceContext, u: torch.Tensor) -> torch.Tensor:
    """div(u) at the quadrature points for u (d, ndofs_v): (nc, nq), the
    components' derivatives summed in component order."""
    out = None
    for i in range(u.shape[0]):
        gi = torch.einsum("cb,qbj,cj->cq", ctx.Kinv[:, :, i], ctx.dphi_v, gather_v(ctx, u[i]))
        out = gi if out is None else out + gi
    return out


def _total(ctx: DeviceContext, t: torch.Tensor) -> torch.Tensor:
    return t if ctx.comm is None else ctx.comm.sum(t)


def integrate(ctx: DeviceContext, vals_qp: torch.Tensor) -> torch.Tensor:
    """Integral over the mesh of a quantity given at quadrature points."""
    return _total(ctx, torch.einsum("cq,q,c->", vals_qp, ctx.qw, ctx.detJ))


def cell_volume_total(ctx: DeviceContext) -> torch.Tensor:
    """assemble(1 * dx)."""
    return _total(ctx, torch.sum(ctx.detJ) * torch.sum(ctx.qw))


# ---------------------------------------------------------------------------
# Dirichlet rows
# ---------------------------------------------------------------------------


def apply_bc_rows(mask: torch.Tensor, y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """After y = A x: the rows of zeroRows(bc, diag=1), y[bc] = x[bc]."""
    return torch.where(mask, x, y)


def bc_symmetric_matvec(ctx: DeviceContext, elems, mask, x, matvec) -> torch.Tensor:
    """zeroRowsColumns(bc, diag=1): y = A (x off bc) with identity bc rows."""
    y = matvec(ctx, elems, torch.where(mask, torch.zeros_like(x), x))
    return torch.where(mask, x, y)


def elems_to_dense(elems: np.ndarray, rows: np.ndarray, cols: np.ndarray, nr: int,
                   nc: int) -> np.ndarray:
    """The dense (nr, nc) matrix of an element stack (ncells, ni, nj) on the
    host, rows and cols the cells' dofs (the JAX package's dense export for
    differential tests)."""
    A = np.zeros((nr, nc))
    e, r, c = np.asarray(elems), np.asarray(rows), np.asarray(cols)
    _, ni, nj = e.shape
    np.add.at(A, (np.repeat(r, nj, axis=1).reshape(-1), np.tile(c, (1, ni)).reshape(-1)),
              e.reshape(-1))
    return A


def setup_constants(ctx: DeviceContext) -> dict:
    """Every time-independent element stack and diagonal."""
    M = mass_elems(ctx)
    K = stiffness_elems(ctx)
    Ap = stiffness_q_elems(ctx)
    Mq = mass_q_elems(ctx)
    return dict(
        M=M, K=K, Ap=Ap, Mq=Mq,
        M_diag=diagonal_v(ctx, M),
        Ap_diag=diagonal_q(ctx, Ap),
        vol=cell_volume_total(ctx),
    )
