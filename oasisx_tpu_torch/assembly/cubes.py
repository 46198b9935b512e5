"""Cube-batched operators on the parity-split grid layout (plain tensor ops).

On meshes from the structured generators every macro-cell (square/cube) is
split into the same S simplices with identical affine geometry, and every
Lagrange dof of every simplex lies on the macro-cell's local (deg+1)^d fine
sub-lattice.  Summing the S shared element matrices into one cube matrix
C of shape (nl, nl), nl = (deg+1)^d, makes every assembled operator
application

    y = sum_cubes  P_c^T  C  P_c  x

where P_c extracts the cube's nl fine-lattice values.  ``cube_gather`` reads
them with nl strided slices, ``cube_scatter`` sums each output point's
contributions from the cubes that contain it with shifted pads (no
scatter-add), and the contraction in between is a matmul.

These are the plain versions: the hand-written kernels in
``assembly/kernels.py`` compute the same sums on the card, and the CPU path
and the tests use these.  Counterpart: ``oasisx_tpu/assembly/cubes.py``.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from ..config import real_dtype
from .reference_tensors import ReferenceTensors
from .structured import StructuredMap


def _slot_maps(sm: StructuredMap) -> np.ndarray:
    """slot[s, j]: index of local dof j of shape s in the cube's
    (deg+1)^d fine sub-lattice (C-order)."""
    pshape, cells, deg, S, poffsets = sm
    d = len(cells)
    nl_side = deg + 1
    nd = len(poffsets[0])
    out = np.empty((S, nd), dtype=np.int64)
    for s in range(S):
        for j, (par, base) in enumerate(poffsets[s]):
            t = tuple(base[k] * deg + par[k] for k in range(d))
            assert all(0 <= tk <= deg for tk in t)
            out[s, j] = int(np.ravel_multi_index(t, (nl_side,) * d))
    return out


def _slot_index(sm: StructuredMap, t_flat: int):
    """Grid slice (into the parity-split padded layout) for cube slot t."""
    pshape, cells, deg, S, poffsets = sm
    d = len(cells)
    t = np.unravel_index(t_flat, (deg + 1,) * d)
    par = tuple(int(tk % deg) for tk in t)
    base = tuple(int(tk // deg) for tk in t)
    return tuple(par) + tuple(slice(base[k], base[k] + cells[k]) for k in range(d))


def num_slots(sm: StructuredMap) -> int:
    deg = sm[2]
    d = len(sm[1])
    return (deg + 1) ** d


@dataclass
class CubeOps:
    """Shared cube-level operator tables for one (V, Q) space pair."""

    M_c: torch.Tensor  # (nl_v, nl_v) component mass
    K_c: torch.Tensor  # (nl_v, nl_v) component stiffness
    Ap_c: torch.Tensor  # (nl_q, nl_q) pressure Laplacian
    Mq_c: torch.Tensor  # (nl_q, nl_q) pressure mass
    B_c: torch.Tensor  # (d, nl_v, nl_q)  p * v.dx(i)
    G_c: torch.Tensor  # (d, nl_v, nl_q)  p.dx(i) * v
    # convection quadrature tables embedded into cube slots; Q = S*nq rows
    Phi: torch.Tensor  # (Q, nl_v) V basis values at all shape-quadrature points
    Dg: torch.Tensor  # (Q, d, nl_v) physical V gradients
    PhiW: torch.Tensor  # (Q, nl_v) test weights detJ_s * w_q * phi
    Ediag: torch.Tensor  # (Q, d, nl_v) PhiW * Dg (convection-diagonal table)
    sm_v: tuple
    sm_q: tuple
    # (d, nl_v, nl_q) the lumped update's weighted nodal gradient (with gtab)
    Gw_c: torch.Tensor | None = None


def build_cube_ops(
    mesh, refs: ReferenceTensors, sm_v, sm_q, dtype=None, *, device, gtab=None
) -> CubeOps | None:
    """Built on the host in float64 NumPy, returned as tensors on ``device``.
    Returns None unless per-shape geometry is uniform (all cells of one
    Kuhn shape share detJ/Kinv — true for the structured generators).

    With ``gtab``, the Q basis's reference gradients at the V reference
    nodes (ndv, d, ndq), also ``Gw_c``: per shape detJ_s Mref_jj
    sum_b Kinv_s[b, g] gtab[j, b, m], so that ``mixed(dp, Gw_c)`` is
    ``engine.weighted_nodal_grad_p`` on the grid."""
    from .geometry import compute_cell_geometry

    info = mesh.structured
    if info is None or sm_v is None or sm_q is None:
        return None
    dtype = real_dtype(dtype)
    d = mesh.dim
    S = info.nshapes
    ncube = int(np.prod(info.shape))
    geo = compute_cell_geometry(mesh.x, mesh.cells, d)
    detJ_s = np.empty(S)
    Kinv_s = np.empty((S, d, d))
    G_s = np.empty((S, d, d))
    for s in range(S):
        blk = slice(s * ncube, (s + 1) * ncube)
        if (
            np.ptp(geo.detJ[blk]) > 1e-12 * abs(geo.detJ[s * ncube])
            or np.abs(geo.Kinv[blk] - geo.Kinv[s * ncube]).max() > 1e-10
        ):
            return None
        detJ_s[s] = geo.detJ[s * ncube]
        Kinv_s[s] = geo.Kinv[s * ncube]
        G_s[s] = geo.G[s * ncube]

    slots_v = _slot_maps(sm_v)  # (S, ndv)
    slots_q = _slot_maps(sm_q)  # (S, ndq)
    nl_v = num_slots(sm_v)
    nl_q = num_slots(sm_q)

    M_s = detJ_s[:, None, None] * refs.mass[None]
    K_s = np.einsum("s,sab,abij->sij", detJ_s, G_s, refs.stiffness)
    Ap_s = np.einsum("s,sab,abij->sij", detJ_s, G_s, refs.stiffness_q)
    Mq_s = detJ_s[:, None, None] * refs.mass_q[None]
    B_s = np.einsum("s,sbg,bjm->sgjm", detJ_s, Kinv_s, refs.mixed_grad)
    Gq_s = np.einsum("s,sbg,bjm->sgjm", detJ_s, Kinv_s, refs.grad_q)

    def embed(mats, rows, cols, nr, nc_):
        C = np.zeros((nr, nc_))
        for s in range(mats.shape[0]):
            np.add.at(C, (rows[s][:, None], cols[s][None, :]), mats[s])
        return C

    M_c = embed(M_s, slots_v, slots_v, nl_v, nl_v)
    K_c = embed(K_s, slots_v, slots_v, nl_v, nl_v)
    Ap_c = embed(Ap_s, slots_q, slots_q, nl_q, nl_q)
    Mq_c = embed(Mq_s, slots_q, slots_q, nl_q, nl_q)
    B_c = np.stack([embed(B_s[:, g], slots_v, slots_q, nl_v, nl_q) for g in range(d)])
    G_c = np.stack([embed(Gq_s[:, g], slots_v, slots_q, nl_v, nl_q) for g in range(d)])
    Gw_c = None
    if gtab is not None:
        wts = detJ_s[:, None] * np.diag(refs.mass)[None]  # (s, j)
        Gw_s = wts[:, None, :, None] * np.einsum("sbg,jbm->sgjm", Kinv_s, np.asarray(gtab))
        Gw_c = np.stack([embed(Gw_s[:, g], slots_v, slots_q, nl_v, nl_q) for g in range(d)])

    w = refs.qweights
    phi = refs.phi_v  # (nq, ndv)
    dphi = refs.dphi_v  # (nq, b, ndv)
    nq = phi.shape[0]
    Q = S * nq
    Phi = np.zeros((Q, nl_v))
    Dg = np.zeros((Q, d, nl_v))
    PhiW = np.zeros((Q, nl_v))
    for s in range(S):
        Phi[np.arange(s * nq, (s + 1) * nq)[:, None], slots_v[s][None, :]] = phi
        dg = np.einsum("bg,qbj->qgj", Kinv_s[s], dphi)  # (nq, d, ndv)
        Dg[np.arange(s * nq, (s + 1) * nq)[:, None, None], np.arange(d)[None, :, None],
           slots_v[s][None, None, :]] = dg
        PhiW[np.arange(s * nq, (s + 1) * nq)[:, None], slots_v[s][None, :]] = (
            detJ_s[s] * w[:, None] * phi
        )
    Ediag = PhiW[:, None, :] * Dg  # (Q, d, nl_v)

    a = lambda x: torch.as_tensor(x, dtype=dtype, device=device)
    return CubeOps(
        M_c=a(M_c), K_c=a(K_c), Ap_c=a(Ap_c), Mq_c=a(Mq_c), B_c=a(B_c), G_c=a(G_c),
        Phi=a(Phi), Dg=a(Dg), PhiW=a(PhiW), Ediag=a(Ediag), sm_v=sm_v, sm_q=sm_q,
        Gw_c=None if Gw_c is None else a(Gw_c),
    )


# ---------------------------------------------------------------------------
# cube-local gather / scatter (slice reads in both directions)
# ---------------------------------------------------------------------------


def cube_gather(x: torch.Tensor, sm: StructuredMap) -> torch.Tensor:
    """Grid vector(s) (..., npad) -> cube-local values (..., nl, ncube)."""
    pshape = sm[0]
    lead = x.shape[:-1]
    X = x.reshape(lead + tuple(pshape))
    ell = (slice(None),) * len(lead)
    return torch.stack(
        [X[ell + _slot_index(sm, t)].reshape(lead + (-1,)) for t in range(num_slots(sm))],
        dim=-2,
    )


def cube_scatter(Y: torch.Tensor, sm: StructuredMap) -> torch.Tensor:
    """Cube-local values (..., nl, ncube) -> assembled grid vector(s) (..., npad).

    Each output grid position (parity p, base b) is the sum over the cubes
    containing it: slot t = p + deg*delta of cube b - delta, delta in {0,1}^k
    over the axes with p_k == 0.  Every term is a shifted pad of one slot
    plane; padded positions (p_k > 0, b_k = n_k) stay zero."""
    pshape, cells, deg, S, _ = sm
    d = len(cells)
    nl_side = deg + 1
    lead = Y.shape[:-2]
    Yg = Y.reshape(lead + (Y.shape[-2],) + tuple(cells))
    chans = []
    for par in itertools.product(*(range(deg) for _ in range(d))):
        free = [k for k in range(d) if par[k] == 0]
        acc = None
        for delta_bits in itertools.product((0, 1), repeat=len(free)):
            delta = [0] * d
            for k, b in zip(free, delta_bits):
                delta[k] = b
            t = tuple(par[k] + deg * delta[k] for k in range(d))
            t_flat = int(np.ravel_multi_index(t, (nl_side,) * d))
            # F.pad lists the last axis first
            pad = []
            for k in reversed(range(d)):
                pad += [delta[k], 1 - delta[k]]
            padded = F.pad(Yg.select(-(d + 1), t_flat), pad)
            acc = padded if acc is None else acc + padded
        chans.append(acc)
    return torch.stack(chans, dim=len(lead)).reshape(lead + (-1,))


# ---------------------------------------------------------------------------
# operator applications
# ---------------------------------------------------------------------------


def matvec_cube(x: torch.Tensor, C: torch.Tensor, sm: StructuredMap) -> torch.Tensor:
    """y = A x for an operator with cube matrix C (nl, nl); x (..., npad)."""
    return cube_scatter(C @ cube_gather(x, sm), sm)


def mixed_all(p: torch.Tensor, C_all: torch.Tensor, sm_v, sm_q) -> torch.Tensor:
    """r_i = B_i p for all d components: (d, npad_v)."""
    U = cube_gather(p, sm_q)
    return torch.stack([cube_scatter(C_all[g] @ U, sm_v) for g in range(C_all.shape[0])])


def divergence_cube(u: torch.Tensor, B_all: torch.Tensor, sm_v, sm_q) -> torch.Tensor:
    """b2 = assemble(div(u) q dx) = sum_i B_i^T u_i: (d, npad_v) -> (npad_q,)."""
    acc = None
    for g in range(u.shape[0]):
        t = B_all[g].T @ cube_gather(u[g], sm_v)
        acc = t if acc is None else acc + t
    return cube_scatter(acc, sm_q)


def diag_cube(C: torch.Tensor, sm: StructuredMap) -> torch.Tensor:
    """Assembled diagonal of a cube-matrix operator."""
    ncube = int(np.prod(sm[1]))
    D = torch.diagonal(C)[:, None].expand(C.shape[0], ncube)
    return cube_scatter(D, sm)


# --- convection (quadrature-factored) --------------------------------------


def conv_uq(ops: CubeOps, uab: torch.Tensor) -> torch.Tensor:
    """Convecting velocity at all shape-quadrature points: (d, Q, ncube)."""
    return ops.Phi @ cube_gather(uab, ops.sm_v)


def conv_local(ops: CubeOps, uq: torch.Tensor, U: torch.Tensor) -> torch.Tensor:
    """Cube-local action of C(uab) on cube-local values U (nl, ncube)."""
    Q, d, nl = ops.Dg.shape
    G = (ops.Dg.reshape(Q * d, nl) @ U).reshape(Q, d, -1)
    dotted = torch.einsum("gqc,qgc->qc", uq, G)
    return ops.PhiW.T @ dotted


def conv_diag(ops: CubeOps, uq: torch.Tensor) -> torch.Tensor:
    """Assembled diagonal of C(uab)."""
    D = torch.einsum("gqc,qgt->tc", uq, ops.Ediag)
    return cube_scatter(D, ops.sm_v)


def tentative_matvec_local(ops: CubeOps, A0_c: torch.Tensor, uq: torch.Tensor,
                           x: torch.Tensor) -> torch.Tensor:
    """y = [A0 + 1/2 C(uab)] x over one gather/scatter pair; x (npad_v,)."""
    U = cube_gather(x, ops.sm_v)
    return cube_scatter(A0_c @ U + 0.5 * conv_local(ops, uq, U), ops.sm_v)


def rhs_matvec_local(ops: CubeOps, A0_c: torch.Tensor, uq: torch.Tensor,
                     x: torch.Tensor) -> torch.Tensor:
    """y = [A0 - 1/2 C(uab)] x, the explicit right-hand side's operator."""
    U = cube_gather(x, ops.sm_v)
    return cube_scatter(A0_c @ U - 0.5 * conv_local(ops, uq, U), ops.sm_v)
