"""Owned-dof slab sharding of the structured grid, halo planes over
``torch.distributed``.

Counterpart of ``oasisx_tpu/parallel/slab.py``.  The structured cube lattice
is cut into contiguous slabs of cube planes along the leading base axis:
rank k owns cube planes [k P, (k+1) P) and the dof planes they generate.
The dof plane shared by slabs k and k+1 lives in rank k's local grid as a
halo plane (local base plane P), owned by rank k+1, except the global last
plane, which the last rank owns.

Invariant: halo and padding slots are zero in every assembled and solution
vector, so local dots plus one sum over ranks give the global reductions.

An operator application on a slab is ``halo_refresh`` (rank k+1's plane 0
into rank k's plane P: scatter_forward) -> the local cube operator or
kernel on the slab's own structured map (cells (P, n1, n2)) ->
``halo_fold`` (rank k's plane P added into rank k+1's plane 0, then zeroed:
scatter_reverse(add)).  The host tables (``SlabInfo``, ``build_slab``) are
the JAX package's, copied; a slab's vectors are this rank's part of the
global slab-flat layout, ``rank * npad_loc`` on.
"""

from __future__ import annotations

from dataclasses import dataclass
from dataclasses import replace as dc_replace

import numpy as np
import torch

from ..assembly import cubes as cub
from ..assembly.structured import StructuredMap
from .comm import Comm


@dataclass
class SlabInfo:
    """Host-side slab decomposition of one structured (V, Q) pair."""

    ndev: int
    planes_per_dev: dict  # {"v": P, "q": P} cube planes per shard
    sm_v_loc: tuple  # the shards' StructuredMap, cells (P, n1, n2)
    sm_q_loc: tuple
    npad_v_loc: int
    npad_q_loc: int
    # canonical dof id -> global slab-flat index (shard * npad_loc + local)
    perm_v: np.ndarray
    perm_q: np.ndarray
    # grid-layout padded position -> owned global slab-flat index (for
    # converting constants computed in the single-device layout)
    grid_to_slab_v: np.ndarray
    grid_to_slab_q: np.ndarray
    # validity of global slab-flat positions (owned, non-padding)
    valid_v: np.ndarray
    valid_q: np.ndarray


def _slab_map(sm: StructuredMap, gridflat: np.ndarray, ndev: int):
    """Split the parity-major grid into ndev slabs along base axis 0.

    Local grid: pshape_loc = (s,)*d + (P+1, n1+1, ..). Global plane
    b0 = g belongs to shard g // P at local plane g % P; shard k's local
    plane P is the halo slot aliasing shard k+1's plane 0 (the global last
    plane n0 lands on shard ndev-1's halo slot, which it owns)."""
    pshape, cells, deg, S, poffsets = sm
    d = len(cells)
    n0 = cells[0]
    if n0 % ndev != 0:
        raise ValueError(f"leading cube count {n0} not divisible by ndev={ndev}")
    P = n0 // ndev
    cells_loc = (P,) + tuple(cells[1:])
    sm_loc: StructuredMap = (
        (deg,) * d + tuple(c + 1 for c in cells_loc),
        cells_loc,
        deg,
        S,
        poffsets,
    )
    npad_loc = int(np.prod(sm_loc[0]))

    # each global padded position -> (shard, local flat position)
    npad = int(np.prod(pshape))
    idx = np.stack(np.unravel_index(np.arange(npad), pshape), axis=1)
    par = idx[:, :d]
    base = idx[:, d:]
    g0 = base[:, 0]
    shard = np.minimum(g0 // P, ndev - 1)
    # positions with g0 == n0 (last plane): shard ndev-1, local plane P
    loc0 = g0 - shard * P
    loc_base = base.copy()
    loc_base[:, 0] = loc0
    loc_flat = np.ravel_multi_index(
        tuple(par[:, k] for k in range(d)) + tuple(loc_base[:, k] for k in range(d)),
        sm_loc[0],
    )
    glob_slab = shard * npad_loc + loc_flat  # owned position of each global pos

    perm = glob_slab[gridflat]
    valid = np.zeros(ndev * npad_loc, dtype=bool)
    valid[perm] = True
    return sm_loc, npad_loc, perm, glob_slab, valid, P


def build_slab(sm_v, gridflat_v, sm_q, gridflat_q, ndev: int) -> SlabInfo:
    sm_v_loc, npv, perm_v, g2s_v, valid_v, Pv = _slab_map(sm_v, gridflat_v, ndev)
    sm_q_loc, npq, perm_q, g2s_q, valid_q, Pq = _slab_map(sm_q, gridflat_q, ndev)
    if Pv != Pq:
        raise ValueError("V and Q slabs disagree (different cube counts?)")
    return SlabInfo(
        ndev=ndev,
        planes_per_dev={"v": Pv, "q": Pq},
        sm_v_loc=sm_v_loc,
        sm_q_loc=sm_q_loc,
        npad_v_loc=npv,
        npad_q_loc=npq,
        perm_v=perm_v,
        perm_q=perm_q,
        grid_to_slab_v=g2s_v,
        grid_to_slab_q=g2s_q,
        valid_v=valid_v,
        valid_q=valid_q,
    )


def local_part(glob_index: np.ndarray, npad_loc: int, rank: int) -> tuple[np.ndarray, np.ndarray]:
    """(the entries of ``glob_index`` that rank owns, their local positions):
    how a global slab-flat table (``perm_*``, ``grid_to_slab_*``) reads on
    one rank."""
    sel = np.flatnonzero(glob_index // npad_loc == rank)
    return sel, glob_index[sel] - rank * npad_loc


# ---------------------------------------------------------------------------
# halo primitives
# ---------------------------------------------------------------------------


def _planes(x: torch.Tensor, sm_loc):
    """x (..., npad_loc) as (..., parity, base) and the base-0 axis."""
    pshape = tuple(sm_loc[0])
    X = x.reshape(x.shape[:-1] + pshape)
    return X, x.dim() - 1 + len(sm_loc[1])


def halo_refresh(x: torch.Tensor, sm_loc, comm: Comm) -> torch.Tensor:
    """A copy of x with its halo plane (local base plane P) filled with the
    next rank's owned plane 0: ``scatter_forward``.  The last rank owns its
    plane P and keeps it."""
    P = sm_loc[1][0]
    X, ax0 = _planes(x.clone(), sm_loc)
    k, n = comm.rank, comm.size
    plane0 = X.select(ax0, 0)
    recv = comm.shift(plane0, k - 1 if k > 0 else None, k + 1 if k < n - 1 else None, plane0)
    if recv is not None:
        X.select(ax0, P).copy_(recv)
    return X.reshape(x.shape)


def halo_fold(y: torch.Tensor, sm_loc, comm: Comm) -> torch.Tensor:
    """A copy of y with its halo plane's contribution added into the next
    rank's plane 0 and zeroed here (the last rank keeps its own plane P):
    ``scatter_reverse(add)``."""
    P = sm_loc[1][0]
    Y, ax0 = _planes(y.clone(), sm_loc)
    k, n = comm.rank, comm.size
    haloP = Y.select(ax0, P)
    recv = comm.shift(haloP, k + 1 if k < n - 1 else None, k - 1 if k > 0 else None, haloP)
    if recv is not None:
        Y.select(ax0, 0).add_(recv)
    if k < n - 1:
        haloP.zero_()
    return Y.reshape(y.shape)


def slab_apply(kernel, x: torch.Tensor, sm_in, sm_out, comm: Comm) -> torch.Tensor:
    """fold(kernel(refresh(x))): a rank-local kernel (or its plain version)
    between the halo exchanges, the slab form of a global operator."""
    return halo_fold(kernel(halo_refresh(x, sm_in, comm)), sm_out, comm)


# ---------------------------------------------------------------------------
# slab operators on the plain cube ops (the JAX package's XLA slab path)
# ---------------------------------------------------------------------------


def matvec_cube_slab(x, C, sm_loc, comm):
    """y = A x on the slab: refresh -> local cube matvec -> fold."""
    return slab_apply(lambda v: cub.matvec_cube(v, C, sm_loc), x, sm_loc, sm_loc, comm)


def mixed_all_slab(p, C_all, sm_v_loc, sm_q_loc, comm):
    return slab_apply(lambda v: cub.mixed_all(v, C_all, sm_v_loc, sm_q_loc), p, sm_q_loc,
                      sm_v_loc, comm)


def divergence_slab(u, B_all, sm_v_loc, sm_q_loc, comm):
    return slab_apply(lambda v: cub.divergence_cube(v, B_all, sm_v_loc, sm_q_loc), u, sm_v_loc,
                      sm_q_loc, comm)


def diag_cube_slab(C, sm_loc, comm):
    return halo_fold(cub.diag_cube(C, sm_loc), sm_loc, comm)


def conv_uq_slab(ops, uab, sm_v_loc, comm):
    """Convecting velocity at the slab's quadrature points (local cubes)."""
    return cub.conv_uq(dc_replace(ops, sm_v=sm_v_loc), halo_refresh(uab, sm_v_loc, comm))


def tentative_matvec_slab(ops, A0_c, uq, x, sm_v_loc, comm):
    ops_loc = dc_replace(ops, sm_v=sm_v_loc)
    return slab_apply(lambda v: cub.tentative_matvec_local(ops_loc, A0_c, uq, v), x, sm_v_loc,
                      sm_v_loc, comm)


def rhs_matvec_slab(ops, A0_c, uq, x, sm_v_loc, comm):
    ops_loc = dc_replace(ops, sm_v=sm_v_loc)
    return slab_apply(lambda v: cub.rhs_matvec_local(ops_loc, A0_c, uq, v), x, sm_v_loc,
                      sm_v_loc, comm)


def conv_diag_slab(ops, uq, sm_v_loc, comm):
    return halo_fold(cub.conv_diag(dc_replace(ops, sm_v=sm_v_loc), uq), sm_v_loc, comm)
