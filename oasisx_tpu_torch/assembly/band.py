"""The band-ELL layout (K18): tables, and the assembly of its values.

An unstructured operator in band-ELL form is ELL in reverse Cuthill-McKee
(RCM) order: rows are grouped in tiles of 128, and a nonzero's column is
``(rb + s) * 128 + lane`` with a static block shift ``s`` per slot and a
lane index per entry.  The values (S, R, 128) are assembled from an element
stack once per solve, outside the Krylov loop; the kernels of
``la/band.py`` apply them.  The JAX package chose this layout because its
TPU lowers only lane gathers; the port keeps it as a layout option of the
general path (``options={"ell_layout": "band"}``) to measure against flat
ELL: fewer padded slots where RCM clusters a row's columns, more where it
spreads them over many shifts.

``rcm_permutation``, ``build_band_tables`` and ``build_band_tables_coo``
are copied from ``oasisx_tpu/assembly/band.py`` with the same NumPy (the
slot assignment shared by the two table builders), so the tables equal the
JAX package's.  ``band_values`` replaces its
segment-sum with the deterministic slot-grouped sum of
``parallel/graph.py`` (the same bits on every run; ``index_add_`` sums with
atomics on the card).  The RCM permutation is applied only inside a solve,
so dofmaps, bc masks and state keep the canonical order.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..parallel.graph import bucket_sum, slot_buckets

LANE = 128


def rcm_permutation(rows: np.ndarray, cols: np.ndarray, n: int) -> np.ndarray:
    """Reverse Cuthill-McKee ordering of the symmetrized sparsity graph.

    Returns ``perm`` with ``perm[new] = old`` (so ``x_new = x[perm]``).
    Pure NumPy (CSR by sort + per-component BFS from a minimum-degree
    seed, neighbors visited in increasing-degree order, then reversed).
    """
    rows = np.asarray(rows, np.int64)
    cols = np.asarray(cols, np.int64)
    keep = rows != cols
    r = np.concatenate([rows[keep], cols[keep]])
    c = np.concatenate([cols[keep], rows[keep]])
    # unique edges -> CSR
    key = r * n + c
    key = np.unique(key)
    r = (key // n).astype(np.int64)
    c = (key % n).astype(np.int64)
    indptr = np.zeros(n + 1, np.int64)
    np.add.at(indptr, r + 1, 1)
    np.cumsum(indptr, out=indptr)
    indices = c  # rows are sorted by construction of `key`
    degree = np.diff(indptr)

    order = np.empty(n, np.int64)
    visited = np.zeros(n, bool)
    pos = 0
    # iterate components, cheapest-degree seed first
    seeds = np.argsort(degree, kind="stable")
    si = 0
    while pos < n:
        while visited[seeds[si]]:
            si += 1
        start = seeds[si]
        visited[start] = True
        order[pos] = start
        head, tail = pos, pos + 1
        pos += 1
        while head < tail:
            u = order[head]
            head += 1
            nbr = indices[indptr[u] : indptr[u + 1]]
            nbr = nbr[~visited[nbr]]
            if nbr.size:
                nbr = nbr[np.argsort(degree[nbr], kind="stable")]
                visited[nbr] = True
                order[tail : tail + nbr.size] = nbr
                tail += nbr.size
        pos = tail
    return order[::-1].copy()


def build_band_tables(
    cd_rows: np.ndarray,
    cd_cols: np.ndarray,
    nrows: int,
    ncols: int,
    perm_rows: np.ndarray,
    perm_cols: np.ndarray | None = None,
):
    """Band-ELL sparsity for a (possibly rectangular) operator assembled
    from cell dofmaps, in permuted row/col orderings.

    Parameters: ``cd_rows`` (nc, ndr) / ``cd_cols`` (nc, ndc) cell
    dofmaps (canonical numbering), ``perm_rows``/``perm_cols`` with
    ``perm[new] = old`` (cols default to rows' permutation).

    Returns ``(shifts, slots, cols, Rr, Rc)``:
      - shifts: tuple of per-slot static block shifts (sorted; one entry
        per slot so equal-shift slots share one rolled copy in-kernel),
      - slots: (nc*ndr*ndc,) int32 mapping each flattened element-matrix
        entry to segment ``slot*(Rr*128) + row_p`` (duplicate (row,col)
        pairs map to the SAME slot so the per-solve segment-sum
        accumulates them; unused slots keep value 0 / lane 0),
      - cols: (S, Rr, 128) int32 lane indices into the rolled source,
      - Rr/Rc: padded block counts (rows/cols pad to multiples of 128).

    The matvec is then ``y2[rb, j] = sum_slot vals[slot, rb, j] *
    xr[rb + shifts[slot], cols[slot, rb, j]]`` for (Rc, 128) input tiles,
    a source tile outside [0, Rc) reading 0 (every such slot holds 0).
    """
    shifts, slots, cols, Rr, Rc = _band_layout(
        cd_rows, cd_cols, nrows, ncols, perm_rows, perm_cols
    )
    return shifts, slots.astype(np.int32), cols, Rr, Rc


def _inverse(perm: np.ndarray, n: int) -> np.ndarray:
    """iperm[old] = new for ``perm[new] = old``."""
    iperm = np.empty(n, np.int64)
    iperm[np.asarray(perm, np.int64)] = np.arange(n)
    return iperm


def _slot_layout(urow: np.ndarray, ucol: np.ndarray):
    """Band slots of the unique (row, col) pairs, sorted by row-major key:
    per block shift, ascending, as many slots as its fullest row needs.
    Returns (shifts, the slot of each pair, the lane of each pair)."""
    s_of = (ucol // LANE) - (urow // LANE)  # per-unique block shift
    lane = (ucol % LANE).astype(np.int32)
    slot_of_uniq = np.empty(len(urow), np.int64)
    shifts: list[int] = []
    base = 0
    for s in np.unique(s_of):
        m = np.flatnonzero(s_of == s)
        rows_s = urow[m]
        # entries are row-sorted within the shift group (uniq is sorted)
        row_start = np.searchsorted(rows_s, rows_s)
        kidx = np.arange(len(m)) - row_start
        Ks = int(kidx.max()) + 1 if len(m) else 0
        slot_of_uniq[m] = base + kidx
        shifts.extend([int(s)] * Ks)
        base += Ks
    return tuple(shifts), slot_of_uniq, lane


def _band_layout(cd_rows, cd_cols, nrows, ncols, perm_rows, perm_cols=None):
    """``build_band_tables`` with the slot index in int64 (S * R * 128 may
    pass 2**31 on large meshes)."""
    if perm_cols is None:
        perm_cols = perm_rows
    nc_, ndr = cd_rows.shape
    ndc = cd_cols.shape[1]
    Rr = -(-nrows // LANE)
    Rc = -(-ncols // LANE)

    rp = _inverse(perm_rows, nrows)[np.asarray(cd_rows, np.int64)]  # (nc, ndr) permuted rows
    cp = _inverse(perm_cols, ncols)[np.asarray(cd_cols, np.int64)]  # (nc, ndc) permuted cols
    rr = np.broadcast_to(rp[:, :, None], (nc_, ndr, ndc)).reshape(-1)
    cc = np.broadcast_to(cp[:, None, :], (nc_, ndr, ndc)).reshape(-1)

    key = rr * np.int64(ncols) + cc
    uniq, inv = np.unique(key, return_inverse=True)
    urow = (uniq // ncols).astype(np.int64)
    shifts, slot_of_uniq, lane = _slot_layout(urow, (uniq % ncols).astype(np.int64))
    S = len(shifts)

    slots = slot_of_uniq[inv] * (Rr * LANE) + urow[inv]
    cols = np.zeros((S, Rr * LANE), np.int32)
    cols[slot_of_uniq, urow] = lane
    return shifts, slots, cols.reshape(S, Rr, LANE), Rr, Rc


def build_band_tables_coo(
    rows: np.ndarray,
    vals_cols: np.ndarray,
    vals: np.ndarray,
    nrows: int,
    ncols: int,
    perm_rows: np.ndarray,
    perm_cols: np.ndarray | None = None,
):
    """Band-ELL tables for a STATIC operator given in COO form (used for
    the AMG level operators/transfers, which never change during a run).
    Returns ``(shifts, vals_b (S, Rr, 128), cols (S, Rr, 128), Rr, Rc)``
    with duplicate (row, col) pairs pre-summed."""
    if perm_cols is None:
        perm_cols = perm_rows
    vals = np.asarray(vals)
    Rr = -(-nrows // LANE)
    Rc = -(-ncols // LANE)
    rr = _inverse(perm_rows, nrows)[np.asarray(rows, np.int64)]
    cc = _inverse(perm_cols, ncols)[np.asarray(vals_cols, np.int64)]
    key = rr * np.int64(ncols) + cc
    uniq, inv = np.unique(key, return_inverse=True)
    vsum = np.zeros(len(uniq), vals.dtype)
    np.add.at(vsum, inv, vals)
    urow = (uniq // ncols).astype(np.int64)
    shifts, slot_of_uniq, lane = _slot_layout(urow, (uniq % ncols).astype(np.int64))
    S = len(shifts)
    vals_b = np.zeros((S, Rr * LANE), vals.dtype)
    cols = np.zeros((S, Rr * LANE), np.int32)
    vals_b[slot_of_uniq, urow] = vsum
    cols[slot_of_uniq, urow] = lane
    return shifts, vals_b.reshape(S, Rr, LANE), cols.reshape(S, Rr, LANE), Rr, Rc


@dataclass
class BandAssembly:
    """One square operator's band-ELL tables and its slot-grouped assembly
    map, on a device.  ``perm[new] = old``, ``iperm`` its inverse."""

    n: int  # rows (dofs) of the operator
    R: int  # row tiles: R * 128 >= n
    shifts: tuple  # per-slot block shift, sorted
    shifts_t: torch.Tensor  # (S,) int32, the same on the device
    cols: torch.Tensor  # (S, R, 128) int32 lanes
    perm: torch.Tensor  # (n,) int64
    iperm: torch.Tensor  # (n,) int64
    buckets: list  # the slot-grouped map of ``parallel.graph.slot_buckets``
    nnz: int  # slots that carry an entry

    @property
    def S(self) -> int:
        return len(self.shifts)


def band_values(elems: torch.Tensor, asm: BandAssembly) -> torch.Tensor:
    """Band-ELL values (S, R, 128) of the element stack ``elems``
    (nc, nd, nd); a slot without an entry is 0."""
    return bucket_sum(elems, asm.buckets, asm.S * asm.R * LANE).reshape(asm.S, asm.R, LANE)


def _edges(cd: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Every (row, col) pair of the element matrices on the dofmap ``cd``."""
    nd = cd.shape[1]
    return np.repeat(cd, nd, axis=1).reshape(-1), np.tile(cd, (1, nd)).reshape(-1)


def build_band_assembly(cell_dofs: np.ndarray, n: int, device) -> BandAssembly:
    """The band-ELL tables, in RCM order, of the operators on the dofmap
    ``cell_dofs`` (nc, nd) with ``n`` dofs (the JAX package's
    ``_make_band_engine`` set-up); the slot index is built in int64."""
    cd = np.asarray(cell_dofs, np.int64)
    perm = rcm_permutation(*_edges(cd), n)
    shifts, slots, cols, R, _ = _band_layout(cd, cd, n, n, perm)
    S = len(shifts)
    buckets, nnz = slot_buckets(slots, S * R * LANE, device)
    dev = lambda a, dt: torch.as_tensor(np.ascontiguousarray(a), dtype=dt, device=device)
    return BandAssembly(
        n=int(n), R=int(R), shifts=tuple(shifts), shifts_t=dev(np.asarray(shifts), torch.int32),
        cols=dev(cols, torch.int32), perm=dev(perm, torch.int64),
        iperm=dev(np.argsort(perm), torch.int64), buckets=buckets, nnz=nnz,
    )
