"""The band-ELL layout (K18): tables, and the assembly of its values.

An unstructured operator in band-ELL form is ELL in reverse Cuthill-McKee
(RCM) order: rows are grouped in tiles of 128, and a nonzero's column is
``(rb + s) * 128 + lane`` with a static block shift ``s`` per slot and a
lane index per entry.  The JAX package stores it as (S, R, 128) arrays,
every slot for every tile, because its TPU lowers only lane gathers; the
port keeps that layout's slots, shifts and lanes but stores only the
(tile, slot) pairs that hold an entry (``build_pair_tables``): a tile
touches about 122 of the vessel's 2,794 slots at N=36, and that count does
not grow with N.  The values (P, 128) are assembled from an element stack
once per solve, outside the Krylov loop; the kernels of ``la/band.py``
apply them.  The port keeps the layout as an option of the general path
(``options={"ell_layout": "band"}``) to measure against flat ELL.

``rcm_permutation``, ``build_band_tables``, ``build_band_tables_coo``,
``_slot_layout`` and ``_band_layout`` are copied from
``oasisx_tpu/assembly/band.py`` with the same NumPy, so the tables equal
the JAX package's; ``expand`` and ``compact`` convert values between the
two layouts.  ``band_values`` replaces its segment-sum with the
deterministic slot-grouped sum of ``parallel/graph.py`` (the same bits on
every run; ``index_add_`` sums with atomics on the card).  The RCM
permutation is applied only inside a solve, so dofmaps, bc masks and state
keep the canonical order.
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


def build_pair_tables(urow: np.ndarray, ucol: np.ndarray, R: int):
    """The band layout of a square operator as pair tables: only the
    (tile, slot) pairs that hold an entry.

    ``urow``/``ucol`` are the operator's distinct entries in RCM order,
    sorted row-major (row tiles of 128, ``R`` tiles).  The slots are
    ``_slot_layout``'s, so they equal the JAX package's (S, R, 128) layout.
    Returns ``(shifts, tile_ptr, pair_shift, lanes, pair_slot, seg)``:
      - shifts: the S slot shifts, as ``build_band_tables``,
      - tile_ptr (R+1,) int32: the pairs of tile rb are
        ``tile_ptr[rb] : tile_ptr[rb+1]``, in ascending slot order,
      - pair_shift (P,) int32: the block shift of each pair's slot,
      - lanes (P, 128) uint8: the lanes of the pair's slot in its tile (0
        where the row has no entry there, as in the JAX layout),
      - pair_slot (P,) int32: the pair's slot (for ``expand``/``compact``),
      - seg (E,) int64: each entry's position ``pair * 128 + row % 128``.

    Then ``y[rb*128 + j] = sum_p vals[p, j] * x[(rb + pair_shift[p])*128 +
    lanes[p, j]]`` over the pairs of tile rb: the band product without the
    slots that hold no entry.  The (S, R, 128) arrays are never built.
    """
    shifts, slot, lane = _slot_layout(urow, ucol)
    S = len(shifts)
    pairs, pair_of = np.unique((urow // LANE) * S + slot, return_inverse=True)
    pair_of = pair_of.reshape(-1)
    ptile, pslot = np.divmod(pairs, S)
    P = len(pairs)
    pair_shift = np.asarray(shifts, np.int64)[pslot]
    tile_ptr = np.zeros(R + 1, np.int64)
    np.cumsum(np.bincount(ptile, minlength=R), out=tile_ptr[1:])
    lanes = np.zeros((P, LANE), np.uint8)
    lanes[pair_of, urow % LANE] = lane  # lane = ucol % 128 < 128
    check_pair_tables(tile_ptr, pair_shift, R)
    return (shifts, tile_ptr.astype(np.int32), pair_shift.astype(np.int32), lanes,
            pslot.astype(np.int32), pair_of * LANE + urow % LANE)


def check_pair_tables(tile_ptr, pair_shift, R: int) -> None:
    """Raises ValueError unless the tables frame a product the kernels may
    run: R tiles, the pairs of each tile a range of [0, P) with P*128 <
    2**31 (the kernels index pair lanes in int32), every source tile
    ``rb + pair_shift`` in [0, R).  On host arrays, once, where tables are
    built: the wrappers check only shapes and types, without a host read."""
    tile_ptr = np.asarray(tile_ptr, np.int64)
    pair_shift = np.asarray(pair_shift, np.int64)
    P = pair_shift.shape[0]
    if tile_ptr.shape != (R + 1,) or tile_ptr[0] != 0 or tile_ptr[-1] != P:
        raise ValueError(f"tile_ptr must be (R+1,) = ({R + 1},) from 0 to P = {P}")
    count = np.diff(tile_ptr)
    if count.min(initial=0) < 0:
        raise ValueError("tile_ptr decreases")
    if P * LANE >= 2**31:
        raise ValueError(f"{P} pairs: the kernels index pair lanes in int32")
    src = np.repeat(np.arange(R), count) + pair_shift
    if P and (src.min() < 0 or src.max() >= R):
        raise ValueError(f"a pair's source tile is outside [0, {R})")


def pair_tiles(tile_ptr: torch.Tensor) -> torch.Tensor:
    """The tile of every pair, (P,) int64."""
    return torch.repeat_interleave(torch.arange(tile_ptr.numel() - 1, device=tile_ptr.device),
                                   torch.diff(tile_ptr.long()))


def expand(t: torch.Tensor, tile_ptr: torch.Tensor, pair_slot, S: int) -> torch.Tensor:
    """Pair layout (P, 128) -> the JAX package's (S, R, 128), 0 in the
    (slot, tile) cells that hold no pair."""
    out = t.new_zeros((S, tile_ptr.numel() - 1, LANE))
    out[torch.as_tensor(pair_slot, device=t.device).long(), pair_tiles(tile_ptr)] = t
    return out


def compact(t: torch.Tensor, tile_ptr: torch.Tensor, pair_slot) -> torch.Tensor:
    """The JAX package's (S, R, 128) layout -> pair layout (P, 128)."""
    return t[torch.as_tensor(pair_slot, device=t.device).long(), pair_tiles(tile_ptr)]


@dataclass
class BandAssembly:
    """One square operator's band-ELL pair tables and its slot-grouped
    assembly map, on a device (``pair_slot`` stays on the host: only
    ``expand``/``compact`` read it).  ``perm[new] = old``, ``iperm`` its
    inverse."""

    n: int  # rows (dofs) of the operator
    R: int  # row tiles: R * 128 >= n
    shifts: tuple  # the block shift of each of the S slots, sorted
    tile_ptr: torch.Tensor  # (R+1,) int32
    pair_shift: torch.Tensor  # (P,) int32
    lanes: torch.Tensor  # (P, 128) uint8
    pair_slot: np.ndarray  # (P,) int32, host
    perm: torch.Tensor  # (n,) int64
    iperm: torch.Tensor  # (n,) int64
    buckets: list  # the slot-grouped map of ``parallel.graph.slot_buckets``
    nnz: int  # entries of the operator: (row, column) pairs

    @property
    def S(self) -> int:
        return len(self.shifts)

    @property
    def P(self) -> int:
        return self.pair_shift.shape[0]

    @property
    def tables(self) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(tile_ptr, pair_shift, lanes): the tables a product reads."""
        return self.tile_ptr, self.pair_shift, self.lanes


def band_values(elems: torch.Tensor, asm: BandAssembly) -> torch.Tensor:
    """Band-ELL values (P, 128) of the element stack ``elems``
    (nc, nd, nd); a lane without an entry is 0."""
    return bucket_sum(elems, asm.buckets, asm.P * LANE).reshape(asm.P, LANE)


def _edges(cd: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Every (row, col) pair of the element matrices on the dofmap ``cd``."""
    nd = cd.shape[1]
    return np.repeat(cd, nd, axis=1).reshape(-1), np.tile(cd, (1, nd)).reshape(-1)


def build_band_assembly(cell_dofs: np.ndarray, n: int, device) -> BandAssembly:
    """The band-ELL pair tables, in RCM order, of the operators on the
    dofmap ``cell_dofs`` (nc, nd) with ``n`` dofs: the JAX package's
    ``_make_band_engine`` set-up (RCM, then the slots of ``_band_layout``),
    with the entries' positions in the pair layout in place of its
    (S, R, 128) segments, in int64."""
    cd = np.asarray(cell_dofs, np.int64)
    rows, cols = _edges(cd)
    perm = rcm_permutation(rows, cols, n)
    iperm = _inverse(perm, n)
    uniq, inv = np.unique(iperm[rows] * np.int64(n) + iperm[cols], return_inverse=True)
    del rows, cols
    R = -(-n // LANE)
    shifts, tile_ptr, pair_shift, lanes, pair_slot, useg = build_pair_tables(
        uniq // n, uniq % n, R)
    buckets, nnz = slot_buckets(useg[inv.reshape(-1)], len(pair_shift) * LANE, device)
    dev = lambda a, dt: torch.as_tensor(np.ascontiguousarray(a), dtype=dt, device=device)
    return BandAssembly(
        n=int(n), R=int(R), shifts=tuple(shifts), tile_ptr=dev(tile_ptr, torch.int32),
        pair_shift=dev(pair_shift, torch.int32), lanes=dev(lanes, torch.uint8),
        pair_slot=pair_slot, perm=dev(perm, torch.int64), iperm=dev(iperm, torch.int64),
        buckets=buckets, nnz=nnz,
    )
