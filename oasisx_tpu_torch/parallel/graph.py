"""ELL sparsity of the unstructured operators, and their deterministic
assembly from element stacks.

Counterpart of ``build_ell_tables`` and ``ell_values`` in
``oasisx_tpu/parallel/graph.py``, on one device (the halo exchange of the
multi-device path is not ported).  An operator in ELL form is applied as
``y[r] = sum_k vals[k, r] * x[cols[k, r]]`` (the ELL kernels of
``la/ell.py``); its values are assembled from the element stack once per
solve, outside the Krylov loop.

The JAX package assembles by a segment-sum.  Here the element entries are
grouped by their ELL slot once, at setup (``EllAssembly``): the slots with
the same count of entries, rounded up to a power of two, form one bucket,
a table of entry positions (padded with a position that holds 0).  Each
slot's value is then a gather and a row sum in the table's fixed order,
written to its slot, one bucket at a time, so repeated runs give the same
bits on the card where ``index_add_`` would sum with atomics.  (A segmented
reduction with one segment per slot, ``torch.segment_reduce``, took 23 ms
a step at the vessel's N=36 size on the H100: one thread block per slot.)

The ELL kernels give each 32-row slice of an operator (the rows of one warp)
its *width*, the largest slot count of a row there (``slice_widths``), and
stop each row's loop at it: the slots past a row's own length hold value 0
and column 0 and add exactly 0, so the product reads only the slices' real
widths (at the vessel's P2 operator 89% of what it reads are entries, where
the full K slots are 43% entries).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


def build_ell_tables(
    cd_rows: np.ndarray, cd_cols: np.ndarray, nloc: int, ndev: int
) -> tuple[int, np.ndarray, np.ndarray]:
    """Per-shard ELL sparsity of the local operator.

    ``cd_rows``/``cd_cols`` are shard-blocked local cell dofmaps
    (ndev*cps, ndr/ndc) (on one device, the cell dofmaps themselves; a
    padded cell has every dof equal to the sentinel nloc - 1).  Returns
    ``(K, slots (ndev, cps*ndr*ndc) int32, cols (ndev, K, nloc) int32)``
    where ``slots`` maps each flattened element-matrix entry to its segment
    ``k*nloc + row`` (padded cells to the dropped segment ``K*nloc``);
    unassigned (k, row) slots keep value 0 and column 0.  Copied from the
    JAX package."""
    ncp_total, ndr = cd_rows.shape
    ndc = cd_cols.shape[1]
    cps = ncp_total // ndev
    sent_dof = nloc - 1
    per_shard = []  # (valid mask, inv->unique, urow (sorted), ucol, kidx)
    Ks = []
    for s in range(ndev):
        cr = cd_rows[s * cps : (s + 1) * cps].astype(np.int64)
        cc = cd_cols[s * cps : (s + 1) * cps].astype(np.int64)
        pad_cell = (cr == sent_dof).all(axis=1)
        key = (
            np.broadcast_to(cr[:, :, None], (cps, ndr, ndc)) * nloc
            + np.broadcast_to(cc[:, None, :], (cps, ndr, ndc))
        ).reshape(-1)
        valid = np.broadcast_to(~pad_cell[:, None, None], (cps, ndr, ndc)).reshape(-1)
        uniq, inv = np.unique(key[valid], return_inverse=True)
        urow = uniq // nloc
        ucol = uniq % nloc
        # per-row running slot index (uniq is sorted, so rows are grouped)
        row_start = np.searchsorted(urow, urow)
        kidx = np.arange(len(uniq)) - row_start
        per_shard.append((valid, inv, urow, ucol, kidx))
        Ks.append(int(kidx.max()) + 1 if len(uniq) else 1)
    K = max(Ks)

    slots = np.full((ndev, cps * ndr * ndc), K * nloc, dtype=np.int32)
    cols = np.zeros((ndev, K, nloc), dtype=np.int32)
    for s, (valid, inv, urow, ucol, kidx) in enumerate(per_shard):
        slots[s, valid] = (kidx[inv] * nloc + urow[inv]).astype(np.int32)
        cols[s, kidx, urow] = ucol.astype(np.int32)
    return K, slots, cols


ELL_SLICE = 32  # rows of one slice: one warp of the ELL kernels (csrc/ell_device.cuh)


def slice_widths(slots: np.ndarray, K: int, n: int) -> np.ndarray:
    """(ceil(n / ELL_SLICE),) int32: per slice of ELL_SLICE consecutive rows,
    the largest slot count of its rows, from the slot map ``slots`` of
    ``build_ell_tables`` (a segment s < K n is slot s // n of row s % n;
    larger segments are dropped).  Not from the columns: column 0 is also a
    real column."""
    seg = slots[slots < K * n].astype(np.int64)
    used = np.zeros(K * n, dtype=bool)
    used[seg] = True
    used = used.reshape(K, n)
    # a row's length: one past its last used slot (0 for an empty row)
    return row_widths(np.where(used.any(axis=0), K - np.argmax(used[::-1], axis=0), 0))


def row_widths(rowlen: np.ndarray) -> np.ndarray:
    """(ceil(n / ELL_SLICE),) int32: the largest of the row lengths
    ``rowlen`` (n,) in each slice of ELL_SLICE consecutive rows."""
    n = rowlen.shape[0]
    nsl = -(-n // ELL_SLICE)
    rowlen = np.concatenate([rowlen, np.zeros(nsl * ELL_SLICE - n, dtype=rowlen.dtype)])
    return rowlen.reshape(nsl, ELL_SLICE).max(axis=1).astype(np.int32)


@dataclass
class EllAssembly:
    """One operator's ELL sparsity and its slot-grouped assembly map."""

    K: int
    n: int
    cols: torch.Tensor  # (K, n) int32, padding column 0
    widths: torch.Tensor  # (ceil(n / ELL_SLICE),) int32: each slice's slot count (slice_widths)
    # per bucket: (positions (nslots, width) into the flattened element
    # stack with one appended 0, padded with that 0; the slots (nslots,))
    buckets: list[tuple[torch.Tensor, torch.Tensor]]
    nnz: int  # slots that carry an entry (the operator's nonzeros)


def bucket_sum(elems: torch.Tensor, buckets: list, nseg: int) -> torch.Tensor:
    """The (nseg,) segment sums of the flattened element stack ``elems``
    over a slot-grouped map (``slot_buckets``): each segment sums its
    entries in the fixed order of its bucket's row; a segment without an
    entry is 0."""
    flat = torch.cat([elems.reshape(-1), elems.new_zeros(1)])
    out = elems.new_zeros(nseg)
    for pos, slots in buckets:
        out[slots] = flat[pos].sum(dim=1)
    return out


def ell_values(elems: torch.Tensor, asm: EllAssembly) -> torch.Tensor:
    """ELL values (K, n) of the element stack ``elems`` (nc, nd, nd); a
    padded slot is 0."""
    return bucket_sum(elems, asm.buckets, asm.K * asm.n).reshape(asm.K, asm.n)


def slot_buckets(slots: np.ndarray, nseg: int, device) -> tuple[list, int]:
    """The slot-grouped assembly map of element entries whose segments are
    ``slots`` (int64, one per flattened entry; a segment >= ``nseg`` is
    dropped): per bucket (entry positions (nsegs, width) padded with the
    position of an appended 0, the segments (nsegs,)), and the count of
    segments with an entry."""
    nent = slots.shape[0]
    order = np.argsort(slots, kind="stable")  # entries grouped by segment, ascending
    useg, starts, counts = np.unique(slots[order], return_index=True, return_counts=True)
    keep = useg < nseg
    useg, starts, counts = useg[keep], starts[keep], counts[keep]
    width = 1 << np.ceil(np.log2(counts)).astype(np.int64)
    buckets = []
    for w in np.unique(width):
        sel = np.flatnonzero(width == w)
        j = np.arange(w)
        idx = starts[sel, None] + j[None, :]
        pos = np.where(j[None, :] < counts[sel, None], order[np.minimum(idx, nent - 1)], nent)
        buckets.append((torch.as_tensor(pos, device=device),
                        torch.as_tensor(useg[sel], device=device)))
    return buckets, int(len(useg))


def build_ell_assembly(cell_dofs: np.ndarray, n: int, device: torch.device) -> EllAssembly:
    """The single-device ELL tables of the operators on the dofmap
    ``cell_dofs`` (nc, nd) with ``n`` dofs.  A real cell never has all its
    dofs equal to n - 1, so no entry is dropped."""
    cd = np.asarray(cell_dofs)
    K, slots, cols = build_ell_tables(cd, cd, n, 1)
    # segment K * n: the dropped segment of padded cells
    buckets, nnz = slot_buckets(slots[0].astype(np.int64), K * n, device)
    return EllAssembly(
        K=int(K), n=int(n), cols=torch.as_tensor(cols[0], device=device),
        widths=torch.as_tensor(slice_widths(slots[0], K, n), device=device), buckets=buckets,
        nnz=nnz,
    )
