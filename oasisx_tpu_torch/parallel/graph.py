"""ELL sparsity of the unstructured operators, their deterministic
assembly from element stacks, and the graph-halo exchange of the sharded
general path.

Counterpart of ``oasisx_tpu/parallel/graph.py``.  An operator in ELL form
is applied as ``y[r] = sum_k vals[k, r] * x[cols[k, r]]`` (the ELL kernels
of ``la/ell.py``); its values are assembled from the element stack once
per solve, outside the Krylov loop.

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

The graph-halo mode (a rank a cell block, ``parallel/sharding.py``).  The
host tables are copied from the JAX package, so both number the dofs the
same way: cells partitioned into ``ndev`` blocks (``rcb_partition``, or
``partition.choose_partition``); each dof *owned* by the lowest shard whose
cells touch it, its *halo* the dofs its cells touch but another shard owns;
each shard's local layout ``[owned | halo | sentinel]``, padded to the
largest shard's counts (``nloc`` slots, the last one the sentinel); the
messages (halo holder -> owner) edge-coloured into rounds in which every
shard sends to at most one partner and receives from at most one
(``color_messages``).  A round is one ``Comm.shift`` on every rank, with
None where a rank has no partner in it (a rank that skipped a round would
leave its partners waiting):

- ``halo_fold`` adds each halo slot's value into its owner's slot, then
  zeroes every slot the rank does not own;
- ``halo_refresh`` copies each owner's value into the halo slots.

The owned-dof invariant: halo and sentinel slots are 0 in every assembled
vector and every solution, so a local dot plus one ``Comm.sum`` is the
global one.  A message carries only its real entries (the JAX package pads
each round's messages to the longest one).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


def rcb_partition(centroids: np.ndarray, ndev: int) -> np.ndarray:
    """Recursive coordinate bisection: split the cell set into ``ndev``
    equal-count parts by recursively cutting at the coordinate median of
    the widest axis.  Returns the shard of each cell (balanced up to
    rounding).  Copied from the JAX package."""
    nc = centroids.shape[0]
    out = np.zeros(nc, dtype=np.int32)

    def rec(idx: np.ndarray, parts: int, base: int) -> None:
        if parts == 1:
            out[idx] = base
            return
        pts = centroids[idx]
        widths = pts.max(axis=0) - pts.min(axis=0)
        ax = int(np.argmax(widths))
        lo_parts = parts // 2
        k = int(round(len(idx) * lo_parts / parts))
        order = np.argsort(pts[:, ax], kind="stable")
        rec(idx[order[:k]], lo_parts, base)
        rec(idx[order[k:]], parts - lo_parts, base + lo_parts)

    rec(np.arange(nc), ndev, 0)
    return out


def color_messages(sizes: list[tuple[int, int, int]]) -> list[list[int]]:
    """Greedy size-sorted edge colouring of point-to-point messages
    ``sizes`` [(src, dst, size)]: rounds as lists of message indices, in
    each round every src and every dst distinct.  Largest first, a message
    joins the round where it adds the least padded payload, or opens a new
    round when joining would pad it by more than a quarter.  Copied from
    the JAX package (also ``partition.schedule_cost``'s model)."""
    order = sorted(range(len(sizes)), key=lambda i: -sizes[i][2])
    rounds: list[list[int]] = []
    used: list[tuple[set, set]] = []
    bmax: list[int] = []  # per-round buffer width (max message size)
    for i in order:
        s, o, sz = sizes[i]
        best, best_inc = None, sz + (sz >> 2) + 1
        for ridx, (su, du) in enumerate(used):
            if s in su or o in du:
                continue
            nb = max(bmax[ridx], sz)
            inc = nb * (len(rounds[ridx]) + 1) - bmax[ridx] * len(rounds[ridx])
            if inc < best_inc:
                best, best_inc = ridx, inc
        if best is None:
            rounds.append([i])
            used.append(({s}, {o}))
            bmax.append(sz)
        else:
            rounds[best].append(i)
            used[best][0].add(s)
            used[best][1].add(o)
            bmax[best] = max(bmax[best], sz)
    return rounds


@dataclass
class HaloExchange:
    """The exchange tables of one function space, for every shard (host)."""

    ndev: int
    nloc: int  # owned_pad + halo_pad + 1 (sentinel)
    owned_pad: int
    # canonical dof -> shard * nloc + local slot on its owner (the stacked
    # local layout, the JAX package's internal dof order)
    perm: np.ndarray
    # per round: (pairs ((src, dst), ...) in the fold direction, pack
    # (ndev, B), unpack (ndev, B)) int32; rows padded with the sentinel
    # nloc - 1, all-sentinel rows for shards out of the round
    sched: list
    ownmask: np.ndarray  # (ndev * nloc,) 1.0 on owned slots
    # per-shard local cell dofmaps (ndev * cells_per_shard, ndpc) into
    # [0, nloc), the shard-blocked cell order, padded rows all sentinel
    cell_dofs_local: np.ndarray


def build_halo_exchange(
    cell_dofs: np.ndarray, shard_of_cell: np.ndarray, ndev: int,
    cell_perm: np.ndarray, cells_per_shard: int,
) -> HaloExchange:
    """Ownership, local numbering and the exchange schedule of one
    dofmap.  ``cell_perm`` is the shard-blocked cell order (padded with -1
    up to ndev * cells_per_shard); ``shard_of_cell`` indexes the original
    cells.  Copied from the JAX package."""
    num_dofs = int(cell_dofs.max()) + 1
    ndpc = cell_dofs.shape[1]

    # owner = lowest shard touching the dof
    owner = np.full(num_dofs, ndev, dtype=np.int32)
    for s in range(ndev):
        dofs_s = np.unique(cell_dofs[shard_of_cell == s])
        owner[dofs_s] = np.minimum(owner[dofs_s], s)
    assert (owner < ndev).all(), "dof untouched by any cell"

    # per-shard owned and halo dof lists (sorted for locality)
    owned = [np.where(owner == s)[0] for s in range(ndev)]
    halo = []
    for s in range(ndev):
        touched = np.unique(cell_dofs[shard_of_cell == s])
        halo.append(touched[owner[touched] != s])
    owned_pad = max(len(o) for o in owned)
    halo_pad = max((len(h) for h in halo), default=0)
    nloc = owned_pad + halo_pad + 1  # +1 sentinel
    sent = nloc - 1

    # local index of each (shard, dof)
    loc = np.full((ndev, num_dofs), -1, dtype=np.int64)
    for s in range(ndev):
        loc[s, owned[s]] = np.arange(len(owned[s]))
        loc[s, halo[s]] = owned_pad + np.arange(len(halo[s]))

    perm = np.empty(num_dofs, dtype=np.int64)
    for s in range(ndev):
        perm[owned[s]] = s * nloc + loc[s, owned[s]]

    # one message per (halo holder s -> owner o), edge-coloured into rounds
    msgs = []  # (s, o, sender halo locs, owner owned locs)
    for s in range(ndev):
        if not len(halo[s]):
            continue
        o_of = owner[halo[s]]
        for o in np.unique(o_of):
            hd = halo[s][o_of == o]
            msgs.append((s, int(o), loc[s, hd], loc[o, hd]))
    rounds = color_messages([(s, o, len(sl)) for s, o, sl, _ in msgs])
    sched = []
    for ridx in rounds:
        B = max(len(msgs[i][2]) for i in ridx)
        pack = np.full((ndev, B), sent, dtype=np.int32)
        unpack = np.full((ndev, B), sent, dtype=np.int32)
        pairs = []
        for i in ridx:
            s, o, sl, ol = msgs[i]
            pack[s, : len(sl)] = sl
            unpack[o, : len(ol)] = ol
            pairs.append((s, o))
        sched.append((tuple(pairs), pack, unpack))

    ownmask = np.zeros(ndev * nloc)
    for s in range(ndev):
        ownmask[s * nloc : s * nloc + len(owned[s])] = 1.0

    # local cell dofmaps in shard-blocked order
    nc_pad = ndev * cells_per_shard
    cdl = np.full((nc_pad, ndpc), sent, dtype=np.int32)
    for i, c in enumerate(cell_perm):
        if c < 0:
            continue
        s = i // cells_per_shard
        cdl[i] = loc[s, cell_dofs[c]]
    assert (cdl >= 0).all()

    return HaloExchange(
        ndev=ndev, nloc=nloc, owned_pad=owned_pad, perm=perm, sched=sched,
        ownmask=ownmask, cell_dofs_local=cdl,
    )


@dataclass
class HaloRounds:
    """One rank's share of a ``HaloExchange``, on its device: per round
    (the owner it sends to in the fold or None, the halo holder it receives
    from or None, its halo slots sent, its owned slots received into), each
    message cut to its real entries; its owned-slot mask."""

    rank: int
    nloc: int
    rounds: list
    ownmask: torch.Tensor  # (nloc,) in the solver's dtype


def halo_rounds(hx: HaloExchange, rank: int, dtype, device) -> HaloRounds:
    """``rank``'s rounds of the schedule ``hx.sched``."""
    sent = hx.nloc - 1
    idx = lambda row: torch.as_tensor(row[row != sent].astype(np.int64), device=device)
    rounds = []
    for pairs, pack, unpack in hx.sched:
        dst = next((o for s, o in pairs if s == rank), None)
        src = next((s for s, o in pairs if o == rank), None)
        rounds.append((dst, src, idx(pack[rank]), idx(unpack[rank])))
    own = hx.ownmask[rank * hx.nloc:(rank + 1) * hx.nloc]
    return HaloRounds(rank=rank, nloc=hx.nloc, rounds=rounds,
                      ownmask=torch.as_tensor(own, device=device).to(dtype))


def halo_fold(y: torch.Tensor, hr: HaloRounds, comm) -> torch.Tensor:
    """scatter_reverse(add) of local vectors ``y`` (..., nloc): each round
    sends this rank's halo values to their owner and adds what it receives
    into its owned slots; then every slot it does not own is zeroed."""
    y = y.clone()
    for dst, src, pack, unpack in hr.rounds:
        like = y.new_empty(y.shape[:-1] + (unpack.shape[0],))
        buf = comm.shift(y[..., pack] if dst is not None else None, dst, src, like)
        if buf is not None:
            y.index_add_(y.dim() - 1, unpack, buf)
    return y * hr.ownmask


def halo_refresh(x: torch.Tensor, hr: HaloRounds, comm) -> torch.Tensor:
    """scatter_forward of local vectors ``x`` (..., nloc): each round the
    owners send their values to the halo holders, which write them into
    their halo slots (the fold's rounds, reversed pairs)."""
    x = x.clone()
    for dst, src, pack, unpack in hr.rounds:
        like = x.new_empty(x.shape[:-1] + (pack.shape[0],))
        buf = comm.shift(x[..., unpack] if src is not None else None, src, dst, like)
        if buf is not None:
            x[..., pack] = buf
    return x


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
