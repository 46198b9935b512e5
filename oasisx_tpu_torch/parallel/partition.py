"""Multilevel edge-cut-aware cell partitioner (host NumPy).

Copied from ``oasisx_tpu/parallel/partition.py`` with the same fixed seed,
so that both packages choose the same partition for the graph-halo mode
and therefore number the dofs the same way.  It partitions the cell dual
graph (cells adjacent across a shared facet) with the multilevel scheme of
METIS and SCOTCH:

1. coarsen by repeated heavy-edge matching (vectorized mutual-proposal
   rounds) until the graph is small,
2. initial k-way partition on the coarsest graph by weighted RCB of the
   (weight-averaged) coarse centroids,
3. uncoarsen, at every level running label-propagation boundary
   refinement under a strict balance cap (the largest part bounds a
   rank's cells).

``choose_partition`` scores that partition and plain RCB
(``graph.rcb_partition``) by the exact exchange payload each would give
(``schedule_cost``, the edge-coloured schedule of
``graph.build_halo_exchange``) and keeps the cheaper.
"""

from __future__ import annotations

from itertools import combinations

import numpy as np


def dual_graph(cells: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Facet-adjacency (dual) graph of a simplex mesh.

    ``cells``: (nc, dim+1) vertex ids.  Returns CSR ``(indptr, indices,
    eweights)`` with unit edge weights (two cells share at most one
    facet).
    """
    nc, nvc = cells.shape
    dim = nvc - 1
    fa, owner = [], []
    for comb in combinations(range(nvc), dim):
        fa.append(np.sort(cells[:, comb], axis=1))
        owner.append(np.arange(nc, dtype=np.int64))
    F = np.vstack(fa)
    own = np.concatenate(owner)
    order = np.lexsort(F.T[::-1])
    Fs, os_ = F[order], own[order]
    same = (Fs[1:] == Fs[:-1]).all(axis=1)
    a, b = os_[:-1][same], os_[1:][same]
    src = np.concatenate([a, b])
    dst = np.concatenate([b, a])
    return _csr(src, dst, np.ones(len(src), dtype=np.int64), nc)


def _csr(src, dst, w, n):
    order = np.argsort(src, kind="stable")
    src, dst, w = src[order], dst[order], w[order]
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.add.at(indptr, src + 1, 1)
    np.cumsum(indptr, out=indptr)
    return indptr, dst.astype(np.int64), w


def _edges(indptr, indices, ew):
    src = np.repeat(np.arange(len(indptr) - 1), np.diff(indptr))
    return src, indices, ew


def _match(indptr, indices, ew, rng) -> np.ndarray:
    """Heavy-edge matching via mutual-proposal rounds (vectorized).
    Returns map node -> matched partner (or itself)."""
    n = len(indptr) - 1
    match = np.full(n, -1, dtype=np.int64)
    src, dst, w = _edges(indptr, indices, ew)
    for _ in range(3):
        free = match < 0
        live = free[src] & free[dst]
        if not live.any():
            break
        s, d, ww = src[live], dst[live], w[live]
        # per-source heaviest neighbor: sort by (src, w, jitter) take last
        jitter = rng.random(len(s))
        order = np.lexsort((jitter, ww, s))
        s, d = s[order], d[order]
        last = np.r_[s[1:] != s[:-1], True]
        prop = np.full(n, -1, dtype=np.int64)
        prop[s[last]] = d[last]
        # mutual proposals
        cand = np.where(free & (prop >= 0))[0]
        mutual = prop[prop[cand]] == cand
        u = cand[mutual]
        v = prop[u]
        keep = u < v
        u, v = u[keep], v[keep]
        match[u] = v
        match[v] = u
    match[match < 0] = np.where(match < 0)[0]
    return match


def _contract(indptr, indices, ew, nw, cent, match):
    """Contract matched pairs; returns coarse graph + node weights +
    weight-averaged centroids + fine->coarse map."""
    n = len(indptr) - 1
    rep = np.minimum(np.arange(n), match)
    uniq, cmap = np.unique(rep, return_inverse=True)
    ncoarse = len(uniq)
    cnw = np.zeros(ncoarse, dtype=np.int64)
    np.add.at(cnw, cmap, nw)
    ccent = np.zeros((ncoarse, cent.shape[1]))
    np.add.at(ccent, cmap, cent * nw[:, None])
    ccent /= cnw[:, None]
    src, dst, w = _edges(indptr, indices, ew)
    cs, cd = cmap[src], cmap[dst]
    keep = cs != cd
    cs, cd, w = cs[keep], cd[keep], w[keep]
    # merge duplicate edges
    key = cs * ncoarse + cd
    uk, inv = np.unique(key, return_inverse=True)
    wsum = np.zeros(len(uk), dtype=np.int64)
    np.add.at(wsum, inv, w)
    return (*_csr(uk // ncoarse, uk % ncoarse, wsum, ncoarse), cnw, ccent, cmap)


def _rcb_weighted(cent: np.ndarray, nw: np.ndarray, ndev: int) -> np.ndarray:
    """Weighted RCB for the coarsest-level initial partition."""
    out = np.zeros(len(cent), dtype=np.int32)

    def rec(idx, parts, base):
        if parts == 1:
            out[idx] = base
            return
        pts = cent[idx]
        ax = int(np.argmax(pts.max(axis=0) - pts.min(axis=0)))
        order = np.argsort(pts[:, ax], kind="stable")
        lo_parts = parts // 2
        cum = np.cumsum(nw[idx][order])
        k = int(np.searchsorted(cum, cum[-1] * lo_parts / parts))
        k = min(max(k, 1), len(idx) - 1)
        rec(idx[order[:k]], lo_parts, base)
        rec(idx[order[k:]], parts - lo_parts, base + lo_parts)

    rec(np.arange(len(cent)), ndev, 0)
    return out


def _refine(indptr, indices, ew, nw, part, ndev, cap, passes=8):
    """Label-propagation boundary refinement with a hard balance cap.

    Each pass: compute every node's edge-weight connectivity to each part,
    take the best positive-gain move per node, apply moves in descending
    gain order while part sizes respect ``cap``.
    """
    n = len(indptr) - 1
    src, dst, w = _edges(indptr, indices, ew)
    sizes = np.zeros(ndev, dtype=np.int64)
    np.add.at(sizes, part, nw)
    for _ in range(passes):
        W = np.zeros((n, ndev), dtype=np.int64)
        np.add.at(W, (src, part[dst]), w)
        cur = W[np.arange(n), part]
        Wm = W.copy()
        Wm[np.arange(n), part] = -1
        best = np.argmax(Wm, axis=1).astype(np.int32)
        gain = Wm[np.arange(n), best] - cur
        cand = np.where(gain > 0)[0]
        if not len(cand):
            break
        cand = cand[np.argsort(-gain[cand], kind="stable")]
        moved = 0
        for u in cand:
            p_new, p_old = best[u], part[u]
            if p_new == p_old:
                continue
            if sizes[p_new] + nw[u] > cap:
                continue
            sizes[p_old] -= nw[u]
            sizes[p_new] += nw[u]
            part[u] = p_new
            moved += 1
        if not moved:
            break
    return part


def edge_cut(cells_or_graph, part) -> int:
    """Total cut edge weight (each cut facet counted once)."""
    if isinstance(cells_or_graph, tuple):
        indptr, indices, ew = cells_or_graph
    else:
        indptr, indices, ew = dual_graph(np.asarray(cells_or_graph))
    src, dst, w = _edges(indptr, indices, ew)
    return int(w[part[src] != part[dst]].sum() // 2)


def partition_cells(
    cells: np.ndarray,
    centroids: np.ndarray,
    ndev: int,
    seed: int = 0,
) -> np.ndarray:
    """Multilevel edge-cut partition of the mesh cells into ``ndev`` parts.

    Balance guarantee: max part size <= ceil(nc/ndev) — exactly the padded
    per-shard cell count of the shard-blocked cell order, so the edge-cut win is
    never paid for with extra compute padding.
    """
    cells = np.asarray(cells)
    nc = len(cells)
    if ndev <= 1:
        return np.zeros(nc, dtype=np.int32)
    rng = np.random.default_rng(seed)
    graph = dual_graph(cells)
    nw = np.ones(nc, dtype=np.int64)
    cent = np.asarray(centroids, dtype=np.float64)
    levels = []  # (graph, nw, cmap)
    indptr, indices, ew = graph
    # --- coarsen ---------------------------------------------------------
    while len(indptr) - 1 > max(64 * ndev, 512):
        match = _match(indptr, indices, ew, rng)
        indptr2, indices2, ew2, nw2, cent2, cmap = _contract(
            indptr, indices, ew, nw, cent, match
        )
        if len(indptr2) - 1 > 0.95 * (len(indptr) - 1):
            break  # matching stalled (e.g. star graphs)
        levels.append(((indptr, indices, ew), nw, cmap))
        indptr, indices, ew, nw, cent = indptr2, indices2, ew2, nw2, cent2
    # --- initial partition on the coarsest graph -------------------------
    part = _rcb_weighted(cent, nw, ndev)
    cap = -(-nc // ndev)
    part = _refine(indptr, indices, ew, nw, part, ndev, cap)
    # --- uncoarsen + refine ----------------------------------------------
    for (g, nw_f, cmap) in reversed(levels):
        part = part[cmap]
        indptr, indices, ew = g
        part = _refine(indptr, indices, ew, nw_f, part, ndev, cap)
    # hard balance pass: RCB-style spill if anything still exceeds cap
    sizes = np.bincount(part, minlength=ndev)
    if sizes.max() > cap:
        part = _spill(graph, part, ndev, cap)
    return part.astype(np.int32)


def interface_signatures(cell_dofs: np.ndarray, shard_of: np.ndarray, ndev: int):
    """Aggregate interface dofs by their touching-shard set.

    Returns ``[(sig_tuple, count)]`` where ``sig_tuple`` is the sorted set
    of shards whose cells touch the dof (only |sig|>=2, i.e. interface
    dofs).  This is the exact information needed to evaluate the halo
    exchange schedule cost under any shard relabeling (ownership = lowest
    RELABELED shard, so pairs must be recomputed per labeling — cheap over
    signatures, expensive over dofs)."""
    ndpc = cell_dofs.shape[1]
    key = cell_dofs.astype(np.int64).ravel() * ndev + np.repeat(
        shard_of.astype(np.int64), ndpc
    )
    uk = np.unique(key)
    dof, shard = uk // ndev, (uk % ndev).astype(np.int32)
    # group by dof
    starts = np.r_[0, np.where(dof[1:] != dof[:-1])[0] + 1, len(dof)]
    sigs: dict[tuple, int] = {}
    for i in range(len(starts) - 1):
        a, b = starts[i], starts[i + 1]
        if b - a < 2:
            continue
        t = tuple(shard[a:b].tolist())
        sigs[t] = sigs.get(t, 0) + 1
    return list(sigs.items())


def schedule_cost(sigs, ndev: int) -> int:
    """Exact payload (slots) of one halo exchange — the
    cost ``build_halo_exchange`` realizes with its edge-colored schedule:
    messages are greedily colored largest-first and each round costs
    ``len(pairs) * max_size_in_round`` (only participating links move
    bytes)."""
    from .graph import color_messages

    pairs = np.zeros((ndev, ndev), dtype=np.int64)
    for sig, cnt in sigs:
        o = min(sig)
        for s in sig:
            if s != o:
                pairs[s, o] += cnt
    s_idx, o_idx = np.nonzero(pairs)
    sizes = [(int(s), int(o), int(pairs[s, o])) for s, o in zip(s_idx, o_idx)]
    rounds = color_messages(sizes)
    return sum(len(r) * max(sizes[i][2] for i in r) for r in rounds)


def choose_partition(
    cells: np.ndarray,
    centroids: np.ndarray,
    ndev: int,
    dofmaps: list[np.ndarray],
    seed: int = 0,
    info: dict | None = None,
) -> np.ndarray:
    """Partition by exact exchange cost.

    Builds both candidates — geometric RCB (graph.py) and the multilevel
    edge-cut partition — evaluates the true edge-colored exchange payload
    each would realize for every given dofmap (velocity + pressure
    spaces), and returns the cheaper one.  Guarantees the result is never
    worse than RCB in the cost the runtime actually pays.  ``info``, a
    dict, receives the chosen candidate's ``name`` and its ``cost``."""
    from .graph import rcb_partition

    cands = {"rcb": rcb_partition(np.asarray(centroids), ndev)}
    try:
        cands["multilevel"] = partition_cells(cells, centroids, ndev, seed=seed)
    except Exception:  # pragma: no cover - partitioner must never be fatal
        pass
    best_name, best_part, best_cost = None, None, None
    for name, part in cands.items():
        cost = sum(
            schedule_cost(interface_signatures(np.asarray(cd), part, ndev), ndev)
            for cd in dofmaps
        )
        if best_cost is None or cost < best_cost:
            best_name, best_part, best_cost = name, part, cost
    import logging

    logging.getLogger("oasisx_tpu_torch").info(
        "partitioner: chose %s (schedule cost %d slots/exchange over %d spaces)",
        best_name, best_cost, len(dofmaps),
    )
    if info is not None:
        info.update(name=best_name, cost=int(best_cost))
    return best_part.astype(np.int32)


def _spill(graph, part, ndev, cap):
    """Move lowest-connectivity nodes out of oversized parts into the
    least-loaded neighbor part (last-resort balance repair)."""
    indptr, indices, ew = graph
    n = len(indptr) - 1
    src, dst, w = _edges(indptr, indices, ew)
    sizes = np.bincount(part, minlength=ndev).astype(np.int64)
    for p in range(ndev):
        while sizes[p] > cap:
            members = np.where(part == p)[0]
            W = np.zeros((len(members), ndev), dtype=np.int64)
            sel = part[src] == p
            s_, d_, w_ = src[sel], dst[sel], w[sel]
            pos = np.full(n, -1, dtype=np.int64)
            pos[members] = np.arange(len(members))
            np.add.at(W, (pos[s_], part[d_]), w_)
            ext = W.copy()
            ext[:, p] = 0
            # candidates with external connectivity, weakest internal ties
            score = W[:, p] - ext.max(axis=1)
            order = np.argsort(score, kind="stable")
            moved = False
            for i in order[: sizes[p] - cap + 8]:
                tgt_w = np.where(sizes + 1 <= cap, ext[i], -1)
                tgt = int(np.argmax(tgt_w))
                if tgt_w[tgt] < 0:
                    tgt = int(np.argmin(sizes))
                    if sizes[tgt] + 1 > cap:
                        continue
                part[members[i]] = tgt
                sizes[p] -= 1
                sizes[tgt] += 1
                moved = True
                if sizes[p] <= cap:
                    break
            if not moved:
                break
    return part
