"""Smoothed-aggregation algebraic multigrid for the unstructured pressure
Poisson.

Counterpart of ``oasisx_tpu/la/amg.py``: the same host-side NumPy setup
(strength graph, greedy aggregation, Jacobi-smoothed tentative
prolongation, Galerkin coarse operators, a dense pseudo-inverse on the
coarsest level, which also handles the singular pure-Neumann operator),
copied with its imports rewritten, and a plain V-cycle on tensors.  Level
operators and transfers are kept in ELL form, (n, K) row-major here as in
the JAX package; ``amg_kernel_data`` flattens them into the (K, n) layout
of the fused AMG-PCG kernel (``la/ell.py``, K17).
"""

from __future__ import annotations

import numpy as np
import torch

from ..parallel.graph import row_widths

__all__ = ["AlgebraicMG", "amg_dist_tables", "amg_kernel_data", "amg_widths", "coo_from_elems"]


def coo_from_elems(cd: np.ndarray, elems: np.ndarray, n: int):
    """Assemble element stacks (nc, m, m) with dofmap (nc, m) into
    duplicate-summed COO (rows, cols, vals) of the n x n operator."""
    nc, m = cd.shape
    rows = np.repeat(cd, m, axis=1).reshape(-1)
    cols = np.tile(cd, (1, m)).reshape(-1)
    vals = np.asarray(elems, np.float64).reshape(-1)
    return _sum_duplicates(rows.astype(np.int64), cols.astype(np.int64), vals, n)


def _sum_duplicates(rows, cols, vals, n):
    key = rows * n + cols
    order = np.argsort(key, kind="stable")
    key, vals = key[order], vals[order]
    first = np.ones(key.shape[0], bool)
    first[1:] = key[1:] != key[:-1]
    starts = np.flatnonzero(first)
    vals = np.add.reduceat(vals, starts)
    key = key[starts]
    return (key // n).astype(np.int64), (key % n).astype(np.int64), vals


def _csr_pointers(rows, n):
    counts = np.bincount(rows, minlength=n)
    indptr = np.zeros(n + 1, np.int64)
    np.cumsum(counts, out=indptr[1:])
    return indptr


def _aggregate(rows, cols, vals, n, theta=0.25, shard=None):
    """Greedy aggregation on the strength graph
    |a_ij| >= theta*sqrt(a_ii*a_jj) (standard SA passes 1-3).
    Returns (agg ids (n,), nagg).  Rows with no strong neighbours
    (Dirichlet identity rows, isolated dofs) become singletons.

    ``shard`` (n,) optional: strong edges between dofs of different
    shards are dropped, so every aggregate is shard-pure (the distributed
    fine-level apply relies on it)."""
    diag = np.zeros(n)
    dmask = rows == cols
    diag[rows[dmask]] = vals[dmask]
    off = ~dmask
    r, c, v = rows[off], cols[off], vals[off]
    dd = np.sqrt(np.abs(diag[r] * diag[c]))
    strong = np.abs(v) >= theta * np.where(dd > 0, dd, np.inf)
    if shard is not None:
        strong &= shard[r] == shard[c]
    r, c = r[strong], c[strong]
    order = np.argsort(r, kind="stable")
    r, c = r[order], c[order]
    indptr = _csr_pointers(r, n)

    agg = np.full(n, -1, np.int64)
    nagg = 0
    # pass 1: roots whose whole strong neighbourhood is free
    for i in range(n):
        if agg[i] >= 0:
            continue
        nb = c[indptr[i] : indptr[i + 1]]
        if (agg[nb] >= 0).any():
            continue
        agg[i] = nagg
        agg[nb] = nagg
        nagg += 1
    # pass 2: attach leftovers to a strongly-connected aggregate
    for i in range(n):
        if agg[i] >= 0:
            continue
        nb = c[indptr[i] : indptr[i + 1]]
        nb = nb[agg[nb] >= 0]
        if nb.size:
            agg[i] = agg[nb[0]]
    # pass 3: remaining nodes (no strong neighbours at all) -> singletons
    for i in range(n):
        if agg[i] < 0:
            agg[i] = nagg
            nagg += 1
    return agg, nagg


def _smoothed_prolongation(rows, cols, vals, n, agg, nagg, invd, omega):
    """P = (I - omega D^-1 A) T with T the piecewise-constant tentative
    prolongation over aggregates; returned as duplicate-summed COO."""
    pr = np.concatenate([np.arange(n), rows])
    pc = np.concatenate([agg, agg[cols]])
    pv = np.concatenate([np.ones(n), -omega * invd[rows] * vals])
    return _sum_duplicates(pr, pc, pv, nagg)


def _galerkin(prows, pcols, pvals, arows, acols, avals, n_f, n_c):
    """A_c = P^T A P via two COO x CSR-of-P expansions (all-numpy)."""
    order = np.argsort(prows, kind="stable")
    pr, pc, pv = prows[order], pcols[order], pvals[order]
    indptr = _csr_pointers(pr, n_f)
    nnz_row = np.diff(indptr)

    def prow_idx(fine_rows):
        """flat indices into (pc, pv) enumerating P's rows at fine_rows,
        plus the repeat counts (vectorized CSR row expansion)."""
        rep = nnz_row[fine_rows]
        base = np.repeat(indptr[fine_rows], rep)
        offs = np.arange(rep.sum()) - np.repeat(
            np.concatenate(([0], np.cumsum(rep)[:-1])), rep
        )
        return base + offs, rep

    # AP: for A entry (i, j, v) and P entry (j, J, w) -> (i, J, v*w)
    idx, rep = prow_idx(acols)
    apr, apc, apv = _sum_duplicates(
        np.repeat(arows, rep), pc[idx], np.repeat(avals, rep) * pv[idx], n_c
    )
    # P^T(AP): for AP entry (i, J, u) and P entry (i, I, w) -> (I, J, w*u)
    idx, rep = prow_idx(apr)
    return _sum_duplicates(
        pc[idx], np.repeat(apc, rep), pv[idx] * np.repeat(apv, rep), n_c
    )


def _to_ell(rows, cols, vals, n):
    """COO -> ELL: (cols (n, K) int64, vals (n, K) float64, widths); padding
    points at column 0 with zero weight, so the matvec is (vals *
    x[cols]).sum(-1).  ``widths`` (ceil(n / 32),) int32: each 32-row slice's
    longest row (``graph.row_widths`` of the CSR row lengths), where K17's
    row loops stop."""
    indptr = _csr_pointers(rows, n)  # rows must be sorted (sum_duplicates)
    rowlen = np.diff(indptr)
    K = max(1, int(rowlen.max()))
    ecols = np.zeros((n, K), np.int64)
    evals = np.zeros((n, K), np.float64)
    pos = np.arange(rows.shape[0]) - indptr[rows]
    ecols[rows, pos] = cols
    evals[rows, pos] = vals
    return ecols, evals, row_widths(rowlen)


def _power_lmax(rows, cols, vals, invd, n, iters=30, seed=7):
    """lambda_max(D^-1 A) by host power iteration (numpy)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(n)
    lam = 1.0
    for _ in range(iters):
        y = np.zeros(n)
        np.add.at(y, rows, vals * x[cols])
        y *= invd
        lam = np.linalg.norm(y)
        if lam == 0:
            return 1.0
        x = y / lam
    return float(lam)


class AlgebraicMG:
    """Symmetric V(pre, post) smoothed-aggregation AMG preconditioner.

    ``vcycle(r) -> z`` approximates A^-1 r.  The setup runs in NumPy on the
    host; the level tables are tensors of ``dtype`` on ``device``.
    """

    def __init__(
        self,
        rows: np.ndarray,
        cols: np.ndarray,
        vals: np.ndarray,
        n: int,
        dtype: torch.dtype = torch.float32,
        device: torch.device | str = "cpu",
        theta: float = 0.25,
        coarse_max: int = 400,
        max_levels: int = 10,
        pre: int = 1,
        post: int = 1,
        nullvec: np.ndarray | None = None,
        dof_shard: np.ndarray | None = None,
    ):
        """``nullvec``: the operator's nullspace vector (the pure-Neumann
        pressure constant).  The V-cycle then projects it out of its input
        and its output, which keeps the preconditioner symmetric positive
        definite on the complement.

        ``dof_shard`` (n,) optional: the owning shard of each fine dof.
        Level-0 aggregation then never crosses a shard boundary, and
        ``self.dist`` keeps what a distributed fine-level apply needs: the
        level-0 smoothed prolongation P0 as COO (fine dof, aggregate,
        weight), the level-0 smoother diagonal ``sm0`` and the aggregate
        count ``nagg0`` (None without ``dof_shard``, or when level 0 does
        not coarsen).  Coarser levels are not constrained.  Without
        ``dof_shard`` the levels are those of the JAX package's
        single-device AMG."""
        t = lambda a: torch.as_tensor(np.asarray(a), device=device)
        f = lambda a: t(np.asarray(a, np.float64)).to(dtype)
        self.pre, self.post = pre, post
        self.nullvec = None if nullvec is None else f(nullvec)
        self.levels = []
        self.dist = None
        # canonicalize (row-major sorted, duplicate-summed): callers may
        # hand-edit entries (e.g. Dirichlet identity rows)
        lrows, lcols, lvals = _sum_duplicates(
            np.asarray(rows, np.int64), np.asarray(cols, np.int64),
            np.asarray(vals, np.float64), n,
        )
        ln = n
        for li in range(max_levels):
            diag = np.zeros(ln)
            dm = lrows == lcols
            diag[lrows[dm]] = lvals[dm]
            invd = np.where(diag != 0, 1.0 / np.where(diag != 0, diag, 1.0), 1.0)
            if ln <= coarse_max:
                break
            # adaptive strength threshold: retry a stalled level with smaller
            # theta (at theta=0 every connection is strong)
            for th in (theta, theta / 4.0, 0.0):
                agg, nagg = _aggregate(lrows, lcols, lvals, ln, th,
                                       shard=dof_shard if li == 0 else None)
                if nagg < 0.5 * ln:
                    break
            if nagg >= 0.9 * ln:  # no meaningful coarsening left
                break
            lmax = _power_lmax(lrows, lcols, lvals, invd, ln)
            omega_p = 4.0 / (3.0 * lmax)
            prw, pcl, pvl = _smoothed_prolongation(
                lrows, lcols, lvals, ln, agg, nagg, invd, omega_p
            )
            if li == 0 and dof_shard is not None:
                self.dist = dict(P0=(prw.copy(), pcl.copy(), pvl.copy()),
                                 sm0=invd * (4.0 / (3.0 * lmax)), nagg0=nagg)
            crw, ccl, cvl = _galerkin(prw, pcl, pvl, lrows, lcols, lvals, ln, nagg)
            # restriction = P^T: swap row/col then duplicate-sort by row
            rrw, rcl, rvl = _sum_duplicates(pcl, prw, pvl, ln)
            ells = {key: _to_ell(*coo) for key, coo in (
                ("A", (lrows, lcols, lvals, ln)), ("P", (prw, pcl, pvl, ln)),
                ("R", (rrw, rcl, rvl, nagg)))}
            self.levels.append(
                dict(
                    n=ln,
                    nc=nagg,
                    A=(t(ells["A"][0]), f(ells["A"][1])),
                    sm=f(invd * (4.0 / (3.0 * lmax))),
                    P=(t(ells["P"][0]), f(ells["P"][1])),
                    R=(t(ells["R"][0]), f(ells["R"][1])),
                    widths={key: t(e[2]) for key, e in ells.items()},
                )
            )
            lrows, lcols, lvals, ln = crw, ccl, cvl, nagg
        # coarsest: dense pseudo-inverse; refuse a stalled coarsening rather
        # than an O(ln^3) SVD
        if ln > max(4 * coarse_max, 2000):
            raise ValueError(
                f"AMG coarsening stalled at n={ln} (> {max(4 * coarse_max, 2000)}):"
                " aggregation found too few strong connections"
            )
        Ad = np.zeros((ln, ln))
        Ad[lrows, lcols] = lvals
        # singular values below 1e-10 of the largest are the nullspace: a
        # Galerkin operator of the pure-Neumann Laplacian keeps its constant
        # mode at a rounding-level singular value (1e-16 to 1e-14 relative),
        # which numpy's default cut (n eps) can keep, giving entries near
        # 1e13 whose rounding then decides the V-cycle's output.  The JAX
        # package uses the default cut; a non-singular coarse operator
        # (Dirichlet or outlet rows) is inverted the same either way.
        self.coarse_inv = f(np.linalg.pinv(Ad, rcond=1e-10))
        self.num_levels = len(self.levels) + 1
        self.coarse_n = ln

    @staticmethod
    def _ell_mv(ell, x: torch.Tensor) -> torch.Tensor:
        cols, vals = ell
        return torch.sum(vals * x[cols], dim=-1)

    def _cycle(self, li: int, r: torch.Tensor) -> torch.Tensor:
        if li == len(self.levels):
            return self.coarse_inv @ r
        lv = self.levels[li]
        A, sm = lv["A"], lv["sm"]
        z = sm * r
        for _ in range(self.pre - 1):
            z = z + sm * (r - self._ell_mv(A, z))
        rc = self._ell_mv(lv["R"], r - self._ell_mv(A, z))
        z = z + self._ell_mv(lv["P"], self._cycle(li + 1, rc))
        for _ in range(self.post):
            z = z + sm * (r - self._ell_mv(A, z))
        return z

    def _project(self, x: torch.Tensor) -> torch.Tensor:
        nv = self.nullvec
        return x - (torch.dot(nv, x) / torch.dot(nv, nv)) * nv

    def vcycle(self, r: torch.Tensor) -> torch.Tensor:
        """The plain V-cycle on a tensor r (n,)."""
        if self.nullvec is None:
            return self._cycle(0, r)
        return self._project(self._cycle(0, self._project(r)))

    def cycle_coarse(self, rc: torch.Tensor) -> torch.Tensor:
        """The V-cycle from level 1 down: what a distributed apply runs on
        every rank after the fine residual's restriction is summed."""
        return self._cycle(1, rc)


def amg_kernel_data(amg: AlgebraicMG) -> tuple[dict, list[torch.Tensor]]:
    """Flatten an ``AlgebraicMG`` into (meta, tensors) for the in-kernel
    V-cycle: per level [Avals, Acols, sm, Pvals, Pcols, Rvals, Rcols] in the
    (K, n) layout (cols int32), then the coarse pseudo-inverse TRANSPOSED
    (the kernel's coarse solve is z_c[j] = sum_i CinvT[i, j] r[i]), then the
    nullspace vector if any.  The counterpart of ``amg_kernel_data`` in
    ``oasisx_tpu/assembly/pallas_ops.py``."""
    meta_levels, arrays = [], []
    T = lambda a: a.T.contiguous()
    I = lambda a: a.T.to(torch.int32).contiguous()
    for lv in amg.levels:
        Ac, Av = lv["A"]
        Pc, Pv = lv["P"]
        Rc, Rv = lv["R"]
        meta_levels.append(
            dict(n=int(lv["n"]), nc=int(lv["nc"]), K_A=int(Ac.shape[1]),
                 K_P=int(Pc.shape[1]), K_R=int(Rc.shape[1]))
        )
        arrays += [T(Av), I(Ac), lv["sm"].contiguous(), T(Pv), I(Pc), T(Rv), I(Rc)]
    arrays.append(T(amg.coarse_inv))
    meta = dict(
        levels=meta_levels,
        coarse_n=int(amg.coarse_n),
        pre=int(amg.pre),
        post=int(amg.post),
        has_null=amg.nullvec is not None,
    )
    if amg.nullvec is not None:
        arrays.append(amg.nullvec.contiguous())
    return meta, arrays


def amg_widths(amg: AlgebraicMG) -> list[torch.Tensor]:
    """The slice widths of the tables of ``amg_kernel_data``, where K17's
    row loops stop: per level those of A, P and R (int32, one per 32 rows:
    A and P over the level's n rows, R over its nc)."""
    return [lv["widths"][key].contiguous() for lv in amg.levels for key in ("A", "P", "R")]


def amg_dist_tables(amg: AlgebraicMG, hx) -> dict:
    """The distributed fine level's tables for every shard (host NumPy,
    the JAX package's ``_make_amg_dist_tables``, oasisx_tpu fracstep.py:
    1665-1727), from an AMG built with ``dof_shard`` and the pressure
    space's ``graph.HaloExchange`` ``hx``:

    - ``Rcols``/``Rvals`` (ndev, nagg, K_R): row J of P0^T restricted to
      the fine dofs shard s owns, columns in its local layout (padding:
      the sentinel, value 0); the ranks' partial products summed give the
      restriction, each fine dof counted once, on its owner;
    - ``Pcols``/``Pvals`` (ndev, nloc, K_P): the P0 rows of shard s's owned
      fine dofs, columns the global aggregates (padding: 0, value 0);
    - ``sm0`` (ndev, nloc): the level-0 smoother diagonal in the local
      layout, 0 on halo and padding slots."""
    ndev, nloc = hx.ndev, hx.nloc
    perm = np.asarray(hx.perm)
    sgl = (perm // nloc).astype(np.int64)
    lloc = (perm % nloc).astype(np.int64)
    d0 = amg.dist
    prw, pcl, pvl = d0["P0"]  # (fine dof i, aggregate J, weight)
    nagg = int(d0["nagg0"])

    def grouped_slots(keys):
        """slot index within each group of equal (sorted) keys."""
        first = np.ones(len(keys), bool)
        first[1:] = keys[1:] != keys[:-1]
        starts = np.where(first, np.arange(len(keys)), 0)
        return np.arange(len(keys)) - np.maximum.accumulate(starts)

    s_of = sgl[prw]
    order = np.lexsort((pcl, s_of))
    so, Jo, io, vo = s_of[order], pcl[order], prw[order], pvl[order]
    slot = grouped_slots(so * nagg + Jo)
    K_R = int(slot.max()) + 1 if len(slot) else 1
    Rcols = np.full((ndev, nagg, K_R), nloc - 1, np.int64)
    Rvals = np.zeros((ndev, nagg, K_R))
    Rcols[so, Jo, slot] = lloc[io]
    Rvals[so, Jo, slot] = vo

    order = np.argsort(prw, kind="stable")
    io, Jo, vo = prw[order], pcl[order], pvl[order]
    slot = grouped_slots(io)
    K_P = int(slot.max()) + 1 if len(slot) else 1
    Pcols = np.zeros((ndev, nloc, K_P), np.int64)
    Pvals = np.zeros((ndev, nloc, K_P))
    Pcols[sgl[io], lloc[io], slot] = Jo
    Pvals[sgl[io], lloc[io], slot] = vo

    sm0 = np.zeros(ndev * nloc)
    sm0[perm] = d0["sm0"]
    return dict(Rcols=Rcols, Rvals=Rvals, Pcols=Pcols, Pvals=Pvals,
                sm0=sm0.reshape(ndev, nloc))
