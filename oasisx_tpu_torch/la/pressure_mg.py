"""Geometric-multigrid-preconditioned CG for the pressure Poisson.

The plain-tensor counterpart of the whole-solve TPU kernel
``make_pressure_cg(..., mg=build_pressure_mg_data(...))``
(``oasisx_tpu/assembly/pallas_ops.py``), step for step:

- V-cycle preconditioner: damped Jacobi smoothing (omega 0.8, 2 sweeps),
  axis-separable linear transfers (restriction = prolongation^T), coarse
  operators ``Ap_c * 2**(l*(d-2))``, and a degree-14 Chebyshev-Jacobi
  solve on the coarsest level;
- the singular Neumann operator handled by demeaning b, every operator
  application, the preconditioned residual and the final iterate;
- the result ``(x, iters, resnorm, converged)``.

``solve`` sends a CUDA tensor to the whole-solve kernel of
``csrc/krylov_ops.cu`` (K1: the CG loop, the V-cycle and every reduction on
the card, no host read; its coarse levels on a sub-group of the grid's
blocks and the coarsest on one block, in its shared memory: the teams that
``csrc/krylov_ops.cu`` ``mg_plan`` chooses and ``mg_teams`` mirrors) and a
CPU tensor to ``solve_plain``, the
plain version: its loop runs on the host with one device read per iteration, and
every ``Ap`` application, on every level, goes through the level operator
it is given (by default the constant-cube kernel's wrapper
``assembly.kernels.matvec_const``).  Launches and plain calls count under
``pressure_mg`` in ``assembly.kernels``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..assembly import kernels as kn
from .krylov import KrylovResult, chebyshev_preconditioner

# K1's teams (csrc/krylov_ops.cu mg_plan, which decides; these mirror it for
# the tests and chip_smoke's check): the levels above the sub-group run on
# the whole grid, on the P1 stencil tile (at most STENCIL_LEVELS of them);
# SUB_BLOCKS blocks of 256 threads run the levels from the first one below
# the finest with at most SUB_POINTS points a thread of theirs, block 0
# alone those from the first with at most BLOCK_POINTS points a thread of
# one block, in its shared memory.
SUB_BLOCKS = 32
SUB_POINTS = 1
BLOCK_POINTS = 4
STENCIL_LEVELS = 4
BODY_BARRIERS = 1  # grid barriers of the CG body outside the V-cycle


def mg_teams(sizes: list[int], block_from: int = 1) -> tuple[int, int, int]:
    """(sub_level, block_level, SUB_BLOCKS) for MG levels of ``sizes``
    points, finest first: block_level the first level l >= ``block_from``
    with at most BLOCK_POINTS * 256 points (len(sizes) where none),
    sub_level the first l >= 1 with at most SUB_POINTS * 256 * SUB_BLOCKS,
    at most block_level and STENCIL_LEVELS.  ``block_from`` is the first
    level whose boxes fit in block 0's shared memory beside the fine tile:
    the plan alone knows it (it moves block 0 to coarser levels, or to none,
    where they do not fit), so a check passes the plan's block level."""
    L = len(sizes)
    first = lambda cap, lo=1: next((l for l in range(lo, L) if sizes[l] <= cap), L)
    lblk = first(BLOCK_POINTS * 256, max(block_from, 1))
    return min(first(SUB_POINTS * 256 * SUB_BLOCKS), lblk, STENCIL_LEVELS), lblk, SUB_BLOCKS


def barriers(L: int, lsub: int, lblk: int, nsmooth: int, degree: int) -> tuple[int, int, int]:
    """(grid, sub-group, block) barriers of one K1 MG iteration:
    BODY_BARRIERS in the CG body, and one after each V-cycle phase (per
    level above the coarsest: nsmooth down (the sweeps after the first, the
    residual), the restriction into the next level, nsmooth + 1 up (the
    prolongation, the sweeps; above lsub the prolongation rides on the
    first sweep); degree - 1 Chebyshev steps on the coarsest), each its
    level's team's; block 0's last phase (it writes z for the level above)
    takes the level above's barrier, and the sub-group's last phase the grid
    barrier that closes its part."""
    phases = [0] * L  # V-cycle phases per level
    for l in range(L - 1):
        phases[l] += 2 * nsmooth + (0 if l < lsub else 1)
        phases[l + 1] += 1
    phases[L - 1] += degree - 1
    grid = BODY_BARRIERS + sum(phases[:lsub])
    sub, block = sum(phases[lsub:lblk]), sum(phases[lblk:])
    if lblk < L:
        block -= 1
        if lblk - 1 < lsub:
            grid += 1
        else:
            sub += 1
    return grid + (1 if sub else 0), max(sub - 1, 0), block


class PressureMGCG:
    """``solve(b, x0)`` on the P1 pressure grid vector (npad_q,)."""

    def __init__(self, sm_q, Ap_c: torch.Tensor, inv_diag, mg: dict, rtol: float,
                 maxiter: int):
        dev, dt = Ap_c.device, Ap_c.dtype
        self.d = d = len(sm_q[1])
        self.rtol = float(rtol)
        self.maxiter = int(maxiter)
        self.omega = mg["omega"]
        self.nsmooth = mg["nsmooth"]
        self.coarse = mg["coarse"]
        t = lambda a: torch.as_tensor(np.asarray(a), device=dev).to(dt)
        self.levels = []
        for li, lvl in enumerate(mg["levels"]):
            grid = tuple(lvl["grid"])
            self.levels.append(dict(
                grid=grid,
                sm=((1,) * d + grid, tuple(lvl["cells"]), 1, None, None),
                C=(Ap_c * lvl["scale"]).contiguous(),
                # the fine level uses the operator's own diagonal, rounded
                # to float32 as the kernel it mirrors stores it
                invd=t(np.asarray(inv_diag, np.float32) if li == 0 else lvl["invd"]).reshape(-1),
            ))
        self.transfers = [tuple(t(m) for m in mats) for mats in mg["transfers"]]
        self.n = int(np.prod(self.levels[0]["grid"]))
        # the kernel's tables: the fine cube matrix, every level's diagonal
        self.Ap_c = Ap_c.contiguous()
        self.cells = tuple(int(c) for c in sm_q[1])
        self.invd_all = torch.cat([lvl["invd"] for lvl in self.levels]).contiguous()
        self.matvec_fn = kn.matvec_const

    # --- operators -----------------------------------------------------------
    def matvec(self, li: int, x: torch.Tensor) -> torch.Tensor:
        lvl = self.levels[li]
        return self.matvec_fn(x.view(1, -1), lvl["C"], lvl["sm"]).view(-1)

    def demean(self, v: torch.Tensor) -> torch.Tensor:
        return v - torch.sum(v) / self.n

    def restrict(self, li: int, v: torch.Tensor) -> torch.Tensor:
        AT, _, B, _ = self.transfers[li]
        v = v.view(self.levels[li]["grid"])
        if self.d == 2:
            return (AT @ (v @ B)).reshape(-1)
        rows = AT @ (v @ B)  # (gf0, gc1, gc2)
        out = rows[0::2].clone()
        half = 0.5 * rows[1::2]
        out[1:] += half
        out[:-1] += half
        return out.reshape(-1)

    def prolong_add(self, li: int, zc: torch.Tensor, zf: torch.Tensor) -> torch.Tensor:
        _, A, _, BT = self.transfers[li]
        Zc = zc.view(self.levels[li + 1]["grid"])
        Zf = zf.view(self.levels[li]["grid"]).clone()
        if self.d == 2:
            return (Zf + A @ (Zc @ BT)).reshape(-1)
        ups = A @ (Zc @ BT)  # (gc0, gf1, gf2)
        Zf[0::2] += ups
        Zf[1::2] += 0.5 * (ups[:-1] + ups[1:])
        return Zf.reshape(-1)

    # --- preconditioner ------------------------------------------------------
    def smooth(self, li: int, r: torch.Tensor, z: torch.Tensor | None) -> torch.Tensor:
        om, iv = self.omega, self.levels[li]["invd"]
        sweeps = self.nsmooth
        if z is None:
            z = om * iv * r
            sweeps -= 1
        for _ in range(sweeps):
            z = z + om * iv * (r - self.matvec(li, z))
        return z

    def chebyshev(self, li: int, r: torch.Tensor) -> torch.Tensor:
        """z = p(D^-1 A) D^-1 r on level li with the coarse bounds."""
        lmin, lmax, deg = self.coarse
        M = chebyshev_preconditioner(lambda z: self.matvec(li, z), self.levels[li]["invd"], lmin,
                                     lmax, deg)
        return M(r)

    def vcycle(self, r: torch.Tensor) -> torch.Tensor:
        L = len(self.levels)
        rs, zs = [r], []
        for li in range(L - 1):
            z = self.smooth(li, rs[li], None)
            zs.append(z)
            rs.append(self.restrict(li, rs[li] - self.matvec(li, z)))
        z = self.chebyshev(L - 1, rs[L - 1])
        for li in reversed(range(L - 1)):
            z = self.smooth(li, rs[li], self.prolong_add(li, z, zs[li]))
        return self.demean(z)

    # --- PCG -----------------------------------------------------------------
    def solve(self, b: torch.Tensor, x0: torch.Tensor) -> KrylovResult:
        """K1 on a CUDA tensor, ``solve_plain`` on the CPU."""
        if not kn._route(b, x0, self.Ap_c):
            return self.solve_plain(b, x0)
        with torch.cuda.device(b.device):
            return self._solve_kernel(b, x0)

    def _solve_kernel(self, b: torch.Tensor, x0: torch.Tensor) -> KrylovResult:
        dev, dt = b.device, b.dtype
        n = self.n
        kn._check(b, "b", dt, (n,))
        kn._check(x0, "x0", dt, (n,))
        kn._check(self.Ap_c, "Ap_c", dt, tuple(self.Ap_c.shape))
        ntot = self.invd_all.numel()
        x = torch.empty(n, dtype=dt, device=dev)
        # 4 vectors a level, p twice, Ap, r's second buffer, sub_sync's 2 words
        work = torch.empty(4 * ntot + 4 * n + 2, dtype=dt, device=dev)
        red = torch.empty(2 * 8 * kn.coop_capacity(dev), dtype=dt, device=dev)
        iters = torch.empty(1, dtype=torch.int32, device=dev)
        rnorm = torch.empty(1, dtype=dt, device=dev)
        conv = torch.empty(1, dtype=torch.int32, device=dev)
        lmin, lmax, deg = self.coarse
        p = kn._ptr
        cells = self.cells + (0,) * (3 - self.d)
        kn._call("pressure_mg", p(self.Ap_c), p(b), p(x0), p(self.invd_all), p(x), p(work),
                 p(red), red.numel() // 16, p(iters), p(rnorm), p(conv),
                 int(dt == torch.float64), self.d, *cells, len(self.levels), int(self.nsmooth),
                 float(self.omega), float(lmin), float(lmax),
                 int(deg), self.rtol, self.maxiter, kn._stream(b))
        return KrylovResult(x, iters[0], rnorm[0], conv[0] != 0, 0)

    def solve_plain(self, b: torch.Tensor, x0: torch.Tensor, matvec=None) -> KrylovResult:
        """The plain version of K1; ``matvec(x (1, n), C, sm)`` applies a
        level's operator (default ``assembly.kernels.matvec_const``)."""
        kn.plain_calls["pressure_mg"] += 1
        self.matvec_fn = matvec or kn.matvec_const
        b = self.demean(b)
        tol = self.rtol * torch.linalg.vector_norm(b)
        x = x0
        r = self.demean(b - self.matvec(0, x0))
        z = self.vcycle(r)
        p = z
        rz = torch.dot(r, z)
        rnorm = torch.linalg.vector_norm(r)
        k = syncs = 0
        while k < self.maxiter:
            syncs += 1
            if not bool(rnorm > tol):
                break
            Apv = self.demean(self.matvec(0, p))
            pAp = torch.dot(p, Apv)
            alpha = rz / torch.where(pAp != 0, pAp, torch.ones_like(pAp))
            x = x + alpha * p
            r = r - alpha * Apv
            z = self.vcycle(r)
            rz_new = torch.dot(r, z)
            beta = rz_new / torch.where(rz != 0, rz, torch.ones_like(rz))
            p = z + beta * p
            rz = rz_new
            rnorm = torch.linalg.vector_norm(r)
            k += 1
        x = self.demean(x)
        return KrylovResult(
            x, torch.tensor(k, dtype=torch.int32, device=b.device), rnorm, rnorm <= tol, syncs
        )
