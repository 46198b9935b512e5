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
blocks, chosen by ``sub_group``) and a CPU tensor to ``solve_plain``, the
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

# The sub-group of K1's V-cycle: SUB_BLOCKS blocks of 256 threads run the
# levels from the first one below the finest with at most SUB_POINTS points
# a thread of theirs; the rest of the grid waits at one grid barrier.  Chosen
# by timing 8, 16 and 32 blocks from every level on an NVIDIA H100 80GB HBM3
# at 700 W (PERF.md): a coarse phase is bound by the work of the sub-group's
# SMs, so 8 blocks are slower than the whole grid (5 iterations at N=36:
# 2.91 ms from level 1, whole grid 1.89 ms); 16 and 32 blocks tie once the
# first sub-group level has at most one point a thread (N=36: 1.44 ms), and
# 32 blocks reach that on level 1 at N=36 and on level 2 at N=64 (2.47 ms,
# whole grid 3.05 ms).  A thread-block cluster of 8 blocks with
# cluster.sync() in place of the counter barrier ran as slow as 8 blocks.
SUB_BLOCKS = 32
SUB_POINTS = 1


def sub_group(sizes: list[int]) -> tuple[int, int]:
    """(sub_level, SUB_BLOCKS) for MG levels of ``sizes`` points, finest
    first: the first level l >= 1 with at most SUB_POINTS * 256 * SUB_BLOCKS
    points (len(sizes) if none: every level on the whole grid)."""
    cap = SUB_POINTS * 256 * SUB_BLOCKS
    lsub = next((l for l in range(1, len(sizes)) if sizes[l] <= cap), len(sizes))
    return lsub, SUB_BLOCKS


def barriers(L: int, lsub: int, nsmooth: int, degree: int) -> tuple[int, int]:
    """(grid, sub-group) barriers of one K1 MG iteration: 5 in the CG body,
    and one after each V-cycle phase (per level above the coarsest: nsmooth
    down (the sweeps after the first, the residual), the restriction into the
    next level, nsmooth + 1 up (the prolongation, the sweeps); degree - 1
    Chebyshev steps on the coarsest); the phases on levels >= lsub are the
    sub-group's, the last of them closed by a grid barrier."""
    phases = [0] * L  # V-cycle phases per level
    for l in range(L - 1):
        phases[l] += 2 * nsmooth + 1
        phases[l + 1] += 1
    phases[L - 1] += degree - 1
    sub = sum(phases[lsub:])
    return 5 + sum(phases[:lsub]) + (1 if sub else 0), max(sub - 1, 0)


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
        self.sub_level, self.sub_blocks = sub_group(
            [int(np.prod(lvl["grid"])) for lvl in self.levels])

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
        work = torch.empty(4 * ntot + n + 2, dtype=dt, device=dev)  # + sub_sync's 2 words
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
                 self.sub_level, self.sub_blocks, float(self.omega), float(lmin), float(lmax),
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
