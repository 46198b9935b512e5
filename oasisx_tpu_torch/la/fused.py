"""The main path's batched Krylov solves from a given initial residual:
plain versions and the wrappers of their whole-solve kernels.

============ ==================================== ==============================
wrapper      solves                               replaces (pallas_ops.py)
============ ==================================== ==============================
cg_mass      C x_b = b_b, Jacobi-PCG, batch B     make_cg_iter_pf (K4) and the
                                                  loop around it (cg_pf_solve)
bicgstab     A_W x_b = b_b, zero-masked bc rows,  make_bicgstab_iter (K2) and
             Jacobi BiCGStab, batch B             bicgstab_fused_from_r0
============ ==================================== ==============================

K4's work buffer is 4 (B, npad) vectors: r, Ap and, on the P2 cube (whose
product is K5's block-tiled one) and the P1 cube (the stencil tile), two
search directions by iteration parity; any other cube runs point by point
on one of them (``oasisx_cg_mass_route`` names the route).

The plain versions ``cg_from_r0`` and ``bicgstab_from_r0`` follow the JAX
functions operation for operation, with the loop on the host (one device
read per iteration, counted in ``KrylovResult.syncs``) and the operator
passed in.  The wrappers send a CPU tensor to the plain version on the cube
kernels' wrappers (their plain versions on the CPU), a CUDA tensor to the
kernel of ``csrc/krylov_ops.cu``, which runs the whole loop on the card
(``syncs`` 0), and raise for anything else.  K2's wrapper allocates the
kernel's staging buffer, (B, nl, ncubes): each product's per-cube outputs
before the points sum them (15.1 MB at N=36, 84.9 MB at N=64 in float32).
Launches and plain calls count in ``assembly.kernels.launches`` /
``plain_calls``.

Both take per-row tolerances ``max(rtol * bnorm, atol)``, active-row
freezing, and one Jacobi inverse diagonal ``invd`` (npad,) shared by the
rows.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..assembly import cubes as cub
from ..assembly import kernels as kn
from .krylov import KrylovResult, _nz


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.sum(a * b, dim=-1)


def _tol(bnorm: torch.Tensor, rtol: float, atol: float) -> torch.Tensor:
    return torch.clamp(rtol * bnorm, min=atol)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def cg_from_r0(apply: Callable, r0, x0, invd, bnorm, rtol: float, maxiter: int,
               atol: float = 1e-50) -> KrylovResult:
    """Batched Jacobi-PCG from the caller's r0 = b - A x0 and x0, all (B, n):
    the device loop of oasisx_tpu's velocity update (fracstep.py:2861-2879)
    around ``make_cg_iter_pf`` (pallas_ops.py:1784-1807).  On an inactive
    row alpha and beta are 0, p is kept and rnorm / iters are frozen."""
    kn.plain_calls["cg_mass"] += 1
    tol = _tol(bnorm, rtol, atol)
    x, r = x0, r0
    z = invd * r
    p = z
    rz = _dot(r, z)
    rn = torch.sqrt(_dot(r, r))
    iters = torch.zeros(r0.shape[0], dtype=torch.int32, device=r0.device)
    zero = torch.zeros_like(rz)
    k = syncs = 0
    while k < maxiter:
        syncs += 1
        if not bool(torch.any(rn > tol)):
            break
        active = rn > tol
        Ap = apply(p)
        pAp = _dot(p, Ap)
        alpha = torch.where(active, rz / _nz(pAp), zero)
        x = x + alpha[:, None] * p
        r = r - alpha[:, None] * Ap
        z = invd * r
        rz_new = torch.where(active, _dot(r, z), rz)
        beta = torch.where(active, rz_new / _nz(rz), zero)
        p = torch.where(active[:, None], z + beta[:, None] * p, p)
        rn = torch.where(active, torch.sqrt(_dot(r, r)), rn)
        iters = iters + active.to(torch.int32)
        rz = rz_new
        k += 1
    return KrylovResult(x, iters, rn, rn <= tol, syncs)


def bicgstab_from_r0(apply: Callable, r0, x0, zmask, invd, bnorm, rtol: float, maxiter: int,
                     atol: float = 1e-50) -> KrylovResult:
    """Batched BiCGStab from r0 = zmask (b - A x0), all (B, n), with x0's
    Dirichlet rows preset to the bc values and the operator's output zeroed
    on them (``zmask`` 0 there), so every Krylov vector is 0 on bc rows:
    ``make_bicgstab_iter`` (pallas_ops.py:1129-1190) driven as
    ``bicgstab_fused_from_r0`` (:1226-1259).  rhat = r0; an inactive row
    keeps x and p, restores r = s + alpha v, and freezes rho / rnorm /
    iters."""
    kn.plain_calls["bicgstab"] += 1
    tol = _tol(bnorm, rtol, atol)
    rho = _dot(r0, r0)
    rn = torch.sqrt(rho)
    rhat, x, r, p = r0, x0, r0, r0
    iters = torch.zeros(r0.shape[0], dtype=torch.int32, device=r0.device)
    col = lambda v: v[:, None]
    k = syncs = 0
    while k < maxiter:
        syncs += 1
        if not bool(torch.any(rn > tol)):
            break
        active = rn > tol
        v = zmask * apply(invd * p)
        alpha = rho / _nz(_dot(rhat, v))
        s = r - col(alpha) * v
        t = zmask * apply(invd * s)
        omega = _dot(t, s) / _nz(_dot(t, t))
        dx = col(alpha) * (invd * p) + col(omega) * (invd * s)
        x = x + col(active.to(x.dtype)) * dx
        r_new = torch.where(col(active), s - col(omega) * t, s + col(alpha) * v)
        rho_new = torch.where(active, _dot(rhat, r_new), rho)
        beta = (rho_new / _nz(rho)) * (alpha / _nz(omega))
        p = torch.where(col(active), r_new + col(beta) * (p - col(omega) * v), p)
        rn = torch.where(active, torch.sqrt(_dot(r_new, r_new)), rn)
        iters = iters + active.to(torch.int32)
        r, rho = r_new, rho_new
        k += 1
    return KrylovResult(x, iters, rn, rn <= tol, syncs)


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------


def _vectors(sm, r0, x0, invd, bnorm, *more):
    """Checks shared by the kernel wrappers; returns (batch, npad)."""
    npad = int(np.prod(sm[0]))
    B = r0.shape[0]
    dt = r0.dtype
    for name, t in (("r0", r0), ("x0", x0)) + tuple(more):
        kn._check(t, name, dt, (B, npad))
    kn._check(invd, "invd", dt, (npad,))
    kn._check(bnorm, "bnorm", dt, (B,))
    return B, npad


def _outputs(r0, B, nwork, npad, bnorm, rtol, atol):
    dev, dt = r0.device, r0.dtype
    return dict(
        tol=_tol(bnorm, rtol, atol).contiguous(),
        x=torch.empty((B, npad), dtype=dt, device=dev),
        work=torch.empty((nwork, B, npad), dtype=dt, device=dev),
        red=torch.empty(2 * 8 * kn.coop_capacity(dev), dtype=dt, device=dev),
        iters=torch.empty(B, dtype=torch.int32, device=dev),
        rnorm=torch.empty(B, dtype=dt, device=dev),
    )


def _result(o) -> KrylovResult:
    return KrylovResult(o["x"], o["iters"], o["rnorm"], o["rnorm"] <= o["tol"], 0)


def cg_mass(C: torch.Tensor, r0, x0, invd, bnorm, sm, rtol: float, maxiter: int,
            atol: float = 1e-50) -> KrylovResult:
    """Batched Jacobi-PCG on the constant-cube-matrix operator C (nl, nl)
    from r0 and x0 (B, npad); K4 on a CUDA tensor, ``cg_from_r0`` on the
    CPU."""
    if not kn._route(C, r0, x0, invd, bnorm):
        return cg_from_r0(lambda v: kn.matvec_const(v, C, sm), r0, x0, invd, bnorm, rtol,
                          maxiter, atol)
    with torch.cuda.device(r0.device):
        return _cg_mass_kernel(C, r0, x0, invd, bnorm, sm, rtol, maxiter, atol)


def _cg_mass_kernel(C, r0, x0, invd, bnorm, sm, rtol, maxiter, atol) -> KrylovResult:
    B, npad = _vectors(sm, r0, x0, invd, bnorm)
    nl = cub.num_slots(sm)
    kn._check(C, "C", r0.dtype, (nl, nl))
    o = _outputs(r0, B, 4, npad, bnorm, rtol, atol)
    p = kn._ptr
    kn._call("cg_mass", p(C), p(r0), p(x0), p(invd), p(o["tol"]), p(o["x"]), p(o["work"]),
             p(o["red"]), o["red"].numel() // 16, p(o["iters"]), p(o["rnorm"]),
             int(r0.dtype == torch.float64), *kn._dims(sm), int(sm[2]), B, int(maxiter),
             kn._stream(r0))
    return _result(o)


def bicgstab(W: torch.Tensor, r0, x0, zmask, invd, bnorm, sm, rtol: float, maxiter: int,
             atol: float = 1e-50) -> KrylovResult:
    """Batched BiCGStab on A_W (per-cube weights W (nl*nl, ncubes)) with
    zero-masked bc rows, from r0 = zmask (b - A_W x0) and x0 (B, npad); K2
    on a CUDA tensor, ``bicgstab_from_r0`` on the CPU."""
    if not kn._route(W, r0, x0, zmask, invd, bnorm):
        return bicgstab_from_r0(lambda v: kn.matvec_win(W, v, sm), r0, x0, zmask, invd,
                                bnorm, rtol, maxiter, atol)
    with torch.cuda.device(r0.device):
        stage = torch.empty((r0.shape[0], cub.num_slots(sm), int(np.prod(sm[1]))),
                            dtype=r0.dtype, device=r0.device)
        return _bicgstab_kernel(W, stage, r0, x0, zmask, invd, bnorm, sm, rtol, maxiter, atol)


def _bicgstab_kernel(W, stage, r0, x0, zmask, invd, bnorm, sm, rtol, maxiter,
                     atol) -> KrylovResult:
    B, npad = _vectors(sm, r0, x0, invd, bnorm, ("zmask", zmask))
    nl, nc = cub.num_slots(sm), int(np.prod(sm[1]))
    kn._check(W, "W", r0.dtype, (nl * nl, nc))
    kn._check_stage(stage, B, nl, nc, r0.dtype)
    o = _outputs(r0, B, 5, npad, bnorm, rtol, atol)
    p = kn._ptr
    kn._call("bicgstab", p(W), p(r0), p(x0), p(zmask), p(invd), p(o["tol"]), p(o["x"]),
             p(o["work"]), p(stage), stage.numel(), p(o["red"]), o["red"].numel() // 16,
             p(o["iters"]), p(o["rnorm"]), int(r0.dtype == torch.float64), *kn._dims(sm),
             int(sm[2]), B, int(maxiter), kn._stream(r0))
    return _result(o)
