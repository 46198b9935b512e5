"""The band-ELL kernels (K18): the RCM permutation in and out of a solve,
plain versions and wrappers.

An operator in band-ELL form (``assembly/band.py``) is ``vals``/``cols``
(S, R, 128) and a shift per slot (``shifts`` (S,) int32): with rows in RCM
order, in tiles of 128,

    y[rb*128 + j] = sum_slot vals[slot, rb, j] * x[(rb + shifts[slot])*128 + cols[slot, rb, j]]

where a source tile outside [0, Rc) reads 0.  A vector in band form is
(..., R*128): the RCM-permuted values, padded (``to_band``).  One wrapper
for each kernel of ``csrc/ell_ops.cu``'s band entries:

============= ========================================= =============================
wrapper       computes                                  replaces (pallas_ops.py)
============= ========================================= =============================
band_matvec   y_b = A x_b, batch nb (1 or 3) sharing A   make_band_matvec_batched
                                                        (:2588)
band_bicgstab batched Jacobi BiCGStab from r0 with      make_band_bicgstab_iter
              zero-masked bc rows, the whole solve in   (:2613) driven by
              one launch                                ell_bicgstab_from_r0 (:2158)
band_cg       batched Jacobi-PCG from r0, the whole     make_band_cg_iter (:2683)
              solve in one launch                       driven by
                                                        ell_cg_batched_from_r0 (:2255)
============= ========================================= =============================

The kernels are K14-K16's (``la/ell.py``) with the band row product; so are
the plain versions, whose loops are ``ell.bicgstab_loop`` and
``ell.cg_loop`` on a product that gathers through the band columns made
flat.  A wrapper sends CPU tensors to the plain version and CUDA tensors to
its kernel, and raises for anything else; launches and plain calls count
in ``assembly.kernels``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..assembly import kernels as kn
from ..assembly.band import LANE, BandAssembly
from .ell import _check_state, _solve_buffers, bicgstab_loop, cg_loop
from .krylov import KrylovResult


def to_band(x: torch.Tensor, asm: BandAssembly, fill: float = 0.0) -> torch.Tensor:
    """Canonical order (..., n) -> band form (..., R*128): RCM-permuted,
    the padding rows ``fill``."""
    xp = x[..., asm.perm]
    return F.pad(xp, (0, asm.R * LANE - asm.n), value=fill)


def from_band(xb: torch.Tensor, asm: BandAssembly) -> torch.Tensor:
    """Band form (..., R*128) -> canonical order (..., n)."""
    return xb[..., : asm.n][..., asm.iperm]


def _flat_cols(cols: torch.Tensor, shifts: torch.Tensor, Rc: int) -> torch.Tensor:
    """(S, R*128) int64 positions in the source: (rb + shift)*128 + lane, or
    Rc*128 (an appended 0) where the source tile is outside [0, Rc)."""
    S, R, _ = cols.shape
    src = torch.arange(R, device=cols.device)[None, :] + shifts.to(cols.device).long()[:, None]
    pos = src[:, :, None] * LANE + cols.long()
    ok = (src >= 0) & (src < Rc)
    return torch.where(ok[:, :, None], pos, Rc * LANE).reshape(S, R * LANE)


# slot entries a plain product gathers at once (bounds its temporaries)
_CHUNK = 1 << 26


def _operator(vals, cols, shifts, Rc: int):
    """The plain product x (..., Rc*128) -> (..., R*128): the ELL plain
    product on the flat positions, over chunks of slots (one chunk at the
    tests' sizes; the vessel's tables hold about 10^9 slots)."""
    S, R, _ = vals.shape
    step = max(1, _CHUNK // (R * LANE))

    def apply(x):
        xp = F.pad(x, (0, 1))
        acc = None
        for a in range(0, S, step):
            pos = _flat_cols(cols[a: a + step], shifts[a: a + step], Rc)
            t = torch.sum(vals[a: a + step].reshape(pos.shape) * xp[..., pos], dim=-2)
            acc = t if acc is None else acc + t
        return acc

    return apply


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def band_matvec_plain(vals, cols, shifts, x) -> torch.Tensor:
    kn.plain_calls["band_matvec"] += 1
    return _operator(vals, cols, shifts, x.shape[-1] // LANE)(x)


def band_bicgstab_plain(vals, cols, shifts, r0, x0, zmask, invd, bnorm, rtol: float,
                        maxiter: int, atol: float = 1e-50) -> KrylovResult:
    """Batched BiCGStab in band form, from r0 = zmask (b - A x0), all
    (nb, R*128): ``make_band_bicgstab_iter`` driven by
    ``ell_bicgstab_from_r0``, the loop of K15's plain version."""
    kn.plain_calls["band_bicgstab"] += 1
    A = _operator(vals, cols, shifts, vals.shape[1])
    return bicgstab_loop(A, r0, x0, zmask, invd, bnorm, rtol, maxiter, atol)


def band_cg_plain(vals, cols, shifts, r0, x0, invd, bnorm, rtol: float, maxiter: int,
                  atol: float = 1e-50) -> KrylovResult:
    """Batched Jacobi-PCG in band form from r0 = b - A x0 and x0, all
    (nb, R*128): ``make_band_cg_iter`` driven by ``ell_cg_batched_from_r0``,
    the loop of K16's plain version."""
    kn.plain_calls["band_cg"] += 1
    A = _operator(vals, cols, shifts, vals.shape[1])
    return cg_loop(A, r0, x0, invd, bnorm, rtol, maxiter, atol)


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------


def _check_band(vals, cols, shifts, dtype) -> tuple[int, int]:
    """(S, R) of a band operator; raises on shapes, types or layout."""
    if vals.dim() != 3 or vals.shape[2] != LANE or tuple(cols.shape) != tuple(vals.shape):
        raise ValueError(f"vals/cols: shapes {tuple(vals.shape)} {tuple(cols.shape)}")
    kn._check(vals, "vals", dtype, tuple(vals.shape))
    if cols.dtype != torch.int32 or not cols.is_contiguous():
        raise TypeError("cols: expected contiguous int32")
    if shifts.dtype != torch.int32 or tuple(shifts.shape) != (vals.shape[0],):
        raise TypeError(f"shifts: expected ({vals.shape[0]},) int32")
    return vals.shape[0], vals.shape[1]


def band_matvec(vals: torch.Tensor, cols: torch.Tensor, shifts: torch.Tensor,
                x: torch.Tensor) -> torch.Tensor:
    """y = A x for x (Rc*128,) or (nb, Rc*128) in band form; K18's product
    on CUDA tensors, the plain version on the CPU."""
    if not kn._route(vals, cols, shifts, x):
        return band_matvec_plain(vals, cols, shifts, x)
    S, R = _check_band(vals, cols, shifts, x.dtype)
    xb = x.reshape(1, -1) if x.dim() == 1 else x
    kn._check(xb, "x", x.dtype, tuple(xb.shape))
    if xb.shape[1] % LANE:
        raise ValueError(f"x: {xb.shape[1]} entries, not whole tiles of {LANE}")
    y = torch.empty((xb.shape[0], R * LANE), dtype=x.dtype, device=x.device)
    p = kn._ptr
    with torch.cuda.device(x.device):
        kn._call("band_matvec", p(vals), p(cols), p(shifts), p(xb), p(y), S, R,
                 xb.shape[1] // LANE, xb.shape[0], int(x.dtype == torch.float64),
                 kn._stream(x))
    return y.reshape(-1) if x.dim() == 1 else y


def band_bicgstab(vals, cols, shifts, r0, x0, zmask, invd, bnorm, rtol: float, maxiter: int,
                  atol: float = 1e-50) -> KrylovResult:
    """Batched BiCGStab in band form with zero-masked bc rows, from
    r0 = zmask (b - A x0) and x0 (nb, R*128); K18's BiCGStab on CUDA
    tensors, the plain version on the CPU."""
    if not kn._route(vals, cols, shifts, r0, x0, zmask, invd, bnorm):
        return band_bicgstab_plain(vals, cols, shifts, r0, x0, zmask, invd, bnorm, rtol,
                                   maxiter, atol)
    S, R = _check_band(vals, cols, shifts, r0.dtype)
    flat = vals.reshape(S, -1)
    _check_state(flat, cols.reshape(S, -1), r0, (("r0", r0), ("x0", x0), ("zmask", zmask)),
                 invd, bnorm)
    o = _solve_buffers(r0, 6, bnorm, rtol, atol)
    p = kn._ptr
    with torch.cuda.device(r0.device):
        kn._call("band_bicgstab", p(vals), p(cols), p(shifts), p(r0), p(x0), p(zmask), p(invd),
                 p(o["tol"]), p(o["x"]), p(o["work"]), p(o["red"]), o["red"].numel() // 16,
                 p(o["iters"]), p(o["rnorm"]), int(r0.dtype == torch.float64), S, R,
                 r0.shape[0], int(maxiter), kn._stream(r0))
    return KrylovResult(o["x"], o["iters"], o["rnorm"], o["rnorm"] <= o["tol"], 0)


def band_cg(vals, cols, shifts, r0, x0, invd, bnorm, rtol: float, maxiter: int,
            atol: float = 1e-50) -> KrylovResult:
    """Batched Jacobi-PCG in band form from r0 = b - A x0 and x0
    (nb, R*128); K18's CG on CUDA tensors, the plain version on the CPU."""
    if not kn._route(vals, cols, shifts, r0, x0, invd, bnorm):
        return band_cg_plain(vals, cols, shifts, r0, x0, invd, bnorm, rtol, maxiter, atol)
    S, R = _check_band(vals, cols, shifts, r0.dtype)
    _check_state(vals.reshape(S, -1), cols.reshape(S, -1), r0, (("r0", r0), ("x0", x0)), invd,
                 bnorm)
    o = _solve_buffers(r0, 3, bnorm, rtol, atol)
    p = kn._ptr
    with torch.cuda.device(r0.device):
        kn._call("band_cg", p(vals), p(cols), p(shifts), p(r0), p(x0), p(invd), p(o["tol"]),
                 p(o["x"]), p(o["work"]), p(o["red"]), o["red"].numel() // 16, p(o["iters"]),
                 p(o["rnorm"]), int(r0.dtype == torch.float64), S, R, r0.shape[0],
                 int(maxiter), kn._stream(r0))
    return KrylovResult(o["x"], o["iters"], o["rnorm"], o["rnorm"] <= o["tol"], 0)
