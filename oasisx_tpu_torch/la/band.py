"""The band-ELL kernels (K18): the RCM permutation in and out of a solve,
plain versions and wrappers.

An operator in band-ELL form (``assembly/band.py``) is its values
``vals`` (P, 128) and three pair tables: ``tile_ptr`` (R+1,) int32 (the
pairs of row tile rb are ``tile_ptr[rb] : tile_ptr[rb+1]``, in ascending
slot order), ``pair_shift`` (P,) int32 and ``lanes`` (P, 128) uint8.  With
rows in RCM order, in tiles of 128,

    y[rb*128 + j] = sum_p vals[p, j] * x[(rb + pair_shift[p])*128 + lanes[p, j]]

over the pairs p of tile rb: the JAX package's (S, R, 128) product
without the (tile, slot) cells that hold no entry, whose terms are exact
zeros.  A vector in band form is (..., R*128): the RCM-permuted values,
padded (``to_band``).  One wrapper for each kernel of ``csrc/ell_ops.cu``'s
band entries:

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

The kernels are K14-K16's (``la/ell.py``) with the pair-table row
product; so are the plain versions, whose loops are ``ell.bicgstab_loop``
and ``ell.cg_loop`` on a product that gathers through the pairs' flat
source positions.  A wrapper sends CPU tensors to the plain version and
CUDA tensors to its kernel, and raises for anything else; launches and
plain calls count in ``assembly.kernels``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..assembly import kernels as kn
from ..assembly.band import LANE, BandAssembly, pair_tiles
from .ell import _check_vectors, _solve_buffers, bicgstab_loop, cg_loop
from .krylov import KrylovResult


def to_band(x: torch.Tensor, asm: BandAssembly, fill: float = 0.0) -> torch.Tensor:
    """Canonical order (..., n) -> band form (..., R*128): RCM-permuted,
    the padding rows ``fill``."""
    xp = x[..., asm.perm]
    return F.pad(xp, (0, asm.R * LANE - asm.n), value=fill)


def from_band(xb: torch.Tensor, asm: BandAssembly) -> torch.Tensor:
    """Band form (..., R*128) -> canonical order (..., n)."""
    return xb[..., : asm.n][..., asm.iperm]


# pair entries a plain product gathers at once (bounds its temporaries)
_CHUNK = 1 << 26


def _operator(vals, tile_ptr, pair_shift, lanes, Rc: int):
    """The plain product x (..., Rc*128) -> (..., R*128).  Each tile's pairs
    are laid out in slot order in a (R, Kmax) table padded with a pair of
    value 0 reading an appended 0; the product gathers the flat source
    positions ``(rb + pair_shift)*128 + lanes`` and sums over each tile's
    pairs, over chunks of tiles (one chunk at the tests' sizes)."""
    dev = vals.device
    R, P = tile_ptr.numel() - 1, vals.shape[0]
    start, count = tile_ptr[:-1].long(), torch.diff(tile_ptr.long())
    kmax = max(int(count.max()), 1)
    k = torch.arange(kmax, device=dev)
    pidx = torch.where(k[None, :] < count[:, None], start[:, None] + k[None, :], P)  # (R, kmax)
    pos = (pair_tiles(tile_ptr) + pair_shift.long())[:, None] * LANE + lanes.long()  # (P, 128)
    pos = F.pad(pos, (0, 0, 0, 1), value=Rc * LANE)  # the pad pair reads the appended 0
    vpad = F.pad(vals, (0, 0, 0, 1))
    step = max(1, _CHUNK // (kmax * LANE))

    def apply(x):
        xp = F.pad(x, (0, 1))
        out = []
        for a in range(0, R, step):
            idx = pidx[a: a + step]
            t = torch.sum(vpad[idx] * xp[..., pos[idx]], dim=-2)  # (..., rc, 128)
            out.append(t.reshape(*x.shape[:-1], -1))
        return torch.cat(out, dim=-1)

    return apply


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def band_matvec_plain(vals, tile_ptr, pair_shift, lanes, x) -> torch.Tensor:
    kn.plain_calls["band_matvec"] += 1
    return _operator(vals, tile_ptr, pair_shift, lanes, x.shape[-1] // LANE)(x)


def band_bicgstab_plain(vals, tile_ptr, pair_shift, lanes, r0, x0, zmask, invd, bnorm,
                        rtol: float, maxiter: int, atol: float = 1e-50) -> KrylovResult:
    """Batched BiCGStab in band form, from r0 = zmask (b - A x0), all
    (nb, R*128): ``make_band_bicgstab_iter`` driven by
    ``ell_bicgstab_from_r0``, the loop of K15's plain version."""
    kn.plain_calls["band_bicgstab"] += 1
    A = _operator(vals, tile_ptr, pair_shift, lanes, tile_ptr.numel() - 1)
    return bicgstab_loop(A, r0, x0, zmask, invd, bnorm, rtol, maxiter, atol)


def band_cg_plain(vals, tile_ptr, pair_shift, lanes, r0, x0, invd, bnorm, rtol: float,
                  maxiter: int, atol: float = 1e-50) -> KrylovResult:
    """Batched Jacobi-PCG in band form from r0 = b - A x0 and x0, all
    (nb, R*128): ``make_band_cg_iter`` driven by ``ell_cg_batched_from_r0``,
    the loop of K16's plain version."""
    kn.plain_calls["band_cg"] += 1
    A = _operator(vals, tile_ptr, pair_shift, lanes, tile_ptr.numel() - 1)
    return cg_loop(A, r0, x0, invd, bnorm, rtol, maxiter, atol)


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------


def _frame(vals, tile_ptr, pair_shift, lanes, n: int) -> tuple[int, int]:
    """(P, R) of a band operator; raises ValueError unless the tables agree
    on P and a vector of the operator has ``n`` = R*128 entries.  Shapes
    only, on either device: the tables' contents are checked where they are
    built (``assembly.band.check_pair_tables``)."""
    if tile_ptr.dim() != 1 or tile_ptr.numel() < 2:
        raise ValueError(f"tile_ptr: shape {tuple(tile_ptr.shape)}, expected (R+1,), R >= 1")
    P, R = vals.shape[0], tile_ptr.numel() - 1
    if pair_shift.shape[:1] != (P,) or lanes.shape[:1] != (P,):
        raise ValueError(f"vals, pair_shift, lanes: {vals.shape[0]}, {pair_shift.shape[0]}, "
                         f"{lanes.shape[0]} pairs")
    if n != R * LANE:
        raise ValueError(f"a vector of {n} entries against an operator of {R} tiles of {LANE}")
    return P, R


def _check_band(vals, tile_ptr, pair_shift, lanes, dtype) -> None:
    """Raises on the types or layout the kernels take."""
    P = vals.shape[0]
    kn._check(vals, "vals", dtype, (P, LANE))
    for name, t, dt, shape in (("tile_ptr", tile_ptr, torch.int32, tuple(tile_ptr.shape)),
                               ("pair_shift", pair_shift, torch.int32, (P,)),
                               ("lanes", lanes, torch.uint8, (P, LANE))):
        if t.dtype != dt or tuple(t.shape) != shape or not t.is_contiguous():
            raise TypeError(f"{name}: expected contiguous {dt} of shape {shape}")


def band_matvec(vals: torch.Tensor, tile_ptr: torch.Tensor, pair_shift: torch.Tensor,
                lanes: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """y = A x for x (R*128,) or (nb, R*128) in band form; K18's product
    on CUDA tensors, the plain version on the CPU."""
    P, R = _frame(vals, tile_ptr, pair_shift, lanes, x.shape[-1])
    if not kn._route(vals, tile_ptr, pair_shift, lanes, x):
        return band_matvec_plain(vals, tile_ptr, pair_shift, lanes, x)
    _check_band(vals, tile_ptr, pair_shift, lanes, x.dtype)
    xb = x.reshape(1, -1) if x.dim() == 1 else x
    kn._check(xb, "x", x.dtype, tuple(xb.shape))
    y = torch.empty((xb.shape[0], R * LANE), dtype=x.dtype, device=x.device)
    p = kn._ptr
    with torch.cuda.device(x.device):
        kn._call("band_matvec", p(vals), p(tile_ptr), p(pair_shift), p(lanes), p(xb), p(y), P, R,
                 R, xb.shape[0], int(x.dtype == torch.float64), kn._stream(x))
    return y.reshape(-1) if x.dim() == 1 else y


def band_bicgstab(vals, tile_ptr, pair_shift, lanes, r0, x0, zmask, invd, bnorm, rtol: float,
                  maxiter: int, atol: float = 1e-50) -> KrylovResult:
    """Batched BiCGStab in band form with zero-masked bc rows, from
    r0 = zmask (b - A x0) and x0 (nb, R*128); K18's BiCGStab on CUDA
    tensors, the plain version on the CPU."""
    P, R = _frame(vals, tile_ptr, pair_shift, lanes, r0.shape[-1])
    if not kn._route(vals, tile_ptr, pair_shift, lanes, r0, x0, zmask, invd, bnorm):
        return band_bicgstab_plain(vals, tile_ptr, pair_shift, lanes, r0, x0, zmask, invd, bnorm,
                                   rtol, maxiter, atol)
    _check_band(vals, tile_ptr, pair_shift, lanes, r0.dtype)
    _check_vectors(R * LANE, r0, (("r0", r0), ("x0", x0), ("zmask", zmask)), invd, bnorm)
    o = _solve_buffers(r0, 6, bnorm, rtol, atol)
    p = kn._ptr
    with torch.cuda.device(r0.device):
        kn._call("band_bicgstab", p(vals), p(tile_ptr), p(pair_shift), p(lanes), p(r0), p(x0),
                 p(zmask), p(invd), p(o["tol"]), p(o["x"]), p(o["work"]), p(o["red"]),
                 o["red"].numel() // 16, p(o["iters"]), p(o["rnorm"]),
                 int(r0.dtype == torch.float64), P, R, r0.shape[0], int(maxiter), kn._stream(r0))
    return KrylovResult(o["x"], o["iters"], o["rnorm"], o["rnorm"] <= o["tol"], 0)


def band_cg(vals, tile_ptr, pair_shift, lanes, r0, x0, invd, bnorm, rtol: float, maxiter: int,
            atol: float = 1e-50) -> KrylovResult:
    """Batched Jacobi-PCG in band form from r0 = b - A x0 and x0
    (nb, R*128); K18's CG on CUDA tensors, the plain version on the CPU."""
    P, R = _frame(vals, tile_ptr, pair_shift, lanes, r0.shape[-1])
    if not kn._route(vals, tile_ptr, pair_shift, lanes, r0, x0, invd, bnorm):
        return band_cg_plain(vals, tile_ptr, pair_shift, lanes, r0, x0, invd, bnorm, rtol,
                             maxiter, atol)
    _check_band(vals, tile_ptr, pair_shift, lanes, r0.dtype)
    _check_vectors(R * LANE, r0, (("r0", r0), ("x0", x0)), invd, bnorm)
    o = _solve_buffers(r0, 3, bnorm, rtol, atol)
    p = kn._ptr
    with torch.cuda.device(r0.device):
        kn._call("band_cg", p(vals), p(tile_ptr), p(pair_shift), p(lanes), p(r0), p(x0), p(invd),
                 p(o["tol"]), p(o["x"]), p(o["work"]), p(o["red"]), o["red"].numel() // 16,
                 p(o["iters"]), p(o["rnorm"]), int(r0.dtype == torch.float64), P, R, r0.shape[0],
                 int(maxiter), kn._stream(r0))
    return KrylovResult(o["x"], o["iters"], o["rnorm"], o["rnorm"] <= o["tol"], 0)
