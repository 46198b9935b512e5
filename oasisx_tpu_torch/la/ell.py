"""The unstructured path's ELL kernels: plain versions and wrappers.

An operator in ELL form is ``vals``/``cols`` of shape (K, n), column-major
by slot: ``y[r] = sum_k vals[k, r] * x[cols[k, r]]``; a padded slot holds
value 0 and column 0, so it adds 0.  One wrapper for each kernel of
``csrc/ell_ops.cu``:

============= ========================================= =============================
wrapper       computes                                  replaces (pallas_ops.py)
============= ========================================= =============================
ell_matvec    y_b = A x_b, batch nb (1 or 3) sharing A   make_ell_matvec (:646),
              (K14)                                     make_ell_matvec_batched (:682)
ell_bicgstab  batched Jacobi BiCGStab from r0 with      make_ell_bicgstab_iter (:2083)
              zero-masked bc rows (K15), the whole      driven by ell_bicgstab_from_r0
              solve in one launch                       (:2158)
ell_cg        batched Jacobi-PCG from r0 (K16), the     make_ell_cg_iter (:2194) driven
              whole solve in one launch                 by ell_cg_batched_from_r0 (:2255)
ell_pcg_amg   CG preconditioned by the smoothed-        make_ell_pcg_amg_iter (:2413)
              aggregation V(pre,post) cycle, with an    with _emit_vcycle (:2348),
              outlet mask or a nullspace projection     make_ell_vcycle (:2385), driven
              (K17), the whole solve in one launch      by ell_pcg_amg_solve (:2493)
ell_vcycle    K17's V-cycle alone, z = M r              make_ell_vcycle (:2385)
============= ========================================= =============================

What bounds them on the H100, and what the kernels do about it: K14 streams
the operator (vals and cols) once per call for every vector of the batch,
one thread per row so that the slot-major layout reads coalesced; it is
bound by memory.  Each 32-row slice (a warp's rows) stops at its width, the
largest slot count among its rows (``widths``, ``graph.slice_widths``), so
the padding past it is not read: at the vessel's N=36 velocity operator a
float32 product reads ~98 MB in place of the 202 MB of all K slots.  K15
and K16 stream the operator once or twice per iteration for all rows
together, on the same row product; at the vessel's N=36 size the operator
does not fit in the 50 MB L2, so they too are bound by memory, and the
state vectors (3 x 1.6 MB) stay in L2.  K17 is bound by latency: its
grid barriers (``amg_barriers`` counts an iteration's) and the long rows of
the coarse AMG tables, which it reads a warp a row from ``kWarpRowK``
(``csrc/ell_ops.cu``) slots up; every AMG table is read to its slices'
widths (``la.amg.amg_widths``).

The plain versions follow the JAX kernels and the loops around them
operation for operation, with the loop on the host (one device read per iteration,
counted in ``KrylovResult.syncs``); they sum all K slots, since a slot past
its slice's width adds exactly 0.  The K14-K17 wrappers take the operator's
``widths`` (int32, one per 32 rows) beside its columns, K17's also the AMG
tables' (``amg_widths``), and raise, on every device, when one is missing
or of another shape or type.  A wrapper sends CPU tensors to the plain
version and CUDA tensors to its kernel (``syncs`` 0), and raises for
anything else; launches and plain calls count in
``assembly.kernels.launches`` / ``plain_calls``.
"""

from __future__ import annotations

import ctypes

import torch

from ..assembly import kernels as kn
from ..parallel.graph import ELL_SLICE
from .krylov import KrylovResult, _nz


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.sum(a * b, dim=-1)


def _tol(bnorm: torch.Tensor, rtol: float, atol: float) -> torch.Tensor:
    return torch.clamp(rtol * bnorm, min=atol)


def _mv(vals: torch.Tensor, cols: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """y[..., r] = sum_k vals[k, r] x[..., cols[k, r]]."""
    return torch.sum(vals * x[..., cols.long()], dim=-2)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def ell_matvec_plain(vals, cols, x) -> torch.Tensor:
    kn.plain_calls["ell_matvec"] += 1
    return _mv(vals, cols, x)


def ell_bicgstab_plain(vals, cols, r0, x0, zmask, invd, bnorm, rtol: float, maxiter: int,
                       atol: float = 1e-50) -> KrylovResult:
    """Batched BiCGStab from r0 = zmask (b - A x0), all (nb, n), x0's bc
    rows preset to the bc values and the operator's output zeroed on them:
    ``make_ell_bicgstab_iter`` driven by ``ell_bicgstab_from_r0``."""
    kn.plain_calls["ell_bicgstab"] += 1
    return bicgstab_loop(lambda v: _mv(vals, cols, v), r0, x0, zmask, invd, bnorm, rtol,
                         maxiter, atol)


def bicgstab_loop(A, r0, x0, zmask, invd, bnorm, rtol: float, maxiter: int,
                  atol: float = 1e-50) -> KrylovResult:
    """The BiCGStab of K15 and K18 on the operator ``A``: rhat = r0; an
    inactive row keeps x, r and p and freezes rho / rnorm / iters."""
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
        phat = invd * p
        v = zmask * A(phat)
        alpha = rho / _nz(_dot(rhat, v))
        s = r - col(alpha) * v
        shat = invd * s
        t = zmask * A(shat)
        omega = _dot(t, s) / _nz(_dot(t, t))
        x = x + col(active.to(x.dtype)) * (col(alpha) * phat + col(omega) * shat)
        r_new = torch.where(col(active), s - col(omega) * t, r)
        rho_new = torch.where(active, _dot(rhat, r_new), rho)
        beta = (rho_new / _nz(rho)) * (alpha / _nz(omega))
        p = torch.where(col(active), r_new + col(beta) * (p - col(omega) * v), p)
        rn = torch.where(active, torch.sqrt(_dot(r_new, r_new)), rn)
        iters = iters + active.to(torch.int32)
        r, rho = r_new, rho_new
        k += 1
    return KrylovResult(x, iters, rn, rn <= tol, syncs)


def ell_cg_plain(vals, cols, r0, x0, invd, bnorm, rtol: float, maxiter: int,
                 atol: float = 1e-50) -> KrylovResult:
    """Batched Jacobi-PCG from r0 = b - A x0 and x0, all (nb, n):
    ``make_ell_cg_iter`` driven by ``ell_cg_batched_from_r0``."""
    kn.plain_calls["ell_cg"] += 1
    return cg_loop(lambda v: _mv(vals, cols, v), r0, x0, invd, bnorm, rtol, maxiter, atol)


def cg_loop(A, r0, x0, invd, bnorm, rtol: float, maxiter: int,
            atol: float = 1e-50) -> KrylovResult:
    """The Jacobi-PCG of K16 and K18 on the operator ``A``: on an inactive
    row alpha and beta are 0, p is kept and iters is frozen."""
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
        Ap = A(p)
        alpha = torch.where(active, rz / _nz(_dot(p, Ap)), zero)
        x = x + alpha[:, None] * p
        r = r - alpha[:, None] * Ap
        z = invd * r
        rz_new = torch.where(active, _dot(r, z), rz)
        beta = torch.where(active, rz_new / _nz(rz), zero)
        p = torch.where(active[:, None], z + beta[:, None] * p, p)
        rn = torch.sqrt(_dot(r, r))
        iters = iters + active.to(torch.int32)
        rz = rz_new
        k += 1
    return KrylovResult(x, iters, rn, rn <= tol, syncs)


def _levels(meta: dict, arrays: list):
    """Per-level dicts of the kernel tables, the coarse CinvT, the
    nullspace vector or None (``amg_kernel_data``'s order)."""
    lv = [dict(zip(("Av", "Ac", "sm", "Pv", "Pc", "Rv", "Rc"), arrays[7 * i: 7 * i + 7]))
          for i in range(len(meta["levels"]))]
    i = 7 * len(lv)
    return lv, arrays[i], (arrays[i + 1] if meta["has_null"] else None)


def _project(nv: torch.Tensor | None, v: torch.Tensor) -> torch.Tensor:
    if nv is None:
        return v
    return v - (torch.dot(nv, v) / torch.dot(nv, nv)) * nv


def vcycle_plain(meta: dict, arrays: list, r: torch.Tensor) -> torch.Tensor:
    """The V(pre, post) cycle over the (K, n) kernel tables, in
    ``_emit_vcycle``'s order of operations."""
    lv, cinvT, nv = _levels(meta, arrays)
    r = _project(nv, r)
    rs, zs = [r], []
    for L in lv:
        sm = L["sm"]
        z = sm * rs[-1]
        for _ in range(meta["pre"] - 1):
            z = z + sm * (rs[-1] - _mv(L["Av"], L["Ac"], z))
        resid = rs[-1] - _mv(L["Av"], L["Ac"], z)
        zs.append(z)
        rs.append(_mv(L["Rv"], L["Rc"], resid))
    z = cinvT.T @ rs[-1]
    for li in reversed(range(len(lv))):
        L = lv[li]
        z = zs[li] + _mv(L["Pv"], L["Pc"], z)
        for _ in range(meta["post"]):
            z = z + L["sm"] * (rs[li] - _mv(L["Av"], L["Ac"], z))
    return _project(nv, z)


def ell_vcycle_plain(amg: tuple[dict, list], r: torch.Tensor) -> torch.Tensor:
    kn.plain_calls["ell_vcycle"] += 1
    return vcycle_plain(*amg, r)


def _fine_matvec(vals0, cols0, mask):
    """The fine operator: A p, or where(mask, p, A (1-mask) p) with the
    outlet mask (``bc_symmetric_matvec``'s identity rows and columns)."""
    if mask is None:
        return lambda p: _mv(vals0, cols0, p)
    return lambda p: mask * p + (1.0 - mask) * _mv(vals0, cols0, (1.0 - mask) * p)


def _pcg_start(amg, vals0, cols0, b, x0, rtol, atol, mask, matvec):
    """``ell_pcg_amg_solve``'s set-up: b projected, tol = max(rtol |b|,
    atol), r0 = b - A x0 projected, A x0 by ``matvec(vals, cols, x)``
    with the mask wrap.  Returns (r0, tol)."""
    nv = _levels(*amg)[2]
    b = _project(nv, b)
    tol = torch.clamp(rtol * torch.linalg.vector_norm(b), min=atol)
    Ax0 = matvec(vals0, cols0, x0 if mask is None else (1.0 - mask) * x0)
    if mask is not None:
        Ax0 = mask * x0 + (1.0 - mask) * Ax0
    return _project(nv, b - Ax0), tol


def ell_pcg_amg_plain(amg: tuple[dict, list], vals0, cols0, b, x0, rtol: float, maxiter: int,
                      atol: float = 1e-50, mask=None) -> KrylovResult:
    """AMG-preconditioned CG: ``make_ell_pcg_amg_iter`` driven by
    ``ell_pcg_amg_solve``, with its pAp / rz breakdown flags; the returned
    count is the loop count and x is projected on exit when the AMG
    carries a nullspace vector."""
    kn.plain_calls["ell_pcg_amg"] += 1
    meta, arrays = amg
    nv = _levels(meta, arrays)[2]
    A = _fine_matvec(vals0, cols0, mask)
    r0, tol = _pcg_start(amg, vals0, cols0, b, x0, rtol, atol, mask, _mv)
    x, r = x0, r0
    z = vcycle_plain(meta, arrays, r)
    p = z
    rz = torch.dot(r, z)
    rn = torch.linalg.vector_norm(r)
    brk = torch.zeros((), dtype=torch.bool, device=r0.device)
    k = syncs = 0
    while k < maxiter:
        syncs += 1
        if not bool((rn > tol) & ~brk):
            break
        Ap = _project(nv, A(p))
        pAp = torch.dot(p, Ap)
        brk = brk | (pAp == 0) | (rz == 0)
        alpha = rz / _nz(pAp)
        x = x + alpha * p
        r = r - alpha * Ap
        z = vcycle_plain(meta, arrays, r)
        rz_new = torch.dot(r, z)
        p = z + (rz_new / _nz(rz)) * p
        rz = rz_new
        rn = torch.linalg.vector_norm(r)
        k += 1
    x = _project(nv, x)
    return KrylovResult(x, torch.tensor(k, dtype=torch.int32, device=r0.device), rn,
                        rn <= tol, syncs)


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------


def _check_widths(widths, n: int) -> None:
    """An operator's slice widths: contiguous int32 of shape (ceil(n / 32),)."""
    nsl = -(-n // ELL_SLICE)
    if not isinstance(widths, torch.Tensor) or tuple(widths.shape) != (nsl,):
        raise ValueError(f"widths: expected shape ({nsl},) for {n} rows, got "
                         f"{tuple(widths.shape) if isinstance(widths, torch.Tensor) else widths}")
    if widths.dtype != torch.int32 or not widths.is_contiguous():
        raise TypeError(f"widths: expected contiguous int32, got {widths.dtype}")


def _check_ell(vals, cols, dtype):
    if vals.dim() != 2 or tuple(cols.shape) != tuple(vals.shape):
        raise ValueError(f"vals/cols: shapes {tuple(vals.shape)} {tuple(cols.shape)}")
    kn._check(vals, "vals", dtype, tuple(vals.shape))
    if cols.dtype != torch.int32 or not cols.is_contiguous():
        raise TypeError("cols: expected contiguous int32")


def ell_matvec(vals: torch.Tensor, cols: torch.Tensor, widths: torch.Tensor,
               x: torch.Tensor) -> torch.Tensor:
    """y = A x for x (nin,) or (nb, nin); A in ELL form (K, n) with columns
    < nin and slice widths ``widths``.  K14 on CUDA tensors, the plain
    version on the CPU."""
    _check_widths(widths, vals.shape[-1])
    if not kn._route(vals, cols, widths, x):
        return ell_matvec_plain(vals, cols, x)
    K, n = vals.shape
    xb = x.reshape(1, -1) if x.dim() == 1 else x
    _check_ell(vals, cols, x.dtype)
    kn._check(xb, "x", x.dtype, tuple(xb.shape))
    y = torch.empty((xb.shape[0], n), dtype=x.dtype, device=x.device)
    p = kn._ptr
    with torch.cuda.device(x.device):
        kn._call("ell_matvec", p(vals), p(cols), p(widths), p(xb), p(y), K, n, xb.shape[1],
                 xb.shape[0], int(x.dtype == torch.float64), kn._stream(x))
    return y.reshape(n) if x.dim() == 1 else y


def _solve_buffers(r0, nwork, bnorm, rtol, atol):
    dev, dt = r0.device, r0.dtype
    nb, n = r0.shape
    return dict(
        tol=_tol(bnorm, rtol, atol).contiguous(),
        x=torch.empty((nb, n), dtype=dt, device=dev),
        work=torch.empty((nwork, nb, n), dtype=dt, device=dev),
        red=torch.empty(2 * 8 * kn.coop_capacity(dev), dtype=dt, device=dev),
        iters=torch.empty(nb, dtype=torch.int32, device=dev),
        rnorm=torch.empty(nb, dtype=dt, device=dev),
    )


def _check_vectors(n, r0, named, invd, bnorm):
    """A solve's vectors for an operator of n rows: r0 and ``named``
    (nb, n), invd (n,), bnorm (nb,)."""
    dt = r0.dtype
    nb, m = r0.shape
    if m != n:
        raise ValueError(f"operator rows {n}, state {m}")
    for name, t in named:
        kn._check(t, name, dt, (nb, n))
    kn._check(invd, "invd", dt, (n,))
    kn._check(bnorm, "bnorm", dt, (nb,))


def _check_state(vals, cols, r0, named, invd, bnorm):
    _check_ell(vals, cols, r0.dtype)
    _check_vectors(vals.shape[1], r0, named, invd, bnorm)


def ell_bicgstab(vals, cols, widths, r0, x0, zmask, invd, bnorm, rtol: float, maxiter: int,
                 atol: float = 1e-50) -> KrylovResult:
    """Batched BiCGStab on an ELL operator (slice widths ``widths``) with
    zero-masked bc rows, from r0 = zmask (b - A x0) and x0 (nb, n); K15 on
    CUDA tensors, the plain version on the CPU."""
    _check_widths(widths, vals.shape[-1])
    if not kn._route(vals, cols, widths, r0, x0, zmask, invd, bnorm):
        return ell_bicgstab_plain(vals, cols, r0, x0, zmask, invd, bnorm, rtol, maxiter, atol)
    _check_state(vals, cols, r0, (("r0", r0), ("x0", x0), ("zmask", zmask)), invd, bnorm)
    o = _solve_buffers(r0, 6, bnorm, rtol, atol)
    p = kn._ptr
    with torch.cuda.device(r0.device):
        kn._call("ell_bicgstab", p(vals), p(cols), p(widths), p(r0), p(x0), p(zmask), p(invd),
                 p(o["tol"]), p(o["x"]), p(o["work"]), p(o["red"]), o["red"].numel() // 16,
                 p(o["iters"]), p(o["rnorm"]), int(r0.dtype == torch.float64), vals.shape[0],
                 r0.shape[1], r0.shape[0], int(maxiter), kn._stream(r0))
    return KrylovResult(o["x"], o["iters"], o["rnorm"], o["rnorm"] <= o["tol"], 0)


def ell_cg(vals, cols, widths, r0, x0, invd, bnorm, rtol: float, maxiter: int,
           atol: float = 1e-50) -> KrylovResult:
    """Batched Jacobi-PCG on an ELL operator (slice widths ``widths``) from
    r0 = b - A x0 and x0 (nb, n); K16 on CUDA tensors, the plain version on
    the CPU."""
    _check_widths(widths, vals.shape[-1])
    if not kn._route(vals, cols, widths, r0, x0, invd, bnorm):
        return ell_cg_plain(vals, cols, r0, x0, invd, bnorm, rtol, maxiter, atol)
    _check_state(vals, cols, r0, (("r0", r0), ("x0", x0)), invd, bnorm)
    o = _solve_buffers(r0, 3, bnorm, rtol, atol)
    p = kn._ptr
    with torch.cuda.device(r0.device):
        kn._call("ell_cg", p(vals), p(cols), p(widths), p(r0), p(x0), p(invd), p(o["tol"]),
                 p(o["x"]), p(o["work"]), p(o["red"]), o["red"].numel() // 16, p(o["iters"]),
                 p(o["rnorm"]), int(r0.dtype == torch.float64), vals.shape[0], r0.shape[1],
                 r0.shape[0], int(maxiter), kn._stream(r0))
    return KrylovResult(o["x"], o["iters"], o["rnorm"], o["rnorm"] <= o["tol"], 0)


def _amg_widths(meta: dict, amg_widths) -> list:
    """``amg_widths``: the slice widths of every AMG level's A, P and R
    (``la.amg.amg_widths``), each checked as ``_check_widths`` checks an
    operator's; raises when they are missing or of another count."""
    L = len(meta["levels"])
    if not isinstance(amg_widths, (list, tuple)) or len(amg_widths) != 3 * L:
        raise ValueError(f"AMG widths: expected 3 tables a level for {L} levels "
                         f"(la.amg.amg_widths), got {type(amg_widths).__name__}")
    for i, m in enumerate(meta["levels"]):
        for j, rows in enumerate((m["n"], m["n"], m["nc"])):
            _check_widths(amg_widths[3 * i + j], rows)
    return list(amg_widths)


def amg_barriers(meta: dict) -> int:
    """Grid barriers of one K17 iteration: in the CG body 5, or 7 with a
    nullspace (its two projections' sums); then one after each V-cycle
    phase, per ELL level above the dense coarse one: pre down (the sweeps
    after the first, the residual), the restriction into the next level,
    post + 1 up (the prolongation, the sweeps); one for the dense coarse
    solve."""
    L = len(meta["levels"])
    return (7 if meta["has_null"] else 5) + L * (meta["pre"] + meta["post"] + 2) + 1


def _amg_call(name, amg, widths, vals0, cols0, widths0, r0, x0, tol, maxiter, mask,
              vcycle_only):
    """Launch the K17 entry ``name`` (whole PCG solve, or the V-cycle
    alone with ``vcycle_only``) on the AMG tables ``amg`` and their slice
    widths ``widths`` (checked by the caller); returns (x, iters, rnorm,
    conv)."""
    meta, arrays = amg
    dev, dt = r0.device, r0.dtype
    n0 = r0.shape[0]
    lv, cinvT, nv = _levels(meta, arrays)
    sizes = [m["n"] for m in meta["levels"]] + [meta["coarse_n"]]
    if sizes[0] != n0:
        raise ValueError(f"AMG fine size {sizes[0]}, vector {n0}")
    keys = ("Av", "Ac", "Aw", "sm", "Pv", "Pc", "Pw", "Rv", "Rc", "Rw")
    ptrs = (ctypes.c_void_p * max(1, len(keys) * len(lv)))()
    dims = (ctypes.c_longlong * max(1, 5 * len(lv)))()
    for i, (L, m) in enumerate(zip(lv, meta["levels"])):
        L = dict(L, Aw=widths[3 * i], Pw=widths[3 * i + 1], Rw=widths[3 * i + 2])
        for j, key in enumerate(keys):
            t = L[key]
            want = torch.int32 if key[1] in "cw" else dt
            if t.dtype != want or not t.is_contiguous() or t.device != dev:
                raise TypeError(f"AMG level {i} {key}: {t.dtype} on {t.device}")
            ptrs[len(keys) * i + j] = t.data_ptr()
        dims[5 * i: 5 * i + 5] = [m["n"], m["nc"], m["K_A"], m["K_P"], m["K_R"]]
    kn._check(cinvT, "CinvT", dt, (sizes[-1], sizes[-1]))
    if nv is not None:
        kn._check(nv, "nullvec", dt, (n0,))
    if mask is not None:
        kn._check(mask, "mask", dt, (n0,))
    kn._check(r0, "r0", dt, (n0,))
    K0 = 0
    if not vcycle_only:
        _check_ell(vals0, cols0, dt)
        kn._check(x0, "x0", dt, (n0,))
        kn._check(tol, "tol", dt, ())
        K0 = vals0.shape[0]
    x = torch.empty(n0, dtype=dt, device=dev)
    work = torch.empty(4 * sum(sizes) + 2 * n0, dtype=dt, device=dev)
    red = torch.empty(2 * 8 * kn.coop_capacity(dev), dtype=dt, device=dev)
    iters = torch.zeros(1, dtype=torch.int32, device=dev)
    rnorm = torch.zeros(1, dtype=dt, device=dev)
    conv = torch.zeros(1, dtype=torch.int32, device=dev)
    p = kn._ptr
    z = ctypes.c_void_p(0)
    with torch.cuda.device(dev):
        kn._call(name, ctypes.cast(ptrs, ctypes.c_void_p), ctypes.cast(dims, ctypes.c_void_p),
                 len(lv), sizes[-1], p(cinvT), z if nv is None else p(nv),
                 z if mask is None else p(mask), z if vcycle_only else p(vals0),
                 z if vcycle_only else p(cols0), z if vcycle_only else p(widths0), K0, n0,
                 int(meta["pre"]), int(meta["post"]), p(r0),
                 z if vcycle_only else p(x0), z if vcycle_only else p(tol), p(x), p(work),
                 p(red), red.numel() // 16, p(iters), p(rnorm), p(conv), int(maxiter),
                 int(dt == torch.float64), kn._stream(r0))
    return x, iters[0], rnorm[0], conv[0] != 0


def ell_vcycle(amg: tuple[dict, list], r: torch.Tensor, amg_widths=None) -> torch.Tensor:
    """z = M r, K17's V-cycle alone (a CUDA tensor) or its plain version;
    ``amg_widths`` (``la.amg.amg_widths``) is checked on every device."""
    widths = _amg_widths(amg[0], amg_widths)
    if not kn._route(r, *amg[1], *widths):
        return ell_vcycle_plain(amg, r)
    return _amg_call("ell_vcycle", amg, widths, None, None, None, r.contiguous(), None, None,
                     0, None, True)[0]


def ell_pcg_amg(amg: tuple[dict, list], vals0, cols0, widths0, b, x0, rtol: float,
                maxiter: int, atol: float = 1e-50, mask=None, amg_widths=None) -> KrylovResult:
    """AMG-preconditioned CG on the pressure Poisson in ELL form
    (vals0/cols0 (K0, n), slice widths ``widths0``), ``ell_pcg_amg_solve``'s
    semantics: with a nullspace vector in the AMG data, b, r0, A p and the
    V-cycle's input and output are projected and so is x on exit; with
    ``mask`` (1.0 on the outlet rows) the operator is where(mask, p,
    A (1-mask) p).  On CUDA tensors the set-up (b, tol, r0 = b - A x0
    through K14) is tensor code and the loop is K17, whose every row
    product stops at its slice's width (``widths0``, and the AMG tables'
    ``amg_widths`` from ``la.amg.amg_widths``, both checked on every
    device); CPU tensors go to the plain version."""
    _check_widths(widths0, vals0.shape[-1])
    widths = _amg_widths(amg[0], amg_widths)
    if not kn._route(vals0, cols0, widths0, b, x0, *amg[1], *widths):
        return ell_pcg_amg_plain(amg, vals0, cols0, b, x0, rtol, maxiter, atol, mask)
    r0, tol = _pcg_start(amg, vals0, cols0, b, x0, rtol, atol, mask,
                         lambda v, c, x: ell_matvec(v, c, widths0, x))
    x, k, rn, conv = _amg_call("ell_pcg_amg", amg, widths, vals0, cols0, widths0,
                               r0.contiguous(), x0.contiguous(), tol, maxiter, mask, False)
    return KrylovResult(x, k, rn, conv, 0)
