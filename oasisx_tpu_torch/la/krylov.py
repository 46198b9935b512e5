"""Matrix-free Krylov solvers on tensors, their loops device while loops.

CG for the SPD operators (pressure Poisson, mass), BiCGStab (one system or
a batch) and restarted GMRES for the nonsymmetric tentative-velocity
operator, following ``oasisx_tpu/la/krylov.py`` operation for operation so
that both packages take the same iterations.  Each loop is the JAX
package's ``lax.while_loop`` as ``device_loop.while_loop``: the counters,
the tolerance and the flags are 0-d device tensors, so that inside a
captured step (``run``'s graph) the loop is a conditional node and reads
nothing on the host; elsewhere it is a Python loop whose condition reads a
device scalar once an iteration (one host sync), counted in
``KrylovResult.syncs`` so a run can report syncs per step.  With ``comm``
(the sharded modes, whose steps run eager and are never captured) the sums
go through the host and the loop is that Python loop.

Batched variants solve k systems sharing one operator, with per-row
convergence: converged rows are frozen so further iterations cannot
corrupt them.

Also the Chebyshev acceleration of Jacobi (``chebyshev_preconditioner``)
and its set-up-time bounds (``estimate_lmax``, ``validated_cheb_bounds``),
which the pressure solve of a structured grid that does not coarsen uses.
"""

from __future__ import annotations

import logging
from typing import Callable, NamedTuple

import numpy as np
import torch

from .device_loop import while_loop

logger = logging.getLogger("oasisx_tpu_torch")


class KrylovResult(NamedTuple):
    x: torch.Tensor
    iters: torch.Tensor  # int32, per row for the batched solvers
    resnorm: torch.Tensor  # final residual 2-norm
    converged: torch.Tensor  # bool
    syncs: int = 0  # device reads made by the loop condition
    # PETSc-style converged reason of cg, bicgstab and gmres: 2 converged
    # (rtol), -3 maximum iterations, -5 breakdown (a zero pAp, rho or omega)
    reason: torch.Tensor | None = None  # int32


def _reason(converged: torch.Tensor, breakdown: torch.Tensor) -> torch.Tensor:
    """2 where converged, else -5 where broken down, else -3 (filled on the
    device: a copy from the host would synchronise)."""
    fill = lambda v: torch.full_like(converged, v, dtype=torch.int32)
    return torch.where(converged, fill(2), torch.where(breakdown, fill(-5), fill(-3)))


def _zero(b: torch.Tensor, dtype=torch.int32) -> torch.Tensor:
    """A 0-d zero on b's device: an iteration counter or a flag."""
    return torch.zeros((), dtype=dtype, device=b.device)


def _identity(x):
    return x


_warned_rtol_clamps: set = set()


def _effective_rtol(rtol: float, dtype) -> float:
    """Clamp the relative tolerance to what the dtype can reach (50 eps):
    asking float32 for 1e-13 otherwise drives the iteration to maxiter.
    Logs once per (rtol, dtype) when the floor raises it."""
    npd = np.dtype(np.float64 if dtype in (torch.float64, np.float64) else np.float32)
    floor = 50.0 * float(np.finfo(npd).eps)
    if float(rtol) < floor:
        key = (float(rtol), npd.name)
        if key not in _warned_rtol_clamps:
            _warned_rtol_clamps.add(key)
            logger.info(
                "ksp_rtol %.3g below the %s accuracy floor; using %.3g",
                float(rtol), npd.name, floor,
            )
        return floor
    return float(rtol)


def _nz(v: torch.Tensor) -> torch.Tensor:
    """v where v != 0, else 1 (safe denominator)."""
    return torch.where(v != 0, v, torch.ones_like(v))


def _reducers(comm):
    """(dot, norm, dot_norm) of vectors, dot_norm(r, z) = (dot(r, z),
    norm(r)): local, or summed over ``comm``'s ranks (the slab path: halo
    and padding slots are zero, so the local sums of the ranks add up to
    the global one; dot_norm in one sum)."""
    if comm is None:
        return (torch.dot, torch.linalg.vector_norm,
                lambda r, z: (torch.dot(r, z), torch.linalg.vector_norm(r)))

    def dot_norm(r, z):
        s = comm.sum(torch.stack([torch.dot(r, z), torch.sum(r * r)]))
        return s[0], torch.sqrt(s[1])

    return (lambda a, b: comm.sum(torch.dot(a, b)),
            lambda v: torch.sqrt(comm.sum(torch.sum(v * v))), dot_norm)


def cg(
    A: Callable,
    b: torch.Tensor,
    x0: torch.Tensor | None = None,
    M: Callable | None = None,
    rtol: float = 1e-10,
    atol: float = 1e-50,
    maxiter: int = 1000,
    project_nullspace: bool = False,
    nullvec: torch.Tensor | None = None,
    comm=None,
) -> KrylovResult:
    """Preconditioned conjugate gradients for an SPD operator.

    With ``project_nullspace`` the constant vector (or ``nullvec``) is
    removed from b, every operator application and the final solution.
    With ``comm`` (``parallel.comm.Comm``) the vectors are a rank's slab and
    every dot product and norm is summed over the ranks."""
    M = M or _identity
    x = torch.zeros_like(b) if x0 is None else x0.clone()
    rtol = _effective_rtol(rtol, b.dtype)
    dot, norm, dot_norm = _reducers(comm)
    ee = None if nullvec is None else dot(nullvec, nullvec)

    def demean(v):
        if not project_nullspace:
            return v
        if nullvec is not None:
            return v - (dot(nullvec, v) / ee) * nullvec
        if comm is None:
            return v - v.mean()
        tot = comm.sum(torch.stack([torch.sum(v), torch.tensor(float(v.numel()), dtype=v.dtype,
                                                               device=v.device)]))
        return v - tot[0] / tot[1]

    b = demean(b)
    tol = torch.clamp(rtol * norm(b), min=atol)
    r = demean(b - A(x))
    z = M(r)
    rz = dot(r, z)

    def cond(x, r, p, rz, k, rnorm, brk):
        return (rnorm > tol) & (k < maxiter) & ~brk

    def body(x, r, p, rz, k, rnorm, brk):
        Ap = demean(A(p))
        pAp = dot(p, Ap)
        brk = brk | (pAp == 0) | (rz == 0)
        alpha = rz / _nz(pAp)
        x = x + alpha * p
        r = r - alpha * Ap
        z = M(r)
        rz_new, rnorm = dot_norm(r, z)
        beta = rz_new / _nz(rz)
        return x, r, z + beta * p, rz_new, k + 1, rnorm, brk

    (x, r, p, rz, k, rnorm, brk), syncs = while_loop(
        cond, body, (x, r, z, rz, _zero(b), norm(r), _zero(b, torch.bool)))
    x = demean(x) if project_nullspace else x
    conv = rnorm <= tol
    return KrylovResult(x, k, rnorm, conv, syncs, _reason(conv, brk))


def bicgstab(
    A: Callable,
    b: torch.Tensor,
    x0: torch.Tensor | None = None,
    M: Callable | None = None,
    rtol: float = 1e-10,
    atol: float = 1e-50,
    maxiter: int = 1000,
) -> KrylovResult:
    """Preconditioned BiCGStab for one nonsymmetric system, with the JAX
    package's restart on a Lanczos breakdown (rho = 0: rhat = r, once) and
    its half-step exit (||s|| below the tolerance ends with alpha's
    update); a breakdown that the restart does not cure stops the loop
    with reason -5."""
    M = M or _identity
    x = torch.zeros_like(b) if x0 is None else x0.clone()
    rtol = _effective_rtol(rtol, b.dtype)
    norm = torch.linalg.vector_norm
    tol = torch.clamp(rtol * norm(b), min=atol)
    r = b - A(x)
    false = _zero(b, torch.bool)
    zero = torch.zeros((), dtype=b.dtype, device=b.device)

    def cond(x, r, p, rho, rhat, restarted, k, rnorm, brk):
        return (rnorm > tol) & (k < maxiter) & ~brk

    def body(x, r, p, rho, rhat, restarted, k, rnorm, brk):
        need_restart = rho == 0
        brk = brk | (need_restart & restarted)
        rhat = torch.where(need_restart, r, rhat)
        rho = torch.where(need_restart, torch.dot(r, r), rho)
        p = torch.where(need_restart, r, p)
        phat = M(p)
        v = A(phat)
        rv = torch.dot(rhat, v)
        brk = brk | (rv == 0) | (rho == 0)
        alpha = rho / _nz(rv)
        s = r - alpha * v
        half = norm(s) <= tol
        shat = M(s)
        t = A(shat)
        tt = torch.dot(t, t)
        brk = brk | (~half & (tt == 0))
        omega = torch.where(half, zero, torch.dot(t, s) / _nz(tt))
        x = x + alpha * phat + omega * shat
        r = torch.where(half, s, s - omega * t)
        rho_new = torch.dot(rhat, r)
        brk = brk | (~half & (omega == 0))
        beta = (rho_new / _nz(rho)) * (alpha / _nz(omega))
        p = r + beta * (p - omega * v)
        return x, r, p, rho_new, rhat, need_restart, k + 1, norm(r), brk

    carry = (x, r, r, torch.dot(r, r), r, false, _zero(b), norm(r), false)
    (x, r, p, rho, rhat, restarted, k, rnorm, brk), syncs = while_loop(cond, body, carry)
    conv = rnorm <= tol
    return KrylovResult(x, k, rnorm, conv, syncs, _reason(conv, brk))


def gmres(
    A: Callable,
    b: torch.Tensor,
    x0: torch.Tensor | None = None,
    M: Callable | None = None,
    rtol: float = 1e-10,
    atol: float = 1e-50,
    maxiter: int = 1000,
    restart: int = 30,
    comm=None,
) -> KrylovResult:
    """Restarted GMRES(m), left-preconditioned (PETSc's default): Arnoldi
    on M A, the test on the preconditioned residual norm against
    rtol ||M b||, Gram-Schmidt against the basis, Givens rotations.  With
    ``comm`` the vectors are a rank's local part: every norm and the
    Hessenberg column's dots are summed over the ranks (the JAX package's
    ``gmres(axis=)``), so every rank holds the same small system.

    The JAX package's fixed-shape cycle (oasisx_tpu/la/krylov.py:516-590)
    on device tensors in the solver's dtype: the basis V (m+1, n), the
    Hessenberg matrix H (m+1, m), g, the step counter and the live flag.
    The restart loop is a device while loop, and so are a cycle's Arnoldi
    steps: they stop at the first step that is not live (converged, the
    iteration limit, an exact breakdown), where the JAX cycle runs its
    remaining steps as masked no-ops; the columns those leave, a unit
    diagonal and a zero basis vector, are where H and V start.  The Givens
    rotations of the earlier steps act on a new column as their product Q
    ((m+1, m+1), one small product a step in place of the JAX loop over
    them), each new rotation updating two rows of Q; the back-substitution
    is one triangular solve on the m x m H (a zero diagonal read as 1)."""
    M = M or _identity
    x = torch.zeros_like(b) if x0 is None else x0.clone()
    rtol = _effective_rtol(rtol, b.dtype)
    m = int(restart)
    n, dt, dev = b.shape[0], b.dtype, b.device
    _, norm, _ = _reducers(comm)
    tol = torch.clamp(rtol * norm(M(b)), min=atol)
    rows = torch.arange(m + 1, device=dev)
    cols = torch.arange(m, device=dev)
    syncs = [0]

    def arnoldi(V, H, Q, g, j, it, live):
        vj = V.index_select(0, j.view(1))[0]
        w = M(A(vj))
        # Gram-Schmidt against rows 0..j (the rest of V is zero)
        h = (V @ w) * (rows <= j).to(dt)
        if comm is not None:
            h = comm.sum(h)
        w = w - h @ V
        hj1 = norm(w)
        ok = hj1 > 0
        V.index_copy_(0, (j + 1).view(1),
                      torch.where(ok & live, w / torch.where(ok, hj1, torch.ones_like(hj1)),
                                  torch.zeros_like(w))[None])
        h = torch.where(rows == j + 1, torch.where(ok, hj1, torch.zeros_like(hj1)), h)
        h = Q @ h  # the earlier rotations
        hj, hj1 = h.index_select(0, j.view(1))[0], h.index_select(0, (j + 1).view(1))[0]
        denom = torch.sqrt(hj * hj + hj1 * hj1)
        pos = denom > 0
        dd = torch.where(pos, denom, torch.ones_like(denom))
        live_step = live & ok
        c = torch.where(live_step & pos, hj / dd, torch.ones_like(hj))
        s = torch.where(live_step & pos, hj1 / dd, torch.zeros_like(hj))
        h = torch.where(rows == j, denom, torch.where(rows == j + 1, torch.zeros_like(h), h))
        qj, qj1 = Q.index_select(0, j.view(1)), Q.index_select(0, (j + 1).view(1))
        Q = torch.where((rows == j)[:, None], c * qj + s * qj1,
                        torch.where((rows == j + 1)[:, None], c * qj1 - s * qj, Q))
        H = torch.where((cols == j)[None, :] & live_step, h[:, None], H)
        gj = g.index_select(0, j.view(1))[0]
        g = torch.where(live_step, torch.where(rows == j, c * gj,
                                               torch.where(rows == j + 1, -s * gj, g)), g)
        res = torch.abs(g.index_select(0, (j + 1).view(1))[0])
        it = it + live.to(torch.int32)
        live = live_step & (res > tol) & (it < maxiter)
        return V, H, Q, g, j + 1, it, live

    def cycle(x, it, rnorm):
        r = M(b - A(x))
        beta = norm(r)
        V = torch.zeros((m + 1, n), dtype=dt, device=dev)
        V[0] = torch.where(beta > 0, r / torch.where(beta > 0, beta, torch.ones_like(beta)), r)
        H = torch.eye(m + 1, m, dtype=dt, device=dev)
        Q = torch.eye(m + 1, dtype=dt, device=dev)
        g = torch.where(rows == 0, beta, torch.zeros((), dtype=dt, device=dev))
        (V, H, Q, g, j, it, live), n_in = while_loop(
            lambda V, H, Q, g, j, it, live: live & (j < m), arnoldi,
            (V, H, Q, g, torch.zeros((), dtype=torch.int64, device=dev), it, beta > tol))
        syncs[0] += n_in
        U = H[:m]
        U = U + torch.diag((torch.diagonal(U) == 0).to(dt))
        y = torch.linalg.solve_triangular(U, g[:m, None], upper=True)[:, 0]
        x = x + y @ V[:m]
        return x, it, norm(M(b - A(x)))

    (x, it, rnorm), n_out = while_loop(
        lambda x, it, rnorm: (rnorm > tol) & (it < maxiter), cycle,
        (x, _zero(b), norm(M(b - A(x)))))
    conv = rnorm <= tol
    return KrylovResult(x, it, rnorm, conv, syncs[0] + n_out,
                        _reason(conv, torch.zeros_like(conv)))


def jacobi_preconditioner(diag: torch.Tensor) -> Callable:
    inv = torch.where(diag != 0, 1.0 / _nz(diag), torch.ones_like(diag))
    return lambda r: inv * r


def chebyshev_preconditioner(matvec: Callable, inv_diag: torch.Tensor, lmin: float, lmax: float,
                             degree: int = 8) -> Callable:
    """Chebyshev acceleration of Jacobi as an SPD preconditioner
    (``oasisx_tpu/la/krylov.py:chebyshev_preconditioner``): z = p(D^-1 A)
    D^-1 r by the three-term recurrence (Saad, Iterative Methods, alg.
    12.1) on the Jacobi-preconditioned operator with eigenvalue bounds
    [lmin, lmax]; ``degree - 1`` applications of ``matvec``, and degree 1
    gives D^-1 r / theta.  A fixed polynomial, so a fixed linear operator,
    valid inside CG."""
    theta = 0.5 * (lmax + lmin)
    delta = 0.5 * (lmax - lmin)
    sigma1 = theta / delta

    def M(r):
        rho = 1.0 / sigma1
        d = (inv_diag * r) / theta
        z = d
        for _ in range(degree - 1):
            rho_new = 1.0 / (2.0 * sigma1 - rho)
            d = rho_new * rho * d + (2.0 * rho_new / delta) * (inv_diag * (r - matvec(z)))
            z = z + d
            rho = rho_new
        return z

    return M


def _start_vector(inv_diag: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """A standard normal vector drawn on the CPU in float64, then cast and
    moved to inv_diag's device: a run on the card and one on the CPU start
    from the same vector."""
    v = torch.randn(inv_diag.shape, generator=generator, dtype=torch.float64)
    return v.to(device=inv_diag.device, dtype=inv_diag.dtype)


def estimate_lmax(matvec: Callable, inv_diag: torch.Tensor, iters: int = 60, seed: int = 0,
                  tol: float = 1e-3, generator: torch.Generator | None = None) -> float:
    """Residual-guarded power iteration for the largest eigenvalue of
    D^-1 A (set-up time, reads the host every iteration): iterate until the
    Rayleigh quotient changes by at most ``tol`` (at most ``iters`` times),
    then pad the estimate by the Rayleigh residual ||D^-1 A v - lam v|| and
    2%.  The start vector comes from ``generator`` (default: seeded with
    ``seed``); the JAX package's ``jax.random`` stream is not reproduced."""
    v = _start_vector(inv_diag, generator or torch.Generator().manual_seed(seed))
    v = v / torch.linalg.vector_norm(v)
    mv = lambda x: inv_diag * matvec(x)
    lam_prev = 0.0
    for k in range(iters):
        w = mv(v)
        nw = float(torch.linalg.vector_norm(w))
        if nw == 0:
            return 1.05
        lam = float(torch.dot(v, w))
        v = w / nw
        if k >= 4 and abs(lam - lam_prev) <= tol * abs(lam):
            break
        lam_prev = lam
    w = mv(v)
    lam = float(torch.dot(v, w))
    resid = float(torch.linalg.vector_norm(w - lam * v))
    return (abs(lam) + resid) * 1.02


def validated_cheb_bounds(matvec: Callable, inv_diag: torch.Tensor, lmax: float, degree: int,
                          tries: int = 5, seed: int = 1,
                          generator: torch.Generator | None = None) -> tuple[float, float]:
    """Divergence backstop for Chebyshev-Jacobi: a polynomial built on an
    underestimated lmax amplifies the top of the spectrum.  Apply the
    candidate preconditioner's error operator E = I - A M three times to a
    random demeaned vector; while ||E^3 r|| exceeds ||r||, double lmax (at
    most ``tries`` times).  Returns (lmax / 30, lmax)."""
    r0 = _start_vector(inv_diag, generator or torch.Generator().manual_seed(seed))
    r0 = r0 - torch.mean(r0)
    rn = float(torch.linalg.vector_norm(r0))
    for _ in range(tries):
        M = chebyshev_preconditioner(matvec, inv_diag, lmax / 30.0, lmax, degree)
        r = r0
        for _ in range(3):
            r = r - matvec(M(r))
        en = float(torch.linalg.vector_norm(r))
        if np.isfinite(en) and en <= rn:
            return lmax / 30.0, lmax
        logger.warning(
            "chebyshev bounds rejected (||E^3 r||/||r|| = %.3g); doubling lmax %.3g -> %.3g",
            en / rn if rn else float("inf"), lmax, 2 * lmax,
        )
        lmax *= 2.0
    return lmax / 30.0, lmax


def _row_norm(v, comm=None):
    return torch.sqrt(_row_dot(v, v, comm))


def _row_dot(a, b, comm=None):
    s = torch.sum(a * b, dim=-1, keepdim=True)
    return s if comm is None else comm.sum(s)


def _row_dots(a, b1, b2, comm=None):
    """(_row_dot(a, b1), _row_dot(a, b2)), in one sum over the ranks (the
    same values as two)."""
    s1 = torch.sum(a * b1, dim=-1, keepdim=True)
    s2 = torch.sum(a * b2, dim=-1, keepdim=True)
    if comm is None:
        return s1, s2
    s = comm.sum(torch.stack([s1, s2]))
    return s[0], s[1]


def cg_batched(
    A: Callable,
    b: torch.Tensor,
    x0: torch.Tensor | None = None,
    M: Callable | None = None,
    rtol: float = 1e-10,
    atol: float = 1e-50,
    maxiter: int = 1000,
    comm=None,
) -> KrylovResult:
    """Preconditioned CG on k systems at once: b, x0 of shape (k, n); with
    ``comm`` each row's reductions are summed over the ranks."""
    M = M or _identity
    x = torch.zeros_like(b) if x0 is None else x0.clone()
    rtol = _effective_rtol(rtol, b.dtype)
    tol = torch.clamp(rtol * _row_norm(b, comm), min=atol)
    r = b - A(x)
    z = M(r)

    def cond(x, r, p, rz, k, rnorm, iters):
        return torch.any(rnorm > tol) & (k < maxiter)

    def body(x, r, p, rz, k, rnorm, iters):
        active = rnorm > tol
        Ap = A(p)
        pAp = _row_dot(p, Ap, comm)
        alpha = torch.where(active, rz / _nz(pAp), torch.zeros_like(rz))
        x = x + alpha * p
        r = r - alpha * Ap
        z = M(r)
        rz_r, rr = _row_dots(r, z, r, comm)
        rz_new = torch.where(active, rz_r, rz)
        beta = torch.where(active, rz_new / _nz(rz), torch.zeros_like(rz))
        p = torch.where(active, z + beta * p, p)
        return x, r, p, rz_new, k + 1, torch.sqrt(rr), iters + active[..., 0].to(torch.int32)

    carry = (x, r, z, _row_dot(r, z, comm), _zero(b), _row_norm(r, comm),
             torch.zeros(b.shape[0], dtype=torch.int32, device=b.device))
    (x, r, p, rz, k, rnorm, iters), syncs = while_loop(cond, body, carry)
    return KrylovResult(x, iters, rnorm[..., 0], rnorm[..., 0] <= tol[..., 0], syncs)


def bicgstab_batched(
    A: Callable,
    b: torch.Tensor,
    x0: torch.Tensor | None = None,
    M: Callable | None = None,
    rtol: float = 1e-10,
    atol: float = 1e-50,
    maxiter: int = 1000,
    comm=None,
) -> KrylovResult:
    """Preconditioned BiCGStab on k systems at once: b, x0 of shape (k, n);
    with ``comm`` each row's reductions are summed over the ranks."""
    M = M or _identity
    x = torch.zeros_like(b) if x0 is None else x0.clone()
    rtol = _effective_rtol(rtol, b.dtype)
    tol = torch.clamp(rtol * _row_norm(b, comm), min=atol)
    r = b - A(x)
    rhat = r
    zero = torch.zeros((), dtype=b.dtype, device=b.device)

    def cond(x, r, p, rho, k, rnorm, iters):
        return torch.any(rnorm > tol) & (k < maxiter)

    def body(x, r, p, rho, k, rnorm, iters):
        active = rnorm > tol
        phat = M(p)
        v = A(phat)
        rv = _row_dot(rhat, v, comm)
        alpha = rho / _nz(rv)
        s = r - alpha * v
        shat = M(s)
        t = A(shat)
        tt, ts = _row_dots(t, t, s, comm)
        omega = ts / _nz(tt)
        x = x + torch.where(active, alpha * phat + omega * shat, zero)
        r = torch.where(active, s - omega * t, r)
        rho_r, rr = _row_dots(r, rhat, r, comm)
        rho_new = torch.where(active, rho_r, rho)
        beta = (rho_new / _nz(rho)) * (alpha / _nz(omega))
        p = torch.where(active, r + beta * (p - omega * v), p)
        return x, r, p, rho_new, k + 1, torch.sqrt(rr), iters + active[..., 0].to(torch.int32)

    carry = (x, r, r, _row_dot(rhat, r, comm), _zero(b), _row_norm(r, comm),
             torch.zeros(b.shape[0], dtype=torch.int32, device=b.device))
    (x, r, p, rho, k, rnorm, iters), syncs = while_loop(cond, body, carry)
    return KrylovResult(x, iters, rnorm[..., 0], rnorm[..., 0] <= tol[..., 0], syncs)
