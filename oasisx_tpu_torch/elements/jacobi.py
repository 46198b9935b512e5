"""Jacobi polynomials and orthonormal simplex (PKD) bases.

Host-side (NumPy, float64) tabulation used at setup time only; results are
baked into jitted device programs as constant arrays.

This replaces the role of Basix element tabulation in the reference stack
(see reference usage at src/oasisx/fracstep.py:163-184): the rebuild
tabulates Lagrange bases directly from Jacobi-polynomial recurrences
(Proriol-Koornwinder-Dubiner orthonormal bases on simplices, evaluated via
collapsed coordinates; cf. Hesthaven & Warburton, "Nodal DG Methods").
"""

from __future__ import annotations

import math

import numpy as np


def jacobi_p(x: np.ndarray, alpha: float, beta: float, n: int) -> np.ndarray:
    """Evaluate the L2-orthonormal Jacobi polynomial P_n^{(alpha,beta)} at x.

    Normalized so that int_{-1}^{1} (1-x)^alpha (1+x)^beta P_n^2 dx = 1.
    """
    x = np.asarray(x, dtype=np.float64)
    gamma0 = (
        2.0 ** (alpha + beta + 1)
        / (alpha + beta + 1)
        * math.gamma(alpha + 1)
        * math.gamma(beta + 1)
        / math.gamma(alpha + beta + 1)
    )
    p_prev = np.full_like(x, 1.0 / math.sqrt(gamma0))
    if n == 0:
        return p_prev
    gamma1 = (alpha + 1) * (beta + 1) / (alpha + beta + 3) * gamma0
    p_cur = ((alpha + beta + 2) * x / 2 + (alpha - beta) / 2) / math.sqrt(gamma1)
    if n == 1:
        return p_cur
    aold = 2.0 / (2 + alpha + beta) * math.sqrt(
        (alpha + 1) * (beta + 1) / (alpha + beta + 3)
    )
    for i in range(1, n):
        h1 = 2 * i + alpha + beta
        anew = (
            2.0
            / (h1 + 2)
            * math.sqrt(
                (i + 1)
                * (i + 1 + alpha + beta)
                * (i + 1 + alpha)
                * (i + 1 + beta)
                / (h1 + 1)
                / (h1 + 3)
            )
        )
        bnew = -(alpha**2 - beta**2) / h1 / (h1 + 2)
        p_next = (-aold * p_prev + (x - bnew) * p_cur) / anew
        p_prev, p_cur = p_cur, p_next
        aold = anew
    return p_cur


def grad_jacobi_p(x: np.ndarray, alpha: float, beta: float, n: int) -> np.ndarray:
    """Derivative of the orthonormal Jacobi polynomial."""
    x = np.asarray(x, dtype=np.float64)
    if n == 0:
        return np.zeros_like(x)
    return math.sqrt(n * (n + alpha + beta + 1)) * jacobi_p(x, alpha + 1, beta + 1, n - 1)


def gauss_lobatto_points(n: int) -> np.ndarray:
    """n+1 Gauss-Lobatto-Legendre points on [-1, 1]."""
    if n == 1:
        return np.array([-1.0, 1.0])
    # Interior GLL points are roots of P'_n (Legendre derivative); use
    # Chebyshev initial guess + Newton on (1-x^2) P'_n(x).
    x = np.cos(np.pi * np.arange(n + 1) / n)[::-1].copy()
    for _ in range(100):
        # Legendre P_n and P_{n-1} by recurrence (unnormalized)
        p0 = np.ones_like(x)
        p1 = x.copy()
        for k in range(2, n + 1):
            p0, p1 = p1, ((2 * k - 1) * x * p1 - (k - 1) * p0) / k
        # f = (1-x^2) P'_n = n (P_{n-1} - x P_n);   f' = -n(n+1) P_n
        f = n * (p0 - x * p1)
        df = -n * (n + 1) * p1
        dx = np.where(np.abs(df) > 0, f / df, 0.0)
        x = x - dx
        x[0], x[-1] = -1.0, 1.0
        if np.max(np.abs(dx[1:-1])) < 1e-15 if n > 1 else True:
            break
    return x


# ---------------------------------------------------------------------------
# Collapsed coordinates
# ---------------------------------------------------------------------------


def rs_to_ab(r: np.ndarray, s: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Triangle (r,s) in [-1,1]^2 (r+s<=0) -> collapsed square (a,b)."""
    a = np.where(np.abs(s - 1.0) > 1e-14, 2.0 * (1.0 + r) / np.where(np.abs(s - 1.0) > 1e-14, 1.0 - s, 1.0) - 1.0, -1.0)
    return a, s.copy()


def rst_to_abc(r, s, t):
    """Tetrahedron (r,s,t) -> collapsed cube (a,b,c)."""
    denom_a = -(s + t)
    a = np.where(np.abs(denom_a) > 1e-14, 2.0 * (1.0 + r) / np.where(np.abs(denom_a) > 1e-14, denom_a, 1.0) - 1.0, -1.0)
    denom_b = 1.0 - t
    b = np.where(np.abs(denom_b) > 1e-14, 2.0 * (1.0 + s) / np.where(np.abs(denom_b) > 1e-14, denom_b, 1.0) - 1.0, -1.0)
    return a, b, t.copy()


# ---------------------------------------------------------------------------
# Orthonormal PKD modal bases: values and gradients
# ---------------------------------------------------------------------------


def simplex1d_p(r: np.ndarray, i: int) -> np.ndarray:
    return jacobi_p(r, 0.0, 0.0, i)


def grad_simplex1d_p(r: np.ndarray, i: int) -> np.ndarray:
    return grad_jacobi_p(r, 0.0, 0.0, i)


def simplex2d_p(a: np.ndarray, b: np.ndarray, i: int, j: int) -> np.ndarray:
    h1 = jacobi_p(a, 0.0, 0.0, i)
    h2 = jacobi_p(b, 2.0 * i + 1.0, 0.0, j)
    return math.sqrt(2.0) * h1 * h2 * (1.0 - b) ** i


def grad_simplex2d_p(a, b, i: int, j: int) -> tuple[np.ndarray, np.ndarray]:
    """(d/dr, d/ds) of the 2D PKD mode (i,j) given collapsed coords."""
    fa = jacobi_p(a, 0.0, 0.0, i)
    dfa = grad_jacobi_p(a, 0.0, 0.0, i)
    gb = jacobi_p(b, 2.0 * i + 1.0, 0.0, j)
    dgb = grad_jacobi_p(b, 2.0 * i + 1.0, 0.0, j)

    dmodedr = dfa * gb
    if i > 0:
        dmodedr = dmodedr * (0.5 * (1.0 - b)) ** (i - 1)
    dmodeds = dfa * (gb * (0.5 * (1.0 + a)))
    if i > 0:
        dmodeds = dmodeds * (0.5 * (1.0 - b)) ** (i - 1)
    tmp = dgb * (0.5 * (1.0 - b)) ** i
    if i > 0:
        tmp = tmp - 0.5 * i * gb * (0.5 * (1.0 - b)) ** (i - 1)
    dmodeds = dmodeds + fa * tmp

    scale = 2.0 ** (i + 0.5)
    return dmodedr * scale, dmodeds * scale


def simplex3d_p(a, b, c, i: int, j: int, k: int) -> np.ndarray:
    h1 = jacobi_p(a, 0.0, 0.0, i)
    h2 = jacobi_p(b, 2.0 * i + 1.0, 0.0, j)
    h3 = jacobi_p(c, 2.0 * (i + j) + 2.0, 0.0, k)
    return 2.0 * math.sqrt(2.0) * h1 * h2 * ((1.0 - b) ** i) * h3 * ((1.0 - c) ** (i + j))


def grad_simplex3d_p(a, b, c, i: int, j: int, k: int):
    """(d/dr, d/ds, d/dt) of the 3D PKD mode (i,j,k) given collapsed coords."""
    fa = jacobi_p(a, 0.0, 0.0, i)
    dfa = grad_jacobi_p(a, 0.0, 0.0, i)
    gb = jacobi_p(b, 2.0 * i + 1.0, 0.0, j)
    dgb = grad_jacobi_p(b, 2.0 * i + 1.0, 0.0, j)
    hc = jacobi_p(c, 2.0 * (i + j) + 2.0, 0.0, k)
    dhc = grad_jacobi_p(c, 2.0 * (i + j) + 2.0, 0.0, k)

    v3dr = dfa * (gb * hc)
    if i > 0:
        v3dr = v3dr * (0.5 * (1.0 - b)) ** (i - 1)
    if i + j > 0:
        v3dr = v3dr * (0.5 * (1.0 - c)) ** (i + j - 1)

    v3ds = 0.5 * (1.0 + a) * v3dr
    tmp = dgb * (0.5 * (1.0 - b)) ** i
    if i > 0:
        tmp = tmp + (-0.5 * i) * (gb * (0.5 * (1.0 - b)) ** (i - 1))
    if i + j > 0:
        tmp = tmp * (0.5 * (1.0 - c)) ** (i + j - 1)
    tmp = fa * (tmp * hc)
    v3ds = v3ds + tmp

    v3dt = 0.5 * (1.0 + a) * v3dr + 0.5 * (1.0 + b) * tmp
    tmp2 = dhc * (0.5 * (1.0 - c)) ** (i + j)
    if i + j > 0:
        tmp2 = tmp2 - 0.5 * (i + j) * (hc * (0.5 * (1.0 - c)) ** (i + j - 1))
    tmp2 = fa * (gb * tmp2)
    tmp2 = tmp2 * (0.5 * (1.0 - b)) ** i
    v3dt = v3dt + tmp2

    scale = 2.0 ** (2 * i + j + 1.5)
    return v3dr * scale, v3ds * scale, v3dt * scale
