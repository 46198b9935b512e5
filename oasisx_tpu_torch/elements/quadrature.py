"""Quadrature rules on unit simplices.

Two families, both exact for the requested total degree:

- Grundmann-Moller simplex rules (default when smaller): for odd degree
  2s+1 on the n-simplex they use C(n+s+1, s) points — e.g. 15 points for
  degree 5 on the tetrahedron vs 48 for the collapsed product rule. Point
  count directly scales the per-step convection tables (Q = S*nq rows per
  macro-cell), so this is a ~3x traffic cut on the hot path. GM weights
  alternate in sign; that is harmless for assembly (the rule is still
  exact) — only strictly-positive-weight applications would care.
- Collapsed (Duffy) Gauss-Legendre product rules as the general fallback.

The two rules integrate any degree-<=d polynomial identically (both exact),
so assembled operators agree to roundoff whichever is chosen.
"""

from __future__ import annotations

from math import comb, factorial

import numpy as np


def _gauss_01(n: int) -> tuple[np.ndarray, np.ndarray]:
    x, w = np.polynomial.legendre.leggauss(n)
    return (x + 1.0) / 2.0, w / 2.0


def _compositions(total: int, parts: int):
    """All tuples of ``parts`` nonnegative ints summing to ``total``."""
    if parts == 1:
        yield (total,)
        return
    for head in range(total + 1):
        for rest in _compositions(total - head, parts - 1):
            yield (head,) + rest


def grundmann_moller(dim: int, s: int) -> tuple[np.ndarray, np.ndarray]:
    """Grundmann-Moller rule of degree 2s+1 on the unit n-simplex.

    A. Grundmann & H. M. Moller, 'Invariant integration formulas for the
    n-simplex by combinatorial methods', SIAM J. Numer. Anal. 15 (1978).
    Weights are scaled so they sum to the reference simplex volume 1/n!.
    """
    n = dim
    d = 2 * s + 1
    pts: list[np.ndarray] = []
    wts: list[float] = []
    vol = 1.0 / factorial(n)
    for i in range(s + 1):
        denom = d + n - 2 * i
        w = (
            (-1.0) ** i
            * 2.0 ** (-2 * s)
            * float(denom) ** d
            / (factorial(i) * factorial(d + n - i))
        )
        for beta in _compositions(s - i, n + 1):
            # barycentric (2*beta_j + 1) / denom; drop the 0th coordinate
            bary = (2.0 * np.asarray(beta, dtype=float) + 1.0) / denom
            pts.append(bary[1:])
            wts.append(w)
    w_arr = np.asarray(wts)
    # GM weights (as above) integrate f over the simplex with the n!-scaled
    # convention; normalize exactly so sum(w) = volume (exactness for f=1)
    w_arr *= vol / w_arr.sum()
    return np.asarray(pts), w_arr


def _duffy_count(cell: str, degree: int) -> int:
    if cell == "triangle":
        return max(1, (degree + 2) // 2) * max(1, (degree + 3) // 2)
    nu = max(1, (degree + 2) // 2)
    nv = max(1, (degree + 3) // 2)
    nw = max(1, (degree + 4) // 2)
    return nu * nv * nw


def quadrature(cell: str, degree: int) -> tuple[np.ndarray, np.ndarray]:
    """Return (points, weights) exact for polynomials of total degree ``degree``.

    Points have shape (nq, dim); weights sum to the reference-cell volume
    (1, 1/2, 1/6 for interval/triangle/tetrahedron).
    """
    dim = {"interval": 1, "triangle": 2, "tetrahedron": 3}.get(cell)
    if dim is not None and dim >= 2:
        # smallest s with 2s+1 >= degree
        s = max(0, -(-(int(degree) - 1) // 2))
        gm_pts = comb(dim + s + 1, s)
        if gm_pts < _duffy_count(cell, degree):
            return grundmann_moller(dim, s)
    if cell == "interval":
        n = max(1, (degree + 2) // 2)
        x, w = _gauss_01(n)
        return x[:, None], w
    if cell == "triangle":
        # x = u*(1-v), y = v ; jacobian (1-v): v-direction integrand degree
        # rises by 1, so use degree+1 exactness there.
        nu = max(1, (degree + 2) // 2)
        nv = max(1, (degree + 3) // 2)
        u, wu = _gauss_01(nu)
        v, wv = _gauss_01(nv)
        U, V = np.meshgrid(u, v, indexing="ij")
        WU, WV = np.meshgrid(wu, wv, indexing="ij")
        x = U * (1.0 - V)
        y = V
        w = WU * WV * (1.0 - V)
        return np.stack([x.ravel(), y.ravel()], axis=1), w.ravel()
    if cell == "tetrahedron":
        # x = u*(1-v)*(1-w), y = v*(1-w), z = w; jacobian (1-v)(1-w)^2
        nu = max(1, (degree + 2) // 2)
        nv = max(1, (degree + 3) // 2)
        nw = max(1, (degree + 4) // 2)
        u, wu = _gauss_01(nu)
        v, wv = _gauss_01(nv)
        t, wt = _gauss_01(nw)
        U, V, T = np.meshgrid(u, v, t, indexing="ij")
        WU, WV, WT = np.meshgrid(wu, wv, wt, indexing="ij")
        x = U * (1.0 - V) * (1.0 - T)
        y = V * (1.0 - T)
        z = T
        w = WU * WV * WT * (1.0 - V) * (1.0 - T) ** 2
        return np.stack([x.ravel(), y.ravel(), z.ravel()], axis=1), w.ravel()
    raise ValueError(f"unknown cell {cell}")
