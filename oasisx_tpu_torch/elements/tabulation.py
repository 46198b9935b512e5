"""Lagrange basis tabulation on unit simplices (interval/triangle/tetrahedron).

Nodal (Lagrange) bases are built from the orthonormal PKD modal basis via a
generalized Vandermonde matrix: for nodes ``X`` and evaluation points ``Y``,

    phi(Y) = PKD(Y) @ inv(PKD(X))

All arrays are NumPy float64 host-side; this runs once at setup.

Unit reference cells:
  interval:     [0, 1]
  triangle:     (0,0), (1,0), (0,1)
  tetrahedron:  (0,0,0), (1,0,0), (0,1,0), (0,0,1)

Replaces the Basix tabulation surface exercised by the reference
(reference src/oasisx/fracstep.py:163-184).
"""

from __future__ import annotations

import numpy as np

from . import jacobi as _j


def num_modes(cell: str, degree: int) -> int:
    if cell == "interval":
        return degree + 1
    if cell == "triangle":
        return (degree + 1) * (degree + 2) // 2
    if cell == "tetrahedron":
        return (degree + 1) * (degree + 2) * (degree + 3) // 6
    raise ValueError(f"unknown cell {cell}")


def cell_dim(cell: str) -> int:
    return {"interval": 1, "triangle": 2, "tetrahedron": 3}[cell]


def _mode_indices(cell: str, degree: int) -> list[tuple[int, ...]]:
    if cell == "interval":
        return [(i,) for i in range(degree + 1)]
    if cell == "triangle":
        return [(i, j) for i in range(degree + 1) for j in range(degree + 1 - i)]
    if cell == "tetrahedron":
        return [
            (i, j, k)
            for i in range(degree + 1)
            for j in range(degree + 1 - i)
            for k in range(degree + 1 - i - j)
        ]
    raise ValueError(cell)


def pkd_vandermonde(cell: str, degree: int, points: np.ndarray) -> np.ndarray:
    """Modal basis values at unit-cell ``points``; shape (npts, nmodes)."""
    points = np.atleast_2d(np.asarray(points, dtype=np.float64))
    modes = _mode_indices(cell, degree)
    out = np.zeros((points.shape[0], len(modes)))
    if cell == "interval":
        r = 2.0 * points[:, 0] - 1.0
        for m, (i,) in enumerate(modes):
            out[:, m] = _j.simplex1d_p(r, i)
    elif cell == "triangle":
        r = 2.0 * points[:, 0] - 1.0
        s = 2.0 * points[:, 1] - 1.0
        a, b = _j.rs_to_ab(r, s)
        for m, (i, j) in enumerate(modes):
            out[:, m] = _j.simplex2d_p(a, b, i, j)
    else:
        r = 2.0 * points[:, 0] - 1.0
        s = 2.0 * points[:, 1] - 1.0
        t = 2.0 * points[:, 2] - 1.0
        a, b, c = _j.rst_to_abc(r, s, t)
        for m, (i, j, k) in enumerate(modes):
            out[:, m] = _j.simplex3d_p(a, b, c, i, j, k)
    return out


def pkd_grad_vandermonde(cell: str, degree: int, points: np.ndarray) -> np.ndarray:
    """Modal basis unit-cell gradients at ``points``; shape (npts, dim, nmodes)."""
    points = np.atleast_2d(np.asarray(points, dtype=np.float64))
    modes = _mode_indices(cell, degree)
    dim = cell_dim(cell)
    out = np.zeros((points.shape[0], dim, len(modes)))
    # biunit chain rule factor: d/dx_unit = 2 * d/dr_biunit
    if cell == "interval":
        r = 2.0 * points[:, 0] - 1.0
        for m, (i,) in enumerate(modes):
            out[:, 0, m] = 2.0 * _j.grad_simplex1d_p(r, i)
    elif cell == "triangle":
        r = 2.0 * points[:, 0] - 1.0
        s = 2.0 * points[:, 1] - 1.0
        a, b = _j.rs_to_ab(r, s)
        for m, (i, j) in enumerate(modes):
            dr, ds = _j.grad_simplex2d_p(a, b, i, j)
            out[:, 0, m] = 2.0 * dr
            out[:, 1, m] = 2.0 * ds
    else:
        r = 2.0 * points[:, 0] - 1.0
        s = 2.0 * points[:, 1] - 1.0
        t = 2.0 * points[:, 2] - 1.0
        a, b, c = _j.rst_to_abc(r, s, t)
        for m, (i, j, k) in enumerate(modes):
            dr, ds, dt = _j.grad_simplex3d_p(a, b, c, i, j, k)
            out[:, 0, m] = 2.0 * dr
            out[:, 1, m] = 2.0 * ds
            out[:, 2, m] = 2.0 * dt
    return out


def tabulate_lagrange(
    cell: str,
    degree: int,
    nodes: np.ndarray,
    points: np.ndarray,
) -> tuple[np.ndarray, np.ndarray]:
    """Tabulate the nodal basis defined by ``nodes`` at ``points``.

    Returns (phi, dphi) with shapes (npts, ndofs) and (npts, dim, ndofs);
    gradients are w.r.t. unit reference coordinates.
    """
    V = pkd_vandermonde(cell, degree, nodes)
    Vinv = np.linalg.inv(V)
    phi = pkd_vandermonde(cell, degree, points) @ Vinv
    dphi = pkd_grad_vandermonde(cell, degree, points) @ Vinv
    return phi, dphi
