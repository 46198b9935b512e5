"""Per-cell affine geometry factors.

For affine simplices the Jacobian is constant per cell, so every element
tensor is a small contraction of constant reference tensors with per-cell
factors (detJ, Kinv = J^{-1}, G = Kinv Kinv^T). This is what makes the
assembly MXU-shaped: batched einsums instead of quadrature loops.

Index conventions:
    J[c, g, b]    = d x_g / d X_b           (phys g, ref b)
    Kinv[c, b, g] = (J^{-1})[b, g]          so  (grad_x phi)_g = Kinv[b,g] dphi[b]
    G[c, a, b]    = sum_g Kinv[a,g] Kinv[b,g]
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class CellGeometry:
    """Host (NumPy f64) geometry factors; cast to device dtype by the engine."""

    detJ: np.ndarray  # (ncells,) absolute Jacobian determinant
    Kinv: np.ndarray  # (ncells, dim, dim)
    G: np.ndarray  # (ncells, dim, dim)


def compute_cell_geometry(x: np.ndarray, cells: np.ndarray, dim: int) -> CellGeometry:
    v0 = x[cells[:, 0]]
    J = np.stack([x[cells[:, i + 1]] - v0 for i in range(dim)], axis=2)  # (nc, g, b)
    if dim == 1:
        detJ = J[:, 0, 0]
        Kinv = 1.0 / detJ[:, None, None]
    elif dim == 2:
        detJ = J[:, 0, 0] * J[:, 1, 1] - J[:, 0, 1] * J[:, 1, 0]
        Kinv = (
            np.stack(
                [
                    np.stack([J[:, 1, 1], -J[:, 0, 1]], axis=1),
                    np.stack([-J[:, 1, 0], J[:, 0, 0]], axis=1),
                ],
                axis=1,
            )
            / detJ[:, None, None]
        )
    else:
        detJ = np.linalg.det(J)
        Kinv = np.linalg.inv(J)
    detJ = np.abs(detJ)
    G = np.einsum("cag,cbg->cab", Kinv, Kinv)
    return CellGeometry(detJ=detJ, Kinv=Kinv, G=G)
