"""Finite element descriptor: family/cell/degree/variant + tabulation cache.

The role of ``basix.ufl.element`` in the reference
(reference src/oasisx/fracstep.py:163-184). Only simplex Lagrange
("Lagrange"/"P" continuous, "DG"/"Discontinuous Lagrange" discontinuous)
families are provided — the closed set the reference exercises.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .nodes import lagrange_nodes
from .quadrature import quadrature
from .tabulation import cell_dim, tabulate_lagrange

_CONTINUOUS_FAMILIES = {"Lagrange", "P", "CG"}
_DISCONTINUOUS_FAMILIES = {"DG", "Discontinuous Lagrange"}


@dataclass(frozen=True)
class FiniteElement:
    """Scalar Lagrange element on a simplex cell.

    Attributes:
        family: "Lagrange" (continuous) or "DG" (discontinuous)
        cell: "interval" | "triangle" | "tetrahedron"
        degree: polynomial degree (>= 1 for Lagrange, >= 0 for DG)
        variant: "gll_warped" (default, matching the reference) or "equispaced"
    """

    family: str
    cell: str
    degree: int
    variant: str = "gll_warped"

    def __post_init__(self):
        if self.family in _CONTINUOUS_FAMILIES:
            object.__setattr__(self, "family", "Lagrange")
            if self.degree < 1:
                raise ValueError("continuous Lagrange needs degree >= 1")
        elif self.family in _DISCONTINUOUS_FAMILIES:
            object.__setattr__(self, "family", "DG")
        else:
            raise ValueError(f"unsupported element family {self.family!r}")

    @property
    def continuous(self) -> bool:
        return self.family == "Lagrange"

    @property
    def dim(self) -> int:
        return cell_dim(self.cell)

    @property
    def nodes(self) -> np.ndarray:
        """Interpolation points on the reference cell, (ndofs, dim)."""
        return lagrange_nodes(self.cell, self.degree, self.variant)

    @property
    def ndofs(self) -> int:
        return self.nodes.shape[0]

    # alias matching dolfinx naming (demo/taylor_green.py:181)
    @property
    def interpolation_points(self) -> np.ndarray:
        return self.nodes

    def tabulate(self, points: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Basis values/gradients at unit-cell points: (nq, nd), (nq, dim, nd)."""
        if self.degree == 0:
            points = np.atleast_2d(points)
            phi = np.ones((points.shape[0], 1))
            dphi = np.zeros((points.shape[0], self.dim, 1))
            return phi, dphi
        return tabulate_lagrange(self.cell, self.degree, self.nodes, points)

    def quadrature(self, degree: int | None = None) -> tuple[np.ndarray, np.ndarray]:
        """Default quadrature for forms with two factors of this element."""
        if degree is None:
            degree = max(2 * self.degree, 1)
        return quadrature(self.cell, degree)


def make_element(
    spec: tuple[str, int] | FiniteElement, cell: str, variant: str = "gll_warped"
) -> FiniteElement:
    """Coerce an ("family", degree) tuple — the reference's public element API
    shape (fracstep.py:152-153) — into a FiniteElement on ``cell``."""
    if isinstance(spec, FiniteElement):
        return spec
    family, degree = spec
    return FiniteElement(family, cell, int(degree), variant)
