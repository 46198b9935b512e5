"""Reference-element layer: tabulation, nodes, quadrature (host-side setup)."""

from .element import FiniteElement, make_element
from .nodes import lagrange_nodes
from .quadrature import quadrature
from .tabulation import cell_dim, num_modes, tabulate_lagrange

__all__ = [
    "FiniteElement",
    "make_element",
    "lagrange_nodes",
    "quadrature",
    "cell_dim",
    "num_modes",
    "tabulate_lagrange",
]
