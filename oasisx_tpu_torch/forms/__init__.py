"""Expression layer (UFL-style names evaluated at quadrature points)."""

from . import expr

__all__ = ["expr"]
