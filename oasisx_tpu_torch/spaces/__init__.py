"""Function spaces and dofmaps (host-side setup)."""

from .dofmap import DofMap, build_dofmap, entity_closure_dofs
from .functionspace import Constant, Function, FunctionSpace, SubSpace

__all__ = [
    "DofMap",
    "build_dofmap",
    "entity_closure_dofs",
    "Constant",
    "Function",
    "FunctionSpace",
    "SubSpace",
]
