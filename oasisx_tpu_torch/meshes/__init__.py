"""Mesh layer: simplex meshes, generators, tags (host-side, NumPy)."""

from .generation import (
    create_box,
    create_cylinder_channel,
    create_interval,
    create_rectangle,
    create_unit_cube,
    create_unit_square,
)
from .mesh import CELL_FACETS, Mesh, Topology
from .tags import MeshTags, locate_entities, locate_entities_boundary, meshtags

__all__ = [
    "Mesh",
    "Topology",
    "MeshTags",
    "CELL_FACETS",
    "create_box",
    "create_cylinder_channel",
    "create_interval",
    "create_rectangle",
    "create_unit_cube",
    "create_unit_square",
    "meshtags",
    "locate_entities",
    "locate_entities_boundary",
]
