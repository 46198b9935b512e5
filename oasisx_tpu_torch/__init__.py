"""oasisx_tpu_torch: the PyTorch and CUDA port of oasisx_tpu.

The single-device IPCS solver (P2/P1 Taylor-Hood): the structured path
(``create_box`` meshes, hand-written CUDA kernels for the cube operators and
solves) and the general unstructured path (any simplex mesh, outlet
pressure conditions, hand-written CUDA kernels for the ELL operators and
solves), with the rotational pressure update and body forces; L2
projection (``Projector``, ``LumpedProject``), the expression layer of
``forms.expr`` and the surface traction of ``assembly.facets``.
It imports neither jax nor oasisx_tpu; the JAX package stays the reference
its tests compare against.
"""

import logging

logger = logging.getLogger("oasisx_tpu_torch")

from .bcs import DirichletBC, LocatorMethod, PressureBC  # noqa: E402
from .fracstep import FractionalStep_AB_CN  # noqa: E402
from .function import LumpedProject, Projector  # noqa: E402

__all__ = ["DirichletBC", "FractionalStep_AB_CN", "LocatorMethod", "LumpedProject",
           "PressureBC", "Projector"]
