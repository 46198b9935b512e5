"""oasisx_tpu_torch: the PyTorch and CUDA port of oasisx_tpu.

The IPCS solver (P2/P1 Taylor-Hood) on one device: the structured path
(``create_box`` meshes, hand-written CUDA kernels for the cube operators and
solves) and the general unstructured path (any simplex mesh, outlet
pressure conditions, hand-written CUDA kernels for the ELL operators and
solves), with the rotational pressure update and body forces.  A step runs
whole (``run``, ``solve``) or one phase at a time (the split-phase API:
``assemble_first``, ``velocity_tentative_assemble``,
``velocity_tentative_solve``, ``pressure_assemble``, ``pressure_solve``,
``velocity_update``, and ``tentative_matrix_dense``).  Also: L2 projection
(``Projector``, ``LumpedProject``), the expression layer of ``forms.expr``,
the surface traction of ``assembly.facets``, mesh import and export, VTU
output and checkpoints (``io``, whose checkpoints the JAX package reads and
writes too), the command line (``python -m oasisx_tpu_torch``, ``main``) and
the demos (``python -m oasisx_tpu_torch.demo.<name>``).  The structured path
also runs sharded in slabs over the ranks of a ``torch.distributed`` group
(``device_mesh``; ``parallel/``, ``python -m oasisx_tpu_torch.parallel.ranks``).
It imports neither jax nor oasisx_tpu; the JAX package stays the reference
its tests compare against.
"""

import logging

logger = logging.getLogger("oasisx_tpu_torch")

from . import io  # noqa: E402
from .bcs import DirichletBC, LocatorMethod, PressureBC  # noqa: E402
from .fracstep import FractionalStep_AB_CN  # noqa: E402
from .function import LumpedProject, Projector  # noqa: E402

__all__ = ["DirichletBC", "FractionalStep_AB_CN", "LocatorMethod", "LumpedProject",
           "PressureBC", "Projector", "io"]
