"""oasisx_tpu_torch: the PyTorch and CUDA port of oasisx_tpu.

The structured single-device IPCS path (3D Taylor-Green on ``create_box``,
P2/P1 Taylor-Hood) with hand-written CUDA kernels for the cube operators.
It imports neither jax nor oasisx_tpu; the JAX package stays the reference
its tests compare against.
"""

import logging

logger = logging.getLogger("oasisx_tpu_torch")

from .bcs import DirichletBC, LocatorMethod  # noqa: E402
from .fracstep import FractionalStep_AB_CN  # noqa: E402

__all__ = ["DirichletBC", "FractionalStep_AB_CN", "LocatorMethod"]
