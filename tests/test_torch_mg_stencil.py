"""K1's MG mode on the CPU, with NumPy and torch alone.

``PressureMGCG.solve_plain`` with every level's product summed in the P1
stencil's order (``kernels.matvec_stencil_plain``, the order of the
kernel's products on the levels that run on the stencil tile) takes the
same iterations as on ``matvec_const_plain`` and agrees to 1e-12, in
float64 on a 2D 12x24 rectangle and a 3D 12x12x12 box (3 levels each).

The kernel runs only on the card; ``chip_smoke.py`` holds it to its plain
version there and its plan (``oasisx_pressure_mg_plan``) to the plain
mirror, whose rows ``test_torch_pressure_mg.py::test_sub_group_plan``
checks.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from oasisx_tpu_torch.assembly import cubes as tcub  # noqa: E402
from oasisx_tpu_torch.assembly import kernels as kn  # noqa: E402
from oasisx_tpu_torch.assembly.reference_tensors import build_reference_tensors  # noqa: E402
from oasisx_tpu_torch.assembly.structured import build_structured_map  # noqa: E402
from oasisx_tpu_torch.elements.element import FiniteElement  # noqa: E402
from oasisx_tpu_torch.la import pressure_mg as pm  # noqa: E402
from oasisx_tpu_torch.meshes import create_box, create_rectangle  # noqa: E402
from oasisx_tpu_torch.spaces.functionspace import FunctionSpace  # noqa: E402


def _pressure_ops(cells):
    """The P1 pressure grid's structured map and Ap_c (float64) of the
    Taylor-Green mesh of ``cells`` on [-1, 1]^d."""
    d = len(cells)
    cell = "tetrahedron" if d == 3 else "triangle"
    mesh = (create_box((-1.0,) * 3, (1.0,) * 3, cells) if d == 3
            else create_rectangle((-1.0,) * 2, (1.0,) * 2, cells))
    el_u, el_p = FiniteElement("Lagrange", cell, 2), FiniteElement("Lagrange", cell, 1)
    V, Q = FunctionSpace(mesh, el_u), FunctionSpace(mesh, el_p)
    sm_v = build_structured_map(mesh, el_u, V.dofmap)[0]
    sm_q = build_structured_map(mesh, el_p, Q.dofmap)[0]
    ops = tcub.build_cube_ops(mesh, build_reference_tensors(el_u, el_p), sm_v, sm_q,
                              dtype=torch.float64, device="cpu")
    return sm_q, ops.Ap_c


@pytest.mark.parametrize("cells", [(12, 24), (12, 12, 12)], ids=["2d-12x24", "3d-12"])
def test_mg_plain_in_stencil_order(cells):
    sm_q, Ap = _pressure_ops(cells)
    mg = kn.build_pressure_mg_data(sm_q, Ap.numpy())
    assert len(mg["levels"]) == 3
    diag = tcub.diag_cube(Ap, sm_q).numpy()
    invd = np.where(diag != 0, 1.0 / np.where(diag != 0, diag, 1.0), 1.0)
    rng = np.random.default_rng(sum(cells))
    b = torch.as_tensor(rng.standard_normal(diag.size))
    x0 = torch.as_tensor(rng.standard_normal(diag.size))
    pcg = pm.PressureMGCG(sm_q, Ap, invd, mg, 1e-10, 200)
    ref = pcg.solve_plain(b, x0, matvec=kn.matvec_const_plain)
    got = pcg.solve_plain(b, x0, matvec=kn.matvec_stencil_plain)
    assert bool(ref.converged) and bool(got.converged)
    assert int(got.iters) == int(ref.iters) >= 4
    assert float((got.x - ref.x).abs().max()) <= 1e-12 * float(ref.x.abs().max())

