"""The P1 stencil tile's product (``csrc/cube_device.cuh``: K1's non-MG
modes and K4's P1 route) on the CPU, with NumPy and torch alone:

- ``kernels.matvec_stencil_plain`` (each point adds its 3^d neighbours
  times its class's coefficients, ``kernels.stencil_table``) equals
  ``matvec_const_plain`` in float64 on 3D boxes and 2D rectangles whose
  axes differ, one cell thick on some axis, at batch 1 and 3, for a random
  nonsymmetric cube matrix: to 1e-12 of the output's largest value (the two
  sum in other orders);
- the coefficients of a class are the sums of C's entries over the cubes
  that exist for it: an interior point's centre is the trace of C, a
  corner's C's corner entry;
- K1's plain version and K4's take the same iterations on the stencil
  product as on ``matvec_const_plain`` (Taylor-Green N=4, float64), x to
  1e-12.

The kernels run only on the card; ``chip_smoke.py`` holds them to their
plain versions there.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import chip_smoke as cs  # noqa: E402
from oasisx_tpu_torch.assembly import cubes as cub  # noqa: E402
from oasisx_tpu_torch.assembly import kernels as kn  # noqa: E402
from oasisx_tpu_torch.la import fused  # noqa: E402
from oasisx_tpu_torch.la.pressure_cg import PressureCG  # noqa: E402

GRIDS = ((3, 4, 5), (2, 1, 3), (1, 1, 1), (5, 7), (1, 4))


@pytest.fixture(scope="module")
def maps():
    return {cells: cs.sweep_map(cells, 1, "cpu")[0] for cells in GRIDS}


@pytest.mark.parametrize("batch", [1, 3])
@pytest.mark.parametrize("cells", GRIDS)
def test_stencil_product_equals_plain(maps, cells, batch):
    sm = maps[cells]
    rng = np.random.default_rng(sum(cells) + 7 * batch)
    nl, npad = cub.num_slots(sm), int(np.prod(sm[0]))
    C = torch.as_tensor(rng.standard_normal((nl, nl)))
    x = torch.as_tensor(rng.standard_normal((batch, npad)))
    y = kn.matvec_stencil_plain(x, C, sm)
    ref = kn.matvec_const_plain(x, C, sm)
    assert y.shape == ref.shape
    assert float((y - ref).abs().max()) <= 1e-12 * float(ref.abs().max())


@pytest.mark.parametrize("d", [2, 3])
def test_stencil_table_classes(d):
    rng = np.random.default_rng(d)
    C = torch.as_tensor(rng.standard_normal((2 ** d, 2 ** d)))
    S = kn.stencil_table(C, d)
    interior, centre = (3 ** d - 1) // 2, (3 ** d - 1) // 2  # class 1...1, offset 0...0
    assert S.shape == (3 ** d, 3 ** d)
    assert abs(float(S[interior, centre] - torch.trace(C))) <= 1e-14 * float(C.abs().sum())
    # the low corner (class 0...0) lies in one cube, as its slot 0
    assert float(S[0, centre]) == float(C[0, 0])
    assert float(S[0, 3 ** d - 1]) == float(C[0, 2 ** d - 1])  # offset +1...+1: slot 2^d - 1
    assert float(S[0, 0]) == 0.0  # offset -1...-1: outside the grid


@pytest.mark.parametrize("degree", [0, 4])
def test_pressure_cg_on_stencil_same_iterations(degree):
    s = cs.tgv_solver(4, torch.float64, "cpu", 1e-8)
    sm_q, Ap = s._sm_q, s._cu.Ap_c
    invd = s._pcg.invd if s._pcg is not None else None
    if invd is None:
        dg = cub.diag_cube(Ap, sm_q)
        invd = torch.where(dg != 0, 1.0 / dg, torch.ones_like(dg))
    rng = np.random.default_rng(3)
    b = torch.as_tensor(rng.standard_normal(s._npad_q))
    x0 = torch.zeros_like(b)
    pcg = PressureCG(sm_q, Ap, invd, 1e-10, 500, degree, 0.05, 2.2 if degree else 0.0)
    ref = pcg.solve_plain(b, x0, matvec=kn.matvec_const_plain)
    got = pcg.solve_plain(b, x0, matvec=kn.matvec_stencil_plain)
    assert bool(ref.converged) and bool(got.converged)
    assert int(ref.iters) == int(got.iters) and int(ref.iters) >= 5
    assert float((got.x - ref.x).abs().max()) <= 1e-12 * float(ref.x.abs().max())


@pytest.mark.parametrize("batch", [1, 3])
def test_cg_mass_on_stencil_same_iterations(batch):
    s = cs.tgv_solver(4, torch.float64, "cpu", 1e-8)
    sm_q, Mq = s._sm_q, s._cu.Mq_c
    dg = cub.diag_cube(Mq, sm_q)
    invd = torch.where(dg != 0, 1.0 / dg, torch.ones_like(dg))
    rng = np.random.default_rng(5 + batch)
    b = torch.as_tensor(rng.standard_normal((batch, s._npad_q)))
    x0 = torch.zeros_like(b)
    bn = torch.linalg.vector_norm(b, dim=-1)
    ref = fused.cg_from_r0(lambda v: kn.matvec_const_plain(v, Mq, sm_q), b, x0, invd, bn,
                           1e-10, 200)
    got = fused.cg_from_r0(lambda v: kn.matvec_stencil_plain(v, Mq, sm_q), b, x0, invd, bn,
                           1e-10, 200)
    assert bool(ref.converged.all()) and bool(got.converged.all())
    assert ref.iters.tolist() == got.iters.tolist() and int(ref.iters.min()) >= 5
    assert float((got.x - ref.x).abs().max()) <= 1e-12 * float(ref.x.abs().max())
