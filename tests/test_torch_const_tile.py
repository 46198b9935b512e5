"""K5's and K4's block-tiled P2 product (``csrc/cube_device.cuh``
``tile_product``) on the CPU, with NumPy and torch alone:

- ``kernels.matvec_const_staged_plain`` (per cube, each output slot sums
  its input slots in order into a staged value; then each point sums its
  cubes' staged values in ``cube_visit``'s order) equals
  ``matvec_const_plain`` in float64 on 3D boxes with unequal axes and 2D
  rectangles, at batch 1-4.  The two may sum a cube's terms in another
  order, so they agree to 1e-12 of the output's largest value, not bit for
  bit;
- ``cg_from_r0`` on the staged product takes the same iterations per row
  as on ``matvec_const_plain`` on the N=4 Taylor-Green mass systems (3D and
  2D) in float64, x to 1e-12;
- ``chip_smoke.py``'s K4 cases, the P1 ones included (K4's stencil-tile
  route on the card), converge on the CPU with equal iterations in both
  solves.

The kernels and their tile (chosen by the entry points, ``tile_choose``)
run only on the card; ``chip_smoke.py`` holds them to their plain versions
there and checks the tile for every type and batch.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import chip_smoke as cs  # noqa: E402
from oasisx_tpu_torch.assembly import cubes as cub  # noqa: E402
from oasisx_tpu_torch.assembly import kernels as kn  # noqa: E402
from oasisx_tpu_torch.assembly.structured import build_structured_map  # noqa: E402
from oasisx_tpu_torch.elements.element import make_element  # noqa: E402
from oasisx_tpu_torch.la import fused  # noqa: E402
from oasisx_tpu_torch.meshes import create_box, create_rectangle  # noqa: E402
from oasisx_tpu_torch.spaces.functionspace import FunctionSpace  # noqa: E402

GRIDS = ((3, 4, 5), (2, 1, 3), (5, 7), (1, 4))


def _sm(cells):
    d = len(cells)
    mesh = (create_box((-1.0,) * 3, (1.0,) * 3, cells) if d == 3
            else create_rectangle((-1.0,) * 2, (1.0,) * 2, cells))
    el = make_element(("Lagrange", 2), mesh.cell_type)
    return build_structured_map(mesh, el, FunctionSpace(mesh, el).dofmap)[0]


@pytest.fixture(scope="module")
def maps():
    return {cells: _sm(cells) for cells in GRIDS}


@pytest.mark.parametrize("batch", [1, 2, 3, 4])
@pytest.mark.parametrize("cells", GRIDS)
def test_staged_product_equals_plain(maps, cells, batch):
    sm = maps[cells]
    rng = np.random.default_rng(sum(cells) + batch)
    nl, npad = cub.num_slots(sm), int(np.prod(sm[0]))
    C = torch.as_tensor(rng.standard_normal((nl, nl)))
    x = torch.as_tensor(rng.standard_normal((batch, npad)))
    ref = kn.matvec_const_plain(x, C, sm)
    got = kn.matvec_const_staged_plain(x, C, sm)
    assert got.shape == ref.shape == (batch, npad)
    assert float((got - ref).abs().max()) <= 1e-12 * float(ref.abs().max())
    one = kn.matvec_const_staged_plain(x[0], C, sm)  # a single vector keeps its shape
    assert one.shape == (npad,) and torch.equal(one, got[0])


@pytest.mark.parametrize("cells", [4, (4, 6)])
def test_cg_on_staged_product_same_iterations(cells):
    """The N=4 Taylor-Green mass system (chip_smoke's K4 case) in float64."""
    s = cs.tgv_solver(cells, torch.float64, "cpu", 1e-8)
    sm, M = s._sm_v, s._cu.M_c
    valid = s._pv(torch.ones(s._gf_v.shape[0], dtype=torch.float64)) != 0
    rng = np.random.default_rng(7)
    b = torch.as_tensor(rng.standard_normal((s._mesh.dim, s._npad_v))) * valid
    args = (b, torch.zeros_like(b), s._M_invd, torch.linalg.vector_norm(b, dim=-1), 1e-10, 2000)
    ref = fused.cg_from_r0(lambda v: kn.matvec_const_plain(v, M, sm), *args)
    got = fused.cg_from_r0(lambda v: kn.matvec_const_staged_plain(v, M, sm), *args)
    assert bool(ref.converged.all()) and bool(got.converged.all())
    assert ref.iters.tolist() == got.iters.tolist() and int(ref.iters.max()) >= 3
    assert float((got.x - ref.x).abs().max()) <= 1e-12 * float(ref.x.abs().max())


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_chip_smoke_mass_cases_converge(dtype):
    """chip_smoke's K4 cases on an N=6 solver (the MG case needs a grid that
    coarsens): the P2 mass at batch 3 and 1, the P1 mass on the pressure
    grid and the pressure mass Mq_c at batch 1 (the rotational update's
    solve), each solved twice by its plain version on the CPU."""
    s = cs.tgv_solver(6, torch.float64, "cpu", 1e-8)
    _, cases = cs.solve_cases(s, "cpu", dtype=dtype)
    mass = [c for c in cases if c[0] == "cg_mass"]
    assert [c[1] for c in mass] == ["M_c, random rhs", "M_c batch 1", "P1 mass", "Mq_c batch 1"]
    for _, label, kfn, pfn, work in mass:
        rk, rp = kfn(), pfn()
        assert bool(rk.converged.all()) and bool(rp.converged.all()), label
        assert rk.iters.tolist() == rp.iters.tolist() and int(rk.iters.min()) >= 3, label
        assert torch.equal(rk.x, rp.x), label
        nbytes, flops = work(rk)
        assert nbytes > 0 and flops > 0, label
