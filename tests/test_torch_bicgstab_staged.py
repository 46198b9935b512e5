"""K2's in-solve product, and K3's, in the order of their two phases
(``csrc/krylov_ops.cu``, ``csrc/cube_ops.cu``), on the CPU with NumPy and
torch alone:

- ``kernels.matvec_win_staged_plain`` (per cube, each output slot sums its
  input slots in order into a staged value; then each point sums its
  cubes' staged values in ``cube_visit``'s order) equals
  ``matvec_win_plain`` (one einsum over the cube, then the cube scatter) in
  float64 on the P2 N=4 cube, the 20x27x33 box and the 2D 41x57 rectangle,
  and on P1 and P3 3D grids, at batch 1-4, with and without the premul and
  zmask multipliers.  The two sum each cube's terms in another order, so
  they agree to 1e-13 of the output's largest value (a few ulps of a sum of
  27 or 64 products), not bit for bit;
- ``bicgstab_from_r0`` on the staged product takes the same iterations per
  row as on ``matvec_win_plain`` on the first tentative system of the N=4
  Taylor-Green problem in float64, x to 1e-12;
- K2's wrapper refuses a missing, short or mis-typed staging buffer before
  any launch.

The kernel runs only on the card; ``chip_smoke.py`` holds it to
``bicgstab_from_r0`` on ``matvec_win_plain`` there.
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

GRIDS = ((4, 4, 4), (20, 27, 33), (41, 57))
DEGREE_GRIDS = (((4, 4, 4), 1), ((3, 4, 5), 3))  # (cells, degree): the P1 and P3 cubes


def _sm(cells, deg=2):
    d = len(cells)
    mesh = (create_box((-1.0,) * 3, (1.0,) * 3, cells) if d == 3
            else create_rectangle((-1.0,) * 2, (1.0,) * 2, cells))
    el = make_element(("Lagrange", deg), mesh.cell_type)
    return build_structured_map(mesh, el, FunctionSpace(mesh, el).dofmap)[0]


@pytest.fixture(scope="module")
def maps():
    """The P2 maps by their cells, the others by (cells, degree)."""
    return {**{cells: _sm(cells) for cells in GRIDS}, **{g: _sm(*g) for g in DEGREE_GRIDS}}


@pytest.mark.parametrize("mult", ["none", "premul", "zmask", "both"])
@pytest.mark.parametrize("batch", [1, 3, 2, 4])
@pytest.mark.parametrize("cells", GRIDS + DEGREE_GRIDS)
def test_staged_product_equals_plain(maps, cells, batch, mult):
    sm = maps[cells]
    rng = np.random.default_rng(int(np.hstack(cells).sum()) + batch)
    nl, nc, npad = cub.num_slots(sm), int(np.prod(sm[1])), int(np.prod(sm[0]))
    t = lambda *shape: torch.as_tensor(rng.standard_normal(shape))
    W, x = t(nl * nl, nc), t(batch, npad)
    pm = t(batch, npad) if mult in ("premul", "both") else None
    zm = (torch.as_tensor(rng.random((batch, npad)) > 0.2).double()
          if mult in ("zmask", "both") else None)
    ref = kn.matvec_win_plain(W, x, sm, premul=pm, zmask=zm)
    got = kn.matvec_win_staged_plain(W, x, sm, premul=pm, zmask=zm)
    assert got.shape == ref.shape == (batch, npad)
    assert float((got - ref).abs().max()) <= 1e-13 * float(ref.abs().max())


def test_bicgstab_on_staged_product_same_iterations():
    """The first tentative solve at N=4 (chip_smoke's K2 case) in float64."""
    s = cs.tgv_solver(4, torch.float64, "cpu", 1e-8)
    st = s._state_from_functions()
    W, uq, b_first = s._assemble_first(st["u1"], st["u2"], cs.DT, cs.NU)
    tdiag = s._tentative_diag(W, uq, cs.DT, cs.NU)
    bc, masks, zmask = s._bc_values(), s._bc_masks, s._zmask
    rhs = torch.where(masks, bc, b_first)
    x0 = torch.where(masks, bc, 2.0 * st["u1"] - st["u2"])
    sm = s._sm_v
    r0 = zmask * rhs - kn.matvec_win_plain(W, x0, sm, zmask=zmask)
    args = (r0, x0, zmask, torch.where(tdiag != 0, 1.0 / tdiag, 1.0),
            torch.linalg.vector_norm(rhs, dim=-1), 1e-8, 2000)
    ref = fused.bicgstab_from_r0(lambda v: kn.matvec_win_plain(W, v, sm), *args)
    got = fused.bicgstab_from_r0(lambda v: kn.matvec_win_staged_plain(W, v, sm), *args)
    assert bool(ref.converged.all()) and bool(got.converged.all())
    assert ref.iters.tolist() == got.iters.tolist() and int(ref.iters.max()) >= 3
    assert float((got.x - ref.x).abs().max()) <= 1e-12 * float(ref.x.abs().max())


@pytest.mark.parametrize("bad", ["none", "short", "int32", "float32", "flat"])
def test_wrapper_refuses_bad_stage(maps, bad):
    """``_bicgstab_kernel`` checks the staging buffer before it loads or
    launches anything, so CPU tensors show the refusal."""
    sm = maps[(4, 4, 4)]
    B, nl, nc, npad = 3, cub.num_slots(sm), int(np.prod(sm[1])), int(np.prod(sm[0]))
    z = torch.zeros((B, npad), dtype=torch.float64)
    W = torch.zeros((nl * nl, nc), dtype=torch.float64)
    stage = {"none": None, "short": torch.zeros((B, nl, nc - 1), dtype=torch.float64),
             "int32": torch.zeros((B, nl, nc), dtype=torch.int32),
             "float32": torch.zeros((B, nl, nc), dtype=torch.float32),
             "flat": torch.zeros(B * nl * nc, dtype=torch.float64)}[bad]
    with pytest.raises((TypeError, ValueError), match="stage"):
        fused._bicgstab_kernel(W, stage, z, z, z, torch.ones(npad, dtype=torch.float64),
                               torch.ones(B, dtype=torch.float64), sm, 1e-8, 5, 1e-50)
    kn._check_stage(torch.zeros((B, nl, nc), dtype=torch.float64), B, nl, nc, torch.float64)
