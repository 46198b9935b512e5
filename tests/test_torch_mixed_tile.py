"""K6's and K7's block-tiled products on the P2/P1 pair (``csrc/cube_device.cuh``
``tile_mixed``) on the CPU, with NumPy and torch alone:

- ``kernels.mixed_staged_plain`` (per cube, each output slot of each
  component sums the cube's P1 inputs in slot order; then each velocity
  point sums its cubes' staged values in ``cube_visit``'s order) equals
  ``mixed_plain``, and ``kernels.divergence_staged_plain`` (per cube, each
  P1 output slot sums the components in order and, in each, the P2 input
  slots in order; then each pressure point sums its cubes) equals
  ``divergence_plain``, in float64 to 1e-12 of the output's largest value,
  on 3D boxes with unequal axes, on 2D rectangles and on grids smaller than
  a tile (3 x 7 x 7 base points in 3D, 15 x 15 in 2D), with B_c, G_c and a
  random C_all.  The two may sum a cube's terms in another order, so they
  agree to rounding, not bit for bit;
- the same on the other degree pairs the structured map builds (P1/P1 and
  P3/P2 in 3D and 2D), which the card runs point by point;
- ``chip_smoke.py``'s K6/K7 sweep runs on the CPU on its two small grids,
  every kernel call against its plain and staged plain calls.

The kernels, their tile (chosen by the entry points, ``tile_pick``) and
their routes run only on the card; ``chip_smoke.py`` holds them to their
plain versions there and prints each route.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import chip_smoke as cs  # noqa: E402
from oasisx_tpu_torch.assembly import cubes as cub  # noqa: E402
from oasisx_tpu_torch.assembly import kernels as kn  # noqa: E402

# unequal axes; (2, 1, 3) and (1, 4) are smaller than one tile on every axis
GRIDS = ((3, 4, 5), (2, 1, 3), (5, 7), (1, 4))
MATRICES = ("B_c", "G_c", "random")


@pytest.fixture(scope="module")
def solvers():
    return {cells: cs.tgv_solver(cells, torch.float64, "cpu", 1e-8) for cells in GRIDS}


def _matrix(s, which, rng):
    if which == "random":
        return torch.as_tensor(rng.standard_normal(tuple(s._cu.B_c.shape)))
    return getattr(s._cu, which)


def _close(got, ref):
    assert got.shape == ref.shape and got.dtype == ref.dtype
    assert float((got - ref).abs().max()) <= 1e-12 * float(ref.abs().max())


@pytest.mark.parametrize("which", MATRICES)
@pytest.mark.parametrize("cells", GRIDS)
def test_mixed_staged_equals_plain(solvers, cells, which):
    s = solvers[cells]
    rng = np.random.default_rng(sum(cells))
    C = _matrix(s, which, rng)
    p = torch.as_tensor(rng.standard_normal(s._npad_q))
    ref = kn.mixed_plain(p, C, s._sm_v, s._sm_q)
    assert ref.shape == (len(cells), s._npad_v)
    _close(kn.mixed_staged_plain(p, C, s._sm_v, s._sm_q), ref)


@pytest.mark.parametrize("which", MATRICES)
@pytest.mark.parametrize("cells", GRIDS)
def test_divergence_staged_equals_plain(solvers, cells, which):
    s = solvers[cells]
    rng = np.random.default_rng(sum(cells) + 1)
    C = _matrix(s, which, rng)
    valid = s._pv(torch.ones(s._gf_v.shape[0], dtype=torch.float64)) != 0
    u = torch.as_tensor(rng.standard_normal((len(cells), s._npad_v))) * valid
    ref = kn.divergence_plain(u, C, s._sm_v, s._sm_q)
    assert ref.shape == (s._npad_q,)
    _close(kn.divergence_staged_plain(u, C, s._sm_v, s._sm_q), ref)


@pytest.mark.parametrize("pair", [(1, 1), (3, 2)])
@pytest.mark.parametrize("cells", [(3, 2, 4), (4, 3)])
def test_other_degree_pairs_staged_equals_plain(cells, pair):
    sm_v, sm_q = (cs.sweep_map(cells, deg, "cpu")[0] for deg in pair)
    d = len(cells)
    rng = np.random.default_rng(d + pair[0])
    C = torch.as_tensor(rng.standard_normal((d, cub.num_slots(sm_v), cub.num_slots(sm_q))))
    p = torch.as_tensor(rng.standard_normal(int(np.prod(sm_q[0]))))
    u = torch.as_tensor(rng.standard_normal((d, int(np.prod(sm_v[0])))))
    _close(kn.mixed_staged_plain(p, C, sm_v, sm_q), kn.mixed_plain(p, C, sm_v, sm_q))
    _close(kn.divergence_staged_plain(u, C, sm_v, sm_q), kn.divergence_plain(u, C, sm_v, sm_q))


def test_chip_smoke_mixed_sweep():
    grids = cs.MIXED_SWEEP[:2]
    assert [len(cells) for cells, _ in cs.MIXED_SWEEP] == [3, 2, 3, 2]
    assert all(pairs == cs.MIXED_PAIRS for _, pairs in cs.MIXED_SWEEP)
    cases = cs.mixed_sweep_cases("cpu", grids)
    assert sorted({(c[0], c[1]) for c in cases}) == sorted(
        (k, f"{d}D P{v}/P{q} {g}") for k in ("mixed", "divergence")
        for d, g in ((3, "5x6x7"), (2, "9x11")) for v, q in cs.MIXED_PAIRS)
    assert {c[3] for c in cases} == {torch.float64, torch.float32}
    cs.check_mixed_sweep("cpu", grids)
