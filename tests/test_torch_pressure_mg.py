"""The port's MG-preconditioned pressure CG against the JAX package's
whole-solve kernel ``make_pressure_cg(..., mg=build_pressure_mg_data(...))``
in interpret mode, float64, on grids that coarsen: equal iteration counts
and x to 1e-8 relative."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from oasisx_tpu.assembly import pallas_ops as po  # noqa: E402
from oasisx_tpu_torch.assembly import cubes as tcub  # noqa: E402
from oasisx_tpu_torch.assembly import kernels as kn  # noqa: E402
from oasisx_tpu_torch.la.pressure_mg import PressureMGCG  # noqa: E402
from tests.test_torch_kernels import _both  # noqa: E402


@pytest.mark.parametrize("cells", [(12, 12), (6, 6, 6)], ids=["2d-12", "3d-6"])
def test_pressure_mg_cg_matches_kernel(cells):
    jops, tops, _, (sm_q, _, valid_q) = _both(cells)
    assert valid_q.all()
    Ap = np.asarray(jops.Ap_c)
    mg_j = po.build_pressure_mg_data(sm_q, Ap)
    mg_t = kn.build_pressure_mg_data(sm_q, Ap)
    assert len(mg_t["levels"]) == len(mg_j["levels"]) >= 2
    assert mg_t["coarse"] == mg_j["coarse"]
    diag = tcub.diag_cube(tops.Ap_c, sm_q).numpy()
    invd = np.where(diag != 0, 1.0 / np.where(diag != 0, diag, 1.0), 1.0)

    rng = np.random.default_rng(7)
    n = valid_q.size
    b = rng.standard_normal(n)
    x0 = rng.standard_normal(n)
    rtol, maxiter = 1e-10, 200
    solve = po.make_pressure_cg(sm_q, Ap, invd, rtol=rtol, maxiter=maxiter, mg=mg_j,
                                interpret=True)
    xj, itj, rj, cj = solve(jnp.asarray(b), jnp.asarray(x0))
    res = PressureMGCG(sm_q, tops.Ap_c, invd, mg_t, rtol, maxiter).solve(
        torch.tensor(b), torch.tensor(x0)
    )
    assert bool(cj) and bool(res.converged)
    assert int(res.iters) == int(itj)
    xj = np.asarray(xj)
    assert np.abs(res.x.numpy() - xj).max() <= 1e-8 * np.abs(xj).max()
    # the solve is right on its own terms: demeaned, small true residual
    x = res.x
    assert abs(float(x.mean())) < 1e-12
    r = (b - b.mean()) - kn.matvec_const(x, tops.Ap_c, sm_q).numpy()
    assert np.linalg.norm(r - r.mean()) <= 2 * rtol * np.linalg.norm(b - b.mean())


def test_pressure_mg_explicit_level_operator():
    """``solve_plain`` with the level operator passed explicitly (the plain
    cube matvec, counted) applies it on every level and agrees with
    make_pressure_cg in interpret mode as the default route does (2D, 12
    cells, 3 levels; equal iterations, x to 1e-8 relative)."""
    jops, tops, _, (sm_q, _, _) = _both((12, 12))
    Ap = np.asarray(jops.Ap_c)
    mg_t = kn.build_pressure_mg_data(sm_q, Ap)
    diag = tcub.diag_cube(tops.Ap_c, sm_q).numpy()
    invd = np.where(diag != 0, 1.0 / np.where(diag != 0, diag, 1.0), 1.0)
    rng = np.random.default_rng(8)
    b = rng.standard_normal(diag.size)
    x0 = np.zeros_like(b)
    rtol, maxiter = 1e-10, 200
    solve = po.make_pressure_cg(sm_q, Ap, invd, rtol=rtol, maxiter=maxiter,
                                mg=po.build_pressure_mg_data(sm_q, Ap), interpret=True)
    xj, itj, _, _ = solve(jnp.asarray(b), jnp.asarray(x0))

    grids = []

    def level_op(x, C, sm):
        grids.append(sm[1])
        return kn.matvec_const_plain(x, C, sm)

    pcg = PressureMGCG(sm_q, tops.Ap_c, invd, mg_t, rtol, maxiter)
    res = pcg.solve_plain(torch.tensor(b), torch.tensor(x0), matvec=level_op)
    assert bool(res.converged) and int(res.iters) == int(itj)
    assert {tuple(c) for c in grids} == {tuple(lv["cells"]) for lv in mg_t["levels"]}
    xj = np.asarray(xj)
    assert np.abs(res.x.numpy() - xj).max() <= 1e-8 * np.abs(xj).max()
    ref = pcg.solve(torch.tensor(b), torch.tensor(x0))
    assert torch.equal(ref.x, res.x) and int(ref.iters) == int(res.iters)


def _fast_div(d: int) -> tuple[int, int]:
    """The multiply-and-shift constants of ``fast_div`` (csrc/cube_device.cuh):
    n / d = (n m) >> s for 0 <= n < 2^31."""
    s = 31 + max(d - 1, 0).bit_length()
    return -(-(1 << s) // d), s


def _mg_grids(cells: tuple) -> list[tuple]:
    """K1's level grids (points per axis, 3D form) as pressure_mg_launch makes
    them: the cells halved per level down to one cell an axis."""
    cells, out = list(cells), []
    while min(cells) >= 1:
        g = tuple(c + 1 for c in cells)
        out.append(g if len(g) == 3 else (1, *g))
        cells = [c // 2 for c in cells]
    return out


def test_coords_split_exact():
    """K1's transfers split a level point idx into (c0, c1, c2) by two
    multiply-and-shift divisions, by g2 and then by g1: exact for every point
    of every level of every 3D grid up to N=64 (even N, and the 20x27x33
    box whose axes differ) and of 2D grids up to 256 cells an axis."""
    shapes = [(N,) * 3 for N in range(2, 65, 2)] + [(20, 27, 33)]
    shapes += [(N, N) for N in range(2, 257, 2)] + [(41, 57)]
    grids = {g for c in shapes for g in _mg_grids(c)}
    assert (1, 129, 129) in grids and (65, 65, 65) in grids
    for g in sorted(grids):
        (m2, s2), (m1, s1) = _fast_div(g[2]), _fast_div(g[1])
        assert m1 < 2**32 and m2 < 2**32
        idx = np.arange(g[0] * g[1] * g[2], dtype=np.uint64)
        q = (idx * np.uint64(m2)) >> np.uint64(s2)
        c0 = (q * np.uint64(m1)) >> np.uint64(s1)
        c2, c1 = idx - q * np.uint64(g[2]), q - c0 * np.uint64(g[1])
        want = np.unravel_index(idx.astype(np.int64), g)
        for got, ref in zip((c0, c1, c2), want):
            np.testing.assert_array_equal(got.astype(np.int64), ref)


# K1 MG's plan mirror (la/pressure_mg.py mg_teams, barriers): per case
# (cells, levels, nsmooth, coarse Chebyshev degree, block_from, teams
# (sub_level, block_level, 32), barriers an iteration (grid, sub-group,
# block)).  Points a level: N=36 50,653 / 6,859 / 1,000 (the coarsest on
# block 0); N=64 274,625 / 35,937 / 4,913 / 729 / 125 (level 1 over one
# point a thread of the sub-group, levels 3-4 on block 0); 256^2 66,049 /
# 16,641 / 4,225 / 1,089 / 289 / 81 (/ 25); 66x98 6,633 / 1,700, N=44
# 91,125 / 12,167 / 1,728 (no level on block 0: the coarsest on the
# sub-group); N=50 132,651 / 17,576 (every level on the whole grid);
# 2d-4096's first level of 8,192 points or fewer is its sixth, past the
# STENCIL_LEVELS levels on the whole grid.  "block-from" rows: the plan
# moved block 0 coarser (or to none) for shared memory.
PLAN_ROWS = {
    "3d-36": ((36, 36, 36), 3, 2, 14, 1, (1, 2, 32), (6, 6, 13)),
    "3d-36-ns1-deg1": ((36, 36, 36), 3, 1, 1, 1, (1, 2, 32), (4, 4, 0)),
    "3d-36-ns3-deg2": ((36, 36, 36), 3, 3, 2, 1, (1, 2, 32), (8, 8, 1)),
    "3d-64": ((64, 64, 64), 5, 2, 14, 1, (2, 3, 32), (11, 6, 19)),
    "3d-64-ns1-deg1": ((64, 64, 64), 5, 1, 1, 1, (2, 3, 32), (7, 4, 4)),
    "3d-64-ns3-deg2": ((64, 64, 64), 5, 3, 2, 1, (2, 3, 32), (15, 8, 9)),
    "2d-256": ((256, 256), 6, 2, 14, 1, (2, 4, 32), (11, 12, 19)),
    "2d-256-ns1-deg1": ((256, 256), 6, 1, 1, 1, (2, 4, 32), (7, 8, 4)),
    "2d-256-ns3-deg2": ((256, 256), 6, 3, 2, 1, (2, 4, 32), (15, 16, 9)),
    "2d-256-7lv": ((256, 256), 7, 2, 14, 1, (2, 4, 32), (11, 12, 25)),
    "2d-256-7lv-ns1-deg1": ((256, 256), 7, 1, 1, 1, (2, 4, 32), (7, 8, 8)),
    "2d-256-7lv-ns3-deg2": ((256, 256), 7, 3, 2, 1, (2, 4, 32), (15, 16, 17)),
    "3d-16x24x32": ((16, 24, 32), 3, 2, 14, 1, (1, 2, 32), (6, 6, 13)),
    "3d-16x24x32-ns1-deg1": ((16, 24, 32), 3, 1, 1, 1, (1, 2, 32), (4, 4, 0)),
    "3d-16x24x32-ns3-deg2": ((16, 24, 32), 3, 3, 2, 1, (1, 2, 32), (8, 8, 1)),
    "2d-48x64": ((48, 64), 5, 2, 14, 1, (1, 1, 32), (6, 0, 31)),
    "2d-48x64-ns1-deg1": ((48, 64), 5, 1, 1, 1, (1, 1, 32), (4, 0, 12)),
    "2d-48x64-ns3-deg2": ((48, 64), 5, 3, 2, 1, (1, 1, 32), (8, 0, 25)),
    "3d-12": ((12, 12, 12), 3, 2, 14, 1, (1, 1, 32), (6, 0, 19)),
    "3d-12-ns1-deg1": ((12, 12, 12), 3, 1, 1, 1, (1, 1, 32), (4, 0, 4)),
    "3d-12-ns3-deg2": ((12, 12, 12), 3, 3, 2, 1, (1, 1, 32), (8, 0, 9)),
    "2d-8": ((8, 8), 2, 2, 14, 1, (1, 1, 32), (6, 0, 13)),
    "2d-8-ns1-deg1": ((8, 8), 2, 1, 1, 1, (1, 1, 32), (4, 0, 0)),
    "2d-8-ns3-deg2": ((8, 8), 2, 3, 2, 1, (1, 1, 32), (8, 0, 1)),
    "2d-512": ((512, 512), 8, 2, 14, 1, (3, 5, 32), (16, 12, 25)),
    "2d-512-ns1-deg1": ((512, 512), 8, 1, 1, 1, (3, 5, 32), (10, 8, 8)),
    "2d-512-ns3-deg2": ((512, 512), 8, 3, 2, 1, (3, 5, 32), (22, 16, 17)),
    "3d-128": ((128, 128, 128), 6, 2, 14, 1, (3, 4, 32), (16, 6, 19)),
    "3d-128-ns1-deg1": ((128, 128, 128), 6, 1, 1, 1, (3, 4, 32), (10, 4, 4)),
    "3d-128-ns3-deg2": ((128, 128, 128), 6, 3, 2, 1, (3, 4, 32), (22, 8, 9)),
    "2d-4096": ((4096, 4096), 11, 2, 14, 1, (4, 8, 32), (21, 24, 25)),
    "2d-4096-ns1-deg1": ((4096, 4096), 11, 1, 1, 1, (4, 8, 32), (13, 16, 8)),
    "2d-4096-ns3-deg2": ((4096, 4096), 11, 3, 2, 1, (4, 8, 32), (29, 32, 17)),
    "2d-66x98": ((66, 98), 2, 2, 14, 1, (1, 2, 32), (6, 13, 0)),
    "2d-66x98-ns1-deg1": ((66, 98), 2, 1, 1, 1, (1, 2, 32), (4, 0, 0)),
    "2d-66x98-ns3-deg2": ((66, 98), 2, 3, 2, 1, (1, 2, 32), (8, 1, 0)),
    "3d-44": ((44, 44, 44), 3, 2, 14, 1, (2, 3, 32), (11, 13, 0)),
    "3d-44-ns1-deg1": ((44, 44, 44), 3, 1, 1, 1, (2, 3, 32), (7, 0, 0)),
    "3d-44-ns3-deg2": ((44, 44, 44), 3, 3, 2, 1, (2, 3, 32), (15, 1, 0)),
    "3d-50": ((50, 50, 50), 2, 2, 14, 1, (2, 2, 32), (19, 0, 0)),
    "3d-50-ns1-deg1": ((50, 50, 50), 2, 1, 1, 1, (2, 2, 32), (4, 0, 0)),
    "3d-50-ns3-deg2": ((50, 50, 50), 2, 3, 2, 1, (2, 2, 32), (9, 0, 0)),
    "3d-36-block-from-3": ((36, 36, 36), 3, 2, 14, 3, (1, 3, 32), (6, 19, 0)),
    "3d-64-block-from-4": ((64, 64, 64), 5, 2, 14, 4, (2, 4, 32), (11, 12, 13)),
    "3d-64-block-from-5": ((64, 64, 64), 5, 2, 14, 5, (2, 5, 32), (11, 25, 0)),
    "2d-256-block-from-5": ((256, 256), 6, 2, 14, 5, (2, 5, 32), (11, 18, 13)),
}


@pytest.mark.parametrize("cells, levels, nsmooth, degree, block_from, plan, bars",
                         list(PLAN_ROWS.values()), ids=list(PLAN_ROWS))
def test_sub_group_plan(cells, levels, nsmooth, degree, block_from, plan, bars):
    """The teams of K1's V-cycle: the sub-group from the first level below
    the finest with at most one point a thread of 32 blocks of 256 (at most
    block 0's level and after at most STENCIL_LEVELS levels on the whole
    grid), block 0 from the first level from ``block_from`` with at most 4
    points a thread of one block; and the barriers of one iteration: the
    grid's, the sub-group's and block 0's; on the whole grid there would be
    their sum less the prolongation phase of each level from the
    sub-group's first to the one above the coarsest (on the grid it rides
    on a sweep)."""
    from oasisx_tpu_torch.la import pressure_mg as pm

    sizes = [int(np.prod(g)) for g in _mg_grids(cells)[:levels]]
    lsub, lblk, blocks = pm.mg_teams(sizes, block_from=block_from)
    assert (lsub, lblk, blocks) == plan
    block_cap, sub_cap = pm.BLOCK_POINTS * 256, pm.SUB_POINTS * 256 * pm.SUB_BLOCKS
    assert all(n > block_cap for n in sizes[block_from:lblk])
    assert all(n <= block_cap for n in sizes[lblk:])
    first_sub = next((lv for lv in range(1, levels) if sizes[lv] <= sub_cap), levels)
    assert lsub == min(first_sub, lblk, pm.STENCIL_LEVELS)
    assert pm.barriers(levels, lsub, lblk, nsmooth, degree) == bars
    assert pm.barriers(levels, levels, levels, nsmooth, degree) == (
        sum(bars) - max(levels - 1 - lsub, 0), 0, 0)
