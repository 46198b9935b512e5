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


@pytest.mark.parametrize("cells, levels, plan, bars", [
    ((36,) * 3, 3, (1, 32), (11, 19)),   # bench.py's N=36: 50,653 / 6,859 / 1,000 points
    ((64,) * 3, 5, (2, 32), (17, 25)),   # N=64: level 1 has 35,937 points, over 1 a thread
    ((256, 256), 6, (2, 32), (17, 31)),  # 2D: 66,049 / 16,641 / 4,225 / ... / 81 points
], ids=["3d-36", "3d-64", "2d-256"])
def test_sub_group_plan(cells, levels, plan, bars):
    """The sub-group of K1's V-cycle: the first level below the finest with at
    most one point a thread of 32 blocks of 256, and the barriers of one
    iteration (nsmooth 2, coarse Chebyshev degree 14): the grid's, and the
    sub-group's; on the whole grid there would be their sum."""
    from oasisx_tpu_torch.la.pressure_mg import barriers, sub_group

    sizes = [int(np.prod(g)) for g in _mg_grids(cells)[:levels]]
    assert sub_group(sizes) == plan
    assert barriers(levels, plan[0], 2, 14) == bars
    assert barriers(levels, levels, 2, 14) == (sum(bars), 0)
