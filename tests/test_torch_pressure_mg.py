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
