"""The JAX package's N=64 size tier on the CPU, the solver side: the
port's K1 plain version on the tier's 5 MG levels, and the port's
structured path end to end against the JAX solver with the tier's
tentative solve.

- K1 with 5 levels (2D, 48 cells: 48 -> 24 -> 12 -> 6 -> 3, the level
  count of N=64 in 3D) against ``make_pressure_cg`` in interpret mode,
  float64: equal iterations, x to 1e-8 relative (the K1 test's bound).
- The structured path against the JAX solver with the HBM-state BiCGStab
  (``pallas_bicgstab_hbm``: K9 and K10, 3 ops an iteration) on the
  pallas-wiring recipe, float32, at the bounds the JAX package holds its
  own float32 engines to (5e-4 on u, 5e-3 on p).

The kernels' own comparisons are in tests/test_torch_size_tier.py."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

import oasisx_tpu as J  # noqa: E402
import oasisx_tpu.meshes as JM  # noqa: E402
import oasisx_tpu.spaces as JS  # noqa: E402
import oasisx_tpu_torch as T  # noqa: E402
import oasisx_tpu_torch.meshes as TM  # noqa: E402
import oasisx_tpu_torch.spaces as TS  # noqa: E402
from oasisx_tpu.assembly import pallas_ops as po  # noqa: E402
from oasisx_tpu_torch.assembly import cubes as tcub  # noqa: E402
from oasisx_tpu_torch.assembly import kernels as kn  # noqa: E402
from oasisx_tpu_torch.la.pressure_mg import PressureMGCG  # noqa: E402
from tests.test_torch_kernels import _both  # noqa: E402
from tests.test_torch_slice import _run2d  # noqa: E402


def test_pressure_mg_five_levels_matches_kernel():
    """K1 on the N=64 tier's level count: 2D, 48 cells, coarsest 3."""
    jops, tops, _, (sm_q, _, valid_q) = _both((48, 48))
    Ap = np.asarray(jops.Ap_c)
    mg_j = po.build_pressure_mg_data(sm_q, Ap)
    mg_t = kn.build_pressure_mg_data(sm_q, Ap)
    assert len(mg_t["levels"]) == len(mg_j["levels"]) == 5
    assert mg_t["coarse"] == mg_j["coarse"]
    diag = tcub.diag_cube(tops.Ap_c, sm_q).numpy()
    invd = np.where(diag != 0, 1.0 / np.where(diag != 0, diag, 1.0), 1.0)
    rng = np.random.default_rng(9)
    b = rng.standard_normal(valid_q.size)
    x0 = np.zeros_like(b)
    rtol, maxiter = 1e-10, 200
    solve = po.make_pressure_cg(sm_q, Ap, invd, rtol=rtol, maxiter=maxiter, mg=mg_j,
                                interpret=True)
    xj, itj, _, cj = solve(jnp.asarray(b), jnp.asarray(x0))
    res = PressureMGCG(sm_q, tops.Ap_c, invd, mg_t, rtol, maxiter).solve(
        torch.tensor(b), torch.tensor(x0))
    assert bool(cj) and bool(res.converged)
    assert int(res.iters) == int(itj)
    xj = np.asarray(xj)
    assert np.abs(res.x.numpy() - xj).max() <= 1e-8 * np.abs(xj).max()


def test_structured_path_matches_jax_hbm_tier():
    """The JAX solver with its N=64 tentative solve (HBM-state BiCGStab, 3
    ops an iteration) against the port's structured path, 2D float32."""
    u0, p0 = _run2d(J, JM, JS, options={"pallas": "interpret", "pallas_bicgstab_hbm": True})
    u1, p1 = _run2d(T, TM, TS, device="cpu")
    uscale = np.abs(u0).max()
    pscale = max(np.abs(p0).max(), 1e-3)
    assert np.abs(u1 - u0).max() / uscale < 5e-4, np.abs(u1 - u0).max() / uscale
    assert np.abs(p1 - p0).max() / pscale < 5e-3, np.abs(p1 - p0).max() / pscale
