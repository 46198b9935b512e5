"""Taylor-Green on the port, on the CPU: tests/test_taylor_green.py's
quality bar (the reference CI's ~2nd-order space-time L2 convergence of
P2/P1 IPCS on [-1, 1]^2, the pressure nullspace path).

- float64, N = 8, 16, 32, dt 0.005 over [0, 0.1], for both
  ``low_memory_version`` settings: rate_u > 1.7 and rate_p > 1.5, and each
  mesh's space-time errors within 1e-6 relative of the JAX solver's on the
  same run (JAX's errors are computed once, with its default strategy: the
  strategies agree to rounding, tests/test_taylor_green.py holds both to
  the bar).  On this structured mesh the port's cube path has one
  strategy, so the ``False`` case sends the mesh to the general path
  (``structured: False``), where the preassembled mixed matrices differ
  from the direct vector assembly of the ``True`` case.
- The rotational update on N=8 over [0, 0.05]: eu < 1e-2, ep < 1e-1.
- float32, N=8, 30 steps with the preonly/lu options (rtol 1e-13, which the
  Krylov layer clamps to a float32-reachable tolerance): finite, |u| < 10.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import oasisx_tpu_torch as T  # noqa: E402
import oasisx_tpu_torch.meshes as TM  # noqa: E402
from oasisx_tpu_torch.forms import expr as E  # noqa: E402
from oasisx_tpu_torch.spaces import Constant  # noqa: E402
from tests import test_taylor_green as jtg  # noqa: E402

SOLVER_OPTS = jtg.SOLVER_OPTS
NS = (8, 16, 32)


def _solver_for(N, nu, rotational=False, low_memory=True, structured=True,
                dtype=torch.float64):
    mesh = TM.create_rectangle((-1, -1), (1, 1), (N, N))
    facets = mesh.exterior_facet_indices()
    tags = TM.meshtags(mesh, mesh.dim - 1, facets, np.full_like(facets, 3))
    t_u = Constant(0.0)
    u_ex = jtg.TG(t_u, nu)
    TOP = T.LocatorMethod.TOPOLOGICAL
    solver = T.FractionalStep_AB_CN(
        mesh, ("Lagrange", 2), ("Lagrange", 1),
        bcs_u=[[T.DirichletBC(u_ex.eval_x, TOP, (tags, 3))],
               [T.DirichletBC(u_ex.eval_y, TOP, (tags, 3))]],
        bcs_p=[], rotational=rotational, solver_options=SOLVER_OPTS,
        options={"low_memory_version": low_memory, "structured": structured}, dtype=dtype,
        device="cpu")
    return mesh, solver, u_ex, t_u


def _errors(ev, mesh, solver, u_ex, t_u, tp):
    """tests/test_taylor_green.py's squared L2 errors at quadrature degree 8."""
    x = E.SpatialCoordinate(mesh)
    decay_u = float(np.exp(-2 * u_ex.nu * np.pi**2 * float(t_u.value)))
    man_u = E.as_vector([-E.cos(E.pi * x[0]) * E.sin(E.pi * x[1]) * decay_u,
                         E.cos(E.pi * x[1]) * E.sin(E.pi * x[0]) * decay_u])
    decay_p = float(np.exp(-4 * np.pi**2 * u_ex.nu * tp))
    man_p = -0.25 * (E.cos(2 * E.pi * x[0]) + E.cos(2 * E.pi * x[1])) * decay_p
    uf = E.as_expr(solver.u)
    du = E.as_vector([uf[0] - man_u.comps[0], uf[1] - man_u.comps[1]])
    dp = E.as_expr(solver._p) - man_p
    return float(ev.integrate(E.inner(du, du))), float(ev.integrate(dp * dp))


def _run_case(N, dt, T0, T1, nu, **kw):
    mesh, solver, u_ex, t_u = _solver_for(N, nu, **kw)
    assert solver.config_report()["structured_fastpath"] is kw.get("structured", True)
    jtg._init(solver, u_ex, t_u, T0, dt)
    ev = E.QPEvaluator(mesh, 8, solver._dtype, "cpu")
    nsteps = int(round((T1 - T0) / dt))
    errs = np.zeros((2, nsteps))
    tp = T0 - dt / 2
    for i in range(nsteps):
        t_u.value = np.asarray(float(t_u.value) + dt)
        tp += dt
        solver.solve(dt, nu, max_iter=1)
        assert solver.last_stats["u_converged"].all() and solver.last_stats["p_converged"]
        errs[:, i] = _errors(ev, mesh, solver, u_ex, t_u, tp)
    return mesh.h().max(), np.sqrt(dt * errs[0].sum()), np.sqrt(dt * errs[1].sum())


def _rates(results):
    hs, eu, ep = (np.array([r[k] for r in results]) for k in range(3))
    return (np.log(eu[1:] / eu[:-1]) / np.log(hs[1:] / hs[:-1]),
            np.log(ep[1:] / ep[:-1]) / np.log(hs[1:] / hs[:-1]), eu, ep)


@pytest.fixture(scope="module")
def jax_errors():
    """The JAX solver's space-time errors on the same runs."""
    return [jtg._run_case(N, 0.005, 0.0, 0.1, 0.01) for N in NS]


@pytest.mark.parametrize("low_memory", [True, False])
def test_taylor_green_convergence(low_memory, jax_errors):
    results = [_run_case(N, 0.005, 0.0, 0.1, 0.01, low_memory=low_memory, structured=low_memory)
               for N in NS]
    rate_u, rate_p, eu, ep = _rates(results)
    _, _, eu_j, ep_j = _rates(jax_errors)
    assert rate_u.min() > 1.7, (rate_u, eu, eu_j)
    assert rate_p.min() > 1.5, (rate_p, ep, ep_j)
    np.testing.assert_allclose(eu, eu_j, rtol=1e-6)
    np.testing.assert_allclose(ep, ep_j, rtol=1e-6)


def test_rotational_form_runs_and_converges():
    h, eu, ep = _run_case(8, 0.005, 0.0, 0.05, 0.01, rotational=True)
    assert eu < 1e-2 and ep < 1e-1


def test_float32_long_horizon_stability():
    nu, dt = 0.01, 0.01
    _, s, ex, t_c = _solver_for(8, nu, dtype=torch.float32)
    jtg._init(s, ex, t_c, 0.0, dt)
    for k in range(30):
        t_c.value = np.asarray((k + 1) * dt)
        s.solve(dt, nu, max_iter=1)
    for f in s._u:
        assert torch.isfinite(f.x.array).all()
        assert float(f.x.array.abs().max()) < 10.0
