"""The port's solver options off the default configurations against the JAX
package, on the CPU in float64.

- ``la/krylov.py``: restarted GMRES and the unbatched BiCGStab against
  ``oasisx_tpu.la`` on a dense nonsymmetric system (equal iterations, x to
  1e-10 relative, PETSc reasons), the breakdown reason -5 of CG and
  BiCGStab, GMRES's -3 at its iteration limit; ``KSPSolver``'s options
  and ``solve`` against the JAX ``KSPSolver``.
- The general path's pressure ``pc_type`` jacobi, none and cheb
  (Chebyshev-Jacobi, degree 6, both packages on the JAX package's bounds:
  their power iterations draw different start vectors) and its tentative
  ``ksp_type`` gmres and cg, against the JAX package's XLA path, on the
  2D rectangle sent to the general path and on the DFG cylinder with its
  outlet: equal iterations every step, u and p to 1e-9 relative.
- The band layout's GMRES tentative solves against the flat ELL layout's.
- ``config_report`` and the kernels each option leaves on the path.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

import oasisx_tpu as J  # noqa: E402
import oasisx_tpu.la as jla  # noqa: E402
import oasisx_tpu.meshes as JM  # noqa: E402
import oasisx_tpu.spaces as JS  # noqa: E402
import oasisx_tpu_torch as T  # noqa: E402
import oasisx_tpu_torch.meshes as TM  # noqa: E402
import oasisx_tpu_torch.spaces as TS  # noqa: E402
from oasisx_tpu_torch import la as tla  # noqa: E402
from oasisx_tpu_torch.assembly import kernels as kn  # noqa: E402
from tests.test_torch_lumped import _tgv2d, _up  # noqa: E402

RTOL = 1e-9
DT, NU = 0.01, 0.01
GENERAL = {"low_memory_version": False, "structured": False}
GMRES = {"ksp_type": "gmres"}
JACOBI = {"pc_type": "jacobi"}


def _nonsymmetric(n=120, seed=7):
    rng = np.random.default_rng(seed)
    A = np.eye(n) * 4.0 + 0.5 * rng.standard_normal((n, n)) / np.sqrt(n)
    A[0, n - 1] += 1.0
    return A, rng.standard_normal(n), rng.standard_normal(n)


def _both_ops(A):
    Aj, At = jnp.asarray(A), torch.tensor(A)
    return ((lambda x: Aj @ x), jla.jacobi_preconditioner(jnp.diagonal(Aj)),
            (lambda x: At @ x), tla.jacobi_preconditioner(torch.diagonal(At)))


def _same(got, ref):
    assert int(got.iters) == int(ref.iters)
    assert bool(got.converged) == bool(ref.converged)
    assert int(got.reason) == int(ref.reason)
    x = np.asarray(ref.x)
    assert np.abs(got.x.numpy() - x).max() <= 1e-10 * np.abs(x).max()


@pytest.mark.parametrize("restart", [25, 8, 3])
def test_gmres_matches_jax(restart):
    A, b, x0 = _nonsymmetric()
    mj, Mj, mt, Mt = _both_ops(A)
    ref = jla.gmres(mj, jnp.asarray(b), x0=jnp.asarray(x0), M=Mj, rtol=1e-10, maxiter=500,
                    restart=restart)
    got = tla.gmres(mt, torch.tensor(b), x0=torch.tensor(x0), M=Mt, rtol=1e-10, maxiter=500,
                    restart=restart)
    _same(got, ref)
    assert int(got.reason) == 2
    # a read a cycle start, an Arnoldi step and a residual test, and the tolerance
    assert got.syncs >= int(got.iters) + 3
    assert np.allclose(got.x.numpy(), np.linalg.solve(A, b), atol=1e-7)


def test_gmres_iteration_limit_reason():
    A, b, _ = _nonsymmetric()
    mj, _, mt, _ = _both_ops(A)
    ref = jla.gmres(mj, jnp.asarray(b), rtol=1e-14, maxiter=7, restart=3)
    got = tla.gmres(mt, torch.tensor(b), rtol=1e-14, maxiter=7, restart=3)
    _same(got, ref)
    assert int(got.reason) == -3 and int(got.iters) == 7


def test_bicgstab_matches_jax():
    A, b, x0 = _nonsymmetric(seed=3)
    mj, Mj, mt, Mt = _both_ops(A)
    ref = jla.bicgstab(mj, jnp.asarray(b), x0=jnp.asarray(x0), M=Mj, rtol=1e-10, maxiter=500)
    got = tla.bicgstab(mt, torch.tensor(b), x0=torch.tensor(x0), M=Mt, rtol=1e-10, maxiter=500)
    _same(got, ref)
    assert got.syncs == int(got.iters) + 1


@pytest.mark.parametrize("solver", ["cg", "bicgstab"])
def test_breakdown_reason(solver):
    """An operator that annihilates everything: a zero pAp / rho at the
    first step is a breakdown (-5), never convergence; a healthy SPD solve
    reports 2."""
    ref = getattr(jla, solver)(lambda x: jnp.zeros_like(x), jnp.ones(16), rtol=1e-8, maxiter=50)
    got = getattr(tla, solver)(lambda x: torch.zeros_like(x), torch.ones(16, dtype=torch.float64),
                               rtol=1e-8, maxiter=50)
    assert int(got.reason) == int(ref.reason) == -5 and not bool(got.converged)
    assert int(got.iters) == int(ref.iters)
    rng = np.random.default_rng(0)
    Q = rng.standard_normal((16, 16))
    spd = torch.tensor(Q @ Q.T + 16 * np.eye(16))
    res = getattr(tla, solver)(lambda x: spd @ x, torch.ones(16, dtype=torch.float64), rtol=1e-6,
                               maxiter=200)
    assert bool(res.converged) and int(res.reason) == 2


@pytest.mark.parametrize("options", [{}, {"ksp_type": "cg"}, GMRES,
                                     {"ksp_type": "gmres", "ksp_gmres_restart": 5,
                                      "pc_type": "none"}],
                         ids=["bcgs", "cg", "gmres", "gmres-restart5-none"])
def test_ksp_solver_matches_jax(options):
    A, b, x0 = _nonsymmetric(seed=11)
    if options.get("ksp_type") == "cg":
        A = A @ A.T
    opts = dict(options, ksp_rtol=1e-10, ksp_max_it=400)
    sj = jla.KSPSolver(opts, prefix="tentative_velocity", symmetric=False)
    st = tla.KSPSolver(opts, prefix="tentative_velocity", symmetric=False)
    assert (st.method, st.gmres_restart, st.use_jacobi(), st.lumped) == \
        (sj.method, sj.gmres_restart, sj.use_jacobi(), sj.lumped)
    sj.setOperators(lambda x: jnp.asarray(A) @ x, jnp.diagonal(jnp.asarray(A)))
    At = torch.tensor(A)
    st.setOperators(lambda x: At @ x, torch.diagonal(At))
    ref, got = sj.solve(jnp.asarray(b), jnp.asarray(x0)), st.solve(torch.tensor(b),
                                                                   torch.tensor(x0))
    _same(got, ref)
    assert int(tla.KSPSolver.converged_reason(got)) == int(jla.KSPSolver.converged_reason(ref)) == 2


def test_ksp_solver_options():
    assert tla.KSPSolver({"pc_type": "lumped"}).lumped
    assert tla.KSPSolver({"lumped": True}).lumped and not tla.KSPSolver({}).lumped
    s = tla.KSPSolver({"ksp_type": "fgmres", "ksp_gmres_restart": 17}, symmetric=False)
    assert s.method == "gmres" and s.gmres_restart == 17
    assert tla.KSPSolver({}).gmres_restart == 30
    assert not tla.KSPSolver({"pc_type": "none"}).use_jacobi()
    with pytest.raises(RuntimeError, match="setOperators"):
        tla.KSPSolver({}).solve(torch.ones(3))


def _compare(sj, st, steps):
    if sj._cheb is not None:
        # the JAX package's Chebyshev bounds, handed to the port
        degree, lmin, lmax = sj._cheb
        assert st._p_cheb["degree"] == degree == 6
        st._p_cheb.update(lmin=lmin, lmax=lmax)
    stj = sj.run(steps, DT, NU, max_iter=1)
    stt = st.run(steps, DT, NU, max_iter=1)
    for k in ("u_iters", "p_iters", "c_iters"):
        np.testing.assert_array_equal(stt[k], stj[k], err_msg=k)
    (ut, pt), (uj, pj) = _up(st), _up(sj)
    assert np.abs(ut - uj).max() <= RTOL * np.abs(uj).max(), np.abs(ut - uj).max()
    assert np.abs(pt - pj).max() <= RTOL * np.abs(pj).max(), np.abs(pt - pj).max()
    assert (stt["host_syncs"] > 0).all()
    return stt


CASES = {
    "jacobi-gmres": (3, JACOBI, GMRES, None),
    "none-gmres-lumped": (3, {"pc_type": "none"}, GMRES, {"pc_type": "lumped"}),
    "cheb-gmres-restart5": (3, {"pc_type": "cheb"}, dict(GMRES, ksp_gmres_restart=5), None),
    "jacobi-cg": (2, JACOBI, {"ksp_type": "cg"}, None),
}


@pytest.mark.parametrize("case", list(CASES))
def test_general_options_match_jax_xla(case):
    steps, pressure, tentative, scalar = CASES[case]
    kw = dict(pressure=pressure, tentative=tentative, scalar=scalar)
    sj = _tgv2d(J, JM, JS, 6, options=GENERAL, **kw)
    st = _tgv2d(T, TM, TS, 6, options=GENERAL, device="cpu", **kw)
    rep = st.config_report()
    assert rep["structured_fastpath"] is False
    assert rep["tentative_method"] == tentative["ksp_type"]
    assert rep["pressure_pc"] == ("cheb-pcg" if pressure["pc_type"] == "cheb" else "jacobi-pcg")
    kn.reset_counts()
    _compare(sj, st, steps)
    # every product on K14's plain version; no whole-solve kernel but the mass CG
    assert kn.plain_calls["ell_matvec"] > 0
    assert kn.plain_calls["ell_bicgstab"] == kn.plain_calls["ell_pcg_amg"] == 0
    assert kn.plain_calls["ell_cg"] == (0 if scalar else steps)
    assert rep["path_kernels"] == (["ell_matvec"] if scalar else ["ell_matvec", "ell_cg"])


def _cylinder(pkg, M, pressure, tentative, h_outlet=0.0, **kw):
    """The DFG cylinder at res=10 with its PressureBC outlet of value
    ``h_outlet`` (tests/test_torch_unstructured.py's), solver options given."""
    mesh = M.create_cylinder_channel(10)
    L, H = 2.2, 0.41
    inlet = M.locate_entities_boundary(mesh, 1, lambda x: np.isclose(x[0], 0.0))
    outlet = M.locate_entities_boundary(mesh, 1, lambda x: np.isclose(x[0], L))
    others = np.setdiff1d(mesh.exterior_facet_indices(), np.hstack([inlet, outlet]))
    facets = np.hstack([inlet, others, outlet])
    values = np.hstack([np.full_like(inlet, 1), np.full_like(others, 2),
                        np.full_like(outlet, 3)]).astype(np.int32)
    tags = M.meshtags(mesh, 1, facets, values)
    inflow = lambda x: 4.0 * 0.3 * x[1] * (H - x[1]) / H**2
    D, TOP = pkg.DirichletBC, pkg.LocatorMethod.TOPOLOGICAL
    bcs_u = [[D(inflow, TOP, (tags, 1)), D(0.0, TOP, (tags, 2))],
             [D(0.0, TOP, (tags, 1)), D(0.0, TOP, (tags, 2))]]
    o = {"ksp_rtol": 1e-12, "ksp_max_it": 2000}
    return pkg.FractionalStep_AB_CN(
        mesh, ("Lagrange", 2), ("Lagrange", 1), bcs_u=bcs_u,
        bcs_p=[pkg.PressureBC(h_outlet, (tags, 3))],
        solver_options={"tentative": dict(o, **tentative), "pressure": dict(o, **pressure),
                        "scalar": dict(o)},
        options={"low_memory_version": False}, dtype=np.float64 if pkg is J else torch.float64,
        **kw)


@pytest.mark.parametrize("pressure", [JACOBI, {"pc_type": "cheb"}], ids=["jacobi", "cheb"])
def test_cylinder_outlet_with_gmres_tentative(pressure):
    """tests/test_krylov.py's cylinder with GMRES(20) tentative solves, on
    the outlet-masked non-AMG pressure solve, against the JAX XLA path."""
    tent = dict(GMRES, ksp_gmres_restart=20)
    sj = _cylinder(J, JM, pressure, tent)
    st = _cylinder(T, TM, pressure, tent, device="cpu")
    assert st.config_report()["outlet"] is True
    stats = _compare(sj, st, 3)
    assert stats["u_converged"].all() and stats["p_converged"].all()
    assert stats["p_iters"].min() >= 3


def test_band_layout_gmres_matches_flat_ell():
    """GMRES on K18's band product takes the flat layout's iterations."""
    runs = []
    for layout in ("ell", "band"):
        s = _tgv2d(T, TM, TS, 6, options=dict(GENERAL, ell_layout=layout), tentative=GMRES,
                   pressure=JACOBI, device="cpu")
        kn.reset_counts()
        runs.append((s.run(3, DT, NU, max_iter=1), _up(s), dict(kn.plain_calls)))
    (sa, (ua, pa), _), (sb, (ub, pb), calls) = runs
    assert calls["band_matvec"] > 0 and calls["band_bicgstab"] == 0
    for k in ("u_iters", "p_iters", "c_iters"):
        np.testing.assert_array_equal(sa[k], sb[k], err_msg=k)
    assert np.abs(ua - ub).max() <= RTOL * np.abs(ua).max()
    assert np.abs(pa - pb).max() <= RTOL * np.abs(pa).max()
