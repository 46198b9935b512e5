"""The port's ``Projector`` and ``LumpedProject`` against the JAX package, on
the CPU in float64: the four cases of tests/test_projector.py run through
both packages (DG1 gradient recovery with a direct-tier solver, re-assembly
after a coefficient update, a callable into P1, the lumped projection), and
a projection with Dirichlet BCs by CG and by GMRES; the projections to 1e-10
relative, the PETSc reasons equal, and each test's own exactness checks on
the port.  The default CG runs all components in one solve (K16's plain
version at batch bs) on the mass matrix's ELL values, Dirichlet rows and
columns folded in (``fold_bc_rows``, held against ``bc_symmetric_matvec``).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import oasisx_tpu as J  # noqa: E402
import oasisx_tpu.forms.expr as JE  # noqa: E402
import oasisx_tpu.meshes as JM  # noqa: E402
import oasisx_tpu.spaces as JS  # noqa: E402
import oasisx_tpu_torch as T  # noqa: E402
import oasisx_tpu_torch.forms.expr as TE  # noqa: E402
import oasisx_tpu_torch.meshes as TM  # noqa: E402
import oasisx_tpu_torch.spaces as TS  # noqa: E402
from oasisx_tpu.elements import FiniteElement as JFE  # noqa: E402
from oasisx_tpu_torch.assembly import engine as teng  # noqa: E402
from oasisx_tpu_torch.assembly import kernels as kn  # noqa: E402
from oasisx_tpu_torch.elements import FiniteElement as TFE  # noqa: E402
from oasisx_tpu_torch.function import fold_bc_rows  # noqa: E402
from oasisx_tpu_torch.parallel.graph import ell_values  # noqa: E402

RTOL = 1e-10
LU = {"ksp_type": "preonly", "pc_type": "lu"}
PKGS = {"jax": (J, JE, JM, JS, JFE), "torch": (T, TE, TM, TS, TFE)}


def _arr(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _close(got, ref, tol=RTOL):
    got, ref = _arr(got), _arr(ref)
    assert np.abs(got - ref).max() <= tol * max(np.abs(ref).max(), 1e-300), \
        np.abs(got - ref).max()


def _kw(name):
    return {} if name == "jax" else dict(dtype=torch.float64, device="cpu")


def _fn(name, S, V):
    return S.Function(V) if name == "jax" else S.Function(V, dtype=torch.float64, device="cpu")


def _gradient_case(name, N, u0, opts=LU):
    """grad(u) of a P2 field projected into vector DG1."""
    pkg, E, M, S, FE = PKGS[name]
    mesh = M.create_unit_square(N)
    V = S.FunctionSpace(mesh, ("Lagrange", 2))
    u = _fn(name, S, V)
    u.interpolate(u0)
    W = S.FunctionSpace(mesh, FE("DG", "triangle", 1), shape=(2,))
    return mesh, u, W, pkg.Projector(E.grad(u), W, petsc_options=opts, **_kw(name))


def test_gradient_projection_exact_matches_jax():
    out = {}
    for name in PKGS:
        mesh, u, W, proj = _gradient_case(
            name, 10, lambda x: x[0] ** 2 + 2 * x[1] ** 2 + 0.5 * x[0] * x[1])
        kn.reset_counts()
        out[name] = (proj.solve(), _arr(proj.x.x.array).copy(), mesh, u, W, proj)
    (rj, xj, *_), (rt, xt, mesh, u, W, proj) = out["jax"], out["torch"]
    assert rt == rj == 2
    _close(xt, xj)
    # one K14 product for r0 and one K16 solve for both components
    assert kn.plain_calls["ell_cg"] == 1 and kn.plain_calls["ell_matvec"] == 1
    x = W.dof_coords
    exact = np.stack([2 * x[:, 0] + 0.5 * x[:, 1], 4 * x[:, 1] + 0.5 * x[:, 0]], axis=1)
    assert np.abs(xt.reshape(-1, 2) - exact).max() < 1e-10
    pf = TE.as_expr(proj.x)
    diff = TE.grad(u) - TE.as_vector([pf[0], pf[1]])
    err = TE.assemble_scalar(mesh, TE.inner(diff, diff), qdegree=6, dtype=torch.float64,
                             device="cpu")
    assert float(err) < 1e-12


def test_projector_reassembly_matches_jax():
    out = {}
    for name in PKGS:
        _, u, _, proj = _gradient_case(name, 6, lambda x: x[0] ** 2)
        proj.solve()
        g1 = _arr(proj.x.x.array).copy()
        u.interpolate(lambda x: 3 * x[0] ** 2)
        proj.solve(assemble_rhs=True)
        out[name] = (g1, _arr(proj.x.x.array).copy())
    (g1j, g2j), (g1t, g2t) = out["jax"], out["torch"]
    _close(g1t, g1j)
    _close(g2t, g2j)
    assert np.abs(g2t - 3 * g1t).max() < 1e-8


def test_projector_callable_scalar_space_matches_jax():
    out = {}
    for name, (pkg, _, M, S, _) in PKGS.items():
        mesh = M.create_unit_square(8)
        Q = S.FunctionSpace(mesh, ("Lagrange", 1))
        proj = pkg.Projector(lambda x: x[0] + x[1], Q, petsc_options={"ksp_rtol": 1e-13},
                             **_kw(name))
        out[name] = (proj.solve(), _arr(proj.x.x.array).copy(), Q)
    (rj, xj, _), (rt, xt, Q) = out["jax"], out["torch"]
    assert rt == rj and rt > 0
    _close(xt, xj)
    xc = Q.dof_coords
    assert np.abs(xt - (xc[:, 0] + xc[:, 1])).max() < 1e-8


def test_lumped_project_matches_jax():
    out = {}
    for name, (pkg, E, M, S, _) in PKGS.items():
        mesh = M.create_unit_square(8)
        Q = S.FunctionSpace(mesh, ("Lagrange", 1))
        const = pkg.LumpedProject(lambda x: np.ones_like(x[0]) * 2.5, Q, **_kw(name))
        const.solve()
        x = E.SpatialCoordinate(mesh)
        smooth = pkg.LumpedProject(E.sin(E.pi * x[0]) * x[1], Q, **_kw(name))
        smooth.solve()
        out[name] = (_arr(const.x.x.array).copy(), _arr(smooth.x.x.array).copy())
    assert np.abs(out["torch"][0] - 2.5).max() < 1e-12
    _close(out["torch"][0], out["jax"][0])
    _close(out["torch"][1], out["jax"][1])


@pytest.mark.parametrize("opts", [{"ksp_rtol": 1e-12}, {"ksp_type": "gmres", "ksp_rtol": 1e-12}],
                         ids=["cg", "gmres"])
def test_projector_dirichlet_matches_jax(opts):
    """A vector P2 projection of a field with the boundary values fixed by
    a Dirichlet BC (symmetric lifting), warm-started from the last
    projection on the second solve."""
    out = {}
    for name, (pkg, E, M, S, _) in PKGS.items():
        mesh = M.create_unit_square(6)
        W = S.FunctionSpace(mesh, ("Lagrange", 2), shape=(2,))
        x = E.SpatialCoordinate(mesh)
        bc = pkg.DirichletBC(lambda p: 0.25 + 0.0 * p[0], pkg.LocatorMethod.GEOMETRICAL,
                             lambda p: np.isclose(p[0], 0.0) | np.isclose(p[1], 1.0))
        c = S.Constant(1.0)
        proj = pkg.Projector(E.as_vector([E.cos(E.pi * x[0]) * x[1], E.as_expr(c) * x[0] ** 2]),
                             W, bcs=[bc], petsc_options=opts, **_kw(name))
        reasons = [proj.solve()]
        first = _arr(proj.x.x.array).copy()
        c.value = np.asarray(-2.0)
        reasons.append(proj.solve())
        out[name] = (reasons, first, _arr(proj.x.x.array).copy(), bc.dofs)
    (rj, fj, xj, _), (rt, ft, xt, dofs) = out["jax"], out["torch"]
    assert rt == rj == [2, 2]
    _close(ft, fj)
    _close(xt, xj)
    assert np.allclose(xt.reshape(-1, 2)[dofs], 0.25, atol=1e-14)


def test_fold_bc_rows_is_the_symmetric_matvec():
    """The folded ELL values apply engine.bc_symmetric_matvec's operator."""
    mesh = TM.create_unit_square(4)
    V = TS.FunctionSpace(mesh, ("Lagrange", 2))
    bc = T.DirichletBC(0.0, T.LocatorMethod.GEOMETRICAL, lambda p: np.isclose(p[1], 0.0))
    proj = T.Projector(lambda x: x[0], V, bcs=[bc], dtype=torch.float64, device="cpu")
    x = torch.tensor(np.random.default_rng(3).standard_normal((2, V.num_dofs)))
    ref = teng.bc_symmetric_matvec(proj._ctx, proj._elems, proj._mask, x, teng.matvec_v)
    _close(proj._matvec(x), ref, 1e-14)
    # with no masked dof the values are the mass matrix's own
    raw = ell_values(proj._elems, proj._ell)
    assert torch.equal(fold_bc_rows(raw, proj._ell.cols, torch.zeros_like(proj._mask)), raw)
