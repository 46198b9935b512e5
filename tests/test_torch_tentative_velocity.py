"""The tentative-velocity system of the port's split phases against a
from-scratch assembly, on the CPU in float64 (tests/test_tentative_velocity.py
on the port).

- The four cases low_memory x body_force on the 10x10 unit square, P1/P1
  with an inlet, walls and an outlet PressureBC (the general path):
  ``tentative_matrix_dense`` against the monolithic ``tests/oracle.py``
  matrix M/dt + C/2 + nu K/2 with its BC rows, and ``_rhs1`` after
  ``velocity_tentative_solve`` against the oracle's right-hand side (CN and
  AB2 terms, p v.dx(i), the body force, the outlet's surface term, the BC
  values), both to 1e-12.
- ``tentative_matrix_dense`` against the JAX solver's on the same state to
  1e-12 relative: the 6x6 Taylor-Green rectangle on the structured path
  (the step's operator, W's plain product, applied to identity columns)
  and sent to the general path (the element stack summed), and the N=3
  Taylor-Green box on the structured path; and its refusal above
  ``DENSE_MAX_DOFS``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import oasisx_tpu as J  # noqa: E402
import oasisx_tpu.meshes as JM  # noqa: E402
import oasisx_tpu.spaces as JS  # noqa: E402
import oasisx_tpu_torch as T  # noqa: E402
import oasisx_tpu_torch.meshes as TM  # noqa: E402
import oasisx_tpu_torch.spaces as TS  # noqa: E402
from oasisx_tpu_torch import fracstep  # noqa: E402
from oasisx_tpu_torch.assembly import kernels as kn  # noqa: E402
from oracle import Oracle  # noqa: E402
from test_bcs import _facet_oracle  # noqa: E402
from tests.test_torch_lumped import _tgv2d  # noqa: E402
from tests.test_torch_slice import _tgv3d  # noqa: E402


class Inlet:
    def __init__(self, t):
        self.t = t

    def eval(self, x):
        return (1 + self.t) * np.sin(np.pi * x[1])


def _tags(M, mesh):
    dim = mesh.dim - 1
    left = M.locate_entities_boundary(mesh, dim, lambda x: np.isclose(x[0], 0))
    tb = M.locate_entities_boundary(mesh, dim, lambda x: np.isclose(x[1], 0) | np.isclose(x[1], 1))
    right = M.locate_entities_boundary(mesh, dim, lambda x: np.isclose(x[0], 1))
    values = np.hstack([np.full_like(left, 1), np.full_like(tb, 2), np.full_like(right, 3)])
    return M.meshtags(mesh, dim, np.hstack([left, tb, right]), values.astype(np.int32)), left, tb, \
        right


@pytest.mark.parametrize("body_force", [True, False])
@pytest.mark.parametrize("low_memory", [True, False])
def test_tentative(low_memory, body_force):
    mesh = TM.create_unit_square(10)
    f = np.array([0.3, -0.1]) if body_force else None
    tags, left, tb, right = _tags(TM, mesh)
    inlet = Inlet(0)
    D, TOP = T.DirichletBC, T.LocatorMethod.TOPOLOGICAL
    bc_tb = D(0.0, TOP, (tags, 2))
    bc_inlet_x = D(inlet.eval, TOP, (tags, 1))
    bcs_u = [[bc_inlet_x, bc_tb], [D(0.0, TOP, (tags, 1)), bc_tb]]
    p_value = 4.0
    solver = T.FractionalStep_AB_CN(
        mesh, ("Lagrange", 1), ("Lagrange", 1), bcs_u=bcs_u,
        bcs_p=[T.PressureBC(p_value, (tags, 3))],
        solver_options={"tentative": {"ksp_type": "preonly", "pc_type": "lu"}},
        options={"low_memory_version": low_memory}, body_force=f, dtype=torch.float64,
        device="cpu")
    assert solver.config_report()["structured_fastpath"] is False

    dt, nu = 0.1, 0.5
    inlet.t = -2 * dt
    for g in solver._u2:
        g.interpolate(inlet.eval)
    inlet.t = -dt
    for g in solver._u1:
        g.interpolate(inlet.eval)
    inlet.t = dt
    bc_inlet_x.update_bc()
    solver._ps.interpolate(lambda x: x[1])
    solver.assemble_first(dt, nu)
    solver.velocity_tentative_assemble()
    diff, errors = solver.velocity_tentative_solve()
    assert (errors > 0).all() and np.isfinite(diff)

    # the oracle: a monolithic assembly on the JAX package's numbering,
    # which is the port's
    jmesh = JM.create_unit_square(10)
    V = JS.FunctionSpace(jmesh, ("Lagrange", 1))
    Q = JS.FunctionSpace(jmesh, ("Lagrange", 1))
    orc = Oracle(jmesh, V.element, V.dofmap, Q.element, Q.dofmap, qdeg=5)
    xd = V.dof_coords
    u_n = (1 - dt) * np.sin(np.pi * xd[:, 1])
    u_n2 = (1 - 2 * dt) * np.sin(np.pi * xd[:, 1])
    uab1 = 1.5 * u_n - 0.5 * u_n2
    M, K, C = orc.mass(), orc.stiffness(), orc.convection(np.stack([uab1, uab1]))
    A = M / dt + 0.5 * C + 0.5 * nu * K
    dofs_left = V.locate_dofs_topological(1, left)
    dofs_tb = V.locate_dofs_topological(1, tb)
    bc0 = np.unique(np.concatenate([dofs_left, dofs_tb]))
    A[bc0, :] = 0.0
    A[bc0, bc0] = 1.0
    assert np.abs(solver.tentative_matrix_dense() - A).max() < 1e-12

    ps = Q.dof_coords[:, 1]
    L_common = (M / dt - 0.5 * C - 0.5 * nu * K) @ u_n
    for i in range(2):
        b = L_common + orc.pressure_gradient_vec(i, ps)
        if body_force:
            load = np.zeros(V.num_dofs)
            e = np.einsum("q,qj,c->cj", orc.w, orc.phi_v, orc.detJ)
            np.add.at(load, V.dofmap.cell_dofs.reshape(-1), e.reshape(-1))
            b = b + f[i] * load
        b = b + _facet_oracle(jmesh, V, Q, right, lambda p: np.full(p.shape[0], p_value), i)
        b[dofs_left] = (1 + dt) * np.sin(np.pi * xd[dofs_left, 1]) if i == 0 else 0.0
        b[dofs_tb] = 0.0
        assert np.abs(solver._rhs1[i].x.array.numpy() - b).max() < 1e-12, i


def _dense_pair(case):
    if case == "box":
        sj, st = _tgv3d(J, JM, N=3), _tgv3d(T, TM, N=3, device="cpu")
    else:
        opts = {"structured": False} if case == "general" else None
        sj = _tgv2d(J, JM, JS, 6, options=opts)
        st = _tgv2d(T, TM, TS, 6, options=opts, device="cpu")
    rng = np.random.default_rng(5)
    for fj, ft in zip(sj._u1 + sj._u2, st._u1 + st._u2):  # a state with every convection term
        v = rng.standard_normal(ft.x.array.shape[0])
        fj.x.array[:] = v
        ft.x.array.copy_(torch.as_tensor(v))
    return sj, st


@pytest.mark.parametrize("case", ["structured", "general", "box"])
def test_dense_matrix_matches_jax(case):
    sj, st = _dense_pair(case)
    assert st.config_report()["structured_fastpath"] is (case != "general")
    for s in (sj, st):
        s.assemble_first(0.05, 0.02)
    kn.reset_counts()
    At, Aj = st.tentative_matrix_dense(), sj.tentative_matrix_dense()
    assert At.shape == Aj.shape and At.dtype == np.float64
    assert np.abs(At - Aj).max() <= 1e-12 * np.abs(Aj).max()
    if case != "general":  # the step's own product on identity columns
        n = st._Vi[0][0].num_dofs
        assert kn.plain_calls["matvec_win"] == -(-n // fracstep.DENSE_BATCH)


def test_dense_matrix_refuses_large_systems(monkeypatch):
    st = _tgv2d(T, TM, TS, 6, device="cpu")
    st.assemble_first(0.05, 0.02)
    monkeypatch.setattr(fracstep, "DENSE_MAX_DOFS", st._Vi[0][0].num_dofs - 1)
    with pytest.raises(ValueError, match="dense export"):
        st.tentative_matrix_dense()
