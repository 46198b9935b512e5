"""The lumped (weighted-gradient) velocity update in the port against the
JAX package, on the CPU in float64.

- The weighted nodal gradient: K6's plain version on the cube matrix
  ``Gw_c`` against the JAX package's ``engine.weighted_nodal_grad_p`` on a
  2D and a 3D structured grid (1e-12 relative), and the port's element
  version against it on the same grids.
- The solver with ``pc_type`` "lumped", 5 steps against the JAX solver:
  the structured 2D rectangle (the JAX XLA path with the kernel path's
  tentative x0 and Jacobi-CG pressure), the rectangle sent to the general
  path (``structured: False``) and the vessel (the JAX ELL kernel path in
  interpret mode on the port's AMG coarse inverse): equal iterations every
  step, c iterations 0, u and p to 1e-10 relative; ``config_report``.

The contracts of tests/test_lumped_update.py are in
tests/test_torch_lumped_contracts.py.
"""

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
from oasisx_tpu.assembly import engine as jeng  # noqa: E402
from oasisx_tpu.elements.element import FiniteElement as JFE  # noqa: E402
from oasisx_tpu.spaces.functionspace import FunctionSpace as JFS  # noqa: E402
from oasisx_tpu_torch.assembly import cubes as tcub  # noqa: E402
from oasisx_tpu_torch.assembly import engine as teng  # noqa: E402
from oasisx_tpu_torch.assembly import kernels as kn  # noqa: E402
from oasisx_tpu_torch.assembly.reference_tensors import build_reference_tensors  # noqa: E402
from oasisx_tpu_torch.assembly.structured import build_structured_map, num_padded  # noqa: E402
from oasisx_tpu_torch.elements.element import FiniteElement as TFE  # noqa: E402
from oasisx_tpu_torch.spaces.functionspace import FunctionSpace as TFS  # noqa: E402
from tests.test_torch_slice import _TG, _cat, _kernel_path_x0, _up  # noqa: E402
from tests.test_torch_unstructured import _share_coarse_inverse, deform_vessel, TGV  # noqa: E402

LUMPED = {"pc_type": "lumped"}
# the states' tolerance; the solves run at 1e-12 (tests/test_torch_pressure_cg.py:
# at rtol 1e-10 two orders of sums leave the iterates ~2e-10 apart)
RTOL = 1e-10
SOLVE_RTOL = 1e-12
DT, NU = 0.01, 0.01


def _grid(cells):
    """Both packages' spaces on one structured grid, and the port's Gw_c."""
    d = len(cells)
    cell = "tetrahedron" if d == 3 else "triangle"
    lo, hi = (-1.0,) * d, (1.0,) * d
    make = (JM.create_box, TM.create_box) if d == 3 else (JM.create_rectangle,
                                                          TM.create_rectangle)
    jm, tm = make[0](lo, hi, cells), make[1](lo, hi, cells)
    jv, jq = JFE("Lagrange", cell, 2), JFE("Lagrange", cell, 1)
    tv, tq = TFE("Lagrange", cell, 2), TFE("Lagrange", cell, 1)
    JV, JQ, TV, TQ = JFS(jm, jv), JFS(jm, jq), TFS(tm, tv), TFS(tm, tq)
    jctx, _ = jeng.build_device_context(jm, jv, JV.dofmap.cell_dofs, JV.num_dofs, jq,
                                        JQ.dofmap.cell_dofs, JQ.num_dofs)
    tctx, refs = teng.build_device_context(tm, tv, TV.dofmap.cell_dofs, TV.num_dofs, tq,
                                           TQ.dofmap.cell_dofs, TQ.num_dofs, torch.float64,
                                           torch.device("cpu"))
    sm_v, gf_v, _ = build_structured_map(tm, tv, TV.dofmap)
    sm_q, gf_q, _ = build_structured_map(tm, tq, TQ.dofmap)
    gtab = tq.tabulate(tv.nodes)[1]
    cu = tcub.build_cube_ops(tm, refs, sm_v, sm_q, dtype=torch.float64, device="cpu", gtab=gtab)
    return dict(jctx=jctx, tctx=tctx, gtab=gtab, cu=cu, sm_v=sm_v, sm_q=sm_q, gf_v=gf_v,
                gf_q=gf_q, nq=TQ.num_dofs, jgtab=jnp.asarray(jq.tabulate(jv.nodes)[1]))


@pytest.mark.parametrize("cells", [(4, 5), (3, 4, 5)], ids=["2d", "3d"])
def test_weighted_gradient_matches_jax(cells):
    """K6 on Gw_c (plain) and the element version against JAX's
    weighted_nodal_grad_p, on random pressures."""
    g = _grid(cells)
    assert np.array_equal(g["gtab"], np.asarray(g["jgtab"]))
    dp = np.random.default_rng(5).standard_normal(g["nq"])
    ref = np.asarray(jeng.weighted_nodal_grad_p(g["jctx"], jnp.asarray(dp), g["jgtab"]))
    scale = np.abs(ref).max()
    grid_q = torch.zeros(num_padded(g["sm_q"]), dtype=torch.float64)
    grid_q[torch.as_tensor(g["gf_q"])] = torch.tensor(dp)
    got = kn.mixed_plain(grid_q, g["cu"].Gw_c, g["sm_v"], g["sm_q"])[:, g["gf_v"]].numpy()
    assert np.abs(got - ref).max() <= 1e-12 * scale, np.abs(got - ref).max() / scale
    el = teng.weighted_nodal_grad_p(g["tctx"], torch.tensor(dp), torch.tensor(g["gtab"]))
    assert np.abs(el.numpy() - ref).max() <= 1e-12 * scale
    assert g["cu"].Gw_c.shape == g["cu"].G_c.shape


def _tgv2d(pkg, meshes, spaces, N, scalar=None, pressure=None, options=None, dt=DT, nu=NU,
           rtol=SOLVE_RTOL, tentative=None, **kw):
    """2D Taylor-Green in float64 with its exact Dirichlet data; u2 at
    t = -dt, u1 at t = 0 (tests/test_lumped_update.py's start)."""
    mesh = meshes.create_rectangle((-1, -1), (1, 1), (N, N))
    facets = mesh.exterior_facet_indices()
    tags = meshes.meshtags(mesh, mesh.dim - 1, facets, np.full_like(facets, 3))
    t_u = spaces.Constant(0.0)
    u_ex = _TG(t_u, nu)
    T_ = pkg.LocatorMethod.TOPOLOGICAL
    bcs = [[pkg.DirichletBC(u_ex.eval_x, T_, (tags, 3))],
           [pkg.DirichletBC(u_ex.eval_y, T_, (tags, 3))]]
    o = {"ksp_rtol": rtol, "ksp_max_it": 2000}
    s = pkg.FractionalStep_AB_CN(
        mesh, ("Lagrange", 2), ("Lagrange", 1), bcs_u=bcs, bcs_p=[],
        solver_options={"tentative": dict(o, **(tentative or {})),
                        "pressure": dict(o, **(pressure or {})), "scalar": dict(o, **(scalar or {}))},
        options=options, dtype=np.float64 if pkg is J else torch.float64, **kw)
    t_u.value = np.asarray(-dt)
    for f, fn in zip(s._u2, (u_ex.eval_x, u_ex.eval_y)):
        f.interpolate(fn)
    t_u.value = np.asarray(0.0)
    for f, fn in zip(s._u1, (u_ex.eval_x, u_ex.eval_y)):
        f.interpolate(fn)
    return s


def _close(st, sj, stats_t, stats_j, rtol=RTOL):
    for k in ("u_iters", "p_iters", "c_iters"):
        np.testing.assert_array_equal(stats_t[k], stats_j[k], err_msg=k)
    (ut, pt), (uj, pj) = _up(st), _up(sj)
    assert np.abs(ut - uj).max() <= rtol * np.abs(uj).max(), np.abs(ut - uj).max()
    assert np.abs(pt - pj).max() <= rtol * np.abs(pj).max(), np.abs(pt - pj).max()


def _check_lumped(s, stats):
    rep = s.config_report()
    assert rep["velocity_update"] == "lumped"
    assert not {"cg_mass", "ell_cg", "band_cg"} & set(rep["path_kernels"])
    assert (stats["c_iters"] == 0).all() and stats["c_converged"].all()
    assert (stats["c_res"] == 0).all()


def test_lumped_structured_matches_jax():
    """The structured path: K6 on Gw_c against the JAX XLA path, 5 steps."""
    kw = dict(scalar=LUMPED, pressure={"pc_type": "jacobi"})
    sj = _tgv2d(J, JM, JS, 6, options={"low_memory_version": False}, **kw)
    _kernel_path_x0(sj)
    stj = sj.run(5, DT, NU, max_iter=1)
    assert sj.config_report()["velocity_update"] == "lumped"
    st = _tgv2d(T, TM, TS, 6, device="cpu", **kw)
    assert st.config_report()["structured_fastpath"] is True
    kn.reset_counts()
    stt = st.run(5, DT, NU, max_iter=1)
    _check_lumped(st, stt)
    # a step: K6 on B_c and on Gw_c, no mass solve
    assert kn.plain_calls["mixed"] == 10 and kn.plain_calls["cg_mass"] == 0
    _close(st, sj, stt, stj)
    # duc is the update's correction, u_new - u_tent
    state = st.get_state()
    assert np.abs(state["duc"]).max() > 0


def test_lumped_general_rectangle_matches_jax():
    """The rectangle on the general path (structured False): the element
    weighted gradient, against the JAX ELL kernel path in interpret mode."""
    opts = {"low_memory_version": False, "structured": False}
    sj = _tgv2d(J, JM, JS, 6, scalar=LUMPED, options=dict(opts, pallas="interpret"))
    st = _tgv2d(T, TM, TS, 6, scalar=LUMPED, options=opts, device="cpu")
    _share_coarse_inverse(sj, st)
    stj = sj.run(5, DT, NU, max_iter=1)
    stt = st.run(5, DT, NU, max_iter=1)
    assert st.config_report()["structured_fastpath"] is False
    _check_lumped(st, stt)
    _close(st, sj, stt, stj)


def _vessel(pkg, M, N, scalar, options, **kw):
    mesh = deform_vessel(M.create_box((-1.0,) * 3, (1.0,) * 3, (N, N, N)))
    facets = mesh.exterior_facet_indices()
    tags = M.meshtags(mesh, 2, facets, np.full_like(facets, 1))
    bcs = [[pkg.DirichletBC(f, pkg.LocatorMethod.TOPOLOGICAL, (tags, 1))] for f in TGV]
    o = {"ksp_rtol": 1e-8, "ksp_max_it": 2000}
    s = pkg.FractionalStep_AB_CN(
        mesh, ("Lagrange", 2), ("Lagrange", 1), bcs_u=bcs, bcs_p=[],
        solver_options={"tentative": dict(o), "pressure": dict(o, amg_coarse_max=20),
                        "scalar": dict(o, **scalar)},
        options=options, dtype=np.float64 if pkg is J else torch.float64, **kw)
    for f, a, b in zip(TGV, s._u1, s._u2):
        a.interpolate(f)
        b.interpolate(f)
    return s


def test_lumped_vessel_matches_jax():
    """The vessel (BENCH_unstructured_r05.json's configuration: AMG-PCG,
    low_memory_version False, the lumped update) at N=3, 5 steps."""
    opts = {"low_memory_version": False}
    sj = _vessel(J, JM, 3, LUMPED, dict(opts, pallas="interpret"))
    st = _vessel(T, TM, 3, LUMPED, opts, device="cpu")
    _share_coarse_inverse(sj, st)
    stj = sj.run(5, 2e-3, 1.0 / 1600.0, max_iter=1)
    stt = st.run(5, 2e-3, 1.0 / 1600.0, max_iter=1)
    assert st.config_report()["path_kernels"] == ["ell_matvec", "ell_bicgstab", "ell_pcg_amg"]
    _check_lumped(st, stt)
    # the solves stop at rtol 1e-8: rounding of ~1e-11 in the iterates
    _close(st, sj, stt, stj, rtol=1e-9)
