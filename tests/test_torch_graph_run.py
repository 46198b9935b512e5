"""``run``'s graph mode on the CPU, in float64: the static-buffer step body
of ``step_graph.StepGraph`` (what the card captures as a CUDA graph and
replays) without the capture.

- The body bit for bit against the per-step loop (``_force_eager``) on the structured 3D box (N=4) and on the general path (the 2D
  rectangle with ``structured: False``, AMG pressure), 3 steps and 2 more,
  with and without a Dirichlet table and a step callback: every stat, the
  callback's outputs, the state and the plain calls equal.  The same on
  the box at ``max_iter`` 3 (the inner loop a device while loop), also
  with a ``max_error`` that ends some steps after 2 inner iterations, and
  on the option paths whose Krylov loops are device while loops: the
  structured tentative CG, the general path's Jacobi and Chebyshev
  pressure CG and its tentative GMRES (``inner_iters`` and ``diff`` equal
  too).
- The same body against the JAX package's ``run`` (its ``lax.scan``) with
  a Dirichlet table and a callback of the time: equal iterations, u, p and
  the callback to 1e-10 (tests/test_torch_run_seq.py's problem; the general
  path's JAX solver runs its ELL kernels in interpret mode); on the
  structured path also at ``max_iter`` 3 (the JAX ``lax.while_loop`` inner
  loop), ``inner_iters`` equal.
- A second ``run`` with another dt replaces the graph and equals a fresh
  solver's run from the same state; a dropped solver frees its graph at
  once (no reference cycle between them).
- ``config_report()["run"]``: "graph" on every single-device
  configuration (``max_iter`` 2, a tentative ``ksp_type`` cg or gmres, the
  general path's Jacobi pressure), "eager: <reason>" for a forced loop; a
  callback that returns a host number is refused by name.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

import oasisx_tpu as J  # noqa: E402
import oasisx_tpu.meshes as JM  # noqa: E402
import oasisx_tpu_torch as T  # noqa: E402
import oasisx_tpu_torch.meshes as TM  # noqa: E402
from oasisx_tpu_torch.assembly import kernels as kn  # noqa: E402
from oasisx_tpu_torch.step_graph import CallbackError  # noqa: E402
from tests import test_torch_run_seq as rs  # noqa: E402
from tests.test_torch_slice import _kernel_path_x0, _up  # noqa: E402
from tests.test_torch_unstructured import TGV  # noqa: E402

DT, NU = rs.DT, rs.NU
# more of tests/test_torch_run_seq.py's rectangle: the general path's
# defaults (BiCGStab, AMG-PCG with a coarse level of at most 10 points; the
# JAX solver's ELL kernels in interpret mode), and the option solves
PATHS = {
    "general-amg": ({"structured": False}, {}, {"amg_coarse_max": 10}),
    "general-amg-jax": ({"structured": False, "pallas": "interpret"}, {}, {"amg_coarse_max": 10}),
    "structured-cg": ({"low_memory_version": False}, {"ksp_type": "cg"}, {"pc_type": "jacobi"}),
    "general-jacobi": ({"structured": False}, {}, {"pc_type": "jacobi"}),
    "general-cheb": ({"structured": False}, {}, {"pc_type": "cheb"}),
}
# a max_error between the box's diffs after 2 and after 1 inner iterations
# (0.21-0.068 and 0.42-0.27 over steps 1-5), so some of its steps end
# after 2 of their 3
MAX_ERROR = 0.1


def _make(pkg, meshes, path, clock=None, **kw):
    """tests/test_torch_run_seq.py's ``_make`` on its paths and ours."""
    saved = dict(rs.PATHS)
    rs.PATHS.update(PATHS)
    try:
        return rs._make(pkg, meshes, path, {"t": 0.0} if clock is None else clock, **kw)
    finally:
        rs.PATHS.clear()
        rs.PATHS.update(saved)


def _box(run="graph"):
    """The 3D Taylor-Green box at N=4 on the structured path."""
    mesh = TM.create_box((-1.0,) * 3, (1.0,) * 3, (4, 4, 4))
    facets = mesh.exterior_facet_indices()
    tags = TM.meshtags(mesh, 2, facets, np.full_like(facets, 1))
    o = {"ksp_rtol": 1e-8, "ksp_max_it": 2000}
    s = T.FractionalStep_AB_CN(
        mesh, ("Lagrange", 2), ("Lagrange", 1),
        bcs_u=[[T.DirichletBC(f, T.LocatorMethod.TOPOLOGICAL, (tags, 1))] for f in TGV],
        solver_options={"tentative": dict(o), "pressure": dict(o), "scalar": dict(o)},
        dtype=torch.float64, device="cpu")
    for f, a, b in zip(TGV, s._u1, s._u2):
        a.interpolate(f)
        b.interpolate(f)
    s._force_eager = run == "eager"
    return s


def _rect(run="graph"):
    s = _make(T, TM, "general-amg", device="cpu")
    s._force_eager = run == "eager"
    return s


def _energy(st, t):
    return {"E": (st["u"] ** 2).sum() * torch.cos(2.0 * t), "t": t, "pmax": st["p"].abs().amax()}


def _runs(s, variant, max_iter=1, max_error=1e-12):
    kn.reset_counts()
    out = []
    for n in (3, 2):
        kw = {}
        if variant == "table+callback":
            times = [(len(out) * 3 + k + 1) * DT for k in range(n)]
            scale = lambda t: 1.0 + t
            table = s.bc_value_table(times)
            kw = dict(bc_vals_seq=table * torch.as_tensor([scale(t) for t in times],
                                                            dtype=table.dtype)[:, None, None],
                      step_callback=_energy, t0=len(out) * 3 * DT)
        out.append(s.run(n, DT, NU, max_iter=max_iter, max_error=max_error, **kw))
    return out, dict(kn.plain_calls)


def _option(path):
    def make(run="graph"):
        s = _make(T, TM, path, device="cpu")
        s._force_eager = run == "eager"
        return s
    return make


# (path, variant, max_iter, max_error)
BODY_CASES = [
    pytest.param("box", "frozen", 1, 1e-12, id="box-frozen"),
    pytest.param("box", "table+callback", 1, 1e-12, id="box-table+callback"),
    pytest.param("general", "frozen", 1, 1e-12, id="general-frozen"),
    pytest.param("general", "table+callback", 1, 1e-12, id="general-table+callback"),
    pytest.param("box", "frozen", 3, 1e-12, id="box-max_iter3"),
    pytest.param("box", "table+callback", 3, MAX_ERROR, id="box-max_iter3-max_error"),
    pytest.param("structured-cg", "frozen", 1, 1e-12, id="structured-cg"),
    pytest.param("general-jacobi", "frozen", 1, 1e-12, id="general-jacobi"),
    pytest.param("general-cheb", "frozen", 2, 1e-12, id="general-cheb-max_iter2"),
    pytest.param("general-gmres", "table+callback", 1, 1e-12, id="general-gmres"),
]


@pytest.mark.parametrize("path,variant,max_iter,max_error", BODY_CASES)
def test_graph_body_matches_eager_loop(path, variant, max_iter, max_error):
    make = {"box": _box, "general": _rect,
            "general-gmres": _option("general")}.get(path) or _option(path)
    a, b = make("graph"), make("eager")
    assert a.config_report()["run"] == "graph"
    assert b.config_report()["run"] == "eager: forced, for a comparison with the graph"
    (ra, ca), (rb, cb) = _runs(a, variant, max_iter, max_error), \
        _runs(b, variant, max_iter, max_error)
    assert a._graph is not None and b._graph is None
    assert ca == cb and sum(ca.values()) > 0
    inner = np.concatenate([r["inner_iters"] for r in ra])
    if max_iter == 1:
        assert (inner == 1).all()
    elif max_error == MAX_ERROR:
        assert set(inner.tolist()) == {2, 3}, inner
    else:
        assert (inner == max_iter).all(), inner
    for sa, sb in zip(ra, rb):
        assert sorted(sa) == sorted(sb)
        for k in sa:
            if k == "callback":
                for c in sa[k]:
                    np.testing.assert_array_equal(sa[k][c], sb[k][c], err_msg=c)
            else:
                np.testing.assert_array_equal(sa[k], sb[k], err_msg=k)
    if variant == "table+callback":
        assert ra[1]["callback"]["t"] == pytest.approx([4 * DT, 5 * DT], rel=1e-14)
    for key in ("u", "u1", "u2", "p", "dp", "duc"):
        np.testing.assert_array_equal(a.get_state()[key], b.get_state()[key], err_msg=key)


def _jax_energy(st, t):
    return {"E": (st["u"] ** 2).sum() * jnp.cos(2.0 * t), "t": t}


def _torch_energy(st, t):
    return {"E": (st["u"] ** 2).sum() * torch.cos(2.0 * t), "t": t}


@pytest.mark.parametrize("path", ["structured", "general-amg", "structured-max_iter3"])
def test_graph_run_matches_jax(path):
    """The body with a Dirichlet table and a callback of t against the
    JAX package's scan; at max_iter 3 its inner loop against the JAX
    package's ``lax.while_loop``."""
    max_iter = 3 if path.endswith("max_iter3") else 1
    path = path.replace("-max_iter3", "")

    def table_run(pkg, meshes, cb, jax_path=None, **kw):
        clock = {"t": 0.0}
        s = _make(pkg, meshes, jax_path or path, clock, **kw)
        if pkg is J and path == "structured":
            _kernel_path_x0(s)
        times = [(k + 1) * DT for k in range(3)]
        table = s.bc_value_table(times, update=lambda t: clock.update(t=t))
        return s, s.run(3, DT, NU, max_iter=max_iter, bc_vals_seq=table, step_callback=cb,
                        t0=0.0)

    sj, stj = table_run(J, JM, _jax_energy, jax_path=path + "-jax" if path != "structured"
                        else path)
    st, stt = table_run(T, TM, _torch_energy, device="cpu")
    assert st.config_report()["run"] == "graph" and st._graph is not None
    for k in ("u_iters", "p_iters", "c_iters", "inner_iters"):
        np.testing.assert_array_equal(stt[k], stj[k], err_msg=k)
    assert (stt["inner_iters"] == max_iter).all()
    (ut, pt), (uj, pj) = _up(st), _up(sj)
    assert np.abs(ut - uj).max() <= rs.RTOL * np.abs(uj).max()
    assert np.abs(pt - pj).max() <= rs.RTOL * np.abs(pj).max()
    cj = stj["callback"].item()  # the JAX run's stats hold the callback's dict as an object
    et, ej = stt["callback"]["E"], np.asarray(cj["E"])
    assert np.abs(et - ej).max() <= rs.RTOL * np.abs(ej).max()
    np.testing.assert_allclose(stt["callback"]["t"], np.asarray(cj["t"]), rtol=1e-15)


def test_second_dt_replaces_the_graph():
    a = _box()
    a.run(2, DT, NU)
    first = a._graph
    state = a.get_state()
    sa = a.run(2, 2 * DT, NU)
    assert a._graph is not first and a._graph.key[0] == 2 * DT
    b = _box()
    b.set_state(state)
    sb = b.run(2, 2 * DT, NU)
    for k in sa:
        np.testing.assert_array_equal(sa[k], sb[k], err_msg=k)
    for key, v in a.get_state().items():
        np.testing.assert_array_equal(v, b.get_state()[key], err_msg=key)


def test_dropped_solver_frees_its_graph():
    """The StepGraph reaches its solver through a weak reference: a solver
    dropped after run (its inner loop a device while loop) is freed at once,
    with its graph, without the cyclic collector."""
    import gc
    import weakref

    s = _box()
    s.run(2, DT, NU, max_iter=2)
    solver, graph = weakref.ref(s), weakref.ref(s._graph)
    enabled = gc.isenabled()
    gc.disable()
    try:
        del s
        assert solver() is None and graph() is None
    finally:
        if enabled:
            gc.enable()


def test_run_mode_report():
    s = _box()
    assert s.config_report()["run"] == "graph"
    s.run(1, DT, NU, max_iter=2)
    assert s.config_report()["run"] == "graph"
    s.run(1, DT, NU)
    assert s.config_report()["run"] == "graph"
    assert _rect().config_report()["run"] == "graph"
    cg = _make(T, TM, "structured-cg", device="cpu")
    assert cg.config_report()["run"] == "graph"
    gm = _make(T, TM, "general", device="cpu")
    assert gm.config_report()["run"] == "graph"
    jac = _make(T, TM, "general-jacobi", device="cpu")
    assert jac.config_report()["run"] == "graph"
    s._force_eager = True
    assert s.config_report()["run"] == "eager: forced, for a comparison with the graph"
    s._force_eager = False
    with pytest.raises(CallbackError, match="_host_number"):
        s.run(1, DT, NU, step_callback=_host_number)


def _host_number(st, t):
    return float(st["u"].sum())
