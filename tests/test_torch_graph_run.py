"""``run``'s graph mode on the CPU, in float64: the static-buffer step body
of ``step_graph.StepGraph`` (what the card captures as a CUDA graph and
replays) without the capture.

- The body bit for bit against the per-step loop (``_force_eager``) on the structured 3D box (N=4) and on the general path (the 2D
  rectangle with ``structured: False``, AMG pressure), 3 steps and 2 more,
  with and without a Dirichlet table and a step callback: every stat, the
  callback's outputs, the state and the plain calls equal.
- The same body against the JAX package's ``run`` (its ``lax.scan``) with
  a Dirichlet table and a callback of the time: equal iterations, u, p and
  the callback to 1e-10 (tests/test_torch_run_seq.py's problem; the general
  path's JAX solver runs its ELL kernels in interpret mode).
- A second ``run`` with another dt replaces the graph and equals a fresh
  solver's run from the same state.
- ``config_report()["run"]``: "graph" on both paths' defaults, "eager:
  <reason>" for ``max_iter`` 2, a tentative ``ksp_type`` cg, the general
  path's Jacobi pressure and a forced loop; a callback that
  returns a host number is refused by name.
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
}


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


def _runs(s, variant):
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
        out.append(s.run(n, DT, NU, max_iter=1, **kw))
    return out, dict(kn.plain_calls)


@pytest.mark.parametrize("variant", ["frozen", "table+callback"])
@pytest.mark.parametrize("path", ["box", "general"])
def test_graph_body_matches_eager_loop(path, variant):
    make = _box if path == "box" else _rect
    a, b = make("graph"), make("eager")
    assert a.config_report()["run"] == "graph"
    assert b.config_report()["run"] == "eager: forced, for a comparison with the graph"
    (ra, ca), (rb, cb) = _runs(a, variant), _runs(b, variant)
    assert a._graph is not None and b._graph is None
    assert ca == cb and sum(ca.values()) > 0
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


@pytest.mark.parametrize("path", ["structured", "general-amg"])
def test_graph_run_matches_jax(path):
    """The body with a Dirichlet table and a callback of t against the
    JAX package's scan."""
    def table_run(pkg, meshes, cb, jax_path=None, **kw):
        clock = {"t": 0.0}
        s = _make(pkg, meshes, jax_path or path, clock, **kw)
        if pkg is J and path == "structured":
            _kernel_path_x0(s)
        times = [(k + 1) * DT for k in range(3)]
        table = s.bc_value_table(times, update=lambda t: clock.update(t=t))
        return s, s.run(3, DT, NU, max_iter=1, bc_vals_seq=table, step_callback=cb, t0=0.0)

    sj, stj = table_run(J, JM, _jax_energy, jax_path=path + "-jax" if path != "structured"
                        else path)
    st, stt = table_run(T, TM, _torch_energy, device="cpu")
    assert st.config_report()["run"] == "graph" and st._graph is not None
    for k in ("u_iters", "p_iters", "c_iters"):
        np.testing.assert_array_equal(stt[k], stj[k], err_msg=k)
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


def test_run_mode_report():
    s = _box()
    assert s.config_report()["run"] == "graph"
    s.run(1, DT, NU, max_iter=2)
    assert s.config_report()["run"] == "eager: max_iter > 1 reads diff between the inner " \
        "iterations"
    s.run(1, DT, NU)
    assert s.config_report()["run"] == "graph"
    assert _rect().config_report()["run"] == "graph"
    cg = _make(T, TM, "structured-cg", device="cpu")
    assert cg.config_report()["run"] == "eager: the tentative cg solve loops on the host"
    gm = _make(T, TM, "general", device="cpu")
    assert gm.config_report()["run"] == "eager: the tentative gmres solve loops on the host"
    jac = _make(T, TM, "general-jacobi", device="cpu")
    assert jac.config_report()["run"] == "eager: the pressure jacobi-pcg solve loops on the host"
    with pytest.raises(CallbackError, match="_host_number"):
        s.run(1, DT, NU, step_callback=_host_number)


def _host_number(st, t):
    return float(st["u"].sum())
