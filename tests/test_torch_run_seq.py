"""Time-dependent boundary data and per-step monitors in the port's ``run``,
on the CPU in float64.

- ``run(bc_vals_seq=bc_value_table(...))`` against the per-step ``solve``
  loop that re-evaluates the boundary data each step
  (tests/test_taylor_green.py's test_run_with_time_dependent_bcs_matches_per_step),
  on both paths, to 1e-10; and against the JAX package's ``run`` with its
  own table (the XLA path; the structured path with the kernel path's
  tentative x0 and Jacobi-CG pressure, the general path with GMRES
  tentative solves): equal iterations, u and p to 1e-10.
- ``h_qvals_seq`` on the DFG cylinder with an outlet pressure that changes
  each step, against the per-step loop and the JAX package.
- Two different ``step_callback``s in turn, a dict-valued one (the time a
  0-d tensor), and the tables' shape checks.
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
from tests.test_torch_options import _cylinder  # noqa: E402
from tests.test_torch_slice import _kernel_path_x0, _up  # noqa: E402

DT, NU, STEPS = 0.01, 0.05, 4
RTOL = 1e-10
PATHS = {
    # options, tentative, pressure solver options
    "structured": ({"low_memory_version": False}, {}, {"pc_type": "jacobi"}),
    "general": ({"low_memory_version": False, "structured": False}, {"ksp_type": "gmres"},
                {"pc_type": "jacobi"}),
}


def _make(pkg, meshes, path, clock, **kw):
    """The 2D box with a Dirichlet field scaled by cos(2t), t read from
    ``clock`` when the BCs are evaluated; u1 = u2 = the t=0 field."""
    mesh = meshes.create_rectangle((-1.0, -1.0), (1.0, 1.0), (6, 6))
    facets = mesh.exterior_facet_indices()
    tags = meshes.meshtags(mesh, mesh.dim - 1, facets, np.full_like(facets, 1))
    gx = lambda x: np.sin(np.pi * x[0]) * np.cos(np.pi * x[1]) * np.cos(2 * clock["t"])
    gy = lambda x: -np.cos(np.pi * x[0]) * np.sin(np.pi * x[1]) * np.cos(2 * clock["t"])
    T_ = pkg.LocatorMethod.TOPOLOGICAL
    options, tent, pres = PATHS[path]
    o = {"ksp_rtol": 1e-12, "ksp_max_it": 2000}
    s = pkg.FractionalStep_AB_CN(
        mesh, ("Lagrange", 2), ("Lagrange", 1),
        bcs_u=[[pkg.DirichletBC(gx, T_, (tags, 1))], [pkg.DirichletBC(gy, T_, (tags, 1))]],
        bcs_p=[], options=options, dtype=np.float64 if pkg is J else torch.float64,
        solver_options={"tentative": dict(o, **tent), "pressure": dict(o, **pres),
                        "scalar": dict(o)}, **kw)
    for i, g in enumerate((gx, gy)):
        s._u1[i].interpolate(g)
        s._u2[i].interpolate(g)
    return s


def _table_run(pkg, meshes, path, **kw):
    clock = {"t": 0.0}
    s = _make(pkg, meshes, path, clock, **kw)
    if pkg is J and path == "structured":
        _kernel_path_x0(s)
    times = [(k + 1) * DT for k in range(STEPS)]
    table = s.bc_value_table(times, update=lambda t: clock.update(t=t))
    stats = s.run(STEPS, DT, NU, max_iter=1, bc_vals_seq=table)
    return s, stats, table


@pytest.mark.parametrize("path", list(PATHS))
def test_run_with_time_dependent_bcs_matches_per_step(path):
    clock = {"t": 0.0}
    s1 = _make(T, TM, path, clock, device="cpu")
    for k in range(STEPS):
        clock["t"] = (k + 1) * DT
        s1.solve(DT, NU, max_iter=1)
    s2, stats, table = _table_run(T, TM, path, device="cpu")
    assert s2.config_report()["structured_fastpath"] is (path == "structured")
    assert isinstance(table, torch.Tensor) and table.shape == (STEPS, 2, s2._Vi[0][0].num_dofs)
    assert stats["u_iters"].shape == (STEPS, 2)
    (ua, pa), (ub, pb) = _up(s1), _up(s2)
    assert np.abs(ua - ub).max() <= RTOL * np.abs(ua).max()
    assert np.abs(pa - pb).max() <= RTOL * np.abs(pa).max()
    # a frozen-BC run parts from both
    s3 = _make(T, TM, path, {"t": 0.0}, device="cpu")
    s3.run(STEPS, DT, NU, max_iter=1)
    assert np.abs(_up(s3)[0] - ua).max() > 1e-4


@pytest.mark.parametrize("path", list(PATHS))
def test_run_with_bc_table_matches_jax(path):
    sj, stj, _ = _table_run(J, JM, path)
    st, stt, _ = _table_run(T, TM, path, device="cpu")
    for k in ("u_iters", "p_iters", "c_iters"):
        np.testing.assert_array_equal(stt[k], stj[k], err_msg=k)
    (ut, pt), (uj, pj) = _up(st), _up(sj)
    assert np.abs(ut - uj).max() <= RTOL * np.abs(uj).max()
    assert np.abs(pt - pj).max() <= RTOL * np.abs(pj).max()


def _outlet_run(pkg, meshes, spaces, seq: bool, **kw):
    """The cylinder whose outlet pressure is a Constant set to 0.05 sin(20 t):
    a table of the outlet values over the steps, or the per-step loop."""
    h = spaces.Constant(0.0)
    s = _cylinder(pkg, meshes, {"pc_type": "jacobi"}, {"ksp_type": "gmres"}, h_outlet=h,
                  **kw)
    set_t = lambda t: setattr(h, "value", np.asarray(0.05 * np.sin(20.0 * t)))
    times = [(k + 1) * 2e-3 for k in range(3)]
    if seq:
        table = s.h_value_table(times, update=set_t)
        assert len(table) == 1 and table[0].shape[0] == 3
        s.run(3, 2e-3, 1e-3, max_iter=1, h_qvals_seq=table)
    else:
        for t in times:
            set_t(t)
            s.solve(2e-3, 1e-3, max_iter=1)
    return _up(s)


def test_outlet_table_matches_per_step_and_jax():
    (ua, pa), (ub, pb) = (_outlet_run(T, TM, TS, seq, device="cpu") for seq in (True, False))
    assert np.abs(ua - ub).max() <= RTOL * np.abs(ua).max()
    assert np.abs(pa - pb).max() <= RTOL * np.abs(pa).max()
    uj, pj = _outlet_run(J, JM, JS, True)
    assert np.abs(ua - uj).max() <= 1e-9 * np.abs(uj).max()
    assert np.abs(pa - pj).max() <= 1e-9 * np.abs(pj).max()


def test_step_callbacks_in_turn():
    """A second run with another callback returns that callback's values
    (tests/test_taylor_green.py's test_run_different_callbacks_not_cached_stale),
    a dict-valued callback stacks each entry, and the time is the end of
    each step from t0."""
    s = _make(T, TM, "structured", {"t": 0.0}, device="cpu")
    energy = lambda st, t: (st["u"] ** 2).sum()
    pmax = lambda st, t: st["p"].abs().max()
    e = s.run(2, DT, NU, step_callback=energy)["callback"]
    p = s.run(2, DT, NU, step_callback=pmax)["callback"]
    assert e.shape == p.shape == (2,) and not np.allclose(e, p)
    assert (p < 1.0).all() and (e > 1.0).all()
    times = []
    out = s.run(3, DT, NU, t0=1.0, step_callback=lambda st, t: times.append(t) or
                {"t": t, "umax": (st["u"].abs().amax(dim=-1), st["p"].sum())})
    # the time is a 0-d tensor of the solver's dtype (each step's own)
    assert all(t.shape == () and t.dtype == torch.float64 for t in times)
    assert [float(t) for t in times] == pytest.approx([1.0 + DT, 1.0 + 2 * DT, 1.0 + 3 * DT])
    cb = out["callback"]
    assert cb["t"] == pytest.approx(times)
    assert cb["umax"][0].shape == (3, 2) and cb["umax"][1].shape == (3,)
    assert "callback" not in s.run(1, DT, NU)


def test_tables_are_checked():
    s = _make(T, TM, "structured", {"t": 0.0}, device="cpu")
    table = s.bc_value_table([DT, 2 * DT])
    with pytest.raises(ValueError, match="bc_vals_seq"):
        s.run(3, DT, NU, bc_vals_seq=table)
    with pytest.raises(ValueError, match="h_qvals_seq"):
        s.run(2, DT, NU, h_qvals_seq=[table])
