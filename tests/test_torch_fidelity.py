"""The fidelity runs on the port against the JAX package, on the CPU in
float64.

- ``demo.fidelity_tgv``: the Taylor-Green Re=1600 sub-box configuration
  (scripts/fidelity_tgv.py: faces tagged by their normal, free slip by
  per-component Dirichlet rows, P2/P1) at N=4, dt 0.01, 5 steps, every
  solve at rtol 1e-12: E(t) from ``run``'s step callback every step
  against the JAX solver's XLA path on the same configuration, its energy
  callback the script's (``cubes.matvec_cube`` on M_c), the JAX tentative
  solve given the port's x0 (ROADMAP known difference f): 1e-9 relative.
  ``main`` runs the same (its solver at rtol 1e-12) and writes the npz.
- ``dissipation``, ``smoothed_peak`` and ``compare`` (``--compare``) on
  synthetic curves whose answers are known in closed form, and on the
  repository's own curves (FIDELITY.md's peaks).
- ``demo.fidelity_tg3d``'s float64 leg (bench.py's problem) at N=4, 2
  chunks of 5 steps, against ``bench.build_solver`` with the energy of
  scripts/fidelity_tg3d.py: 1e-9 relative at rtol 1e-12, and at the
  script's rtol 1e-6 within 1e-6 of E0 (the two packages' pressure
  multigrids differ, ROADMAP known difference a); ``main``'s JSON keys.
"""

import json
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402
import oasisx_tpu as J  # noqa: E402
import oasisx_tpu.meshes as JM  # noqa: E402
from oasisx_tpu.assembly import cubes as jcub  # noqa: E402
from oasisx_tpu.assembly import engine as jeng  # noqa: E402

from oasisx_tpu_torch.demo import fidelity_tg3d as tg3d  # noqa: E402
from oasisx_tpu_torch.demo import fidelity_tgv as tgv  # noqa: E402
from tests.test_torch_slice import _kernel_path_x0  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
N, DT, STEPS, RTOL = 4, 0.01, 5, 1e-12


def _jax_subbox(N, rtol):
    """scripts/fidelity_tgv.py's solver and energy callback."""
    L = np.pi
    mesh = JM.create_box((0.0, 0.0, 0.0), (L, L, L), (N, N, N))
    facets = mesh.exterior_facet_indices()
    mids = mesh.midpoints(mesh.dim - 1, facets)
    vals = np.zeros(len(facets), dtype=np.int32)
    tol = 1e-10
    vals[np.isclose(mids[:, 0], 0.0, atol=tol) | np.isclose(mids[:, 0], L, atol=tol)] = 1
    vals[(vals == 0) & (np.isclose(mids[:, 1], 0.0, atol=tol)
                        | np.isclose(mids[:, 1], L, atol=tol))] = 2
    vals[(vals == 0) & (np.isclose(mids[:, 2], 0.0, atol=tol)
                        | np.isclose(mids[:, 2], L, atol=tol))] = 3
    tags = JM.meshtags(mesh, mesh.dim - 1, facets, vals)
    bcs_u = [[J.DirichletBC(0.0, J.LocatorMethod.TOPOLOGICAL, (tags, g))] for g in (1, 2, 3)]
    solver = J.FractionalStep_AB_CN(
        mesh, ("Lagrange", 2), ("Lagrange", 1), bcs_u, [],
        solver_options={k: {"ksp_rtol": rtol, "ksp_max_it": 2000}
                        for k in ("tentative", "pressure", "scalar")},
        dtype=np.float64,
    )
    fs = (lambda x: np.sin(x[0]) * np.cos(x[1]) * np.cos(x[2]),
          lambda x: -np.cos(x[0]) * np.sin(x[1]) * np.cos(x[2]),
          lambda x: np.zeros_like(x[0]))
    for f, u1, u2 in zip(fs, solver._u1, solver._u2):
        u1.interpolate(f)
        u2.interpolate(f)
    cu_, sm_v = solver._cu, solver._ctx.sv

    def energy_cb(state, t):
        u = state["u"]
        e = sum(jnp.vdot(u[g], jcub.matvec_cube(u[g], cu_.M_c, sm_v)) for g in range(3))
        return 0.5 * e / L**3

    return solver, energy_cb


@pytest.fixture(scope="module")
def jax_curve():
    s, energy_cb = _jax_subbox(N, RTOL)
    _kernel_path_x0(s)
    st0 = s._state_from_functions()
    E = [float(energy_cb(dict(st0, u=st0["u1"]), 0.0))]
    stats = s.run(STEPS, DT, tgv.NU, max_iter=1, step_callback=energy_cb)
    return np.asarray(E + np.asarray(stats["callback"], dtype=np.float64).tolist())


def test_tgv_energy_matches_jax(jax_curve):
    s = tgv.build_solver(N, torch.float64, "cpu", rtol=RTOL)
    assert s._structured  # N=4 does not coarsen: K1's Chebyshev mode
    energy = tgv.energy_fn(s)
    E = [float(energy(s._state_from_functions()["u1"]))]
    for _ in range(STEPS):  # a run() call a step: the window's read every step
        st = s.run(1, DT, tgv.NU, max_iter=1, step_callback=lambda state, t: energy(state["u"]))
        assert st["u_converged"].all() and st["p_converged"].all()
        E.extend(np.asarray(st["callback"]).tolist())
    E = np.asarray(E)
    assert E.shape == jax_curve.shape == (STEPS + 1,)
    assert np.abs(E - jax_curve).max() <= 1e-9 * jax_curve[0]
    assert np.all(np.diff(E) < 0)  # the energy decays


def test_tgv_main_writes_curve(jax_curve, tmp_path, capsys, monkeypatch):
    out = tmp_path / "curve.npz"
    real = tgv.build_solver
    monkeypatch.setattr(tgv, "build_solver", lambda n, dt, dev: real(n, dt, dev, rtol=RTOL))
    res = tgv.main(["-N", str(N), "--dt", str(DT), "--T", str(STEPS * DT), "--window", "2",
                    "--device", "cpu", "--dtype", "float64",
                    "--out", str(out), "--compare", str(ROOT / "fidelity_tgv_N32_f64.npz")])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    ref_keys = {"N", "dt", "dtype", "platform", "E0", "peak_dissipation", "t_peak",
                "published_peak"}
    assert ref_keys <= set(printed) and printed["platform"] == "cpu"
    assert printed["dtype"] == "float64" and printed["compare"] == res["compare"]
    d = np.load(out)
    assert set(d.files) == {"t", "E", "eps", "meta"}
    assert np.abs(d["E"] - jax_curve).max() <= 1e-9 * jax_curve[0]
    assert np.allclose(d["t"], DT * np.arange(STEPS + 1))
    assert np.array_equal(d["eps"], tgv.dissipation(d["E"], DT))
    assert json.loads(str(d["meta"]))["E0"] == res["E0"]


def test_dissipation_and_smoothed_peak():
    dt = 0.01
    t = dt * np.arange(1001)
    # E quadratic: the central differences are exact inside
    E = 0.125 - 1e-3 * t**2
    eps = tgv.dissipation(E, dt)
    assert np.allclose(eps[1:-1], 2e-3 * t[1:-1], rtol=0, atol=1e-12)
    # a peaked dissipation: a 9-point average of a linear tent keeps its
    # slopes, so the smoothed peak is the tent's top less 4 steps' rise
    # averaged: top - (2/9)(1 + 2 + 3 + 4) slope dt
    top, slope = 0.014, 1e-3
    eps = top - slope * np.abs(t - 8.3)
    peak, tp = tgv.smoothed_peak(t, eps)
    assert tp == pytest.approx(8.3)
    assert peak == pytest.approx(top - (2 / 9) * 10 * slope * dt, rel=1e-12)
    # a curve shorter than the window: the mean of all of it, at its middle
    assert tgv.smoothed_peak(t[:5], np.arange(5.0)) == (2.0, pytest.approx(0.02))


def test_compare_synthetic(tmp_path):
    dt = 0.01
    t = dt * np.arange(1001)
    E_ref = 0.125 * np.exp(-0.1 * t)
    ref = tmp_path / "ref.npz"
    np.savez(ref, t=t, E=E_ref, eps=tgv.dissipation(E_ref, dt))
    # the run a bump away from the reference, on half the times and twice
    # the step: the reference is interpolated onto the run's times
    tr = 2 * dt * np.arange(301)
    E = 0.125 * np.exp(-0.1 * tr) + 1e-4 * np.exp(-((tr - 3.0) / 0.5) ** 2)
    c = tgv.compare(tr, E, tgv.dissipation(E, 2 * dt), ref)
    assert c["max_abs_dE"] == pytest.approx(1e-4, rel=1e-3)
    assert c["t_max_abs_dE"] == pytest.approx(3.0)
    assert c["ref_t_peak_smoothed"] == pytest.approx(0.04)  # decaying: the first window
    assert c["ref_peak_smoothed"] == pytest.approx(0.0125 * np.exp(-0.004), rel=1e-4)
    assert c["peak_rel_diff"] == pytest.approx(
        (c["peak_smoothed"] - c["ref_peak_smoothed"]) / c["ref_peak_smoothed"])
    # the run beyond the reference's end: only the shared times count
    c2 = tgv.compare(np.r_[t, t[-1] + dt], np.r_[E_ref, 1.0], np.r_[tgv.dissipation(E_ref, dt),
                                                                    0.0], ref)
    assert c2["max_abs_dE"] == 0.0


def test_compare_repository_curves():
    """FIDELITY.md's table: the smoothed peaks of the stored curves and the
    float32 curve's 1.6e-4 gap to float64."""
    f64, f32 = ROOT / "fidelity_tgv_N32_f64.npz", ROOT / "fidelity_tgv_N32_f32_exact.npz"
    d = np.load(f32)
    c = tgv.compare(d["t"], d["E"], d["eps"], f64)
    assert round(c["peak_smoothed"], 5) == 0.01403 and c["t_peak_smoothed"] == pytest.approx(8.3)
    assert round(c["ref_peak_smoothed"], 5) == 0.01398
    assert c["max_abs_dE"] == pytest.approx(1.6e-4, abs=5e-6)
    assert 0.003 < c["peak_rel_diff"] < 0.005
    # N=64 (dt 0.005): FIDELITY.md's 0.01336 at t=8.70 is the unsmoothed
    # peak, 0.013361; the 9-point average reads 0.013352 at the same time
    d64 = np.load(ROOT / "fidelity_tgv_N64_f32.npz")
    assert round(float(d64["eps"].max()), 5) == 0.01336
    peak, tp = tgv.smoothed_peak(d64["t"], d64["eps"])
    assert abs(peak - 0.01336) < 1e-5 and tp == pytest.approx(8.7)


def _jax_tg3d(rtol, chunks, chunk):
    """scripts/fidelity_tg3d.py's run() in float64 on the CPU."""
    sys.path.insert(0, str(ROOT))
    try:
        from bench import build_solver
    finally:
        sys.path.remove(str(ROOT))
    solver = build_solver(N, dtype=np.float64, rtol=rtol)
    _kernel_path_x0(solver)

    def energy():
        e = 0.0
        for i in range(3):
            ui = jnp.asarray(solver._pv(solver._u1[i].x.array), solver._dtype)
            e += float(jeng.integrate(solver._ctx, jeng.eval_v_at_qp(solver._ctx, ui) ** 2))
        return 0.5 * e / solver._vol

    es = [energy()]
    for _ in range(chunks):
        solver.run(chunk, tg3d.DT, tg3d.NU, max_iter=1)
        es.append(energy())
    return np.asarray(es)


@pytest.mark.parametrize("rtol,tol", [(1e-12, 1e-9), (1e-6, 1e-6)])
def test_tg3d_f64_leg_matches_jax(monkeypatch, rtol, tol):
    ref = _jax_tg3d(rtol, 2, 5)
    real = tg3d.build_solver
    monkeypatch.setattr(tg3d, "build_solver", lambda n, dt, dev: real(n, dt, dev, rtol=rtol))
    t, E, wall = tg3d.run(N, torch.float64, "cpu", 10, 5)
    assert np.allclose(t, [0.0, 0.01, 0.02]) and wall > 0
    assert np.abs(E - ref).max() <= tol * ref[0], np.abs(E - ref).max() / ref[0]


def test_tg3d_main_keys(tmp_path, capsys):
    out = tg3d.main(["-N", "2", "--steps", "4", "--chunk", "2", "--device", "cpu",
                     "--out", str(tmp_path / "tg3d.npz")])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert {"max_rel_energy_dev", "wall_dev", "wall_cpu", "platform"} <= set(printed)
    assert printed["platform"] == "cpu" and len(out["t"]) == 3
    # float32 against float64 on the same problem: rounding, not a method gap
    assert 0.0 < printed["max_rel_energy_dev"] < 1e-5
    assert set(np.load(tmp_path / "tg3d.npz").files) == {"t", "energy_f32_dev",
                                                         "energy_f64_cpu", "meta"}
