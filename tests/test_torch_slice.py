"""The port's IPCS step against the JAX solver, end to end, on the CPU.

- 3D, float64: the bench problem (bench.py ``build_solver`` semantics) at
  N=6, rtol 1e-10, 3 steps, max_iter 1, against the JAX solver's default
  CPU path with its kernel path's tentative initial guess: u and p to 1e-7
  relative, u/c iterations within 1 per step (the JAX CPU path runs
  per-component BiCGStab and CG; p iterations may differ, its pressure
  preconditioner is la/multigrid.py).
- State carry-over: the port started from the JAX state after 2 steps
  takes the third step as JAX does (1e-8).
- 2D, float32: the pallas-wiring recipe against the JAX kernel path in
  interpret mode, at the bounds the JAX package holds its own f32 engines
  to (5e-4 on u, 5e-3 on p).
- The port imports neither jax nor oasisx_tpu: the solver, its kernels,
  ``io``, the CLI, ``utils``, every demo module, the slab path's
  ``parallel`` modules and ``la.multigrid``.
"""

import subprocess
import sys
from pathlib import Path

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

DT, NU = 2e-3, 1.0 / 1600.0
TGV = (
    lambda x: np.sin(np.pi * x[0]) * np.cos(np.pi * x[1]) * np.cos(np.pi * x[2]),
    lambda x: -np.cos(np.pi * x[0]) * np.sin(np.pi * x[1]) * np.cos(np.pi * x[2]),
    lambda x: np.zeros_like(x[0]),
)


def _arr(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _tgv3d(pkg, meshes, N=6, rtol=1e-10, popts=None, **kw):
    mesh = meshes.create_box((-1.0, -1.0, -1.0), (1.0, 1.0, 1.0), (N, N, N))
    facets = mesh.exterior_facet_indices()
    tags = meshes.meshtags(mesh, mesh.dim - 1, facets, np.full_like(facets, 1))
    bcs_u = [[pkg.DirichletBC(f, pkg.LocatorMethod.TOPOLOGICAL, (tags, 1))] for f in TGV]
    opts = {"ksp_rtol": rtol, "ksp_max_it": 2000}
    solver = pkg.FractionalStep_AB_CN(
        mesh, ("Lagrange", 2), ("Lagrange", 1), bcs_u=bcs_u, bcs_p=[],
        solver_options={"tentative": dict(opts), "pressure": dict(opts, **(popts or {})),
                        "scalar": dict(opts)},
        dtype=np.float64, **kw,
    )
    for f, u1, u2 in zip(TGV, solver._u1, solver._u2):
        u1.interpolate(f)
        u2.interpolate(f)
    return solver


def _up(solver):
    return np.stack([_arr(f.x.array) for f in solver._u]), _arr(solver._p.x.array)


def _cat(*stats):
    return {k: np.concatenate([s[k] for s in stats]) for k in ("u_iters", "p_iters", "c_iters")}


def _kernel_path_x0(solver):
    """Give the JAX solver's float64 XLA tentative solve the initial guess
    of its kernel path (oasisx_tpu/fracstep.py:2395): Dirichlet rows of x0
    preset to the bc values.  The port runs the kernel path's formulation
    on every device; the JAX package builds that path in float32 only.  The
    velocity update does not re-apply the bcs, so from the second step on
    the two guesses differ on bc rows and so do the iteration counts."""
    solve = solver._tentative_solve_dev

    def preset(P, A_lhs, rhs1, bc_vals, u, x0=None):
        x0 = u if x0 is None else x0
        return solve(P, A_lhs, rhs1, bc_vals, u, x0=jnp.where(P["bc_masks"], bc_vals, x0))

    solver._tentative_solve_dev = preset


@pytest.fixture(scope="module")
def jax3d():
    """JAX 3D run: 2 steps, its state, 1 more step."""
    s = _tgv3d(J, JM, options={"low_memory_version": False})
    _kernel_path_x0(s)
    st2 = dict(s.run(2, DT, NU, max_iter=1))
    state = {k: np.asarray(v) for k, v in s._state_from_functions().items()}
    st3 = dict(s.run(1, DT, NU, max_iter=1))
    u, p = _up(s)
    return dict(stats=_cat(st2, st3), state=state, u=u, p=p)


def test_slice_3d_f64_matches_jax(jax3d):
    s = _tgv3d(T, TM, device="cpu")
    assert s.config_report()["pressure_pc"] == "mg-pcg"
    stats = _cat(s.run(2, DT, NU, max_iter=1), s.run(1, DT, NU, max_iter=1))
    u, p = _up(s)
    assert np.abs(u - jax3d["u"]).max() <= 1e-7 * np.abs(jax3d["u"]).max()
    assert np.abs(p - jax3d["p"]).max() <= 1e-7 * np.abs(jax3d["p"]).max()
    for k in ("u_iters", "c_iters"):
        assert np.abs(stats[k] - jax3d["stats"][k]).max() <= 1, (k, stats[k], jax3d["stats"][k])
    assert np.all(s.last_stats["u_converged"]) and np.all(s.last_stats["c_converged"])
    assert s.last_stats["host_syncs"].shape == (1,) and s.last_stats["host_syncs"][0] > 0


def test_state_carry_over(jax3d):
    """set_state from the JAX state after 2 steps, then one more step."""
    s = _tgv3d(T, TM, device="cpu")
    s.set_state(jax3d["state"])
    got = s.get_state()
    for k, v in jax3d["state"].items():
        assert np.array_equal(got[k], v), k
    s.run(1, DT, NU, max_iter=1)
    u, p = _up(s)
    assert np.abs(u - jax3d["u"]).max() <= 1e-8 * np.abs(jax3d["u"]).max()
    assert np.abs(p - jax3d["p"]).max() <= 1e-8 * np.abs(jax3d["p"]).max()


def test_host_write_resets_device_state():
    """A write into a state Function after a run rebuilds the device state
    from the Functions (warm-start correction reset), as the JAX solver
    does after a host write."""
    s = _tgv3d(T, TM, N=6, rtol=1e-8, device="cpu")
    s.run(1, DT, NU)
    assert s._state_from_functions() is s._state
    s._u[0].x.array[:] *= 1.0
    st = s._state_from_functions()
    assert st is not s._state and float(st["duc"].abs().max()) == 0.0


# --- 2D float32 against the JAX kernel path (tests/test_pallas_wiring.py recipe)

SOLVER_OPTS = {
    "tentative": {"ksp_type": "bcgs", "rtol": 1e-10, "max_it": 200},
    "pressure": {"ksp_type": "cg", "rtol": 1e-10, "max_it": 200},
    "scalar": {"ksp_type": "cg", "rtol": 1e-10, "max_it": 200},
}
NU2, DT2, N2 = 0.01, 0.01, 6


class _TG:
    def __init__(self, t, nu):
        self.t, self.nu = t, nu

    def _decay(self):
        return np.exp(-2.0 * self.nu * np.pi**2 * float(self.t.value))

    def eval_x(self, x):
        return -np.cos(np.pi * x[0]) * np.sin(np.pi * x[1]) * self._decay()

    def eval_y(self, x):
        return np.cos(np.pi * x[1]) * np.sin(np.pi * x[0]) * self._decay()


def _run2d(pkg, meshes, spaces, nsteps=3, N=N2, **kw):
    mesh = meshes.create_rectangle((-1, -1), (1, 1), (N, N))
    facets = mesh.exterior_facet_indices()
    tags = meshes.meshtags(mesh, mesh.dim - 1, facets, np.full_like(facets, 3))
    t_u = spaces.Constant(0.0)
    u_ex = _TG(t_u, NU2)
    bcx = pkg.DirichletBC(u_ex.eval_x, pkg.LocatorMethod.TOPOLOGICAL, (tags, 3))
    bcy = pkg.DirichletBC(u_ex.eval_y, pkg.LocatorMethod.TOPOLOGICAL, (tags, 3))
    solver = pkg.FractionalStep_AB_CN(
        mesh, ("Lagrange", 2), ("Lagrange", 1), bcs_u=[[bcx], [bcy]], bcs_p=[],
        solver_options=SOLVER_OPTS, dtype=np.float32, **kw,
    )
    t_u.value = np.asarray(-DT2)
    solver._u2[0].interpolate(u_ex.eval_x)
    solver._u2[1].interpolate(u_ex.eval_y)
    t_u.value = np.asarray(0.0)
    solver._u1[0].interpolate(u_ex.eval_x)
    solver._u1[1].interpolate(u_ex.eval_y)
    for _ in range(nsteps):
        t_u.value = np.asarray(float(t_u.value) + DT2)
        solver.solve(DT2, NU2, max_iter=2)
        assert bool(np.asarray(solver.last_stats["u_converged"]).all())
        assert bool(np.asarray(solver.last_stats["p_converged"]))
    return _up(solver)


def test_slice_2d_f32_matches_jax_kernel_path():
    u0, p0 = _run2d(J, JM, JS, options={"pallas": "interpret"})
    u1, p1 = _run2d(T, TM, TS, device="cpu")
    uscale = np.abs(u0).max()
    pscale = max(np.abs(p0).max(), 1e-3)
    assert np.abs(u1 - u0).max() / uscale < 5e-4, np.abs(u1 - u0).max() / uscale
    assert np.abs(p1 - p0).max() / pscale < 5e-3, np.abs(p1 - p0).max() / pscale


def test_port_imports_no_jax():
    code = (
        "import sys, oasisx_tpu_torch, oasisx_tpu_torch.fracstep, "
        "oasisx_tpu_torch.assembly.kernels, oasisx_tpu_torch._build, oasisx_tpu_torch.io, "
        "oasisx_tpu_torch.main, oasisx_tpu_torch.__main__, oasisx_tpu_torch.demo.taylor_green, "
        "oasisx_tpu_torch.demo.taylor_green3d, oasisx_tpu_torch.demo.channel, "
        "oasisx_tpu_torch.demo.cylinder, oasisx_tpu_torch.demo.vessel, "
        "oasisx_tpu_torch.demo.assembly_bcs, oasisx_tpu_torch.demo.assembly_strategies, "
        "oasisx_tpu_torch.demo.fidelity_tgv, oasisx_tpu_torch.demo.fidelity_tg3d, "
        "oasisx_tpu_torch.utils, oasisx_tpu_torch.utils.timers, oasisx_tpu_torch.parallel.slab, "
        "oasisx_tpu_torch.parallel.comm, oasisx_tpu_torch.parallel.launch, "
        "oasisx_tpu_torch.parallel.ranks, oasisx_tpu_torch.parallel.partition, "
        "oasisx_tpu_torch.parallel.sharding, oasisx_tpu_torch.parallel.graph, "
        "oasisx_tpu_torch.la.multigrid;"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'oasisx_tpu')];"
        "assert not bad, bad"
    )
    root = Path(__file__).resolve().parent.parent
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=300, cwd=root)
    assert r.returncode == 0, r.stderr
