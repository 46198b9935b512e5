"""The port's general (unstructured) path end to end against the JAX
package's single-device ELL kernel path, on the CPU, in float64.

- The vessel-deformed Taylor-Green box (bench.py ``build_solver(mode=
  "unstructured")`` semantics) at N=3, 3 steps, rtol 1e-8, both
  ``low_memory_version`` strategies; with ``amg_coarse_max`` 20 the AMG
  has three levels, so the V-cycle's transfers run.
- The DFG cylinder (tests/test_ell_wiring.py's set-up) at res=10 with its
  outlet PressureBC, 3 steps: the outlet mask variant of the pressure
  solve and the surface terms of the tentative right-hand side.

The JAX solver runs its ELL kernels in interpret mode
(``options={"pallas": "interpret"}``) with the port's coarse pseudo-
inverse (the port cuts the rounding-level null mode of a singular coarse
operator, tests/test_torch_amg.py).  Per-step u/p/c iteration counts are
equal, and u and p agree to 1e-9 relative to their largest entry: both run
the same float64 algorithm with sums in another order, and the solves stop
at rtol 1e-8, which leaves rounding differences of ~1e-11 (measured) in
the iterates.  Also: the state round trip on the general path and the
card as the default device (the band layout is in tests/test_torch_band.py,
the lumped update and the other solver options in tests/test_torch_lumped.py
and tests/test_torch_options.py).
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
from oasisx_tpu.assembly import pallas_ops as po  # noqa: E402
from oasisx_tpu_torch.assembly import kernels as kn  # noqa: E402

RTOL = 1e-9
TGV = (
    lambda x: np.sin(np.pi * x[0]) * np.cos(np.pi * x[1]) * np.cos(np.pi * x[2]),
    lambda x: -np.cos(np.pi * x[0]) * np.sin(np.pi * x[1]) * np.cos(np.pi * x[2]),
    lambda x: np.zeros_like(x[0]),
)


def deform_vessel(mesh):
    """bench.py's vessel deformation; marks the mesh unstructured."""
    x = mesh.x.copy()
    lo, hi = x[:, 0].min(), x[:, 0].max()
    s = (x[:, 0] - lo) / (hi - lo)
    r = (1.0 - 0.25 * s) * (1.0 + 0.55 * np.exp(-(((s - 0.55) / 0.12) ** 2)))
    x[:, 1] = 0.45 * np.sin(np.pi * s) + 1.0 * r * x[:, 1]
    x[:, 2] = 0.3 * np.sin(np.pi * s * 0.9) + 0.8 * r * x[:, 2]
    mesh.x[:] = x
    mesh.structured = None
    return mesh


def _vessel(pkg, M, N, options, popts=None, deform=True, **kw):
    mesh = M.create_box((-1.0,) * 3, (1.0,) * 3, (N, N, N))
    if deform:
        deform_vessel(mesh)
    facets = mesh.exterior_facet_indices()
    tags = M.meshtags(mesh, 2, facets, np.full_like(facets, 1))
    bcs = [[pkg.DirichletBC(f, pkg.LocatorMethod.TOPOLOGICAL, (tags, 1))] for f in TGV]
    o = {"ksp_rtol": 1e-8, "ksp_max_it": 2000}
    s = pkg.FractionalStep_AB_CN(
        mesh, ("Lagrange", 2), ("Lagrange", 1), bcs_u=bcs, bcs_p=[],
        solver_options={"tentative": dict(o), "pressure": dict(o, **(popts or {})),
                        "scalar": dict(o)},
        options=options, dtype=np.float64 if pkg is J else torch.float64, **kw)
    for f, a, b in zip(TGV, s._u1, s._u2):
        a.interpolate(f)
        b.interpolate(f)
    return s


def _cylinder(pkg, M, options, **kw):
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
    o = {"ksp_rtol": 1e-8, "ksp_max_it": 2000}
    return pkg.FractionalStep_AB_CN(
        mesh, ("Lagrange", 2), ("Lagrange", 1), bcs_u=bcs_u, bcs_p=[pkg.PressureBC(0.0, (tags, 3))],
        solver_options={"tentative": dict(o), "pressure": dict(o), "scalar": dict(o)},
        options=options, dtype=np.float64 if pkg is J else torch.float64, **kw)


def _arr(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _up(s):
    return np.stack([_arr(f.x.array) for f in s._u]), _arr(s._p.x.array)


def _share_coarse_inverse(sj, st):
    """Run the JAX solver's fused AMG-PCG on the port's coarse
    pseudo-inverse (the rest of its hierarchy is equal)."""
    assert sj.config_report()["pallas"]["ell_single"] == "ell"
    assert sj.config_report()["pressure_pc"] == "pallas-amg-pcg-fused"
    sj._amg.coarse_inv = jnp.asarray(st._amg.coarse_inv.numpy())
    sj._ell_amg["arrays"] = po.amg_kernel_data(sj._amg)[1]


def _compare(sj, st, steps, dt, nu):
    _share_coarse_inverse(sj, st)
    stj = sj.run(steps, dt, nu, max_iter=1)
    kn.reset_counts()
    stt = st.run(steps, dt, nu, max_iter=1)
    for k in ("u_iters", "p_iters", "c_iters"):
        np.testing.assert_array_equal(stj[k], stt[k], err_msg=k)
    for k in ("u_converged", "p_converged", "c_converged"):
        assert stt[k].all(), k
    (uj, pj), (ut, pt) = _up(sj), _up(st)
    assert np.abs(uj - ut).max() <= RTOL * np.abs(uj).max()
    assert np.abs(pj - pt).max() <= RTOL * np.abs(pj).max()
    # every solve and product went through the ELL kernels' plain versions
    for name in kn.ELL_KERNELS:
        assert kn.plain_calls[name] >= steps, name
    assert sum(kn.plain_calls[k] for k in kn.STRUCTURED_KERNELS) == 0
    return stt


@pytest.mark.parametrize("low_memory,coarse_max", [(False, 20), (True, 400)])
def test_vessel_matches_jax_ell_path(low_memory, coarse_max):
    opts = {"low_memory_version": low_memory}
    popts = {"amg_coarse_max": coarse_max}
    sj = _vessel(J, JM, 3, dict(opts, pallas="interpret"), popts)
    st = _vessel(T, TM, 3, opts, popts, device="cpu")
    rep = st.config_report()
    assert rep["structured_fastpath"] is False and rep["pressure_pc"] == "amg-pcg-fused"
    assert rep["path_kernels"] == list(kn.ELL_KERNELS)
    assert rep["pressure_mg_levels"] == (3 if coarse_max == 20 else 1)
    _compare(sj, st, 3, 2e-3, 1.0 / 1600.0)


def test_structured_false_box_matches_jax_ell_path():
    """options={"structured": False} sends the undeformed box, which has a
    structured map, to the general path in both packages."""
    opts = {"low_memory_version": False, "structured": False}
    popts = {"amg_coarse_max": 20}
    sj = _vessel(J, JM, 3, dict(opts, pallas="interpret"), popts, deform=False)
    st = _vessel(T, TM, 3, opts, popts, deform=False, device="cpu")
    assert st._mesh.structured is not None
    rep = st.config_report()
    assert rep["structured_fastpath"] is False and rep["pressure_pc"] == "amg-pcg-fused"
    _compare(sj, st, 3, 2e-3, 1.0 / 1600.0)


def test_cylinder_outlet_matches_jax_ell_path():
    sj = _cylinder(J, JM, {"pallas": "interpret", "low_memory_version": False})
    st = _cylinder(T, TM, {"low_memory_version": False}, device="cpu")
    assert st.config_report()["outlet"] is True
    stats = _compare(sj, st, 3, 0.01, 0.001)
    assert stats["p_iters"].min() >= 3


def test_state_round_trip_on_general_path():
    """get_state/set_state in the canonical dof order: a solver loaded with
    another's state after 2 steps takes the third step as it does."""
    a = _vessel(T, TM, 2, {}, device="cpu")
    a.run(2, 2e-3, 1.0 / 1600.0)
    state = a.get_state()
    assert state["u"].shape == (3, a._Vi[0][0].num_dofs)
    assert state["p"].shape == (a._Q.num_dofs,)
    b = _vessel(T, TM, 2, {}, device="cpu")
    b.set_state(state)
    for k, v in b.get_state().items():
        np.testing.assert_array_equal(v, state[k])
    a.run(1, 2e-3, 1.0 / 1600.0)
    b.run(1, 2e-3, 1.0 / 1600.0)
    for fa, fb in zip(a._u + [a._p], b._u + [b._p]):
        np.testing.assert_array_equal(fa.x.array.numpy(), fb.x.array.numpy())


def test_default_device_is_the_card():
    """device=None means the card; on a machine without one the solver
    raises instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None runs on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _vessel(T, TM, 2, {})
