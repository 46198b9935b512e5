"""K1's non-MG modes in the port: the Jacobi- and Chebyshev-Jacobi-
preconditioned pressure CG (``la/pressure_cg.py``), and the structured path
on grids that do not coarsen, against the JAX package on the CPU.

- The plain version against ``make_pressure_cg(mg=None, interpret=True)``
  in float64, at Chebyshev degrees 0, 1 and 4 (2D, 11 x 11 cells; 3D, 5^3),
  and 0 and 2 on a 3D box of 5 x 6 x 7 cells (axes of both parities and
  unequal lengths, as the kernel's tiles meet them), the bounds passed in to
  both: equal iterations and x to 1e-8 relative; x demeaned and its true
  residual within 2 rtol.
- 2D float32 at N=5 (odd: no MG) against the JAX kernel path in interpret
  mode, both packages' Chebyshev bounds pinned to one dense eigvalsh value
  (their power iterations draw different random vectors): u to 5e-4 and p
  to 5e-3 relative after 3 steps, the bounds the JAX package holds its own
  f32 engines to (ROADMAP Queue 3 note c).
- 2D float64 at N=5 with the pressure pc_type "jacobi" against the JAX
  package's XLA Jacobi-CG at rtol 1e-12, with the kernel path's tentative
  x0 (ROADMAP Queue 3 note f): equal iterations every step, u and p to
  1e-10; and the state carried across from the JAX solver at that odd
  grid.
- ``config_report`` names the method each option selects.
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
from oasisx_tpu.assembly import pallas_ops as po  # noqa: E402
from oasisx_tpu_torch.assembly import cubes as tcub  # noqa: E402
from oasisx_tpu_torch.assembly import kernels as kn  # noqa: E402
from oasisx_tpu_torch.la import krylov as tk  # noqa: E402
from oasisx_tpu_torch.la.pressure_cg import PressureCG  # noqa: E402
from tests.test_torch_cheb import dense_laplacian  # noqa: E402
from tests.test_torch_kernels import _both  # noqa: E402
from tests.test_torch_slice import (  # noqa: E402
    DT, DT2, NU, NU2, _TG, _cat, _kernel_path_x0, _run2d, _tgv3d, _up,
)


@pytest.mark.parametrize("cells,degree", [((11, 11), 0), ((11, 11), 1), ((11, 11), 4),
                                          ((5, 5, 5), 4), ((5, 6, 7), 0), ((5, 6, 7), 2)],
                         ids=["2d-11-jacobi", "2d-11-cheb1", "2d-11-cheb4", "3d-5-cheb4",
                              "3d-567-jacobi", "3d-567-cheb2"])
def test_pressure_cg_matches_kernel(cells, degree):
    jops, tops, _, (sm_q, _, valid_q) = _both(cells)
    n = valid_q.size
    Ap = np.asarray(jops.Ap_c)
    diag = tcub.diag_cube(tops.Ap_c, sm_q).numpy()
    # the JAX kernel stores its inverse diagonal in float32: hand both the
    # same rounded values
    invd = (1.0 / diag).astype(np.float32).astype(np.float64)
    lmax = 1.02 * dense_laplacian(cells)[2] if degree else 0.0
    lmin = lmax / 30.0
    rng = np.random.default_rng(11)
    b, x0 = rng.standard_normal(n), rng.standard_normal(n)
    rtol, maxiter = 1e-10, 500
    solve = po.make_pressure_cg(sm_q, Ap, invd, rtol=rtol, maxiter=maxiter, cheb_degree=degree,
                                lmin=lmin, lmax=lmax, interpret=True)
    xj, itj, _, cj = solve(jnp.asarray(b), jnp.asarray(x0))
    pcg = PressureCG(sm_q, tops.Ap_c, invd, rtol, maxiter, degree, lmin, lmax)
    kn.reset_counts()
    res = pcg.solve(torch.tensor(b), torch.tensor(x0))
    assert kn.plain_calls["pressure_cg"] == 1 and kn.launches["pressure_cg"] == 0
    assert bool(cj) and bool(res.converged)
    assert int(res.iters) == int(itj)
    xj = np.asarray(xj)
    assert np.abs(res.x.numpy() - xj).max() <= 1e-8 * np.abs(xj).max()
    x = res.x
    assert abs(float(x.mean())) < 1e-12
    bd = b - b.mean()
    r = bd - kn.matvec_const_plain(x, tops.Ap_c, sm_q).numpy()
    assert np.linalg.norm(r - r.mean()) <= 2 * rtol * np.linalg.norm(bd)


def test_pressure_cg_explicit_operator_and_arguments():
    """``solve_plain`` applies the operator it is given; ``solve`` on CPU
    tensors is the plain version; bounds that a Chebyshev degree cannot use
    are refused."""
    _, tops, _, (sm_q, _, valid_q) = _both((7, 9))
    n = valid_q.size
    invd = 1.0 / tcub.diag_cube(tops.Ap_c, sm_q)
    calls = []

    def op(x, C, sm):
        calls.append(sm[1])
        return kn.matvec_const_plain(x, C, sm)

    pcg = PressureCG(sm_q, tops.Ap_c, invd, 1e-10, 500, 4, 2.04 / 30.0, 2.04)
    b = torch.tensor(np.random.default_rng(5).standard_normal(n))
    x0 = torch.zeros(n, dtype=torch.float64)
    res = pcg.solve_plain(b, x0, matvec=op)
    ref = pcg.solve(b, x0)
    # r0, 3 Chebyshev products per preconditioner application, A p per iteration
    k = int(res.iters)
    assert len(calls) == 1 + 3 * (k + 1) + k and set(calls) == {tuple(sm_q[1])}
    assert torch.equal(ref.x, res.x) and int(ref.iters) == int(res.iters)
    with pytest.raises(ValueError, match="Chebyshev degree"):
        PressureCG(sm_q, tops.Ap_c, invd, 1e-10, 500, 4, 1.0, 1.0)


@pytest.fixture
def pinned_bounds(monkeypatch):
    """Both packages' Chebyshev bounds pinned to 1.02 x the dense largest
    eigenvalue of D^-1 A of the 2D N=5 pressure grid (each package's
    solver looks its estimators up when it builds the pressure solve)."""
    lmax = 1.02 * dense_laplacian((5, 5))[2]
    est = lambda *a, **k: lmax
    bounds = lambda mv, invd, lm, deg, *a, **k: (lm / 30.0, lm)
    for mod in (jla, tk):
        monkeypatch.setattr(mod, "estimate_lmax", est)
        monkeypatch.setattr(mod, "validated_cheb_bounds", bounds)


def test_slice_2d_f32_odd_grid_matches_jax_kernel_path(pinned_bounds):
    kn.reset_counts()
    u1, p1 = _run2d(T, TM, TS, N=5, device="cpu")
    assert kn.plain_calls["pressure_cg"] >= 3 and kn.plain_calls["pressure_mg"] == 0
    u0, p0 = _run2d(J, JM, JS, N=5, options={"pallas": "interpret"})
    uscale = np.abs(u0).max()
    pscale = max(np.abs(p0).max(), 1e-3)
    assert np.abs(u1 - u0).max() / uscale < 5e-4, np.abs(u1 - u0).max() / uscale
    assert np.abs(p1 - p0).max() / pscale < 5e-3, np.abs(p1 - p0).max() / pscale


JACOBI = {"pc_type": "jacobi"}
# CG's iterates under two summation orders part at the level of the
# tolerance (3D N=5: p by 4e-9 at rtol 1e-10, measured); at 1e-12 they
# agree to 1e-10
RTOL_JACOBI = 1e-12


def _tgv2d(pkg, meshes, spaces, N, **kw):
    """2D Taylor-Green at N cells a side in float64, Dirichlet data on every
    edge, Jacobi-CG pressure at RTOL_JACOBI; u1 = u2 = the t=0 field."""
    mesh = meshes.create_rectangle((-1, -1), (1, 1), (N, N))
    facets = mesh.exterior_facet_indices()
    tags = meshes.meshtags(mesh, mesh.dim - 1, facets, np.full_like(facets, 3))
    u_ex = _TG(spaces.Constant(0.0), NU2)
    T_ = pkg.LocatorMethod.TOPOLOGICAL
    bcs = [[pkg.DirichletBC(u_ex.eval_x, T_, (tags, 3))], [pkg.DirichletBC(u_ex.eval_y, T_, (tags, 3))]]
    o = {"ksp_rtol": RTOL_JACOBI, "ksp_max_it": 2000}
    s = pkg.FractionalStep_AB_CN(
        mesh, ("Lagrange", 2), ("Lagrange", 1), bcs_u=bcs, bcs_p=[],
        solver_options={"tentative": dict(o), "pressure": dict(o, **JACOBI), "scalar": dict(o)},
        dtype=np.float64, **kw)
    for i, f in enumerate((u_ex.eval_x, u_ex.eval_y)):
        s._u1[i].interpolate(f)
        s._u2[i].interpolate(f)
    assert s.config_report()["pressure_pc"] == "jacobi-pcg"
    return s


@pytest.fixture(scope="module")
def jax2d_odd():
    """The JAX package's XLA path at N=5 with Jacobi-CG pressure: 2 steps,
    its state, 1 more step."""
    s = _tgv2d(J, JM, JS, 5, options={"low_memory_version": False})
    _kernel_path_x0(s)
    st2 = dict(s.run(2, DT2, NU2, max_iter=1))
    state = {k: np.asarray(v) for k, v in s._state_from_functions().items()}
    st3 = dict(s.run(1, DT2, NU2, max_iter=1))
    u, p = _up(s)
    return dict(stats=_cat(st2, st3), state=state, u=u, p=p)


def _close(s, ref):
    u, p = _up(s)
    assert np.abs(u - ref["u"]).max() <= 1e-10 * np.abs(ref["u"]).max()
    assert np.abs(p - ref["p"]).max() <= 1e-10 * np.abs(ref["p"]).max()


def test_slice_2d_f64_jacobi_matches_jax_xla(jax2d_odd):
    s = _tgv2d(T, TM, TS, 5, device="cpu")
    stats = _cat(s.run(2, DT2, NU2, max_iter=1), s.run(1, DT2, NU2, max_iter=1))
    for k in ("u_iters", "p_iters", "c_iters"):
        np.testing.assert_array_equal(stats[k], jax2d_odd["stats"][k], err_msg=k)
    _close(s, jax2d_odd)


def test_state_carry_over_odd_grid(jax2d_odd):
    """set_state from the JAX state after 2 steps at N=5, then one more
    step, as test_torch_slice.py's test_state_carry_over at N=6."""
    s = _tgv2d(T, TM, TS, 5, device="cpu")
    s.set_state(jax2d_odd["state"])
    got = s.get_state()
    for k, v in jax2d_odd["state"].items():
        assert np.array_equal(got[k], v), k
    s.run(1, DT2, NU2, max_iter=1)
    _close(s, jax2d_odd)


@pytest.mark.parametrize("N,popts,options,method", [
    (6, None, None, "mg-pcg"),
    (5, None, None, "cheb-pcg"),
    (6, None, {"pallas_pressure_pc": "cheb"}, "cheb-pcg"),
    (5, None, {"pallas_cheb_degree": 0}, "jacobi-pcg"),
    (6, {"pc_type": "jacobi"}, None, "jacobi-pcg"),
    (6, {"pc_type": "none"}, {"pallas_pressure_pc": "cheb"}, "jacobi-pcg"),
    (4, None, {"structured": False}, "amg-pcg-fused"),
], ids=["mg", "odd-cheb", "option-cheb", "degree-0", "pc-jacobi", "pc-none", "unstructured"])
def test_config_report_names_the_pressure_method(N, popts, options, method):
    s = _tgv3d(T, TM, N=N, popts=popts, options=options, device="cpu")
    rep = s.config_report()
    assert rep["pressure_pc"] == method
    assert rep["structured_fastpath"] is (method != "amg-pcg-fused")
    if method == "amg-pcg-fused":
        assert rep["path_kernels"] == list(kn.ELL_KERNELS)
        return
    used = "pressure_mg" if method == "mg-pcg" else "pressure_cg"
    assert used in rep["path_kernels"] and len(rep["path_kernels"]) == 8
    if method == "cheb-pcg":
        cheb = rep["pressure_cheb"]
        assert cheb["degree"] == 4 and cheb["lmin"] == cheb["lmax"] / 30.0
        assert cheb["lmax"] >= cheb["lmax_estimate"] > 1.0
    kn.reset_counts()
    s.run(1, DT, NU, max_iter=1)
    assert kn.plain_calls[used] == 1 and sum(kn.launches.values()) == 0
