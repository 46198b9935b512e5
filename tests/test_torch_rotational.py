"""The rotational pressure update, body forces and the constructor of the
port's solver against the JAX package, on the CPU in float64.

- Rotational update, 3 steps against the JAX XLA path (the kernel path's
  tentative x0, Jacobi-CG pressure, rtol 1e-12): the 6x6 rectangle on the
  structured path with a constant body force (K7's output reused, K5 and
  K4 at batch 1 on Mq_c), the rectangle sent to the general path with a
  callable body force (K14 and K16 at batch 1 on Mq's ELL values), and the
  res=10 DFG cylinder with its outlet; equal u / p / c iterations every
  step, u and p to 1e-10 relative, the rotational solves converged, and
  the vector Function ``solver.u`` equal to the JAX solver's.
- K7's output against the JAX engine's ``source_load_vec_q(div u)``: the
  sign and the scale of the structured path's (div u, q).
- b0 against the JAX solver's ``_b0`` for a constant and a callable force,
  P2/P1 and P1/P1, structured and ``structured: False``, to 1e-12.
- The constructor: JAX's parameter names in JAX's order, ``device`` last;
  ``device_mesh`` refused; ``jit_options`` logged as ignored.
"""

import inspect
import logging

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
from oasisx_tpu_torch.assembly import kernels as kn  # noqa: E402
from oasisx_tpu_torch.assembly.structured import num_padded  # noqa: E402
from tests.test_torch_lumped import _grid, _tgv2d, _up  # noqa: E402
from tests.test_torch_options import _cylinder  # noqa: E402
from tests.test_torch_slice import _kernel_path_x0  # noqa: E402

RTOL = 1e-10
DT, NU = 0.01, 0.01
JACOBI = {"pc_type": "jacobi"}
FORCE = lambda x: np.sin(np.pi * x[0]) * x[1]  # noqa: E731


def _vec(f):
    a = f.x.array
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _compare(sj, st, steps=3):
    _kernel_path_x0(sj)
    stj = sj.run(steps, DT, NU, max_iter=1)
    kn.reset_counts()
    stt = st.run(steps, DT, NU, max_iter=1)
    for k in ("u_iters", "p_iters", "c_iters"):
        np.testing.assert_array_equal(stt[k], stj[k], err_msg=k)
    (ut, pt), (uj, pj) = _up(st), _up(sj)
    assert np.abs(ut - uj).max() <= RTOL * np.abs(uj).max(), np.abs(ut - uj).max()
    assert np.abs(pt - pj).max() <= RTOL * np.abs(pj).max(), np.abs(pt - pj).max()
    assert stt["rot_converged"].all() and (stt["rot_iters"] > 0).all()
    assert (stt["rot_res"] <= 1e-12).all()
    # the vector Function: the components interleaved, as the JAX solver's
    vt, vj = _vec(st.u), _vec(sj.u)
    np.testing.assert_array_equal(vt.reshape(-1, ut.shape[0]).T, ut)
    assert np.abs(vt - vj).max() <= RTOL * np.abs(vj).max()
    assert st.config_report()["pressure_update"] == "rotational"
    return stt


@pytest.mark.parametrize("general", [False, True], ids=["structured", "general"])
def test_rotational_rectangle_matches_jax(general):
    """With a body force (constant on the structured path, a callable on the
    general one): 3 steps against the JAX solver, and p moved off the
    standard update's."""
    opts = {"low_memory_version": False, "structured": False} if general else None
    force = (FORCE, 0.5) if general else (0.5, -1.0)
    kw = dict(pressure=JACOBI, rotational=True, body_force=force)
    sj = _tgv2d(J, JM, JS, 6, options=dict(opts or {}, low_memory_version=False), **kw)
    st = _tgv2d(T, TM, TS, 6, options=opts, device="cpu", **kw)
    rep = st.config_report()
    assert rep["structured_fastpath"] is not general and rep["body_force"] is True
    _compare(sj, st)
    if general:
        assert kn.plain_calls["ell_cg"] == 6 and "ell_cg" in rep["path_kernels"]
    else:
        # a step: K4 twice (rotational, velocity update), K7 once (reused)
        assert kn.plain_calls["cg_mass"] == 6 and kn.plain_calls["divergence"] == 3
    std = _tgv2d(T, TM, TS, 6, options=opts, device="cpu", pressure=JACOBI, body_force=force)
    std.run(3, DT, NU, max_iter=1)
    assert std.config_report()["pressure_update"] == "standard"
    assert "rot_iters" not in std.last_stats
    pr, ps = _vec(st._p), _vec(std._p)
    assert np.abs(pr - ps).max() > 1e-6 * np.abs(ps).max()


def test_rotational_cylinder_outlet_matches_jax():
    """The outlet path: (div u, q) unmasked on the outlet rows, as in JAX."""
    sj = _cylinder(J, JM, JACOBI, {}, rotational=True)
    st = _cylinder(T, TM, JACOBI, {}, rotational=True, device="cpu")
    assert st.config_report()["outlet"] is True
    _compare(sj, st)


@pytest.mark.parametrize("cells", [(4, 5), (3, 4, 5)], ids=["2d", "3d"])
def test_divergence_sign_and_scale(cells):
    """K7's output (plain) on the grid equals the JAX engine's assembled
    (div u, q) from div u at the quadrature points: -dt b2 is (div u, q)."""
    g = _grid(cells)
    d = len(cells)
    nv = len(g["gf_v"])
    u = np.random.default_rng(4).standard_normal((d, nv))
    div_qp = sum(np.asarray(jeng.grad_v_at_qp(g["jctx"], jnp.asarray(u[i])))[:, :, i]
                 for i in range(d))
    ref = np.asarray(jeng.source_load_vec_q(g["jctx"], jnp.asarray(div_qp)))
    ugrid = torch.zeros((d, num_padded(g["sm_v"])), dtype=torch.float64)
    ugrid[:, torch.as_tensor(g["gf_v"])] = torch.tensor(u)
    got = kn.divergence_plain(ugrid, g["cu"].B_c, g["sm_v"], g["sm_q"])[g["gf_q"]].numpy()
    assert np.abs(got - ref).max() <= 1e-12 * np.abs(ref).max()


def _b0_pair(deg_u, general, forces):
    """Both packages' solvers on a 4x3 rectangle, the body force of each
    from ``forces`` (JAX's, the port's)."""
    out = []
    for pkg, M, force in ((J, JM, forces[0]), (T, TM, forces[1])):
        mesh = M.create_rectangle((0.0, 0.0), (1.0, 0.7), (4, 3))
        facets = mesh.exterior_facet_indices()
        tags = M.meshtags(mesh, 1, facets, np.full_like(facets, 1))
        bc = pkg.DirichletBC(0.0, pkg.LocatorMethod.TOPOLOGICAL, (tags, 1))
        kw = dict(dtype=np.float64) if pkg is J else dict(dtype=torch.float64, device="cpu")
        s = pkg.FractionalStep_AB_CN(
            mesh, ("Lagrange", deg_u), ("Lagrange", 1), [[bc], [bc]], [], body_force=force,
            options={"structured": False} if general else None, **kw)
        out.append(s)
    return out


@pytest.mark.parametrize("general", [False, True], ids=["structured", "general"])
@pytest.mark.parametrize("deg_u", [2, 1], ids=["P2P1", "P1P1"])
def test_body_force_b0_matches_jax(deg_u, general):
    """A constant and a Constant component, then two callables: b0 at the
    engine's own quadrature rule."""
    callables = (FORCE, lambda x: x[0] * x[1])
    for forces in (((0.3, JS.Constant(-1.5)), (0.3, TS.Constant(-1.5))), (callables, callables)):
        sj, st = _b0_pair(deg_u, general, forces)
        assert st.config_report()["structured_fastpath"] is not general
        for fj, ft in zip(sj._b0, st._b0):
            ref = np.asarray(fj.x.array)
            assert np.abs(ref).max() > 0
            assert np.abs(_vec(ft) - ref).max() <= 1e-12 * np.abs(ref).max()


def test_no_body_force_leaves_b0_zero():
    st = _b0_pair(2, False, (None, None))[1]
    assert st._b0_dev is None and st.config_report()["body_force"] is False
    assert all(float(f.x.array.abs().max()) == 0.0 for f in st._b0)


def test_constructor_matches_jax_signature(caplog):
    pj = list(inspect.signature(J.FractionalStep_AB_CN.__init__).parameters)
    pt = list(inspect.signature(T.FractionalStep_AB_CN.__init__).parameters)
    assert pt[-1] == "device" and pt[:-1] == pj
    mesh = TM.create_rectangle((0.0, 0.0), (1.0, 1.0), (2, 2))
    args = (mesh, ("Lagrange", 2), ("Lagrange", 1), [[], []])
    # a device_mesh with the rotational update takes the graph-halo path, or
    # with "replicated" the replicated mode; a device_mesh that is not one is
    # a TypeError in either case
    with pytest.raises(TypeError, match="device_mesh"):
        T.FractionalStep_AB_CN(*args, rotational=True, device_mesh=object(), device="cpu",
                               options={"replicated": True})
    with pytest.raises(TypeError, match="device_mesh"):
        T.FractionalStep_AB_CN(*args, rotational=True, device_mesh=object(), device="cpu")
    with caplog.at_level(logging.INFO, logger="oasisx_tpu_torch"):
        T.FractionalStep_AB_CN(*args, jit_options={"cffi_extra_compile_args": ["-O3"]},
                               dtype=torch.float64, device="cpu")
    assert "cffi_extra_compile_args" in caplog.text and "ignored" in caplog.text
