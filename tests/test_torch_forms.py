"""The port's expression layer and surface traction against the JAX package,
on the CPU in float64.

- ``forms.expr``: ``QPEvaluator.eval`` and ``assemble_scalar`` on a P2 unit
  square and a P2 3D box with seeded coefficients, to 1e-12 relative:
  ``inner``, ``grad``, ``div``, ``Component``, ``as_vector``,
  ``SpatialCoordinate`` with ``sin``/``cos``/``exp``/``sqrt``, powers and a
  mutable ``Constant`` read at evaluation time.
- ``assembly.engine``'s quadrature-point functions (``eval_v_at_qp``,
  ``grad_v_at_qp``, ``grad_q_at_qp``, ``source_load_vec_q``,
  ``source_load_vec_v``) against the JAX engine's.
- ``assembly.facets``: ``facet_area`` and ``surface_traction`` on the res=10
  DFG cylinder's cylinder facets with a seeded u and p, to 1e-12.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

import oasisx_tpu.forms.expr as JE  # noqa: E402
import oasisx_tpu.meshes as JM  # noqa: E402
import oasisx_tpu.spaces as JS  # noqa: E402
import oasisx_tpu_torch.forms.expr as TE  # noqa: E402
import oasisx_tpu_torch.meshes as TM  # noqa: E402
import oasisx_tpu_torch.spaces as TS  # noqa: E402
from oasisx_tpu.assembly import engine as jeng  # noqa: E402
from oasisx_tpu.assembly import facets as jfac  # noqa: E402
from oasisx_tpu_torch.assembly import engine as teng  # noqa: E402
from oasisx_tpu_torch.assembly import facets as tfac  # noqa: E402

TOL = 1e-12
CPU = torch.device("cpu")


def _close(got, ref, tol=TOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    scale = max(np.abs(ref).max(), 1e-300)
    assert np.abs(got - ref).max() <= tol * scale, np.abs(got - ref).max() / scale


def _mesh(pkg_meshes, d):
    if d == 2:
        return pkg_meshes.create_unit_square(5)
    return pkg_meshes.create_box((0.0, 0.0, 0.0), (1.0, 0.8, 1.2), (2, 3, 2))


def _both(d, seed=0):
    """Per package (mesh, P2 scalar f, P2 vector v, P1 q, Constant c), the
    coefficients from one seed."""
    rng = np.random.default_rng(seed)
    out = {}
    arrays = None
    for name, M, S in (("jax", JM, JS), ("torch", TM, TS)):
        mesh = _mesh(M, d)
        V, W, Q = (S.FunctionSpace(mesh, ("Lagrange", 2)),
                   S.FunctionSpace(mesh, ("Lagrange", 2), shape=(d,)),
                   S.FunctionSpace(mesh, ("Lagrange", 1)))
        if arrays is None:
            arrays = [rng.standard_normal(X.num_dofs) for X in (V, W, Q)]
        fs = []
        for X, a in zip((V, W, Q), arrays):
            if name == "jax":
                f = S.Function(X)
                f.x.array[:] = a
            else:
                f = S.Function(X, dtype=torch.float64, device=CPU)
                f.x.array.copy_(torch.tensor(a))
            fs.append(f)
        out[name] = (mesh, *fs, S.Constant(0.7))
    return out


def _exprs(E, mesh, f, v, q, c):
    """The expressions the two packages evaluate, built by the same code."""
    x = E.SpatialCoordinate(mesh)
    d = mesh.dim
    man = E.as_vector([E.sin(E.pi * x[0]) * E.cos(E.pi * x[1])]
                      + [x[i] ** 2 for i in range(1, d)])
    F, V, C = E.as_expr(f), E.as_expr(v), E.as_expr(c)
    gf = E.grad(f)
    return {
        "f": F,
        "v[1]": V[1],
        "grad f . grad f": E.inner(gf, gf),
        "dot(v, grad q)": E.dot(v, E.grad(q)),
        "div v": E.div(v),
        "div as_vector": E.div(E.as_vector([V[i] for i in range(d)])),
        "|v - man|^2": E.inner(V - man, V - man),
        "c q + exp(-f) / 2": C * q + E.exp(-F) / 2.0,
        "sqrt(1 + f^2) - grad q[0]": E.sqrt(1.0 + F * F) - E.grad(q)[0],
        "3 - c / (2 + x0)": 3.0 - C / (2.0 + x[0]),
    }


@pytest.mark.parametrize("d", [2, 3], ids=["square", "box"])
def test_forms_match_jax(d):
    """Every expression's values at the quadrature points and its integral,
    before and after the Constant changes."""
    pair = _both(d)
    ej = _exprs(JE, *pair["jax"])
    et = _exprs(TE, *pair["torch"])
    mj, mt = pair["jax"][0], pair["torch"][0]
    evj = JE.QPEvaluator(mj, 4)
    evt = TE.QPEvaluator(mt, 4, torch.float64, "cpu")
    _close(evt.xq, evj.xq)
    for cval in (0.7, -2.5):
        pair["jax"][4].value = np.asarray(cval)
        pair["torch"][4].value = np.asarray(cval)
        for key in ej:
            _close(evt.eval(et[key]), evj.eval(ej[key]))
            sj = JE.assemble_scalar(mj, ej[key], qdegree=6)
            st = TE.assemble_scalar(mt, et[key], qdegree=6, dtype=torch.float64, device="cpu")
            assert st.dim() == 0 and st.dtype == torch.float64
            _close(st, sj)
    # a vector expression evaluated a component at a time
    vt = TE.as_expr(pair["torch"][2])
    _close(evt.eval(vt, comp=1), evj.eval(JE.as_expr(pair["jax"][2]), comp=1))


def test_forms_errors():
    mt = _mesh(TM, 2)
    V = TS.FunctionSpace(mt, ("Lagrange", 1), shape=(2,))
    f = TS.Function(V, dtype=torch.float64, device=CPU)
    with pytest.raises(ValueError, match="scalar operands"):
        TE.grad(f)
    with pytest.raises(TypeError):
        TE.as_expr("f")
    ev = TE.QPEvaluator(mt, 2, torch.float64, "cpu")
    with pytest.raises(ValueError, match="component"):
        ev.eval(TE.as_expr(f))


@pytest.mark.parametrize("d", [2, 3], ids=["square", "box"])
def test_engine_qp_functions_match_jax(d):
    rng = np.random.default_rng(1)
    ctx = {}
    for name, M, S, E in (("jax", JM, JS, jeng), ("torch", TM, TS, teng)):
        mesh = _mesh(M, d)
        V, Q = S.FunctionSpace(mesh, ("Lagrange", 2)), S.FunctionSpace(mesh, ("Lagrange", 1))
        args = (mesh, V.element, V.dofmap.cell_dofs, V.num_dofs, Q.element, Q.dofmap.cell_dofs,
                Q.num_dofs)
        ctx[name] = E.build_device_context(*args) if name == "jax" else \
            E.build_device_context(*args, torch.float64, CPU)
    (cj, _), (ct, _) = ctx["jax"], ctx["torch"]
    nv, nq, (nc, nqp) = ct.ndofs_v, ct.ndofs_q, tuple(ct.detJ.shape) + tuple(ct.qw.shape)
    xv, xq, g = rng.standard_normal(nv), rng.standard_normal(nq), rng.standard_normal((nc, nqp))
    T, Jx = torch.tensor, jnp.asarray
    _close(teng.eval_v_at_qp(ct, T(xv)), jeng.eval_v_at_qp(cj, Jx(xv)))
    _close(teng.grad_v_at_qp(ct, T(xv)), jeng.grad_v_at_qp(cj, Jx(xv)))
    _close(teng.grad_q_at_qp(ct, T(xq)), jeng.grad_q_at_qp(cj, Jx(xq)))
    _close(teng.source_load_vec_q(ct, T(g)), jeng.source_load_vec_q(cj, Jx(g)))
    _close(teng.source_load_vec_v(ct, T(g)), jeng.source_load_vec_v(cj, Jx(g)))
    # batched: a leading axis of vectors gives a leading axis of outputs
    g2 = np.stack([g, 2.0 * g])
    _close(teng.source_load_vec_v(ct, T(g2))[1],
           2.0 * np.asarray(jeng.source_load_vec_v(cj, Jx(g))))
    # div u at the quadrature points, the components in order
    u = rng.standard_normal((d, nv))
    ref = sum(np.asarray(jeng.grad_v_at_qp(cj, Jx(u[i])))[:, :, i] for i in range(d))
    _close(teng.div_v_at_qp(ct, T(u)), ref)


def _cylinder_facets(M, mesh):
    """demo/cylinder.py's cylinder facets: exterior facets within 0.9 D of
    the centre."""
    ext = mesh.exterior_facet_indices()
    mid = mesh.x[mesh.topology.facets[ext]].mean(axis=1)
    return ext[np.linalg.norm(mid - np.asarray((0.2, 0.2)), axis=1) < 0.9 * 0.1]


def test_surface_traction_matches_jax():
    rng = np.random.default_rng(2)
    res = {}
    for name, M, S, E, F in (("jax", JM, JS, jeng, jfac), ("torch", TM, TS, teng, tfac)):
        mesh = M.create_cylinder_channel(10)
        V, Q = S.FunctionSpace(mesh, ("Lagrange", 2)), S.FunctionSpace(mesh, ("Lagrange", 1))
        cyl = _cylinder_facets(M, mesh)
        args = (mesh, V.element, V.dofmap.cell_dofs, V.num_dofs, Q.element, Q.dofmap.cell_dofs,
                Q.num_dofs)
        if name == "jax":
            ctx, _ = E.build_device_context(*args)
            fctx = F.build_facet_context(mesh, V.element, Q.element, cyl)
        else:
            ctx, _ = E.build_device_context(*args, torch.float64, CPU)
            fctx = F.build_facet_context(mesh, V.element, Q.element, cyl, V.dofmap.cell_dofs,
                                         torch.float64, CPU)
        res[name] = (ctx, fctx, V.num_dofs, Q.num_dofs, len(cyl))
    ctx_j, fj, nv, nq, nf = res["jax"]
    ctx_t, ft = res["torch"][:2]
    assert nf >= 8
    u, p = rng.standard_normal((2, nv)), rng.standard_normal(nq)
    area = tfac.facet_area(ft)
    _close(area, jfac.facet_area(fj))
    assert abs(float(area) - np.pi * 0.1) < 0.02  # the polygonal circumference
    for nu in (1e-3, 0.5):
        _close(tfac.surface_traction(ctx_t, ft, torch.tensor(u), torch.tensor(p), nu),
               jfac.surface_traction(ctx_j, fj, jnp.asarray(u), jnp.asarray(p), nu))
    # a constant pressure alone: no net force on a closed surface
    F = tfac.surface_traction(ctx_t, ft, torch.zeros(2, nv, dtype=torch.float64),
                              torch.ones(nq, dtype=torch.float64), 1e-3)
    assert float(F.abs().max()) < 1e-12
