"""The port's general assembly engine and facet assembly against the JAX
package, on the CPU, in float64.

The same mesh (a vessel-deformed N=3 box of P2/P1 tetrahedra, and a 2D
rectangle of P2/P1 triangles with its vertices moved off the lattice) goes
through ``oasisx_tpu.assembly.engine`` and ``oasisx_tpu_torch.assembly.
engine`` with the same inputs, made from a seed with numpy.  Every element
stack, product, diagonal, vector assembly and functional agrees to 1e-12
relative to its largest entry: both packages evaluate the same sums in
float64, in a different order, so they differ by rounding only.  The
transpose maps are equal, and the outlet surface vectors of the DFG
cylinder agree to the same bound.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

import oasisx_tpu.meshes as JM  # noqa: E402
import oasisx_tpu_torch.meshes as TM  # noqa: E402
from oasisx_tpu.assembly import engine as jeng  # noqa: E402
from oasisx_tpu.assembly import facets as jfac  # noqa: E402
from oasisx_tpu.elements.element import FiniteElement as JFE  # noqa: E402
from oasisx_tpu.spaces.functionspace import FunctionSpace as JFS  # noqa: E402
from oasisx_tpu_torch.assembly import engine as teng  # noqa: E402
from oasisx_tpu_torch.assembly import facets as tfac  # noqa: E402
from oasisx_tpu_torch.elements.element import FiniteElement as TFE  # noqa: E402
from oasisx_tpu_torch.spaces.functionspace import FunctionSpace as TFS  # noqa: E402

RTOL = 1e-12


def _deform(mesh):
    """The vessel deformation of bench.py (3D) or a smooth shear (2D)."""
    x = mesh.x.copy()
    s = (x[:, 0] - x[:, 0].min()) / (x[:, 0].max() - x[:, 0].min())
    if mesh.x.shape[1] == 3:
        r = (1.0 - 0.25 * s) * (1.0 + 0.55 * np.exp(-(((s - 0.55) / 0.12) ** 2)))
        x[:, 1] = 0.45 * np.sin(np.pi * s) + r * x[:, 1]
        x[:, 2] = 0.3 * np.sin(np.pi * s * 0.9) + 0.8 * r * x[:, 2]
    else:
        x[:, 1] = x[:, 1] * (1.0 + 0.3 * s) + 0.2 * np.sin(np.pi * s)
    mesh.x[:] = x
    mesh.structured = None
    return mesh


_CACHE = {}


def _contexts(kind):
    """(jax ctx, torch ctx, per-package dofmaps) on the same deformed mesh."""
    if kind in _CACHE:
        return _CACHE[kind]
    out = {}
    for pkg, M, FE, FS in (("jax", JM, JFE, JFS), ("torch", TM, TFE, TFS)):
        if kind == "box3":
            mesh, cell = M.create_box((-1.0,) * 3, (1.0,) * 3, (3, 3, 3)), "tetrahedron"
        else:
            mesh, cell = M.create_rectangle((-1.0, -1.0), (1.0, 1.0), (4, 3)), "triangle"
        _deform(mesh)
        el_v, el_q = FE("Lagrange", cell, 2), FE("Lagrange", cell, 1)
        V, Q = FS(mesh, el_v), FS(mesh, el_q)
        args = (mesh, el_v, V.dofmap.cell_dofs, V.num_dofs, el_q, Q.dofmap.cell_dofs, Q.num_dofs)
        if pkg == "jax":
            ctx, _ = jeng.build_device_context(*args, dtype=np.float64)
        else:
            ctx, _ = teng.build_device_context(*args, dtype=torch.float64, device="cpu")
        out[pkg] = (ctx, V.dofmap.cell_dofs, Q.dofmap.cell_dofs)
    _CACHE[kind] = out
    return out


def _inputs(ctx, seed=0):
    rng = np.random.default_rng(seed)
    d, nv, nq = ctx.dim, ctx.ndofs_v, ctx.ndofs_q
    return dict(
        uab=rng.standard_normal((d, nv)), u=rng.standard_normal((d, nv)),
        x=rng.standard_normal(nv), p=rng.standard_normal(nq),
        mask=rng.random(nv) < 0.2,
    )


def _close(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    scale = max(np.abs(a).max(), 1e-300)
    assert np.abs(a - b).max() <= RTOL * scale, np.abs(a - b).max() / scale


# op name -> (jax call, torch call), each f(eng, ctx, inputs as the package's arrays)
OPS = {
    "mass_elems": lambda e, c, i: e.mass_elems(c),
    "mass_q_elems": lambda e, c, i: e.mass_q_elems(c),
    "stiffness_elems": lambda e, c, i: e.stiffness_elems(c),
    "stiffness_q_elems": lambda e, c, i: e.stiffness_q_elems(c),
    "convection_elems": lambda e, c, i: e.convection_elems(c, i["uab"]),
    "pressure_gradient_mats": lambda e, c, i: e.pressure_gradient_mats(c),
    "grad_p_mats": lambda e, c, i: e.grad_p_mats(c),
    "matvec_v": lambda e, c, i: e.matvec_v(c, e.stiffness_elems(c), i["x"]),
    "matvec_q": lambda e, c, i: e.matvec_q(c, e.stiffness_q_elems(c), i["p"]),
    "matvec_vq": lambda e, c, i: e.matvec_vq(c, e.pressure_gradient_mats(c)[1], i["p"]),
    "matvec_qv": lambda e, c, i: e.matvec_qv(
        c, (jnp if e is jeng else torch).swapaxes(e.pressure_gradient_mats(c)[0], 1, 2),
        i["u"][0]),
    "diagonal_v": lambda e, c, i: e.diagonal_v(c, e.convection_elems(c, i["uab"])),
    "diagonal_q": lambda e, c, i: e.diagonal_q(c, e.stiffness_q_elems(c)),
    "pressure_gradient_vecs": lambda e, c, i: e.pressure_gradient_vecs(c, i["p"]),
    "divergence_vec": lambda e, c, i: e.divergence_vec(c, i["u"]),
    "grad_p_vecs": lambda e, c, i: e.grad_p_vecs(c, i["p"]),
    "constant_load_vec": lambda e, c, i: e.constant_load_vec(c, 1.25),
    "eval_q_at_qp": lambda e, c, i: e.eval_q_at_qp(c, i["p"]),
    "integrate": lambda e, c, i: e.integrate(c, e.eval_q_at_qp(c, i["p"])),
    "cell_volume_total": lambda e, c, i: e.cell_volume_total(c),
    "apply_bc_rows": lambda e, c, i: e.apply_bc_rows(
        i["mask"], e.matvec_v(c, e.mass_elems(c), i["x"]), i["x"]),
    "bc_symmetric_matvec": lambda e, c, i: e.bc_symmetric_matvec(
        c, e.stiffness_elems(c), i["mask"], i["x"], e.matvec_v),
}


@pytest.mark.parametrize("kind", ["box3", "rect2"])
@pytest.mark.parametrize("op", sorted(OPS))
def test_engine_op_matches_jax(kind, op):
    both = _contexts(kind)
    (jc, _, _), (tc, _, _) = both["jax"], both["torch"]
    inp = _inputs(jc)
    ji = {k: jnp.asarray(v) for k, v in inp.items()}
    ti = {k: torch.as_tensor(v) for k, v in inp.items()}
    _close(OPS[op](jeng, jc, ji), OPS[op](teng, tc, ti))


@pytest.mark.parametrize("kind", ["box3", "rect2"])
def test_batched_products_match_per_component(kind):
    """The port's products take a leading batch: each row is the JAX
    package's single-vector product."""
    both = _contexts(kind)
    (jc, _, _), (tc, _, _) = both["jax"], both["torch"]
    u = _inputs(jc)["u"]
    y = teng.matvec_v(tc, teng.mass_elems(tc), torch.as_tensor(u))
    for i in range(u.shape[0]):
        _close(jeng.matvec_v(jc, jeng.mass_elems(jc), jnp.asarray(u[i])), y[i])
    _close(jnp.stack([jeng.matvec_vq(jc, m, jnp.asarray(_inputs(jc)["p"]))
                      for m in jeng.grad_p_mats(jc)]),
           teng.matvec_vq(tc, teng.grad_p_mats(tc), torch.as_tensor(_inputs(jc)["p"])))


@pytest.mark.parametrize("kind", ["box3", "rect2"])
def test_setup_constants_and_maps_match_jax(kind):
    both = _contexts(kind)
    (jc, jcd_v, jcd_q), (tc, tcd_v, tcd_q) = both["jax"], both["torch"]
    np.testing.assert_array_equal(jcd_v, tcd_v)
    np.testing.assert_array_equal(jcd_q, tcd_q)
    for cd, n, pos in ((tcd_v, tc.ndofs_v, tc.pos_v), (tcd_q, tc.ndofs_q, tc.pos_q)):
        np.testing.assert_array_equal(jeng.build_transpose_map(cd, n), pos.numpy())
        np.testing.assert_array_equal(jeng.build_transpose_map(cd, n),
                                      teng.build_transpose_map(cd, n))
    jc_, tc_ = jeng.setup_constants(jc), teng.setup_constants(tc)
    assert sorted(jc_) == sorted(tc_)
    for k in jc_:
        _close(jc_[k], tc_[k])


def _cylinder_outlet(M):
    mesh = M.create_cylinder_channel(6)
    outlet = M.locate_entities_boundary(mesh, 1, lambda x: np.isclose(x[0], 2.2))
    return mesh, outlet


def test_pressure_surface_vecs_match_jax():
    """The outlet term int_ds p n_i dv/dx_i on the DFG cylinder's outlet,
    and the facet evaluation of a pressure field."""
    rng = np.random.default_rng(5)
    res = {}
    for pkg, M, FE, FS, eng, fac in (("jax", JM, JFE, JFS, jeng, jfac),
                                     ("torch", TM, TFE, TFS, teng, tfac)):
        mesh, outlet = _cylinder_outlet(M)
        el_v, el_q = FE("Lagrange", "triangle", 2), FE("Lagrange", "triangle", 1)
        V, Q = FS(mesh, el_v), FS(mesh, el_q)
        args = (mesh, el_v, V.dofmap.cell_dofs, V.num_dofs, el_q, Q.dofmap.cell_dofs, Q.num_dofs)
        if pkg == "jax":
            ctx, _ = eng.build_device_context(*args, dtype=np.float64)
            fctx = fac.build_facet_context(mesh, el_v, el_q, outlet, dtype=np.float64)
            arr = jnp.asarray
        else:
            ctx, _ = eng.build_device_context(*args, dtype=torch.float64, device="cpu")
            fctx = fac.build_facet_context(mesh, el_v, el_q, outlet, V.dofmap.cell_dofs,
                                           dtype=torch.float64, device="cpu")
            arr = torch.as_tensor
        if "p" not in res:
            res["p"] = rng.standard_normal(Q.num_dofs)
        pq = fac.facet_eval_q(ctx, fctx, arr(res["p"]))
        res[pkg] = (pq, fac.pressure_surface_vecs(ctx, fctx, pq))
    _close(res["jax"][0], res["torch"][0])
    _close(res["jax"][1], res["torch"][1])
