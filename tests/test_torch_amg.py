"""The port's smoothed-aggregation AMG against the JAX package's, on the
CPU.

The same COO operator (a 2D 5-point Laplacian, with Dirichlet rows, with
the consistent Neumann stencil and its constant nullspace, and the
pressure Laplacian of a deformed P1 box) goes into ``oasisx_tpu.la.amg``
and ``oasisx_tpu_torch.la.amg`` in float64.  The set-up is the same NumPy
code, so the hierarchy is equal: level sizes, aggregate counts and ELL
columns exactly, values and smoothers to 1e-12 relative (the sums run in
another order).  The coarse pseudo-inverse is the JAX package's where the
coarse operator is non-singular; on a pure-Neumann operator the port cuts
singular values below 1e-10 of the largest, so its pseudo-inverse drops
the constant mode the JAX package's may keep at a rounding-level singular
value (there it is held to annihilating the coarse constant).  The V-cycle
on a seeded residual agrees to 1e-12 relative with the JAX cycle run on
the port's coarse pseudo-inverse, and ``amg_kernel_data`` flattens the
hierarchy as the JAX package does.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from oasisx_tpu.assembly import pallas_ops as po  # noqa: E402
from oasisx_tpu.la.amg import AlgebraicMG as JAMG  # noqa: E402
from oasisx_tpu.la.amg import coo_from_elems as jcoo  # noqa: E402
from oasisx_tpu_torch.la.amg import AlgebraicMG as TAMG  # noqa: E402
from oasisx_tpu_torch.la.amg import amg_kernel_data, coo_from_elems  # noqa: E402

RTOL = 1e-12


def lap2d_coo(nx, neumann=False):
    """2D 5-point Laplacian COO, n = nx*nx (Dirichlet, or the consistent
    Neumann stencil with zero row sums)."""
    rows, cols, vals = [], [], []
    for i in range(nx):
        for j in range(nx):
            r = i * nx + j
            nb = [(i + a, j + b) for a, b in ((1, 0), (-1, 0), (0, 1), (0, -1))
                  if 0 <= i + a < nx and 0 <= j + b < nx]
            rows.append(r)
            cols.append(r)
            vals.append(float(len(nb)) if neumann else 4.0)
            for ii, jj in nb:
                rows.append(r)
                cols.append(ii * nx + jj)
                vals.append(-1.0)
    return np.array(rows), np.array(cols), np.array(vals), nx * nx


def deformed_p1_coo():
    """The P1 pressure Laplacian of a vessel-deformed 4^3 box."""
    from oasisx_tpu_torch.assembly.geometry import compute_cell_geometry
    from oasisx_tpu_torch.assembly.reference_tensors import build_reference_tensors
    from oasisx_tpu_torch.elements.element import FiniteElement
    from oasisx_tpu_torch.meshes import create_box
    from oasisx_tpu_torch.spaces.functionspace import FunctionSpace

    mesh = create_box((-1.0,) * 3, (1.0,) * 3, (4, 4, 4))
    x = mesh.x
    s = (x[:, 0] + 1.0) / 2.0
    x[:, 1] = 0.45 * np.sin(np.pi * s) + (1.0 - 0.25 * s) * x[:, 1]
    el = FiniteElement("Lagrange", "tetrahedron", 1)
    Q = FunctionSpace(mesh, el)
    geo = compute_cell_geometry(mesh.x, mesh.cells, 3)
    ref = build_reference_tensors(FiniteElement("Lagrange", "tetrahedron", 2), el).stiffness_q
    elems = np.einsum("c,cab,abij->cij", geo.detJ, geo.G, ref)
    rows, cols, vals = coo_from_elems(Q.dofmap.cell_dofs, elems, Q.num_dofs)
    r2, c2, v2 = jcoo(Q.dofmap.cell_dofs, elems, Q.num_dofs)
    assert np.array_equal(rows, r2) and np.array_equal(cols, c2) and np.array_equal(vals, v2)
    return rows, cols, vals, Q.num_dofs


CASES = {
    "dirichlet": lambda: (*lap2d_coo(20), None, 40),
    "neumann": lambda: (*lap2d_coo(20, neumann=True), "ones", 40),
    "p1_box": lambda: (*deformed_p1_coo(), "ones", 20),
}


def _pair(case, pre=2, post=2):
    rows, cols, vals, n, null, cmax = CASES[case]()
    nv = None if null is None else np.ones(n)
    kw = dict(theta=0.25, coarse_max=cmax, pre=pre, post=post, nullvec=nv)
    j = JAMG(rows, cols, vals, n, dtype=jnp.float64, **kw)
    t = TAMG(rows, cols, vals, n, dtype=torch.float64, device="cpu", **kw)
    return j, t, n


def _close(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape
    assert np.abs(a - b).max() <= RTOL * max(np.abs(a).max(), 1e-300)


@pytest.mark.parametrize("case", sorted(CASES))
def test_amg_levels_match_jax(case):
    j, t, _ = _pair(case)
    assert len(j.levels) == len(t.levels) >= 1
    assert (j.num_levels, j.coarse_n) == (t.num_levels, t.coarse_n)
    for lj, lt in zip(j.levels, t.levels):
        assert (lj["n"], lj["nc"]) == (lt["n"], lt["nc"])
        for key in ("A", "P", "R"):
            np.testing.assert_array_equal(np.asarray(lj[key][0]), lt[key][0].numpy())
            _close(lj[key][1], lt[key][1])
        _close(lj["sm"], lt["sm"])
    if j.nullvec is None:
        _close(j.coarse_inv, t.coarse_inv)
    else:
        ci = t.coarse_inv.numpy()
        assert np.abs(ci.sum(axis=1)).max() <= 1e-8 * np.abs(ci).max()
        np.testing.assert_allclose(ci, ci.T, rtol=0, atol=1e-10 * np.abs(ci).max())


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("smooth", [(1, 1), (2, 2)])
def test_amg_vcycle_matches_jax(case, smooth):
    j, t, n = _pair(case, *smooth)
    j.coarse_inv = jnp.asarray(t.coarse_inv.numpy())
    r = np.random.default_rng(7).standard_normal(n)
    _close(j.vcycle(jnp.asarray(r)), t.vcycle(torch.as_tensor(r)))


@pytest.mark.parametrize("case", sorted(CASES))
def test_amg_kernel_data_matches_jax(case):
    j, t, _ = _pair(case)
    j.coarse_inv = jnp.asarray(t.coarse_inv.numpy())
    jm, ja = po.amg_kernel_data(j)
    tm, ta = amg_kernel_data(t)
    assert jm == tm
    assert len(ja) == len(ta)
    for a, b in zip(ja, ta):
        assert b.is_contiguous()
        if np.issubdtype(np.asarray(a).dtype, np.integer):
            assert b.dtype == torch.int32
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
        else:
            _close(a, b)
