"""The port's ELL tables and the plain versions of its ELL kernels K14-K17
against the JAX package, on the CPU.

- ``build_ell_tables`` equal to the JAX function on the vessel-deformed
  N=3 box's P2 and P1 dofmaps; the slot-grouped assembly ``ell_values``
  against the JAX segment-sum ``ell_values`` to 1e-12 relative (float64,
  the sums run in another order).
- K14-K16: the plain versions against ``make_ell_matvec(_batched)``,
  ``make_ell_bicgstab_iter`` and ``make_ell_cg_iter`` in interpret mode,
  run in the JAX package's own solve loops, on ``tests/test_ell_kernels.py``'s
  operators in float64: products to 1e-13, solves with equal iteration
  counts and x to 1e-10 relative.
- K17: the plain AMG-PCG against ``make_ell_pcg_amg_iter`` and
  ``ell_pcg_amg_solve`` in interpret mode on the 2D Laplacian, with the
  nullspace projection and with an outlet mask, in float64: equal
  iteration counts, x to 1e-10 relative; the plain V-cycle over the kernel
  tables against ``make_ell_vcycle`` to 1e-12.  Both sides use the same
  AMG hierarchy (the port's, whose coarse pseudo-inverse drops the
  rounding-level null mode; tests/test_torch_amg.py holds it to the JAX
  set-up).
- The wrappers send CPU tensors to the plain versions and count them.

The CUDA kernels run only on the card; ``chip_smoke.py`` holds them to
these plain versions there.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

import oasisx_tpu.meshes as JM  # noqa: E402
from oasisx_tpu.assembly import pallas_ops as po  # noqa: E402
from oasisx_tpu.elements.element import FiniteElement as JFE  # noqa: E402
from oasisx_tpu.parallel import graph as jgr  # noqa: E402
from oasisx_tpu.spaces.functionspace import FunctionSpace as JFS  # noqa: E402
from oasisx_tpu_torch.assembly import kernels as kn  # noqa: E402
from oasisx_tpu_torch.la import ell  # noqa: E402
from oasisx_tpu_torch.la.amg import AlgebraicMG, amg_kernel_data, amg_widths  # noqa: E402
from oasisx_tpu_torch.parallel import graph as tgr  # noqa: E402

from test_ell_kernels import _lap1d_ell, _lap2d_coo, _nonsym_ell  # noqa: E402

T = lambda a: torch.as_tensor(np.asarray(a))


def _W(cols):
    """Slice widths that read every slot of an ELL table (K, n)."""
    K, n = np.shape(cols)
    return torch.full((-(-n // tgr.ELL_SLICE),), K, dtype=torch.int32)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(a).max(), 1e-300)


def _vessel_dofmaps():
    mesh = JM.create_box((-1.0,) * 3, (1.0,) * 3, (3, 3, 3))
    mesh.structured = None
    out = {}
    for deg in (2, 1):
        V = JFS(mesh, JFE("Lagrange", "tetrahedron", deg))
        out[deg] = (V.dofmap.cell_dofs, V.num_dofs)
    return out


@pytest.mark.parametrize("deg", [2, 1])
def test_build_ell_tables_equal_jax(deg):
    cd, n = _vessel_dofmaps()[deg]
    K, slots, cols = jgr.build_ell_tables(cd, cd, n, 1)
    K2, slots2, cols2 = tgr.build_ell_tables(cd, cd, n, 1)
    assert K == K2
    np.testing.assert_array_equal(slots, slots2)
    np.testing.assert_array_equal(cols, cols2)
    asm = tgr.build_ell_assembly(cd, n, "cpu")
    assert asm.K == K and asm.nnz == len(np.unique(slots[0]))
    np.testing.assert_array_equal(asm.cols.numpy(), cols[0])


@pytest.mark.parametrize("deg", [2, 1])
def test_ell_values_match_jax(deg):
    cd, n = _vessel_dofmaps()[deg]
    K, slots, cols = jgr.build_ell_tables(cd, cd, n, 1)
    nd = cd.shape[1]
    elems = np.random.default_rng(deg).standard_normal((cd.shape[0], nd, nd))
    ref = jgr.ell_values(jnp.asarray(elems), jnp.asarray(slots[0]), K, n)
    got = tgr.ell_values(T(elems), tgr.build_ell_assembly(cd, n, "cpu"))
    assert _rel(ref, got) <= 1e-12
    # the operator: the ELL product equals the element-stack product
    x = np.random.default_rng(9).standard_normal(n)
    y = np.zeros(n)
    np.add.at(y, cd.reshape(-1), np.einsum("cij,cj->ci", elems, x[cd]).reshape(-1))
    assert _rel(y, ell.ell_matvec_plain(got, T(cols[0]), T(x))) <= 1e-12


@pytest.mark.parametrize("nb", [1, 3])
def test_ell_matvec_plain_matches_interpret(nb):
    n = 40
    vals, cols, _ = _nonsym_ell(n, np.float64)
    x = np.random.default_rng(nb).standard_normal((nb, n))
    if nb == 1:
        ref = po.make_ell_matvec(3, n, n, interpret=True)(
            jnp.asarray(vals), jnp.asarray(cols), jnp.asarray(x[0]))[None]
    else:
        ref = po.make_ell_matvec_batched(3, n, n, nb, interpret=True)(
            jnp.asarray(vals), jnp.asarray(cols), jnp.asarray(x))
    kn.reset_counts()
    got = ell.ell_matvec(T(vals), T(cols), _W(cols), T(x[0]) if nb == 1 else T(x))
    assert kn.plain_calls["ell_matvec"] == 1 and kn.launches["ell_matvec"] == 0
    assert _rel(ref, got.reshape(nb, n)) <= 1e-13


def test_ell_bicgstab_plain_matches_interpret():
    """Batched BiCGStab with a bc row on component 0 (zmask, x0 preset)."""
    n, nb = 40, 3
    vals, cols, A = _nonsym_ell(n, np.float64)
    rng = np.random.default_rng(1)
    b = rng.standard_normal((nb, n))
    masks = np.zeros((nb, n), bool)
    masks[0, 0] = masks[2, n - 1] = True
    bcv = np.where(masks, 1.25, 0.0)
    rhs = np.where(masks, bcv, b)
    x0 = np.where(masks, bcv, rng.standard_normal((nb, n)) * 0.1)
    zmask = 1.0 - masks
    invd = 1.0 / np.diagonal(A)
    r0 = zmask * (rhs - x0 @ A.T)
    bnorm = np.sqrt(np.sum(rhs * rhs, axis=-1))
    rtol, maxiter = 1e-10, 200
    it_fn = po.make_ell_bicgstab_iter(3, n, nb, interpret=True)
    xj, itj, _, cj = po.ell_bicgstab_from_r0(
        it_fn, jnp.asarray(vals), jnp.asarray(cols), jnp.asarray(r0), jnp.asarray(x0),
        jnp.asarray(zmask), jnp.asarray(invd), jnp.asarray(bnorm), rtol, maxiter)
    kn.reset_counts()
    res = ell.ell_bicgstab(T(vals), T(cols), _W(cols), T(r0), T(x0), T(zmask), T(invd),
                           T(bnorm), rtol, maxiter)
    assert kn.plain_calls["ell_bicgstab"] == 1 and res.syncs >= 1
    assert bool(np.asarray(cj).all()) and bool(res.converged.all())
    np.testing.assert_array_equal(np.asarray(itj), res.iters.numpy())
    assert _rel(xj, res.x) <= 1e-10


def test_ell_cg_plain_matches_interpret():
    """Batched Jacobi-PCG on an SPD banded operator from a nonzero x0."""
    n, nb = 48, 3
    vals, cols, A = _lap1d_ell(n, dtype=np.float64)
    vals[0] += 2.0
    A[np.arange(n), np.arange(n)] += 2.0
    rng = np.random.default_rng(2)
    b = rng.standard_normal((nb, n))
    x0 = rng.standard_normal((nb, n))
    r0 = b - x0 @ A.T
    invd = 1.0 / np.diagonal(A)
    bnorm = np.sqrt(np.sum(b * b, axis=-1))
    rtol, maxiter = 1e-10, 300
    it_fn = po.make_ell_cg_iter(3, n, nb, interpret=True)
    xj, itj, _, cj = po.ell_cg_batched_from_r0(
        it_fn, jnp.asarray(vals), jnp.asarray(cols), jnp.asarray(r0), jnp.asarray(x0),
        jnp.asarray(invd), jnp.asarray(bnorm), rtol, maxiter)
    kn.reset_counts()
    res = ell.ell_cg(T(vals), T(cols), _W(cols), T(r0), T(x0), T(invd), T(bnorm), rtol, maxiter)
    assert kn.plain_calls["ell_cg"] == 1
    assert bool(np.asarray(cj).all()) and bool(res.converged.all())
    np.testing.assert_array_equal(np.asarray(itj), res.iters.numpy())
    assert _rel(xj, res.x) <= 1e-10


def _amg_problem(variant, nx=24):
    """The 2D Laplacian of test_ell_kernels: Neumann with its nullspace, or
    Dirichlet with a band of outlet rows (identity rows and columns)."""
    rows, cols, vals, n = _lap2d_coo(nx)
    vals = vals.astype(np.float64)
    mask = np.zeros(n, bool)
    if variant == "null":
        fix = np.zeros(n)
        np.add.at(fix, rows[rows != cols], -vals[rows != cols])
        vals = vals.copy()
        dm = rows == cols
        vals[dm] = fix[rows[dm]]
    else:
        mask[n - nx:] = True
        keep = ~(mask[rows] | mask[cols])
        d = np.flatnonzero(mask)
        rows, cols, vals = (np.concatenate([rows[keep], d]), np.concatenate([cols[keep], d]),
                            np.concatenate([vals[keep], np.ones(d.size)]))
    amg = AlgebraicMG(rows, cols, vals, n, dtype=torch.float64, coarse_max=50, pre=2, post=2,
                      nullvec=np.ones(n) if variant == "null" else None)
    # the fine operator in (K, n) form, without the mask's identity rows
    A = np.zeros((n, n))
    r0, c0, v0, _ = _lap2d_coo(nx)
    np.add.at(A, (r0, c0), v0.astype(np.float64))
    if variant == "null":
        A[np.arange(n), np.arange(n)] = 0.0
        A[np.arange(n), np.arange(n)] = -A.sum(axis=1)
    K = int((A != 0).sum(axis=1).max())
    ev, ec = np.zeros((K, n)), np.zeros((K, n), np.int32)
    for i in range(n):
        nzc = np.flatnonzero(A[i])
        ev[: len(nzc), i], ec[: len(nzc), i] = A[i, nzc], nzc
    return amg, ev, ec, mask, n


def _jax_arrays(amg):
    meta, arrays = amg_kernel_data(amg)
    return meta, arrays, [jnp.asarray(a.numpy()) for a in arrays]


@pytest.mark.parametrize("variant", ["null", "mask"])
def test_ell_vcycle_plain_matches_interpret(variant):
    amg, _, _, _, n = _amg_problem(variant)
    meta, arrays, jarrays = _jax_arrays(amg)
    assert len(meta["levels"]) >= 2
    r = np.random.default_rng(4).standard_normal(n)
    ref = po.make_ell_vcycle(meta, n, interpret=True)(*jarrays, jnp.asarray(r))
    assert _rel(ref, ell.ell_vcycle((meta, arrays), T(r), amg_widths(amg))) <= 1e-12
    assert _rel(amg.vcycle(T(r)), ell.vcycle_plain(meta, arrays, T(r))) <= 1e-12


@pytest.mark.parametrize("variant", ["null", "mask"])
def test_ell_pcg_amg_plain_matches_interpret(variant):
    amg, ev, ec, mask, n = _amg_problem(variant)
    meta, arrays, jarrays = _jax_arrays(amg)
    rng = np.random.default_rng(3)
    b = rng.standard_normal(n)
    x0 = 0.1 * rng.standard_normal(n)
    if variant == "mask":
        b[mask] = 0.0
    rtol, maxiter = 1e-10, 100
    mk = jnp.asarray(mask.astype(np.float64))
    vj, cj = jnp.asarray(ev), jnp.asarray(ec)
    mv = po.make_ell_matvec(ev.shape[0], n, n, interpret=True)
    if variant == "mask":
        matvec = lambda x: jnp.where(mask, x, mv(vj, cj, jnp.where(mask, 0.0, x)))
    else:
        matvec = lambda x: mv(vj, cj, x)
    it_fn = po.make_ell_pcg_amg_iter(meta, ev.shape[0], n, has_mask=variant == "mask",
                                     interpret=True)
    xj, kj, _, cvj = po.ell_pcg_amg_solve(
        it_fn, po.make_ell_vcycle(meta, n, interpret=True), matvec, jarrays, vj, cj,
        jnp.asarray(b), jnp.asarray(x0), rtol, maxiter,
        mask=mk if variant == "mask" else None,
        nullvec=jnp.ones(n) if variant == "null" else None)
    kn.reset_counts()
    res = ell.ell_pcg_amg((meta, arrays), T(ev), T(ec), _W(ec), T(b), T(x0), rtol, maxiter,
                          mask=T(mask.astype(np.float64)) if variant == "mask" else None,
                          amg_widths=amg_widths(amg))
    assert kn.plain_calls["ell_pcg_amg"] == 1 and sum(kn.launches.values()) == 0
    assert bool(cvj) and bool(res.converged)
    assert int(kj) == int(res.iters) >= 3
    assert _rel(xj, res.x) <= 1e-10


def test_wrappers_refuse_mixed_devices():
    vals, cols, _ = _nonsym_ell(8, np.float64)
    with pytest.raises(ValueError):
        ell.ell_matvec(T(vals), T(cols), _W(cols),
                       torch.zeros(8, dtype=torch.float64, device="meta"))
