"""The port's whole-solve Krylov kernels (plain versions on the CPU) and the
cube gather against the JAX package's Pallas kernels in interpret mode, on
the systems of tests/test_pallas_ops.py (3D, N=4, P2/P1, float64):

- K2 ``bicgstab_from_r0`` against ``make_bicgstab_iter`` driven by
  ``bicgstab_fused_from_r0``: same W, zmask, invd, r0 and x0; x to 1e-7
  relative (the Pallas test's own bound), equal iteration counts per row.
- K4 ``cg_from_r0`` against ``make_cg_iter_pf`` driven by ``cg_pf_solve``:
  x to 1e-8 relative, equal iteration counts per row; on the P2 velocity
  mass at batch 3, and on the P1 pressure mass at batch 1 and 3 (the P1
  cube's route).
- K8 ``cube_gather`` against ``make_gather_chunked``: equal (a copy).
- Every new wrapper sends a CPU tensor to its plain version and counts it
  there, and raises for a device with no kernel.

The CUDA kernels run only on the card: chip_smoke.py holds them to these
plain versions there, at the N=36 shapes."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from oasisx_tpu.assembly import cubes as cu  # noqa: E402
from oasisx_tpu.assembly import pallas_ops as po  # noqa: E402
from oasisx_tpu_torch.assembly import kernels as kn  # noqa: E402
from oasisx_tpu_torch.la import fused  # noqa: E402
from oasisx_tpu_torch.la.pressure_mg import PressureMGCG  # noqa: E402
from tests.test_cubes import _grid, setup  # noqa: E402


@pytest.fixture(scope="module")
def box():
    """3D, N=4, P2/P1: the JAX package's tables and structured maps."""
    return setup(3, 4, 2, 1)


def test_bicgstab_from_r0_matches_kernel(box):
    """K2: tentative operator W with Dirichlet rows on the x0 = 0 grid face,
    a warm start, rtol 1e-9 (the recipe of test_pallas_ops.py:224-278)."""
    mesh, ctx, refs, ops, (sm_v, gf_v, _), _ = box
    rng = np.random.default_rng(16)
    d = mesh.dim
    nl = ops.M_c.shape[0]
    g = lambda: _grid(rng.standard_normal(ctx.ndofs_v), gf_v, sm_v)
    uab = jnp.asarray(np.stack([g() for _ in range(d)]))
    a, bb = 5.0, 0.2
    A0 = np.asarray(a * ops.M_c + bb * ops.K_c)
    u27 = jnp.stack([cu.cube_gather(uab[i], sm_v) for i in range(d)]).reshape(d * nl, -1)
    T = po.conv_weight_tensor(ops)
    W = (jnp.asarray(A0.reshape(-1, 1)) + 0.5 * jnp.asarray(T).T @ u27).reshape(nl, nl, -1)
    uq = cu.conv_uq(ops, uab)

    maskg = np.zeros(po._grid_shape(sm_v), bool)
    maskg[:, 0] = True
    masks = np.stack([maskg.reshape(-1)] * d)
    bcvals = np.stack([g() for _ in range(d)]) * masks[0]
    diag = np.asarray(a * cu.diag_cube(ops.M_c, sm_v) + bb * cu.diag_cube(ops.K_c, sm_v)
                      + 0.5 * cu.conv_diag(ops, uq))

    def matvec(x):
        y = jnp.stack([cu.tentative_matvec_local(ops, jnp.asarray(A0), uq, x[i])
                       for i in range(d)])
        return jnp.where(masks, x, y)

    rhs = np.where(masks, bcvals, np.stack([g() for _ in range(d)]))
    x0 = np.where(masks, bcvals, 0.1 * np.stack([g() for _ in range(d)]))
    r0 = np.where(masks, 0.0, rhs - np.asarray(matvec(jnp.asarray(x0))))
    zmask = np.where(masks, 0.0, 1.0)
    invd = np.where(diag != 0, 1.0 / np.where(diag != 0, diag, 1.0), 1.0)
    bnorm = np.sqrt(np.sum(rhs * rhs, axis=-1))
    rtol, maxiter = 1e-9, 60

    pf = lambda v: po.to_planeflat(jnp.asarray(v), sm_v)
    it_fn = po.make_bicgstab_iter(sm_v, d, interpret=True)
    xj, itj, rnj, cj = po.bicgstab_fused_from_r0(
        it_fn, po.build_w_win(W, sm_v), pf(r0), pf(x0), pf(zmask), pf(invd),
        jnp.asarray(bnorm), rtol, maxiter)
    xj = np.asarray(po.from_planeflat(xj, sm_v))

    t = torch.tensor
    kn.reset_counts()
    res = fused.bicgstab(t(np.asarray(W).reshape(nl * nl, -1)), t(r0), t(x0), t(zmask),
                         t(invd), t(bnorm), sm_v, rtol, maxiter)
    assert kn.plain_calls["bicgstab"] == 1 and kn.launches["bicgstab"] == 0
    assert bool(np.asarray(cj).all()) and bool(res.converged.all())
    assert np.array_equal(res.iters.numpy(), np.asarray(itj)), (res.iters, itj)
    assert len(set(res.iters.tolist())) > 1  # rows converge apart: freezing is exercised
    assert np.abs(res.x.numpy() - xj).max() <= 1e-7 * np.abs(xj).max()
    assert res.syncs == int(res.iters.max()) + 1


def test_cg_from_r0_matches_kernel(box):
    """K4: the mass operator from a warm start x0, r0 = b - M x0, rtol 1e-10
    (the recipe of test_pallas_ops.py:324-344)."""
    mesh, ctx, refs, ops, (sm_v, gf_v, _), _ = box
    rng = np.random.default_rng(21)
    d = mesh.dim
    gv = lambda: _grid(rng.standard_normal(ctx.ndofs_v), gf_v, sm_v)
    diag = np.asarray(cu.diag_cube(ops.M_c, sm_v))
    invd = np.where(diag != 0, 1.0 / np.where(diag != 0, diag, 1.0), 1.0)
    mvb = lambda x: jnp.stack([cu.matvec_cube(x[b], ops.M_c, sm_v) for b in range(d)])
    b = np.asarray(mvb(jnp.asarray(np.stack([gv() for _ in range(d)]))))
    b = b * np.array([[1.0], [1e-2], [30.0]])
    x0 = 0.5 * np.stack([gv() for _ in range(d)])
    r0 = b - np.asarray(mvb(jnp.asarray(x0)))
    rtol, maxiter = 1e-10, 100

    pf = lambda v: po.to_planeflat(jnp.asarray(v), sm_v)
    mv_pf = lambda xp: pf(mvb(po.from_planeflat(xp, sm_v)))
    it_fn = po.make_cg_iter_pf(sm_v, np.asarray(ops.M_c), d, interpret=True)
    xj, itj, rnj, cj = po.cg_pf_solve(it_fn, mv_pf, pf(b), pf(x0), pf(invd), rtol, maxiter)
    xj = np.asarray(po.from_planeflat(xj, sm_v))

    t = torch.tensor
    kn.reset_counts()
    res = fused.cg_mass(t(np.asarray(ops.M_c)), t(r0), t(x0), t(invd),
                        t(np.sqrt(np.sum(b * b, axis=-1))), sm_v, rtol, maxiter)
    assert kn.plain_calls["cg_mass"] == 1 and kn.launches["cg_mass"] == 0
    assert bool(np.asarray(cj).all()) and bool(res.converged.all())
    assert np.array_equal(res.iters.numpy(), np.asarray(itj)), (res.iters, itj)
    assert np.abs(res.x.numpy() - xj).max() <= 1e-8 * np.abs(xj).max()


@pytest.mark.parametrize("batch", [1, 3], ids=["Mq_c-batch1", "P1-mass-batch3"])
def test_cg_from_r0_p1_matches_kernel(box, batch):
    """K4 on the P1 cube (the kernel's stencil-tile route): the pressure
    mass Mq_c at batch 1 (the rotational update's solve) and at batch d (a
    P1 mass, rows of unequal scale) from a warm start, rtol 1e-10, against
    ``make_cg_iter_pf`` on the pressure grid driven by ``cg_pf_solve``: x to
    1e-8 relative, equal iteration counts per row."""
    mesh, ctx, refs, ops, _, (sm_q, gf_q, _) = box
    rng = np.random.default_rng(23 + batch)
    gq = lambda: _grid(rng.standard_normal(ctx.ndofs_q), gf_q, sm_q)
    Mq = np.asarray(ops.Mq_c)
    diag = np.asarray(cu.diag_cube(ops.Mq_c, sm_q))
    invd = np.where(diag != 0, 1.0 / np.where(diag != 0, diag, 1.0), 1.0)
    mvb = lambda x: jnp.stack([cu.matvec_cube(x[b], ops.Mq_c, sm_q) for b in range(batch)])
    b = np.asarray(mvb(jnp.asarray(np.stack([gq() for _ in range(batch)]))))
    b = b * np.array([[1.0], [1e-2], [30.0]])[:batch]
    x0 = 0.5 * np.stack([gq() for _ in range(batch)])
    r0 = b - np.asarray(mvb(jnp.asarray(x0)))
    rtol, maxiter = 1e-10, 100

    pf = lambda v: po.to_planeflat(jnp.asarray(v), sm_q)
    mv_pf = lambda xp: pf(mvb(po.from_planeflat(xp, sm_q)))
    it_fn = po.make_cg_iter_pf(sm_q, Mq, batch, interpret=True)
    xj, itj, rnj, cj = po.cg_pf_solve(it_fn, mv_pf, pf(b), pf(x0), pf(invd), rtol, maxiter)
    xj = np.asarray(po.from_planeflat(xj, sm_q))

    t = torch.tensor
    kn.reset_counts()
    res = fused.cg_mass(t(Mq), t(r0), t(x0), t(invd), t(np.sqrt(np.sum(b * b, axis=-1))), sm_q,
                        rtol, maxiter)
    assert kn.plain_calls["cg_mass"] == 1 and kn.launches["cg_mass"] == 0
    assert bool(np.asarray(cj).all()) and bool(res.converged.all())
    assert np.array_equal(res.iters.numpy(), np.asarray(itj)), (res.iters, itj)
    assert int(res.iters.min()) >= 3
    assert np.abs(res.x.numpy() - xj).max() <= 1e-8 * np.abs(xj).max()


def test_cube_gather_matches_kernel(box):
    """K8: (d, npad) -> (d, nl, ncubes), a copy, so equal."""
    mesh, ctx, refs, ops, (sm_v, gf_v, _), _ = box
    rng = np.random.default_rng(13)
    d, nl = mesh.dim, ops.M_c.shape[0]
    x = np.stack([_grid(rng.standard_normal(ctx.ndofs_v), gf_v, sm_v) for _ in range(d)])
    ref = np.asarray(po.make_gather_chunked(sm_v, batch=d, interpret=True)(jnp.asarray(x)))
    kn.reset_counts()
    got = kn.cube_gather(torch.tensor(x), sm_v)
    assert kn.plain_calls["cube_gather"] == 1 and kn.launches["cube_gather"] == 0
    assert np.array_equal(got.numpy(), ref.reshape(d, nl, -1))


def test_new_wrappers_route_and_raise(box):
    """A CPU tensor takes the plain version and counts there; a tensor on a
    device with no kernel raises, for each of the four new wrappers."""
    mesh, ctx, refs, ops, (sm_v, _, _), _ = box
    d = mesh.dim
    npad_v = int(np.prod(sm_v[0]))
    z = torch.zeros((d, npad_v), dtype=torch.float64)
    one = torch.ones(npad_v, dtype=torch.float64)
    bn = torch.ones(d, dtype=torch.float64)
    M = torch.tensor(np.asarray(ops.M_c))
    W = M.reshape(-1, 1).repeat(1, int(np.prod(sm_v[1])))
    # the pressure solve needs a grid that coarsens: 2D, N=6
    _, _, _, ops2, _, (sm_q, _, _) = setup(2, 6, 2, 1)
    npad_q = int(np.prod(sm_q[0]))
    mg = kn.build_pressure_mg_data(sm_q, np.asarray(ops2.Ap_c))
    pcg = PressureMGCG(sm_q, torch.tensor(np.asarray(ops2.Ap_c)), np.ones(npad_q), mg, 1e-8, 10)
    calls = {
        "cube_gather": lambda dev: kn.cube_gather(z.to(dev), sm_v),
        "cg_mass": lambda dev: fused.cg_mass(M.to(dev), z.to(dev), z.to(dev), one.to(dev),
                                             bn.to(dev), sm_v, 1e-8, 5),
        "bicgstab": lambda dev: fused.bicgstab(W.to(dev), z.to(dev), z.to(dev), z.to(dev),
                                               one.to(dev), bn.to(dev), sm_v, 1e-8, 5),
    }
    kn.reset_counts()
    for name, call in calls.items():
        call("cpu")
        assert kn.plain_calls[name] == 1, name
        with pytest.raises(ValueError):
            call("meta")
    q = torch.zeros(npad_q, dtype=torch.float64)
    res = pcg.solve(q, q)
    assert kn.plain_calls["pressure_mg"] == 1 and res.syncs >= 1
    with pytest.raises(ValueError):
        pcg.solve(q.to("meta"), q.to("meta"))
    assert sum(kn.launches.values()) == 0
    kn.reset_counts()
