"""The JAX package's N=64 size tier (its kernels for grids past the TPU's
VMEM budget) against the port's main-path kernels that take those shapes,
on the CPU: the port's plain versions against the Pallas kernels in
interpret mode, float64 unless a kernel fixes its own type.

- K10 ``make_matvec_hbm_chan`` (y = zmask A_W (premul x), channel-major
  state) against ``kernels.matvec_win`` with its multipliers: 1e-11 on
  O(1) data (float64 sums in another order), padding exactly 0.
- ``make_tent_matvec_hbm`` (one vector, W streamed per slot row) against
  ``matvec_win`` at batch 1, in float32 because that kernel keeps W in a
  float32 buffer: 2e-5 relative to the largest entry (each output sums up
  to 4 x 9 float32 products in another order; float32 eps is 6e-8).
- K13 ``make_scatter_chunked`` against ``kernels.cube_scatter``: 1e-11.
- K11 ``make_cg_step`` driven by ``cg_solve_stepped``, one component at a
  time, against K4's plain version ``cg_mass`` at batch 1 and at batch d:
  equal iterations per component, x to 1e-8 relative (the bound of the
  K4 test), at rtol 1e-8: the row whose right-hand side is 100x smaller
  than its initial residual then stops 1e-10 below it, clear of the
  rounding floor where the two loops' residual norms part by ~30%.
- K9 ``make_bicgstab_hbm_kernels`` driven by ``bicgstab_hbm_from_r0``,
  resident and streaming, against K2's plain version ``bicgstab``: equal
  iterations per component, x to 1e-7 relative (the Pallas test's bound).

K1 with the tier's 5 levels and the structured path end to end against
the JAX solver's tier are in tests/test_torch_size_tier_path.py.  The CUDA
kernels run only on the card: chip_smoke.py phase 3c holds them to these
plain versions at the N=64 shapes."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from oasisx_tpu.assembly import cubes as cu  # noqa: E402
from oasisx_tpu.assembly import pallas_ops as po  # noqa: E402
from oasisx_tpu_torch.assembly import kernels as kn  # noqa: E402
from oasisx_tpu_torch.la import fused  # noqa: E402
from tests.test_cubes import _grid, setup  # noqa: E402

ATOL = 1e-11


@pytest.fixture(scope="module")
def box3():
    """3D, N=3, P2/P1: the JAX package's tables and structured maps."""
    return setup(3, 3, 2, 1)


@pytest.fixture(scope="module")
def box2():
    """2D, N=5, P2/P1: the streamed-W kernels unroll a DMA per slot pair,
    81 in 2D against 729 in 3D, which is what their interpret-mode
    compile time follows (in 3D the K9 test took 90 s a case); their code
    does not depend on d."""
    return setup(2, 5, 2, 1)


def _valid(sm, gf):
    v = np.zeros(int(np.prod(sm[0])), bool)
    v[gf] = True
    return v


def test_matvec_hbm_chan_matches_matvec_win(box2):
    """K10 folded into K3: y = zmask A_W (premul x), d components."""
    mesh, ctx, refs, ops, (sm_v, gf_v, _), _ = box2
    rng = np.random.default_rng(41)
    d, nl = mesh.dim, ops.M_c.shape[0]
    nc = int(np.prod(sm_v[1]))
    g = lambda: _grid(rng.standard_normal(ctx.ndofs_v), gf_v, sm_v)
    x = np.stack([g() for _ in range(d)])
    premul = np.stack([g() for _ in range(d)])
    zmask = (rng.random(x.shape) > 0.3).astype(np.float64)
    W = rng.standard_normal((nl * nl, nc))
    h = lambda v: po.to_hbm_state(jnp.asarray(v), sm_v)
    mv = po.make_matvec_hbm_chan(sm_v, d, interpret=True)
    ref = np.asarray(po.from_hbm_state(mv(po.build_w_win(jnp.asarray(W), sm_v), h(x),
                                          h(premul), h(zmask)), sm_v))
    t = torch.tensor
    kn.reset_counts()
    got = kn.matvec_win(t(W), t(x), sm_v, premul=t(premul), zmask=t(zmask)).numpy()
    assert kn.plain_calls["matvec_win"] == 1 and kn.launches["matvec_win"] == 0
    assert np.abs(got - ref).max() <= ATOL, np.abs(got - ref).max()
    assert (got[:, ~_valid(sm_v, gf_v)] == 0).all()
    # each multiplier alone is the plain product with it applied by hand
    plain = kn.matvec_win(t(W), t(premul * x), sm_v).numpy()
    assert np.array_equal(kn.matvec_win(t(W), t(x), sm_v, premul=t(premul)).numpy(), plain)
    assert np.array_equal(kn.matvec_win(t(W), t(premul * x), sm_v, zmask=t(zmask)).numpy(),
                          zmask * plain)


def test_tent_matvec_hbm_matches_matvec_win(box2):
    """The test-only per-slot-row W stream, folded into K3 at batch 1."""
    mesh, ctx, refs, ops, (sm_v, gf_v, _), _ = box2
    rng = np.random.default_rng(14)
    d, nl = mesh.dim, ops.M_c.shape[0]
    x = _grid(rng.standard_normal(ctx.ndofs_v), gf_v, sm_v).astype(np.float32)
    uab = np.stack([_grid(rng.standard_normal(ctx.ndofs_v), gf_v, sm_v) for _ in range(d)])
    A0 = 5.0 * np.asarray(ops.M_c) + 0.2 * np.asarray(ops.K_c)
    u27 = np.stack([np.asarray(cu.cube_gather(jnp.asarray(uab[g]), sm_v))
                    for g in range(d)]).reshape(d * nl, -1)
    W = (A0.reshape(-1, 1) + 0.5 * po.conv_weight_tensor(ops).T @ u27).astype(np.float32)
    mv = po.make_tent_matvec_hbm(sm_v, interpret=True)
    ref = np.asarray(mv(po.pad_weights(jnp.asarray(W), sm_v), jnp.asarray(x)))
    got = kn.matvec_win(torch.tensor(W), torch.tensor(x)[None], sm_v)[0].numpy()
    assert got.dtype == np.float32
    scale = np.abs(ref).max()
    assert np.abs(got - ref).max() <= 2e-5 * scale, np.abs(got - ref).max() / scale


@pytest.mark.parametrize("batch", [1, 3])
def test_scatter_chunked_matches_cube_scatter(box3, batch):
    """K13: (B, nl, *cells) -> (B, npad); the port's scatter is an output
    owner, the TPU kernel a sum of slot-chunk partial sums."""
    mesh, ctx, refs, ops, (sm_v, gf_v, _), _ = box3
    rng = np.random.default_rng(13 + batch)
    nl = ops.M_c.shape[0]
    cells = tuple(sm_v[1])
    U = rng.standard_normal((batch, nl) + cells)
    sv = po.make_scatter_chunked(sm_v, batch=batch, interpret=True)
    ref = np.asarray(sv(jnp.asarray(U[0] if batch == 1 else U))).reshape(batch, -1)
    kn.reset_counts()
    got = kn.cube_scatter(torch.tensor(U.reshape(batch, nl, -1)), sm_v).numpy()
    assert kn.plain_calls["cube_scatter"] == 1 and kn.launches["cube_scatter"] == 0
    assert np.abs(got - ref).max() <= ATOL, np.abs(got - ref).max()
    assert (got[:, ~_valid(sm_v, gf_v)] == 0).all()


def test_cg_step_matches_cg_mass(box3):
    """K11 folded into K4: per-component CG with the baked mass matrix,
    against K4 at batch 1 (each component) and at batch d (rows converge
    apart: the right-hand sides differ in scale by 3000x)."""
    mesh, ctx, refs, ops, (sm_v, gf_v, _), _ = box3
    rng = np.random.default_rng(15)
    d = mesh.dim
    M_c = np.asarray(ops.M_c)
    diag = np.asarray(cu.diag_cube(ops.M_c, sm_v))
    invd = np.where(diag != 0, 1.0 / np.where(diag != 0, diag, 1.0), 1.0)
    # b and r0 by the XLA cube matvec (cg_solve_stepped takes it for r0)
    mv = lambda v: cu.matvec_cube(v, ops.M_c, sm_v)
    g = lambda: _grid(rng.standard_normal(ctx.ndofs_v), gf_v, sm_v)
    b = np.stack([np.asarray(mv(jnp.asarray(g()))) for _ in range(d)])
    b = b * np.array([[1.0], [1e-2], [30.0]])
    x0 = 0.5 * np.stack([g() for _ in range(d)])
    rtol, maxiter = 1e-8, 200
    step = po.make_cg_step(sm_v, M_c, interpret=True)
    ref = [po.cg_solve_stepped(step, mv, jnp.asarray(b[i]), jnp.asarray(x0[i]),
                               jnp.asarray(invd), rtol, maxiter) for i in range(d)]
    xj = np.stack([np.asarray(r[0]) for r in ref])
    itj = np.array([int(r[1]) for r in ref])
    assert all(bool(r[3]) for r in ref) and len(set(itj.tolist())) > 1
    r0 = b - np.stack([np.asarray(mv(jnp.asarray(x0[i]))) for i in range(d)])
    bn = np.sqrt(np.sum(b * b, axis=-1))
    t = torch.tensor
    M = t(M_c)
    kn.reset_counts()
    rows = [fused.cg_mass(M, t(r0[i:i + 1]), t(x0[i:i + 1]), t(invd), t(bn[i:i + 1]), sm_v,
                          rtol, maxiter) for i in range(d)]
    batched = fused.cg_mass(M, t(r0), t(x0), t(invd), t(bn), sm_v, rtol, maxiter)
    assert kn.plain_calls["cg_mass"] == d + 1 and kn.launches["cg_mass"] == 0
    one = np.concatenate([r.x.numpy() for r in rows])
    assert np.array_equal(np.concatenate([r.iters.numpy() for r in rows]), itj)
    assert np.array_equal(batched.iters.numpy(), itj)
    for x in (one, batched.x.numpy()):
        for i in range(d):
            assert np.abs(x[i] - xj[i]).max() <= 1e-8 * np.abs(xj[i]).max()


@pytest.mark.parametrize("resident", [False, True], ids=["streaming", "resident"])
def test_bicgstab_hbm_matches_bicgstab(box2, resident):
    """K9 folded into K2: the tentative operator W with Dirichlet rows on
    the x0 = 0 grid face and a warm start, rtol 1e-9 (the recipe of
    tests/test_pallas_ops.py:387-477, in 2D for the reason of ``box2``)."""
    mesh, ctx, refs, ops, (sm_v, gf_v, _), _ = box2
    rng = np.random.default_rng(17)
    d, nl = mesh.dim, ops.M_c.shape[0]
    g = lambda: _grid(rng.standard_normal(ctx.ndofs_v), gf_v, sm_v)
    uab = jnp.asarray(np.stack([g() for _ in range(d)]))
    a, bb = 5.0, 0.2
    A0 = np.asarray(a * ops.M_c + bb * ops.K_c)
    u27 = jnp.stack([cu.cube_gather(uab[i], sm_v) for i in range(d)]).reshape(d * nl, -1)
    W = (jnp.asarray(A0.reshape(-1, 1))
         + 0.5 * jnp.asarray(po.conv_weight_tensor(ops)).T @ u27).reshape(nl, nl, -1)
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

    h = lambda v: po.to_hbm_state(jnp.asarray(v), sm_v)
    kernels = po.make_bicgstab_hbm_kernels(sm_v, d, interpret=True, dtype=jnp.float64,
                                           resident=resident)
    xj, itj, _, cj = po.bicgstab_hbm_from_r0(
        kernels, po.build_w_win(W, sm_v), h(r0), h(x0), h(zmask),
        h(np.broadcast_to(invd, (d, invd.size))), jnp.asarray(bnorm), rtol, maxiter)
    xj = np.asarray(po.from_hbm_state(xj, sm_v))

    t = torch.tensor
    kn.reset_counts()
    res = fused.bicgstab(t(np.asarray(W).reshape(nl * nl, -1)), t(r0), t(x0), t(zmask),
                         t(invd), t(bnorm), sm_v, rtol, maxiter)
    assert kn.plain_calls["bicgstab"] == 1 and kn.launches["bicgstab"] == 0
    assert bool(np.asarray(cj).all()) and bool(res.converged.all())
    assert np.array_equal(res.iters.numpy(), np.asarray(itj)), (res.iters, itj)
    assert np.abs(res.x.numpy() - xj).max() <= 1e-7 * np.abs(xj).max()


def test_size_tier_wrappers_route_and_raise(box3):
    """cube_scatter and matvec_win's multipliers: a CPU tensor takes the
    plain version, a device with no kernel raises."""
    mesh, ctx, refs, ops, (sm_v, _, _), _ = box3
    nl, nc = ops.M_c.shape[0], int(np.prod(sm_v[1]))
    npad = int(np.prod(sm_v[0]))
    U = torch.zeros((2, nl, nc), dtype=torch.float64)
    x = torch.zeros((2, npad), dtype=torch.float64)
    W = torch.zeros((nl * nl, nc), dtype=torch.float64)
    kn.reset_counts()
    kn.cube_scatter(U, sm_v)
    kn.matvec_win(W, x, sm_v, premul=x, zmask=x)
    assert kn.plain_calls["cube_scatter"] == 1 and kn.plain_calls["matvec_win"] == 1
    with pytest.raises(ValueError):
        kn.cube_scatter(U.to("meta"), sm_v)
    with pytest.raises(ValueError):
        kn.matvec_win(W.to("meta"), x.to("meta"), sm_v, zmask=x)
    assert sum(kn.launches.values()) == 0
    kn.reset_counts()
