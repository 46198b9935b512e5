"""The port's cube kernels (plain versions on the CPU) against the JAX
package: the ``cubes.py`` ops and the Pallas kernels in interpret mode, in
float64 at atol 1e-11 on O(1) data, with padded grid positions exactly 0.

The CUDA kernels themselves run only on the card: ``chip_smoke.py`` holds
them to these plain versions there, at the N=36 shapes."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from oasisx_tpu.assembly import cubes as jcub  # noqa: E402
from oasisx_tpu.assembly import engine as jeng  # noqa: E402
from oasisx_tpu.assembly import pallas_ops as po  # noqa: E402
from oasisx_tpu.assembly.structured import build_structured_map as jbsm  # noqa: E402
from oasisx_tpu.elements.element import FiniteElement as JFE  # noqa: E402
from oasisx_tpu.meshes import create_box as jbox, create_rectangle as jrect  # noqa: E402
from oasisx_tpu.spaces.functionspace import FunctionSpace as JFS  # noqa: E402
from oasisx_tpu_torch.assembly import cubes as tcub  # noqa: E402
from oasisx_tpu_torch.assembly import kernels as kn  # noqa: E402
from oasisx_tpu_torch.assembly.reference_tensors import build_reference_tensors  # noqa: E402
from oasisx_tpu_torch.assembly.structured import build_structured_map as tbsm  # noqa: E402
from oasisx_tpu_torch.elements.element import FiniteElement as TFE  # noqa: E402
from oasisx_tpu_torch.meshes import create_box as tbox, create_rectangle as trect  # noqa: E402
from oasisx_tpu_torch.spaces.functionspace import FunctionSpace as TFS  # noqa: E402

ATOL = 1e-11
CELLS = [(3, 4, 5), (3, 5)]  # unequal cells, so a swapped axis shows


def _both(cells):
    """The same structured problem in both packages: (jax ops, torch ops,
    per-space (sm, valid))."""
    d = len(cells)
    if d == 3:
        lo, hi, cell = (-1.0, -1.0, -1.0), (1.0, 1.0, 1.0), "tetrahedron"
        jm, tm = jbox(lo, hi, cells), tbox(lo, hi, cells)
    else:
        lo, hi, cell = (-1.0, -1.0), (1.0, 1.0), "triangle"
        jm, tm = jrect(lo, hi, cells), trect(lo, hi, cells)
    out = {}
    for pkg, mesh, FE, FS, bsm in (("jax", jm, JFE, JFS, jbsm), ("torch", tm, TFE, TFS, tbsm)):
        el_u, el_p = FE("Lagrange", cell, 2), FE("Lagrange", cell, 1)
        V, Q = FS(mesh, el_u), FS(mesh, el_p)
        (sm_v, gf_v, valid_v) = bsm(mesh, el_u, V.dofmap)
        (sm_q, gf_q, valid_q) = bsm(mesh, el_p, Q.dofmap)
        if pkg == "jax":
            _, refs = jeng.build_device_context(
                mesh, el_u, V.dofmap.cell_dofs, V.num_dofs, el_p, Q.dofmap.cell_dofs, Q.num_dofs
            )
            ops = jcub.build_cube_ops(mesh, refs, sm_v, sm_q)
        else:
            refs = build_reference_tensors(el_u, el_p)
            ops = tcub.build_cube_ops(mesh, refs, sm_v, sm_q, dtype=torch.float64, device="cpu")
        out[pkg] = (ops, (sm_v, gf_v, valid_v), (sm_q, gf_q, valid_q))
    (_, jv, jq), (_, tv, tq) = out["jax"], out["torch"]
    assert jv[0] == tv[0] and jq[0] == tq[0]
    assert np.array_equal(jv[1], tv[1]) and np.array_equal(jq[1], tq[1])
    return out["jax"][0], out["torch"][0], tv, tq


@pytest.fixture(scope="module", params=CELLS, ids=lambda c: "x".join(map(str, c)))
def problem(request):
    return _both(request.param)


def _data(rng, valid, *lead):
    return rng.standard_normal(lead + valid.shape) * valid


def _check(got, ref, valid):
    got = got.numpy()
    assert np.abs(got - np.asarray(ref)).max() <= ATOL, np.abs(got - np.asarray(ref)).max()
    assert (got[..., ~valid] == 0).all()


def test_cube_ops_match(problem):
    """The copied cube tables are the JAX package's, entry for entry."""
    jops, tops, _, _ = problem
    for name in ("M_c", "K_c", "Ap_c", "Mq_c", "B_c", "G_c", "Phi", "Dg", "PhiW"):
        assert np.abs(getattr(tops, name).numpy() - np.asarray(getattr(jops, name))).max() < 1e-13


def test_plain_cube_ops(problem):
    """gather/scatter, diagonals and the convection tables' ops."""
    jops, tops, (sm_v, _, valid_v), (sm_q, _, valid_q) = problem
    rng = np.random.default_rng(6)
    d = len(sm_v[1])
    x = _data(rng, valid_v)
    U = tcub.cube_gather(torch.tensor(x), sm_v)
    assert np.array_equal(U.numpy(), np.asarray(jcub.cube_gather(jnp.asarray(x), sm_v)))
    Y = rng.standard_normal(U.shape)
    _check(tcub.cube_scatter(torch.tensor(Y), sm_v), jcub.cube_scatter(jnp.asarray(Y), sm_v),
           valid_v)
    _check(tcub.diag_cube(tops.K_c, sm_v), jcub.diag_cube(jops.K_c, sm_v), valid_v)
    _check(tcub.diag_cube(tops.Ap_c, sm_q), jcub.diag_cube(jops.Ap_c, sm_q), valid_q)
    uab = _data(rng, valid_v, d)
    uq = tcub.conv_uq(tops, torch.tensor(uab))
    uq_ref = np.asarray(jcub.conv_uq(jops, jnp.asarray(uab)))
    assert np.abs(uq.numpy() - uq_ref).max() <= ATOL
    _check(tcub.conv_diag(tops, uq), jcub.conv_diag(jops, jnp.asarray(uq_ref)), valid_v)


def test_matvec_const(problem):
    """K5 (and K12 at batch 1): constant cube matrix, batch d and batch 1."""
    jops, tops, (sm_v, _, valid_v), (sm_q, _, valid_q) = problem
    rng = np.random.default_rng(1)
    d = len(sm_v[1])
    x = _data(rng, valid_v, d)
    got = kn.matvec_const(torch.tensor(x), tops.M_c, sm_v)
    ref = np.stack([jcub.matvec_cube(jnp.asarray(x[b]), jops.M_c, sm_v) for b in range(d)])
    _check(got, ref, valid_v)
    pallas = po.make_matvec_pf(sm_v, np.asarray(jops.M_c), d, interpret=True)
    _check(got, po.from_planeflat(pallas(po.to_planeflat(jnp.asarray(x), sm_v)), sm_v), valid_v)

    xq = _data(rng, valid_q)
    got = kn.matvec_const(torch.tensor(xq)[None], tops.Ap_c, sm_q)[0]
    _check(got, jcub.matvec_cube(jnp.asarray(xq), jops.Ap_c, sm_q), valid_q)
    k12 = po.make_matvec(sm_q, np.asarray(jops.Ap_c), interpret=True)
    _check(got, k12(jnp.asarray(xq)), valid_q)
    # a 1-D input keeps its shape
    assert kn.matvec_const(torch.tensor(xq), tops.Ap_c, sm_q).shape == xq.shape


def test_matvec_win(problem):
    """K3: per-cube weights W[to*nl + ti, cube] shared by the components."""
    jops, tops, (sm_v, _, valid_v), _ = problem
    rng = np.random.default_rng(2)
    d = len(sm_v[1])
    nl = tcub.num_slots(sm_v)
    x = _data(rng, valid_v, d)
    W = rng.standard_normal((nl * nl, int(np.prod(sm_v[1]))))
    got = kn.matvec_win(torch.tensor(W), torch.tensor(x), sm_v)
    k3 = po.make_matvec_win(sm_v, d, interpret=True)
    ref = po.from_planeflat(
        k3(po.build_w_win(jnp.asarray(W), sm_v), po.to_planeflat(jnp.asarray(x), sm_v)), sm_v
    )
    _check(got, ref, valid_v)
    # with W = the constant mass matrix on every cube it is the mass matvec
    Wm = np.repeat(np.asarray(jops.M_c).reshape(-1, 1), W.shape[1], axis=1)
    got = kn.matvec_win(torch.tensor(Wm), torch.tensor(x), sm_v)
    _check(got, np.stack([jcub.matvec_cube(jnp.asarray(x[b]), jops.M_c, sm_v) for b in range(d)]),
           valid_v)


@pytest.mark.parametrize("name", ["B_c", "G_c"])
def test_mixed(problem, name):
    """K6: r_g = C_g p for every component."""
    jops, tops, (sm_v, _, valid_v), (sm_q, _, valid_q) = problem
    rng = np.random.default_rng(3)
    d = len(sm_v[1])
    p = _data(rng, valid_q)
    got = kn.mixed(torch.tensor(p), getattr(tops, name), sm_v, sm_q)
    _check(got, jcub.mixed_all(jnp.asarray(p), getattr(jops, name), sm_v, sm_q), valid_v)
    k6 = po.make_mixed_pf(sm_v, sm_q, np.asarray(getattr(jops, name)), d, interpret=True)
    _check(got, po.from_planeflat(k6(po.to_planeflat(jnp.asarray(p), sm_q)), sm_v), valid_v)


def test_mixed_weighted_gradient():
    """K6 on the lumped update's cube matrix Gw_c (a run-time matrix of
    G_c's shape) against the Pallas kernel in interpret mode, in 2D."""
    from oasisx_tpu_torch.elements.element import make_element

    cells = CELLS[1]
    mesh = trect((-1.0, -1.0), (1.0, 1.0), cells)
    el_u, el_p = (make_element(("Lagrange", k), "triangle") for k in (2, 1))
    sm_v, _, valid_v = tbsm(mesh, el_u, TFS(mesh, el_u).dofmap)
    sm_q, _, valid_q = tbsm(mesh, el_p, TFS(mesh, el_p).dofmap)
    ops = tcub.build_cube_ops(mesh, build_reference_tensors(el_u, el_p), sm_v, sm_q,
                              dtype=torch.float64, device="cpu",
                              gtab=el_p.tabulate(el_u.nodes)[1])
    p = _data(np.random.default_rng(9), valid_q)
    got = kn.mixed(torch.tensor(p), ops.Gw_c, sm_v, sm_q)
    _check(got, kn.mixed_plain(torch.tensor(p), ops.Gw_c, sm_v, sm_q), valid_v)
    k6 = po.make_mixed_pf(sm_v, sm_q, ops.Gw_c.numpy(), 2, interpret=True)
    _check(got, po.from_planeflat(k6(po.to_planeflat(jnp.asarray(p), sm_q)), sm_v), valid_v)


def test_divergence(problem):
    """K7: b2 = sum_g B_g^T u_g, B read transposed."""
    jops, tops, (sm_v, _, valid_v), (sm_q, _, valid_q) = problem
    rng = np.random.default_rng(4)
    d = len(sm_v[1])
    u = _data(rng, valid_v, d)
    got = kn.divergence(torch.tensor(u), tops.B_c, sm_v, sm_q)
    _check(got, jcub.divergence_cube(jnp.asarray(u), jops), valid_q)
    k7 = po.make_divergence_pf(sm_v, sm_q, np.asarray(jops.B_c), d, interpret=True)
    _check(got, po.from_planeflat(k7(po.to_planeflat(jnp.asarray(u), sm_v)), sm_q), valid_q)


def test_build_w_matches_windowed(problem):
    """W = A0 + 1/2 T^T U against build_w_win_from_u with the seam and pad
    positions of its window dropped."""
    jops, tops, (sm_v, _, valid_v), _ = problem
    rng = np.random.default_rng(5)
    cells = sm_v[1]
    d, nl = len(cells), tcub.num_slots(sm_v)
    uab = _data(rng, valid_v, d)
    A0 = 5.0 * np.asarray(jops.M_c) + 0.2 * np.asarray(jops.K_c)
    T = po.conv_weight_tensor(jops)
    assert np.abs(kn.conv_weight_tensor(tops) - T).max() < 1e-13
    U = np.stack([np.asarray(jcub.cube_gather(jnp.asarray(uab[g]), sm_v)) for g in range(d)])
    Ut = tcub.cube_gather(torch.tensor(uab), sm_v)
    assert np.abs(Ut.numpy() - U).max() == 0
    W = kn.build_w(torch.tensor(T), torch.tensor(A0), Ut.reshape(d * nl, -1)).numpy()
    Wwin = np.asarray(po.build_w_win_from_u(
        jnp.asarray(T), jnp.asarray(A0), jnp.asarray(U.reshape(d * nl, -1)), sm_v))
    if d == 2:
        ref = Wwin[:, : cells[0], : cells[1]]
    else:
        c0, c1, c2 = cells
        WL = po.win_len(sm_v)
        ref = np.pad(Wwin[:, :c0, :WL], ((0, 0), (0, 0), (0, c1 * (c2 + 1) - WL)))
        ref = ref.reshape(nl * nl, c0, c1, c2 + 1)[..., :c2]
    assert np.abs(W - ref.reshape(nl * nl, -1)).max() <= ATOL


def test_wrappers_route_and_count():
    """A CPU tensor takes the plain version and counts there; a tensor on a
    device with no kernel raises; shapes are checked on the kernel path."""
    _, tops, (sm_v, _, valid_v), (sm_q, _, _) = _both((2, 3, 2))
    kn.reset_counts()
    x = torch.zeros((3, valid_v.size), dtype=torch.float64)
    kn.matvec_const(x, tops.M_c, sm_v)
    kn.divergence(x, tops.B_c, sm_v, sm_q)
    assert kn.plain_calls["matvec_const"] == 1 and kn.plain_calls["divergence"] == 1
    assert sum(kn.launches.values()) == 0
    with pytest.raises(ValueError):
        kn.matvec_const(x.to("meta"), tops.M_c.to("meta"), sm_v)
    with pytest.raises(ValueError):
        kn.matvec_const(x.to("meta"), tops.M_c, sm_v)
    kn.reset_counts()
    assert sum(kn.plain_calls.values()) == 0
