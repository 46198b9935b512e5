"""The slab-sharded structured path against the JAX package's, on the CPU
in float64.

- ``build_slab``'s tables equal to ``oasisx_tpu.parallel.slab``'s, for
  (dim, N, du, dp) in (3,8,2,1), (2,8,2,1), (3,8,1,1) at 2 and 4 slabs.
- One spawned gloo group at world 2 and one at world 4 (the rank code in
  ``oasisx_tpu_torch.parallel.ranks``, which imports no JAX; inputs pass
  as an .npz).  Every slab operator (halo refresh and fold, M, Ap, mixed,
  divergence, the diagonal, the convecting velocity, the tentative and
  right-hand-side operators, the convection diagonal, and ``slab_apply``
  of the K5, K3, K6 and K7 plain versions) against the JAX ``shard_map``
  result on as many virtual devices to 1e-11, halo and padding slots
  exactly 0.  Then 3 steps of the 3D Taylor-Green problem at N=8, rtol
  1e-12, against the JAX slab solver (XLA slab ops, gathered XLA MG):
  u, u1, u2, p, dp to 1e-10 relative, the u / p / c iterations equal, and
  ``get_state`` equal to the JAX slab state; against the port's
  single-device run to 1e-8.  At world 2 also ``set_state`` and one
  ``solve`` of 2 inner iterations against JAX's, and the slab path's other
  solver branches, each against the JAX slab solver with the same options
  (iterations equal, state to 1e-10): the Chebyshev-Jacobi pressure
  preconditioner; Jacobi for the pressure with batched CG for the
  tentative solves (capped at 300 iterations: CG stalls on that
  nonsymmetric system from the second step in both packages).
- In the spawned groups also the slab path's split step on
  tests/test_graph_halo.py's 8 x 8 rectangle (rtol 1e-13) against the JAX
  slab split step (u 1e-9, ps 1e-8, the diff and reasons equal) and the
  port's single-device ``solve(max_iter=1)``, and its dense tentative
  matrix against JAX's sharded export and the port's single-device one to
  1e-12 (the graph-halo and replicated cases are tests/test_torch_halo.py's);
  a leading cube count the ranks do not divide runs graph-halo; on a 1-D
  ``DeviceMesh`` the lumped update falls back to the mass CG, a split step
  converges and its dense matrix equals the single-device export.
- The routing (one world-1 group): an unstructured mesh, ``structured``
  False, a PressureBC, the rotational update and ``slab`` False run
  graph-halo; with ``replicated`` a box whose slabs divide keeps the slab
  path, an unstructured mesh or a PressureBC runs the replicated mode.

The ranks start before the JAX references are computed and are joined
after them, with a time limit; each collective has a 60 s limit.  A rank
that raises, or stalls past the group's time limit, fails the group
within seconds.
"""

import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh, PartitionSpec as P  # noqa: E402

import oasisx_tpu as J  # noqa: E402
import oasisx_tpu.meshes as JM  # noqa: E402
from oasisx_tpu.parallel import slab as jsl  # noqa: E402
from tests.test_cubes import setup as jsetup  # noqa: E402
from tests.test_torch_halo import (_jax_split, _port_single, check_dense, check_split,  # noqa: E402
                                   check_split_single, RECT_OPTIONS, SPLIT_RTOL)

import oasisx_tpu_torch as T  # noqa: E402
import oasisx_tpu_torch.meshes as TM  # noqa: E402
from oasisx_tpu_torch.assembly.structured import build_structured_map  # noqa: E402
from oasisx_tpu_torch.parallel import ranks, slab as tsl  # noqa: E402
from oasisx_tpu_torch.parallel.launch import launch, start  # noqa: E402
from oasisx_tpu_torch.spaces import FunctionSpace  # noqa: E402

N, DT, NU, RTOL, STEPS = 8, 0.01, 0.05, 1e-12, 3
A0 = (4.0, 0.1)  # A0 = a0 M + a1 K for the convection operators
JOIN_S = 300.0
# the world-2 group's other solver branches: solver_options, and what
# config_report says of the pressure preconditioner and tentative method
VARIANTS = (({"pressure": {"pc_type": "cheb"}}, "cheb-pcg", "bcgs"),
            ({"pressure": {"pc_type": "jacobi"},
              "tentative": {"ksp_type": "cg", "ksp_max_it": 300}}, "jacobi-pcg", "cg"))


def _rel(a, b):
    return np.abs(np.asarray(a) - np.asarray(b)).max() / max(np.abs(np.asarray(b)).max(), 1e-300)


@pytest.mark.parametrize("ndev", [2, 4])
@pytest.mark.parametrize("dim,n,du,dp", [(3, 8, 2, 1), (2, 8, 2, 1), (3, 8, 1, 1)])
def test_build_slab_tables(dim, n, du, dp, ndev):
    _, _, _, _, (sv, gfv, _), (sq, gfq, _) = jsetup(dim, n, du, dp)
    ref = jsl.build_slab(sv, gfv, sq, gfq, ndev)
    mesh = (TM.create_rectangle((-1.0, -1.0), (1.0, 1.0), (n, n)) if dim == 2 else
            TM.create_box((-1.0, -1.0, -1.0), (1.0, 1.0, 1.0), (n, n, n)))
    V, Q = FunctionSpace(mesh, ("Lagrange", du)), FunctionSpace(mesh, ("Lagrange", dp))
    (tv, tgv, _), (tq, tgq, _) = (build_structured_map(mesh, S.element, S.dofmap)
                                  for S in (V, Q))
    got = tsl.build_slab(tv, tgv, tq, tgq, ndev)
    assert got.ndev == ref.ndev and got.planes_per_dev == ref.planes_per_dev
    assert got.sm_v_loc == ref.sm_v_loc and got.sm_q_loc == ref.sm_q_loc
    assert (got.npad_v_loc, got.npad_q_loc) == (ref.npad_v_loc, ref.npad_q_loc)
    for k in ("perm_v", "perm_q", "grid_to_slab_v", "grid_to_slab_q", "valid_v", "valid_q"):
        assert np.array_equal(getattr(got, k), getattr(ref, k)), k


def _halo_slots(info, space):
    """The halo slots of the global slab-flat layout: local plane P of every
    rank but the last, where the last rank's plane P holds owned dofs."""
    sm = info.sm_v_loc if space == "v" else info.sm_q_loc
    n = info.npad_v_loc if space == "v" else info.npad_q_loc
    valid = info.valid_v if space == "v" else info.valid_q
    d = len(sm[1])
    b0 = np.unravel_index(np.arange(n), sm[0])[d]
    plane = (b0 == sm[1][0]) & valid[(info.ndev - 1) * n:]
    return np.concatenate([plane] * (info.ndev - 1) + [np.zeros(n, bool)])


def _jax_ops(world, info, ops, z):
    """The JAX package's slab operators under shard_map on ``world``
    virtual devices, one jit."""
    mesh_d = Mesh(np.array(jax.devices()[:world]), ("x",))
    svl, sql = info.sm_v_loc, info.sm_q_loc
    A0_c = A0[0] * ops.M_c + A0[1] * ops.K_c

    def fn(yv, yq, xv, xq, u, uab):
        uq = jsl.conv_uq_slab(ops, uab, svl, "x")
        return dict(
            refresh_v=jsl.halo_refresh(yv, svl, "x"), refresh_q=jsl.halo_refresh(yq, sql, "x"),
            fold_v=jsl.halo_fold(yv, svl, "x"), fold_q=jsl.halo_fold(yq, sql, "x"),
            M=jsl.matvec_cube_slab(xv, ops.M_c, svl, "x"),
            Ap=jsl.matvec_cube_slab(xq, ops.Ap_c, sql, "x"),
            mixed=jsl.mixed_all_slab(xq, ops.B_c, svl, sql, "x"),
            div=jsl.divergence_slab(u, ops, svl, sql, "x"),
            diag=jsl.diag_cube_slab(ops.Ap_c, sql, "x"),
            uq=uq,
            tent=jsl.tentative_matvec_slab(ops, A0_c, uq, xv, svl, "x"),
            rhs=jsl.rhs_matvec_slab(ops, A0_c, uq, xv, svl, "x"),
            conv_diag=jsl.conv_diag_slab(ops, uq, svl, "x"),
        )

    s1, s2 = P("x"), P(None, "x")
    outs = dict(refresh_v=s1, refresh_q=s1, fold_v=s1, fold_q=s1, M=s1, Ap=s1, mixed=s2,
                div=s1, diag=s1, uq=P(None, None, "x"), tent=s1, rhs=s1, conv_diag=s1)
    f = jax.jit(jax.shard_map(fn, mesh=mesh_d, in_specs=(s1, s1, s1, s1, s2, s2),
                              out_specs=outs))
    res = f(*(jnp.asarray(z[k]) for k in ("yv", "yq", "xvs", "xqs", "us", "uabs")))
    return {k: np.asarray(v) for k, v in res.items()}


def _jax_solver(world, solver_options=None):
    m = JM.create_box((-1.0, -1.0, -1.0), (1.0, 1.0, 1.0), (N, N, N))
    facets = m.exterior_facet_indices()
    tags = JM.meshtags(m, m.dim - 1, facets, np.full_like(facets, 1))
    bcs = [[J.DirichletBC(f, J.LocatorMethod.TOPOLOGICAL, (tags, 1))] for f in ranks.TGV]
    opts = {"ksp_rtol": RTOL, "ksp_max_it": 2000}
    s = J.FractionalStep_AB_CN(
        m, ("Lagrange", 2), ("Lagrange", 1), bcs, [],
        solver_options={k: dict(opts, **(solver_options or {}).get(k, {}))
                        for k in ("tentative", "pressure", "scalar")},
        dtype=np.float64, device_mesh=Mesh(np.array(jax.devices()[:world]), ("x",)))
    for f, u1, u2 in zip(ranks.TGV, s._u1, s._u2):
        u1.interpolate(f)
        u2.interpolate(f)
    assert s.config_report()["sharding"] == "slab-halo"
    return s


@pytest.fixture(scope="module")
def single_device():
    """The port's single-device run of the same 3 steps."""
    s = ranks.tgv_solver(N, torch.float64, "cpu", RTOL)
    s.run(STEPS, DT, NU)
    return dict(u=np.stack([f.x.array.numpy() for f in s._u]), p=s._p.x.array.numpy())


@pytest.fixture(scope="module", params=[2, 4])
def slab_group(request, tmp_path_factory, single_device):
    """One spawned group a world: ``ranks.slab_checks`` (the slab
    operators, the solver runs, ``mesh_checks``, the slab-mode split step
    on the rectangle); the JAX references computed while the ranks run."""
    world = request.param
    tmp_path = tmp_path_factory.mktemp(f"slab{world}")
    _, _, _, ops, (sv, gfv, _), (sq, gfq, _) = jsetup(3, N, 2, 1)
    info = jsl.build_slab(sv, gfv, sq, gfq, world)
    nv, nq = len(gfv), len(gfq)
    rng = np.random.default_rng(40 + world)
    z = dict(dim=3, N=N, du=2, dp=1, a0=A0[0], a1=A0[1], xv=rng.standard_normal(nv),
             xq=rng.standard_normal(nq), u=rng.standard_normal((3, nv)),
             uab=rng.standard_normal((3, nv)))
    for space, valid in (("v", info.valid_v), ("q", info.valid_q)):
        keep = valid | _halo_slots(info, space)
        z["y" + space] = rng.standard_normal(valid.size) * keep
    path = tmp_path / "inputs.npz"
    np.savez(path, **z)
    cfg = dict(N=N, dtype="float64", device="cpu", rtol=RTOL, steps=STEPS, dt=DT, nu=NU)
    variants = VARIANTS if world == 2 else ()
    cfgs = [dict(cfg, solve=world == 2)] + [dict(cfg, solver_options=v[0]) for v in variants]
    splits = [dict(problem="rect", rtol=SPLIT_RTOL, dtype="float64", device="cpu",
                   options=RECT_OPTIONS["slab"], dense=True)]
    with start(ranks.slab_checks, world, (str(path), cfgs, splits)) as group:
        # the JAX references while the ranks run
        slab = _to_slab
        z.update(xvs=slab(z["xv"], info.perm_v, world * info.npad_v_loc),
                 xqs=slab(z["xq"], info.perm_q, world * info.npad_q_loc),
                 us=slab(z["u"], info.perm_v, world * info.npad_v_loc),
                 uabs=slab(z["uab"], info.perm_v, world * info.npad_v_loc))
        ref = _jax_ops(world, info, ops, z)
        js = _jax_solver(world)
        jstats = js.run(STEPS, DT, NU)
        jstate = {k: np.asarray(v) for k, v in js._dev_state.items()}
        jfun = _functions(js)
        jvar = []
        for opts, _, _ in variants:
            jv = _jax_solver(world, opts)
            jvar.append((jv.run(STEPS, DT, NU), _functions(jv)))
        if world == 2:
            jdiff = js.solve(DT, NU, max_iter=2)
            jsolve = dict(js.last_stats, state={k: np.asarray(v) for k, v in
                                                js._dev_state.items()}, **_functions(js))
        jsplit, single = _jax_split("slab", world), _port_single("slab")
        lumped = ranks.tgv_solver((world * 2, 2, 2), torch.float64, "cpu", 1e-8,
                                  solver_options={"scalar": {"pc_type": "lumped"}})
        lumped.assemble_first(ranks.DT, ranks.NU)
        lumped_dense = lumped.tentative_matrix_dense()
        out = group.join(JOIN_S)
    return dict(world=world, out=out, info=info, ref=ref, jstats=jstats, jstate=jstate, jfun=jfun,
                jvar=jvar, variants=variants, js=js, single_device=single_device,
                jdiff=jdiff if world == 2 else None, jsolve=jsolve if world == 2 else None,
                split=([o["splits"][0] for o in out], jsplit, single), lumped_dense=lumped_dense)


def test_slab_group(slab_group):
    grp = slab_group
    world, out, info, ref, js = (grp[k] for k in ("world", "out", "info", "ref", "js"))
    jstats, jstate, jfun, jvar = (grp[k] for k in ("jstats", "jstate", "jfun", "jvar"))
    single_device, variants = grp["single_device"], grp["variants"]
    jdiff, jsolve = grp["jdiff"], grp["jsolve"]

    # the slab operators
    valid = dict(v=info.valid_v, q=info.valid_q)
    for key, r in ref.items():
        g = np.concatenate([o["ops"][key] for o in out], axis=-1)
        assert g.shape == r.shape, key
        assert _rel(g, r) <= 1e-11, (key, _rel(g, r))
        if key in ("M", "Ap", "mixed", "div", "diag", "tent", "rhs", "conv_diag", "fold_v",
                   "fold_q"):
            sp = "q" if key in ("Ap", "div", "diag", "fold_q") else "v"
            assert np.all(g[..., ~valid[sp]] == 0), key
    pairs = dict(k_M="M", k_win="tent", k_mixed="mixed", k_div="div")
    for key, rk in pairs.items():
        g = np.concatenate([o["ops"][key] for o in out], axis=-1)
        assert _rel(g, ref[rk]) <= 1e-11, (key, _rel(g, ref[rk]))
        sp = "q" if rk == "div" else "v"
        assert np.all(g[..., ~valid[sp]] == 0), key

    # the solver: every rank's iterations the same, rank 0's state
    _check_run([o["runs"][0] for o in out], jstats, jfun)
    r0 = out[0]["runs"][0]
    for k in ("u", "p"):
        assert _rel(r0[k], single_device[k]) <= 1e-8, (k, _rel(r0[k], single_device[k]))
    for k in ("u", "u1", "u2", "p", "dp", "duc"):
        assert _rel(r0["state"][k], jstate[k]) <= 1e-10, k
        sp = "q" if k in ("p", "dp") else "v"
        assert np.all(r0["state"][k][..., ~valid[sp]] == 0), k
    cfgr = r0["config"]
    assert (cfgr["sharding"], cfgr["ndev"], cfgr["pressure_pc"]) == ("slab-halo", world, "mg-pcg")
    assert cfgr["path_kernels"] == list(T.assembly.kernels.SLAB_KERNELS)
    assert r0["traffic"] == js.halo_traffic_report()
    if world == 2:
        assert abs(r0["solve_diff"] - jdiff) <= 1e-10 * abs(jdiff)
        for k in ("u_iters", "p_iters", "c_iters", "inner_iters"):
            assert np.array_equal(np.asarray(r0["solve_stats"][k]), np.asarray(jsolve[k])), k
        for k in ("u", "u1", "u2", "p", "dp"):
            assert _rel(r0["solve"][k], jsolve[k]) <= 1e-10, k
        for k in ("u", "u1", "u2", "p", "dp", "duc"):
            assert _rel(r0["solve"]["state"][k], jsolve["state"][k]) <= 1e-10, k

    # the other solver branches
    for i, ((opts, pc, method), (jst, jf)) in enumerate(zip(variants, jvar), start=1):
        runs = [o["runs"][i] for o in out]
        _check_run(runs, jst, jf)
        assert (runs[0]["config"]["pressure_pc"], runs[0]["config"]["tentative_method"]) == \
            (pc, method), opts

    # the group's other checks, and no JAX in the ranks: a leading cube count
    # the ranks do not divide runs graph-halo; the lumped update falls back to
    # the mass CG on the slab path, where a split step converges and the
    # dense tentative matrix equals the single-device export
    for o in out:
        chk = o["checks"]
        assert chk["jax_free"]
        assert chk["ndev"] == "graph-halo" and chk["sharding"] == "slab-halo"
        assert chk["velocity_update"] == "cg"
        assert np.isfinite(chk["split"]["diff"]) and chk["split"]["diff"] > 0
        assert all(np.all(np.asarray(v) == 2) for v in chk["split"]["reasons"].values())
        assert chk["groups"] == [(o["runs"][0]["rank"], world)] * 2
    assert np.abs(out[0]["checks"]["dense"] - grp["lumped_dense"]).max() < 1e-12


def test_split_step(slab_group):
    """The slab path's split step on tests/test_graph_halo.py's rectangle
    against the JAX slab split step (as tests/test_torch_halo.py's
    graph-halo and replicated cases)."""
    splits, ref, _ = slab_group["split"]
    assert {r["config"]["sharding"] for r in splits} == {"slab-halo"}
    check_split(splits, ref)


def test_split_step_single_device(slab_group):
    check_split_single(*slab_group["split"][::2])


def test_dense_tentative_matrix(slab_group):
    check_dense(*slab_group["split"])


def _check_run(runs, jstats, jfun):
    """Every rank's u / p / c iterations equal to the JAX slab solver's,
    rank 0's state Functions to 1e-10 relative."""
    for k in ("u_iters", "p_iters", "c_iters"):
        assert np.array_equal(np.asarray(runs[0]["stats"][k]), np.asarray(jstats[k])), \
            (k, runs[0]["stats"][k], jstats[k])
        for r in runs[1:]:
            assert np.array_equal(r["stats"][k], runs[0]["stats"][k])
    for k in ("u", "u1", "u2", "p", "dp"):
        assert _rel(runs[0][k], jfun[k]) <= 1e-10, (k, _rel(runs[0][k], jfun[k]))


@pytest.mark.parametrize("how", ["raise", "stall"])
def test_launch_fails_fast(how):
    """A rank that raises, or stalls past the group's time limit, fails the
    whole group within seconds, its partners killed while they wait in a
    sum over ranks."""
    t0 = time.monotonic()
    err, match, limit = ((RuntimeError, "fails on purpose", 30.0) if how == "raise" else
                         (TimeoutError, "still running", 8.0))
    with pytest.raises(err, match=match):
        launch(ranks.misbehave, 2, (1, how), timeout=limit, pg_timeout=30.0)
    assert time.monotonic() - t0 < limit + 12.0


def _to_slab(a, perm, n):
    out = np.zeros(a.shape[:-1] + (n,))
    out[..., perm] = a
    return out


def _functions(js):
    """Copies of the JAX solver's state Functions (a later step writes the
    arrays in place)."""
    f = lambda fs: np.stack([np.array(g.x.array) for g in fs])
    return dict(u=f(js._u), u1=f(js._u1), u2=f(js._u2), p=np.array(js._p.x.array),
                dp=np.array(js._dp.x.array))


@pytest.fixture(scope="module")
def routed():
    """The sharding mode of each case of ``ranks.routing``, all built in one
    world-1 group."""
    return launch(ranks.routing, 1, ())[0]


ROUTES = {"unstructured": "graph-halo", "structured_false": "graph-halo",
          "pressure_bc": "graph-halo", "rotational": "graph-halo", "slab_false": "graph-halo",
          # options["replicated"]: the slab path first where it is taken (a box
          # whose slabs divide), else the replicated mode
          "replicated": ("replicated_slab", "slab-halo"),
          "replicated_unstructured": "replicated", "replicated_pressure_bc": "replicated"}


@pytest.mark.parametrize("case", list(ROUTES))
def test_refused_before_the_group(case, routed):
    """The cases the JAX package sends to graph-halo take it; with
    ``replicated`` a box whose slabs divide keeps the slab path and an
    unstructured mesh or a PressureBC takes the replicated mode, as in the
    JAX package (oasisx_tpu fracstep.py:186-275)."""
    key, want = ROUTES[case] if isinstance(ROUTES[case], tuple) else (case, ROUTES[case])
    assert routed[key] == want, (case, routed)
