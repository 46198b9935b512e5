"""The graph-halo sharded general path against the JAX package's, on the CPU
in float64.

- The host tables of the res=10 cylinder and the vessel at N=4, at 2 and 4
  shards, equal to the JAX package's: ``rcb_partition``,
  ``partition_cells``, ``choose_partition`` (its choice's
  ``schedule_cost`` over ``interface_signatures``), ``color_messages``,
  ``build_halo_exchange`` (``perm``, ``sched``, ``ownmask``,
  ``cell_dofs_local``), and the pressure AMG built with ``dof_shard``: the
  shard-pure aggregates, ``dist`` and the distributed level's tables
  (``amg_dist_tables`` against the JAX solver's
  ``_make_amg_dist_tables``).
- One spawned gloo group at world 2 and one at world 4 (the rank code in
  ``oasisx_tpu_torch.parallel.ranks``, which imports no JAX; inputs pass as
  an .npz).  Against the JAX ``shard_map`` results on as many virtual
  devices: ``halo_refresh`` and ``halo_fold`` bit for bit, and the
  per-shard product of random element stacks through the plain K14 and
  K18 versions between them to 1e-11 (the JAX side: refresh, the element
  product, fold), halo and sentinel slots exactly 0.  Then 3 steps of the
  res=10 cylinder with its outlet (rotational False and True) and of the
  vessel at N=4 (its AMG coarsened below 50 dofs, so that the distributed
  apply with the nullspace runs; the JAX AMG's coarse pseudo-inverse handed
  to the ranks: ROADMAP known difference g) against the JAX halo solver
  with its per-shard kernels (interpret mode) at rtol 1e-12: every rank's
  u / p / c iterations equal to JAX's, u and p to 1e-9 relative,
  ``get_state`` equal to the JAX stacked layout, ``config_report`` and
  ``halo_traffic_report`` as JAX's.  At world 2 also the options, two
  steps each on the res=6 cylinder: ``amg_distributed`` False with
  ``ell_layout`` "band" and ``partitioner`` "rcb"; pressure Chebyshev-Jacobi
  (the JAX solver's bounds handed to the ranks) with GMRES tentative
  solves; pressure Jacobi with CG tentative solves.

The same groups run the replicated mode (``options={"replicated": True}``)
against the JAX package's: tests/test_sharding.py's unit square with its
PressureBC outlet (3 steps of ``solve(max_iter=2)``) and the vessel at N=4
(nullspace), rtol 1e-12: every rank's iterations equal to JAX's, u and p to
1e-9, ``config_report`` as JAX's (Jacobi-PCG), every rank's state bit for
bit rank 0's.  And the split-phase API under the mesh on
tests/test_graph_halo.py's 8 x 8 rectangle (rtol 1e-13) in the graph-halo
and replicated modes: the split step against JAX's split step in the same
mode and world (u 1e-9, ps 1e-8, the diff and reasons equal) and against
the port's single-device ``solve(max_iter=1)``; the dense tentative matrix
against JAX's sharded export and the port's single-device one to 1e-12.
Each check is a test of its own on the module's group of its world.

The JAX solvers that hand something to the ranks are built first, then the
ranks start, and the JAX references run while they do; the groups are
joined with a time limit (each collective: 60 s).
"""

from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh, PartitionSpec as P  # noqa: E402

import oasisx_tpu as J  # noqa: E402
import oasisx_tpu.meshes as JM  # noqa: E402
from oasisx_tpu.la import amg as jamg  # noqa: E402
from oasisx_tpu.parallel import graph as JG, partition as JP  # noqa: E402
from oasisx_tpu.spaces.functionspace import FunctionSpace as JFS  # noqa: E402

import oasisx_tpu_torch.meshes as TM  # noqa: E402
from oasisx_tpu_torch.assembly.geometry import compute_cell_geometry  # noqa: E402
from oasisx_tpu_torch.assembly.reference_tensors import build_reference_tensors  # noqa: E402
from oasisx_tpu_torch.la import amg as tamg  # noqa: E402
from oasisx_tpu_torch.parallel import graph as TG, partition as TP, ranks  # noqa: E402
from oasisx_tpu_torch.parallel import sharding as TS  # noqa: E402
from oasisx_tpu_torch.parallel.launch import start  # noqa: E402
from oasisx_tpu_torch.spaces import FunctionSpace as TFS  # noqa: E402

RTOL, STEPS, VSTEPS, JOIN_S = 1e-12, 3, 2, 300.0
CYL = dict(problem="cylinder", res=10)
VES = dict(problem="vessel", N=4, dt=ranks.DT, nu=ranks.NU,
           solver_options={"pressure": {"amg_coarse_max": 50}})
# the world-2 group's options on the res=6 cylinder: (solver_options,
# options, the pressure preconditioner and tentative method config_report names)
VARIANTS = (
    ({"pressure": {"amg_distributed": False, "amg_coarse_max": 50}},
     {"ell_layout": "band", "partitioner": "rcb"}, "amg-pcg", "bcgs"),
    ({"pressure": {"pc_type": "cheb"}, "tentative": {"ksp_type": "gmres"}}, None, "cheb-pcg",
     "gmres"),
    ({"pressure": {"pc_type": "jacobi"}, "tentative": {"ksp_type": "cg"}}, None, "jacobi-pcg",
     "cg"),
)
JAX_PC = {"chebyshev-jacobi-pcg": "cheb-pcg"}  # the JAX package's names where the port's differ


def _rel(a, b):
    return np.abs(np.asarray(a) - np.asarray(b)).max() / max(np.abs(np.asarray(b)).max(), 1e-300)


def _cylinder_tags(mod, mesh):
    inlet = mod.locate_entities_boundary(mesh, 1, lambda x: np.isclose(x[0], 0.0))
    outlet = mod.locate_entities_boundary(mesh, 1, lambda x: np.isclose(x[0], ranks.CYL_L))
    others = np.setdiff1d(mesh.exterior_facet_indices(), np.hstack([inlet, outlet]))
    facets = np.hstack([inlet, others, outlet])
    values = np.hstack([np.full_like(inlet, 1), np.full_like(others, 2),
                        np.full_like(outlet, 3)]).astype(np.int32)
    return mod.meshtags(mesh, 1, facets, values)


def _mesh(mod, cfg):
    if cfg["problem"] == "cylinder":
        return mod.create_cylinder_channel(cfg["res"])
    return ranks.deform_vessel(mod.create_box((-1.0, -1.0, -1.0), (1.0, 1.0, 1.0),
                                              (cfg["N"],) * 3))


def _jax_solver(cfg, world):
    """The JAX halo solver of a ``ranks.halo_solver`` cfg on ``world``
    virtual devices, its per-shard kernels in interpret mode."""
    mesh = _mesh(JM, cfg)
    opts = {"ksp_rtol": RTOL, "ksp_max_it": 2000}
    so = {k: dict(opts, **(cfg.get("solver_options") or {}).get(k, {}))
          for k in ("tentative", "pressure", "scalar")}
    options = dict({"pallas": "interpret"}, **(cfg.get("options") or {}))
    kw = dict(solver_options=so, dtype=np.float64,
              device_mesh=Mesh(np.array(jax.devices()[:world]), ("x",)))
    if cfg["problem"] == "cylinder":
        tags = _cylinder_tags(JM, mesh)
        inflow = lambda x: 4.0 * ranks.CYL_UM * x[1] * (ranks.CYL_H - x[1]) / ranks.CYL_H**2
        T = J.LocatorMethod.TOPOLOGICAL
        bcs = [[J.DirichletBC(inflow, T, (tags, 1)), J.DirichletBC(0.0, T, (tags, 2))],
               [J.DirichletBC(0.0, T, (tags, 1)), J.DirichletBC(0.0, T, (tags, 2))]]
        s = J.FractionalStep_AB_CN(mesh, ("Lagrange", 2), ("Lagrange", 1), bcs,
                                   [J.PressureBC(0.0, (tags, 3))],
                                   rotational=cfg.get("rotational", False), options=options, **kw)
    else:
        facets = mesh.exterior_facet_indices()
        tags = JM.meshtags(mesh, mesh.dim - 1, facets, np.full_like(facets, 1))
        bcs = [[J.DirichletBC(f, J.LocatorMethod.TOPOLOGICAL, (tags, 1))] for f in ranks.TGV]
        s = J.FractionalStep_AB_CN(mesh, ("Lagrange", 2), ("Lagrange", 1), bcs, [],
                                   options=dict(options, low_memory_version=False), **kw)
        for f, u1, u2 in zip(ranks.TGV, s._u1, s._u2):
            u1.interpolate(f)
            u2.interpolate(f)
    assert s.config_report()["sharding"] == "graph-halo"
    return s


def _dofmaps(mod_fs, mesh):
    return [mod_fs(mesh, ("Lagrange", d)).dofmap.cell_dofs for d in (2, 1)]


# ---------------------------------------------------------------------------
# host tables
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ndev", [2, 4])
@pytest.mark.parametrize("case", ["cylinder", "vessel"])
def test_host_tables(case, ndev):
    cfg = CYL if case == "cylinder" else VES
    jm, tm = _mesh(JM, cfg), _mesh(TM, cfg)
    assert np.array_equal(jm.cells, tm.cells) and np.array_equal(jm.x, tm.x)
    cent = tm.x[tm.cells].mean(axis=1)
    dm = _dofmaps(TFS, tm)
    assert all(np.array_equal(a, b) for a, b in zip(dm, _dofmaps(JFS, jm)))
    assert np.array_equal(TG.rcb_partition(cent, ndev), JG.rcb_partition(cent, ndev))
    assert np.array_equal(TP.partition_cells(tm.cells, cent, ndev),
                          JP.partition_cells(jm.cells, cent, ndev))
    info = {}
    part = TP.choose_partition(tm.cells, cent, ndev, dofmaps=dm, info=info)
    assert np.array_equal(part, JP.choose_partition(jm.cells, cent, ndev, dofmaps=dm))
    assert info["cost"] == sum(JP.schedule_cost(JP.interface_signatures(cd, part, ndev), ndev)
                               for cd in dm)
    assert TP.edge_cut(tm.cells, part) == JP.edge_cut(jm.cells, part)
    sizes = [(0, 1, 7), (1, 0, 5), (2, 1, 9), (1, 2, 2), (2, 0, 9), (0, 2, 1)]
    assert TG.color_messages(sizes) == JG.color_messages(sizes)
    B, perm = TS.shard_blocks(part, ndev)
    for cd in dm:
        th = TG.build_halo_exchange(cd, part, ndev, perm, B)
        jh = JG.build_halo_exchange(cd, part, ndev, perm, B)
        assert (th.nloc, th.owned_pad, th.ndev) == (jh.nloc, jh.owned_pad, jh.ndev)
        for k in ("perm", "ownmask", "cell_dofs_local"):
            assert np.array_equal(getattr(th, k), getattr(jh, k)), k
        assert len(th.sched) == len(jh.sched) > 0
        for (tp, tpk, tu), (jp, jpk, ju) in zip(th.sched, jh.sched):
            assert tp == jp and np.array_equal(tpk, jpk) and np.array_equal(tu, ju)

    # the pressure AMG with shard-pure level-0 aggregates (coarsened below 50)
    geo = compute_cell_geometry(tm.x, tm.cells, tm.dim)
    refs = build_reference_tensors(TFS(tm, ("Lagrange", 2)).element,
                                   TFS(tm, ("Lagrange", 1)).element)
    elems = np.einsum("c,cab,abij->cij", geo.detJ, geo.G, refs.stiffness_q)
    n = int(dm[1].max()) + 1
    rows, cols, vals = tamg.coo_from_elems(dm[1], elems, n)
    hq = TG.build_halo_exchange(dm[1], part, ndev, perm, B)
    shard = hq.perm // hq.nloc
    ta, na = tamg._aggregate(rows, cols, vals, n, 0.25, shard=shard)
    ja, nja = jamg._aggregate(rows, cols, vals, n, 0.25, shard=shard)
    assert na == nja and np.array_equal(ta, ja)
    assert np.all(shard[ta == ta[0]] == shard[0])  # shard-pure
    kw = dict(coarse_max=50, pre=2, post=2, nullvec=np.ones(n), dof_shard=shard)
    t = tamg.AlgebraicMG(rows, cols, vals, n, dtype=torch.float64, **kw)
    j = jamg.AlgebraicMG(rows, cols, vals, n, dtype=jnp.float64, **kw)
    assert t.num_levels == j.num_levels > 1 and t.dist["nagg0"] == j.dist["nagg0"]
    for a, b in zip(t.dist["P0"], j.dist["P0"]):
        assert np.array_equal(a, b)
    assert np.array_equal(t.dist["sm0"], j.dist["sm0"])
    assert tamg.AlgebraicMG(rows, cols, vals, n, dtype=torch.float64, coarse_max=50).dist is None
    got = tamg.amg_dist_tables(t, hq)
    ref = J.FractionalStep_AB_CN._make_amg_dist_tables(
        SimpleNamespace(_hx_q=JG.build_halo_exchange(dm[1], part, ndev, perm, B), _amg=j,
                        _dtype=jnp.float64))
    for k, v in got.items():
        assert np.array_equal(v, np.asarray(ref[k])), k


# ---------------------------------------------------------------------------
# the rank groups
# ---------------------------------------------------------------------------

def _inputs(world, rng):
    """The ops' inputs on the res=10 cylinder, in the stacked local layout
    of the multilevel partition, and what the JAX side needs of them."""
    mesh = _mesh(TM, CYL)
    cent = mesh.x[mesh.cells].mean(axis=1)
    dm = _dofmaps(TFS, mesh)
    part = TP.choose_partition(mesh.cells, cent, world, dofmaps=dm)
    B, perm = TS.shard_blocks(part, world)
    z = dict(problem="cylinder", res=CYL["res"], N=0)
    hxs = {}
    for sp, cd in zip("vq", dm):
        hx = JG.build_halo_exchange(cd, part, world, perm, B)
        hxs[sp] = hx
        n, nd = world * hx.nloc, cd.shape[1]
        own = hx.ownmask.astype(bool)
        z["x" + sp] = rng.standard_normal(n) * own
        keep = np.zeros(n, bool)
        for s in range(world):  # owned and halo slots of each shard
            cells = perm[s * B:(s + 1) * B]
            keep[s * hx.nloc + np.unique(hx.cell_dofs_local[s * B:(s + 1) * B][cells >= 0])] = True
        z["y" + sp] = rng.standard_normal(n) * keep
        z["elems_" + sp] = rng.standard_normal((len(mesh.cells), nd, nd))
    return z, hxs, perm, B


def _jax_ops(world, z, hxs, perm, B):
    """halo_refresh, halo_fold and refresh -> the element product -> fold
    under shard_map on ``world`` virtual devices."""
    mesh_d = Mesh(np.array(jax.devices()[:world]), ("x",))
    trees, perms_, specs, args, arg_specs = {}, {}, {}, [], []
    for sp in "vq":
        hx = hxs[sp]
        trees[sp], perms_[sp] = JG.make_halo_tables(hx, jnp.float64)
        specs[sp] = JG.halo_tree_specs(trees[sp], "x")
        E = np.zeros((world * B,) + z["elems_" + sp].shape[1:])
        E[perm >= 0] = z["elems_" + sp][perm[perm >= 0]]
        args += [z["x" + sp], z["y" + sp], E, hx.cell_dofs_local.reshape(world, B, -1),
                 trees[sp]]
        arg_specs += [P("x"), P("x"), P("x", None, None), P("x", None, None), specs[sp]]

    def fn(xv, yv, Ev, cdv, tv, xq, yq, Eq, cdq, tq):
        out = {}
        for sp, x, y, E, cd, tr in (("v", xv, yv, Ev, cdv, tv), ("q", xq, yq, Eq, cdq, tq)):
            pm = perms_[sp]
            out["refresh_" + sp] = JG.halo_refresh(x, tr, pm, "x")
            out["fold_" + sp] = JG.halo_fold(y, tr, pm, "x")
            xr = JG.halo_refresh(x, tr, pm, "x")
            ye = jnp.einsum("cij,cj->ci", E, xr[cd[0]])
            yl = jnp.zeros_like(x).at[cd[0].reshape(-1)].add(ye.reshape(-1))
            out["mv_" + sp] = JG.halo_fold(yl, tr, pm, "x")
        return out

    keys = [f"{k}_{sp}" for sp in "vq" for k in ("refresh", "fold", "mv")]
    f = jax.jit(jax.shard_map(fn, mesh=mesh_d, in_specs=tuple(arg_specs),
                              out_specs={k: P("x") for k in keys}))
    return {k: np.asarray(v) for k, v in f(*(jnp.asarray(a) if isinstance(a, np.ndarray)
                                             else a for a in args)).items()}


def _functions(js):
    f = lambda fs: np.stack([np.array(g.x.array) for g in fs])
    return dict(u=f(js._u), u1=f(js._u1), u2=f(js._u2), p=np.array(js._p.x.array),
                dp=np.array(js._dp.x.array))


def _jax_run(js, cfg, steps):
    stats = js.run(steps, cfg.get("dt", ranks.CYL_DT), cfg.get("nu", ranks.CYL_NU))
    state = {k: np.asarray(v) for k, v in js._dev_state.items()}
    return dict(stats=stats, state=state, fun=_functions(js), config=js.config_report(),
                traffic=js.halo_traffic_report())


def _check_run(runs, ref, pc, method):
    """Every rank's u / p / c iterations equal to the JAX halo solver's,
    rank 0's state to 1e-9, the config and traffic as JAX's."""
    r0 = runs[0]
    for k in ("u_iters", "p_iters", "c_iters"):
        assert np.array_equal(np.asarray(r0["stats"][k]), np.asarray(ref["stats"][k])), \
            (k, r0["stats"][k], ref["stats"][k])
        for r in runs[1:]:
            assert np.array_equal(r["stats"][k], r0["stats"][k])
    for k in ("u", "u1", "u2", "p", "dp"):
        assert _rel(r0[k], ref["fun"][k]) <= 1e-9, (k, _rel(r0[k], ref["fun"][k]))
    for k in ("u", "u1", "u2", "p", "dp", "duc"):
        assert r0["state"][k].shape == ref["state"][k].shape, k
        assert _rel(r0["state"][k], ref["state"][k]) <= 1e-9, k
    cfg, jcfg = r0["config"], ref["config"]
    assert cfg["sharding"] == jcfg["sharding"] == "graph-halo"
    assert cfg["pressure_pc"] == JAX_PC.get(jcfg["pressure_pc"], jcfg["pressure_pc"]) == pc
    assert cfg["tentative_method"] == jcfg["tentative_method"] == method
    tr, jtr = r0["traffic"], ref["traffic"]
    assert (tr["mode"], tr["ndev"]) == (jtr["mode"], jtr["ndev"])
    for sp in "vq":
        assert {k: tr[sp][k] for k in jtr[sp]} == jtr[sp], sp
        assert tr[sp]["sent_bytes_per_exchange"] <= jtr[sp]["bytes_per_exchange"]


def _jax_replicated(cfg, world):
    """The JAX replicated solver of a ``ranks.halo_solver`` cfg ("square" or
    "vessel") on ``world`` virtual devices."""
    opts = {"ksp_rtol": RTOL, "ksp_max_it": 2000}
    so = {k: dict(opts) for k in ("tentative", "pressure", "scalar")}
    kw = dict(solver_options=so, dtype=np.float64, options=dict(cfg["options"]),
              device_mesh=Mesh(np.array(jax.devices()[:world]), ("x",)))
    if cfg["problem"] == "vessel":
        mesh = _mesh(JM, cfg)
        facets = mesh.exterior_facet_indices()
        tags = JM.meshtags(mesh, mesh.dim - 1, facets, np.full_like(facets, 1))
        bcs = [[J.DirichletBC(f, J.LocatorMethod.TOPOLOGICAL, (tags, 1))] for f in ranks.TGV]
        kw["options"]["low_memory_version"] = False
        s = J.FractionalStep_AB_CN(mesh, ("Lagrange", 2), ("Lagrange", 1), bcs, [], **kw)
        for f, u1, u2 in zip(ranks.TGV, s._u1, s._u2):
            u1.interpolate(f)
            u2.interpolate(f)
    else:
        mesh = JM.create_unit_square(10)
        side = lambda f: JM.locate_entities_boundary(mesh, 1, f)
        left, right = side(lambda x: np.isclose(x[0], 0)), side(lambda x: np.isclose(x[0], 1))
        tb = side(lambda x: np.isclose(x[1], 0) | np.isclose(x[1], 1))
        values = np.hstack([np.full_like(left, 1), np.full_like(tb, 2),
                            np.full_like(right, 3)]).astype(np.int32)
        tags = JM.meshtags(mesh, 1, np.hstack([left, tb, right]), values)
        T = J.LocatorMethod.TOPOLOGICAL
        bcs = [[J.DirichletBC(lambda x: np.sin(np.pi * x[1]), T, (tags, 1)),
                J.DirichletBC(0.0, T, (tags, 2))],
               [J.DirichletBC(0.0, T, (tags, 1)), J.DirichletBC(0.0, T, (tags, 2))]]
        s = J.FractionalStep_AB_CN(mesh, ("Lagrange", 2), ("Lagrange", 1), bcs,
                                   [J.PressureBC(lambda x: 1.0 + 0.1 * x[1], (tags, 3))], **kw)
        for f in (*s._u1, *s._u2):
            f.interpolate(lambda x: 0.1 * np.sin(np.pi * x[0]) * np.sin(np.pi * x[1]))
    assert s.config_report()["sharding"] == "replicated"
    return s


def _jax_replicated_run(cfg, world):
    js = _jax_replicated(cfg, world)
    dt, nu = ranks.step_size(cfg)
    if cfg.get("solve_iter"):
        per = []
        for _ in range(cfg["steps"]):
            js.solve(dt, nu, max_iter=cfg["solve_iter"])
            per.append(dict(js.last_stats))
        stats = {k: np.stack([np.asarray(p[k]) for p in per]) for k in per[0]}
    else:
        stats = js.run(cfg["steps"], dt, nu)
    return dict(stats=stats, state={k: np.asarray(v) for k, v in js._dev_state.items()},
                fun=_functions(js), config=js.config_report(), traffic=js.halo_traffic_report())


def _jax_rect(mode, world):
    """tests/test_graph_halo.py's split-phase rectangle on ``world`` virtual
    devices (``mode`` "slab", "graph" with its per-shard kernels in
    interpret mode, or "replicated")."""
    ux = lambda x: -np.cos(np.pi * x[0]) * np.sin(np.pi * x[1])
    uy = lambda x: np.cos(np.pi * x[1]) * np.sin(np.pi * x[0])
    mesh = JM.create_rectangle((-1, -1), (1, 1), (8, 8))
    facets = mesh.exterior_facet_indices()
    tags = JM.meshtags(mesh, 1, facets, np.full_like(facets, 3))
    T = J.LocatorMethod.TOPOLOGICAL
    s = J.FractionalStep_AB_CN(
        mesh, ("Lagrange", 2), ("Lagrange", 1),
        bcs_u=[[J.DirichletBC(ux, T, (tags, 3))], [J.DirichletBC(uy, T, (tags, 3))]], bcs_p=[],
        solver_options={k: {"ksp_rtol": SPLIT_RTOL} for k in ("tentative", "pressure", "scalar")},
        options=RECT_OPTIONS[mode] | ({"pallas": "interpret"} if mode == "graph" else {}),
        device_mesh=Mesh(np.array(jax.devices()[:world]), ("x",)), dtype=np.float64)
    for f, g in ((s._u1[0], ux), (s._u1[1], uy), (s._u2[0], ux), (s._u2[1], uy)):
        f.interpolate(g)
    return s


def _jax_split(mode, world):
    """The JAX split step and the dense tentative matrix of its operator."""
    s = _jax_rect(mode, world)
    assert s.config_report()["sharding"] == SHARDING[mode]
    s._ps.x.array[:] = s._p.x.array
    s.assemble_first(ranks.RECT_DT, ranks.RECT_NU)
    s.velocity_tentative_assemble()
    diff, u = s.velocity_tentative_solve()
    s.pressure_assemble(ranks.RECT_DT)
    p = s.pressure_solve(ranks.RECT_NU)
    c = s.velocity_update(ranks.RECT_DT)
    return dict(diff=diff, reasons=dict(u=u, p=p, c=c), ps=np.array(s._ps.x.array),
                u=np.stack([np.array(f.x.array) for f in s._u]), dense=s.tentative_matrix_dense())


def _port_single(mode):
    """The port's single-device solve(max_iter=1) of the rectangle and its
    dense tentative matrix (of the initial state's operator)."""
    opts = {k: v for k, v in RECT_OPTIONS[mode].items() if k != "replicated"}
    s = ranks.rect_solver(torch.float64, "cpu", SPLIT_RTOL, options=opts)
    s.assemble_first(ranks.RECT_DT, ranks.RECT_NU)
    A = s.tentative_matrix_dense()
    s.solve(ranks.RECT_DT, ranks.RECT_NU, max_iter=1)
    return dict(u=np.stack([f.x.array.numpy() for f in s._u]), ps=s._ps.x.array.numpy(), dense=A)


SPLIT_RTOL = 1e-13
RECT_OPTIONS = {"slab": {"structured": True}, "graph": {"structured": False},
                "replicated": {"structured": False, "replicated": True}}
SHARDING = {"slab": "slab-halo", "graph": "graph-halo", "replicated": "replicated"}
HALO_SPLITS = ("graph", "replicated")  # the slab mode's split rides test_torch_slab.py's groups
# the replicated runs: tests/test_sharding.py's square (3 steps of solve(max_iter=2)) and the
# vessel at N=4 (nullspace), each at rtol 1e-12
REPLICATED = {"square": dict(problem="square", solve_iter=2),
              "vessel": dict(problem="vessel", N=4)}


@pytest.fixture(scope="module", params=[2, 4])
def halo_group(request, tmp_path_factory):
    """One spawned group a world: ``ranks.halo_checks`` on the ops'
    inputs, the graph-halo runs, the replicated runs and the split steps;
    the JAX references computed while the ranks run."""
    world = request.param
    rng = np.random.default_rng(70 + world)
    z, hxs, perm, B = _inputs(world, rng)
    path = tmp_path_factory.mktemp(f"halo{world}") / "inputs.npz"
    np.savez(path, **z)
    cfg = dict(rtol=RTOL, steps=STEPS, dtype="float64", device="cpu")
    mains = [dict(cfg, **CYL), dict(cfg, **CYL, rotational=True), dict(cfg, **VES)]
    # the JAX solvers whose coarse inverse or Chebyshev bounds the ranks take
    jv = _jax_solver(mains[-1], world)
    mains[-1]["coarse_inv"] = np.asarray(jv._amg.coarse_inv)
    variants, jvar = [], []
    for so, opts, pc, method in (VARIANTS if world == 2 else ()):
        c = dict(cfg, problem="cylinder", res=6, steps=VSTEPS, solver_options=so, options=opts)
        js = _jax_solver(c, world)
        if js._cheb is not None:
            c["p_cheb"] = dict(zip(("degree", "lmin", "lmax"), js._cheb))
        variants.append(c)
        jvar.append(js)
    reps = {k: dict(cfg, options={"replicated": True}, **v) for k, v in REPLICATED.items()}
    splits = [dict(problem="rect", rtol=SPLIT_RTOL, dtype="float64", device="cpu",
                   options=RECT_OPTIONS[m], dense=True) for m in HALO_SPLITS]
    cfgs = mains + variants + list(reps.values())
    with start(ranks.halo_checks, world, (str(path), cfgs, splits)) as group:
        ops = _jax_ops(world, z, hxs, perm, B)
        ref = [_jax_run(_jax_solver(c, world), c, STEPS) for c in mains[:-1]]
        ref.append(_jax_run(jv, mains[-1], STEPS))
        ref += [_jax_run(js, c, VSTEPS) for js, c in zip(jvar, variants)]
        jrep = {k: _jax_replicated_run(c, world) for k, c in reps.items()}
        jsplit = {m: _jax_split(m, world) for m in HALO_SPLITS}
        single = {m: _port_single(m) for m in HALO_SPLITS}
        out = group.join(JOIN_S)
    nrun = len(mains) + len(variants)
    return SimpleNamespace(
        world=world, out=out, ops=ops, ref=ref, hxs=hxs, mains=mains, variants=variants,
        rep={k: ([o["runs"][nrun + i] for o in out], jrep[k]) for i, k in enumerate(reps)},
        split={m: ([o["splits"][i] for o in out], jsplit[m], single[m])
               for i, m in enumerate(HALO_SPLITS)})


def test_halo_group(halo_group):
    g = halo_group
    out, hxs, mains, variants = g.out, g.hxs, g.mains, g.variants
    # the exchange and the per-shard products
    for key, r in g.ops.items():
        sp = key[-1]
        own = hxs[sp].ownmask == 1
        parts = ([o["ops"][key] for o in out] if not key.startswith("mv") else None)
        if parts is not None:
            g_ = np.concatenate(parts)
            assert np.array_equal(g_, r), key
            continue
        for kind in ("ell", "band"):
            g_ = np.concatenate([o["ops"][f"{kind}_{sp}"] for o in out])
            assert _rel(g_, r) <= 1e-11, (kind, sp, _rel(g_, r))
            assert np.all(g_[~own] == 0), (kind, sp)
    for o in out:
        assert o["jax_free"]

    # the solver
    checks = [(m, "amg-pcg-distributed", "bcgs") for m in mains]
    checks += [(c, v[2], v[3]) for c, v in zip(variants, VARIANTS)]
    for i, ((c, pc, method), r) in enumerate(zip(checks, g.ref)):
        _check_run([o["runs"][i] for o in out], r, pc, method)
    assert out[0]["runs"][0]["config"]["partitioner"]["name"] in ("multilevel", "rcb")
    if g.world == 2:
        band_run = out[0]["runs"][len(mains)]["config"]
        assert band_run["partitioner"] == {"name": "rcb"} and band_run["ell_layout"] == "band"


# ---------------------------------------------------------------------------
# the replicated mode (options["replicated"]) against the JAX package's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("problem", list(REPLICATED))
def test_replicated_iterations(halo_group, problem):
    """Every rank's u / p / c iterations equal to the JAX replicated
    solver's.  The square's third step is the exception for u: its flow
    blows up (diff ~5e4), its BiCGStab takes ~150 iterations at rtol 1e-12,
    and rounding decides the count (the JAX package itself: 145 / 172 at
    world 2, 149 / 162 at world 4); there every u solve converged."""
    runs, ref = halo_group.rep[problem]
    for k in ("u_iters", "p_iters", "c_iters"):
        got, want = np.asarray(runs[0]["stats"][k]), np.asarray(ref["stats"][k])
        if k == "u_iters" and problem == "square":
            assert bool(np.all(runs[0]["stats"]["u_converged"][-1]))
            got, want = got[:-1], want[:-1]
        assert np.array_equal(got, want), (k, runs[0]["stats"][k], ref["stats"][k])
        for r in runs[1:]:
            assert np.array_equal(r["stats"][k], runs[0]["stats"][k]), k


@pytest.mark.parametrize("problem", list(REPLICATED))
def test_replicated_state(halo_group, problem):
    """Rank 0's state Functions and ``get_state`` (canonical, as the JAX
    replicated state) to 1e-9 relative of the JAX replicated solver's."""
    runs, ref = halo_group.rep[problem]
    r0 = runs[0]
    for k in ("u", "u1", "u2", "p", "dp"):
        assert _rel(r0[k], ref["fun"][k]) <= 1e-9, (k, _rel(r0[k], ref["fun"][k]))
    for k in ("u", "u1", "u2", "p", "dp", "duc"):
        assert r0["state"][k].shape == ref["state"][k].shape, k
        assert _rel(r0["state"][k], ref["state"][k]) <= 1e-9, k


@pytest.mark.parametrize("problem", list(REPLICATED))
def test_replicated_config(halo_group, problem):
    """``config_report`` as the JAX replicated solver's (Jacobi-PCG: ROADMAP
    known difference l), no kernel on the path, no halo traffic."""
    runs, ref = halo_group.rep[problem]
    cfg, jcfg = runs[0]["config"], ref["config"]
    for k in ("sharding", "structured_fastpath", "velocity_update", "pressure_pc",
              "pressure_mg_levels", "tentative_method", "low_memory", "dtype"):
        assert cfg[k] == jcfg[k], (k, cfg[k], jcfg[k])
    assert cfg["pressure_pc"] == "jacobi-pcg" and cfg["ndev"] == halo_group.world
    assert cfg["path_kernels"] == [] and runs[0]["traffic"] is None is ref["traffic"]
    assert not any(r["launches"] or r["plain_calls"] for r in runs)


@pytest.mark.parametrize("problem", list(REPLICATED))
def test_replicated_ranks_identical(halo_group, problem):
    """Every rank's state bit for bit rank 0's (the products' sums add in
    rank order on every rank, the dots are local on the same vectors)."""
    runs, _ = halo_group.rep[problem]
    assert len({r["digest"] for r in runs}) == 1, [r["digest"] for r in runs]


# ---------------------------------------------------------------------------
# the split-phase API and the dense tentative matrix under the mesh
# ---------------------------------------------------------------------------

def check_split(splits, ref):
    """Every rank's split step against the JAX split step in the same mode
    and world: the diff (1e-12 relative) and the reasons equal, u within
    1e-9 and ps within 1e-8."""
    r0 = splits[0]
    for r in splits:
        assert abs(r["diff"] - ref["diff"]) <= 1e-12 * abs(ref["diff"]), (r["diff"], ref["diff"])
        for k in ("u", "p", "c"):
            assert np.array_equal(np.asarray(r["reasons"][k]), np.asarray(ref["reasons"][k])), k
    assert np.abs(r0["u"] - ref["u"]).max() < 1e-9
    assert np.abs(r0["ps"] - ref["ps"]).max() < 1e-8


def check_split_single(splits, single):
    """The split step against the port's single-device solve(max_iter=1)
    (ROADMAP known difference j apart: u 1e-9, ps 1e-8)."""
    assert np.abs(splits[0]["u"] - single["u"]).max() < 1e-9
    assert np.abs(splits[0]["ps"] - single["ps"]).max() < 1e-8


def check_dense(splits, ref, single):
    """The gathered dense tentative matrix against JAX's sharded export and
    the port's single-device export, to 1e-12."""
    A = splits[0]["dense"]
    assert A.shape == ref["dense"].shape == single["dense"].shape
    assert np.abs(A - ref["dense"]).max() < 1e-12, np.abs(A - ref["dense"]).max()
    assert np.abs(A - single["dense"]).max() < 1e-12, np.abs(A - single["dense"]).max()


@pytest.mark.parametrize("mode", HALO_SPLITS)
def test_split_step(halo_group, mode):
    splits, ref, _ = halo_group.split[mode]
    assert {r["config"]["sharding"] for r in splits} == {SHARDING[mode]}
    check_split(splits, ref)


@pytest.mark.parametrize("mode", HALO_SPLITS)
def test_split_step_single_device(halo_group, mode):
    splits, _, single = halo_group.split[mode]
    check_split_single(splits, single)


@pytest.mark.parametrize("mode", HALO_SPLITS)
def test_dense_tentative_matrix(halo_group, mode):
    splits, ref, single = halo_group.split[mode]
    check_dense(splits, ref, single)
