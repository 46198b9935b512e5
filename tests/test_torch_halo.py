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


@pytest.mark.parametrize("world", [2, 4])
def test_halo_group(world, tmp_path):
    rng = np.random.default_rng(70 + world)
    z, hxs, perm, B = _inputs(world, rng)
    path = tmp_path / "inputs.npz"
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
    with start(ranks.halo_checks, world, (str(path), mains + variants)) as group:
        ops = _jax_ops(world, z, hxs, perm, B)
        ref = [_jax_run(_jax_solver(c, world), c, STEPS) for c in mains[:-1]]
        ref.append(_jax_run(jv, mains[-1], STEPS))
        ref += [_jax_run(js, c, VSTEPS) for js, c in zip(jvar, variants)]
        out = group.join(JOIN_S)

    # the exchange and the per-shard products
    for key, r in ops.items():
        sp = key[-1]
        own = hxs[sp].ownmask == 1
        parts = ([o["ops"][key] for o in out] if not key.startswith("mv") else None)
        if parts is not None:
            g = np.concatenate(parts)
            assert np.array_equal(g, r), key
            continue
        for kind in ("ell", "band"):
            g = np.concatenate([o["ops"][f"{kind}_{sp}"] for o in out])
            assert _rel(g, r) <= 1e-11, (kind, sp, _rel(g, r))
            assert np.all(g[~own] == 0), (kind, sp)
    for o in out:
        assert o["jax_free"]

    # the solver
    checks = [(m, "amg-pcg-distributed", "bcgs") for m in mains]
    checks += [(c, v[2], v[3]) for c, v in zip(variants, VARIANTS)]
    for i, ((c, pc, method), r) in enumerate(zip(checks, ref)):
        _check_run([o["runs"][i] for o in out], r, pc, method)
    assert out[0]["runs"][0]["config"]["partitioner"]["name"] in ("multilevel", "rcb")
    if world == 2:
        band_run = out[0]["runs"][len(mains)]["config"]
        assert band_run["partitioner"] == {"name": "rcb"} and band_run["ell_layout"] == "band"
