"""Rank functions of the slab-sharded solver, and its command line.

Each function here runs on every rank of a group that
``parallel/launch.py`` started (or ``torchrun``): ``fn(comm, ...)``.  They
live in this module because a spawned rank imports its function's module
afresh; the module imports nothing of JAX.

- ``tgv_solver``: bench.py's problem (3D Taylor-Green on the box [-1, 1]^3,
  Dirichlet data on every face, P2/P1) on the port, optionally sharded.
- ``run_tgv``: that solver over the ranks' slabs: optional per-shard kernel
  checks, warm-up steps, timed steps, the launch counters, the traffic,
  the times of one halo exchange and one sum over ranks; rank 0 returns
  the state.
- ``slab_ops``: the slab operators of ``parallel/slab.py`` on inputs from
  a ``.npz`` file, each rank's slab of the outputs; ``refusals``,
  ``slab_checks`` and ``misbehave``: the tests' other rank functions.

Command line (the same entry for the launcher and for torchrun)::

    python -m oasisx_tpu_torch.parallel.ranks --world 2 -N 16 --steps 10
    torchrun --standalone --nproc-per-node 2 -m oasisx_tpu_torch.parallel.ranks -N 16 --steps 10

prints rank 0's steps/s, iterations a step and traffic as one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from .comm import Comm

DT, NU = 2e-3, 1.0 / 1600.0  # bench.py's step and viscosity
TGV = (
    lambda x: np.sin(np.pi * x[0]) * np.cos(np.pi * x[1]) * np.cos(np.pi * x[2]),
    lambda x: -np.cos(np.pi * x[0]) * np.sin(np.pi * x[1]) * np.cos(np.pi * x[2]),
    lambda x: np.zeros_like(x[0]),
)


def tgv_solver(N, dtype, device, rtol: float, device_mesh=None,
               solver_options: dict | None = None):
    """The bench problem at N cells an axis (a tuple: the box's cells), the
    initial u1 = u2 = the Taylor-Green field; ``solver_options`` adds to a
    solve family's ("tentative", "pressure", "scalar")."""
    from .. import DirichletBC, FractionalStep_AB_CN, LocatorMethod
    from ..meshes import create_box, meshtags

    cells = (N, N, N) if isinstance(N, int) else tuple(N)
    mesh = create_box((-1.0, -1.0, -1.0), (1.0, 1.0, 1.0), cells)
    facets = mesh.exterior_facet_indices()
    tags = meshtags(mesh, mesh.dim - 1, facets, np.full_like(facets, 1))
    bcs_u = [[DirichletBC(f, LocatorMethod.TOPOLOGICAL, (tags, 1))] for f in TGV]
    opts = {"ksp_rtol": rtol, "ksp_max_it": 2000}
    solver = FractionalStep_AB_CN(
        mesh, ("Lagrange", 2), ("Lagrange", 1), bcs_u=bcs_u, bcs_p=[],
        solver_options={k: dict(opts, **(solver_options or {}).get(k, {}))
                        for k in ("tentative", "pressure", "scalar")},
        dtype=dtype, device=device, device_mesh=device_mesh,
    )
    for f, u1, u2 in zip(TGV, solver._u1, solver._u2):
        u1.interpolate(f)
        u2.interpolate(f)
    return solver


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def kernel_checks(solver, seed: int = 0) -> dict:
    """K3, K5, K6 and K7 applied per shard (refresh, the kernel on the
    slab's map, fold) against their plain versions on the same inputs:
    random slab vectors (float64 normal draws from ``seed`` and the rank,
    cast; halo and padding slots 0) and W of the solver's next step.  The
    largest error of each, absolute and relative to the largest output,
    and whether the kernel's halo and padding slots are exactly 0.  On the
    CPU both sides are the plain version."""
    from ..assembly import kernels as kn

    cu, sv, sq, comm = solver._cu, solver._sm_v, solver._sm_q, solver._comm
    st = solver._state_from_functions()
    W = solver._assemble_first(st["u1"], st["u2"], DT, NU)[0]
    gen = torch.Generator().manual_seed(seed * 1000 + comm.rank)
    k, nv, nq = comm.rank, solver._npad_v, solver._npad_q
    valid_v = torch.as_tensor(solver._slab.valid_v[k * nv:(k + 1) * nv])
    valid_q = torch.as_tensor(solver._slab.valid_q[k * nq:(k + 1) * nq])
    draw = lambda shape, valid: (torch.randn(shape, generator=gen, dtype=torch.float64)
                                 * valid).to(device=solver._device, dtype=solver._dtype)
    u, p = draw((cu.B_c.shape[0], nv), valid_v), draw((nq,), valid_q)
    cases = {
        "matvec_win": (lambda v: kn.matvec_win(W, v, sv), lambda v: kn.matvec_win_plain(W, v, sv),
                       u, "v", "v"),
        "matvec_const": (lambda v: kn.matvec_const(v, cu.M_c, sv),
                         lambda v: kn.matvec_const_plain(v, cu.M_c, sv), u, "v", "v"),
        "mixed": (lambda q: kn.mixed(q, cu.B_c, sv, sq),
                  lambda q: kn.mixed_plain(q, cu.B_c, sv, sq), p, "q", "v"),
        "divergence": (lambda v: kn.divergence(v, cu.B_c, sv, sq),
                       lambda v: kn.divergence_plain(v, cu.B_c, sv, sq), u, "v", "q"),
    }
    valid = {"v": valid_v.to(solver._device), "q": valid_q.to(solver._device)}
    out = {}
    for name, (kfn, pfn, x, si, so) in cases.items():
        y = solver._slab_op(kfn, x, si, so)
        ref = solver._slab_op(pfn, x, si, so)
        scale = float(torch.max(torch.abs(ref)))
        err = float(torch.max(torch.abs(y - ref)))
        out[name] = dict(rel_err=err / max(scale, 1e-300), max_abs_err=err, max_out=scale,
                         halo_zero=bool(torch.all(y[..., ~valid[so]] == 0)),
                         shape=list(x.shape))
    return out


def _time_comm(solver, reps: int = 50) -> dict:
    """Host-clock ms of one sum over ranks (one value) and of one halo
    refresh of the velocity (d planes), each the mean of ``reps``."""
    from .slab import halo_refresh

    comm, dev = solver._comm, solver._device
    one = torch.ones(1, dtype=solver._dtype, device=dev)
    u = solver._state_from_functions()["u"]
    out = {}
    for name, fn in (("sum_ms", lambda: comm.sum(one)),
                     ("halo_ms", lambda: halo_refresh(u, solver._sm_v, comm))):
        fn()
        comm.barrier()
        _sync(dev)
        t = time.perf_counter()
        for _ in range(reps):
            fn()
        _sync(dev)
        out[name] = (time.perf_counter() - t) * 1e3 / reps
    return out


def _profile(solver, steps: int, dt, nu) -> dict:
    """torch.profiler over ``steps`` more steps: this rank's device time
    (its kernels' and copies' self time) apart from NCCL's kernels, which
    hold the card while they wait for a partner, NCCL's, and the wall, in
    ms."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    dev = solver._device
    _sync(dev)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        solver.run(steps, dt, nu)
        _sync(dev)
        wall = time.perf_counter() - t0
    dev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    nccl = sum(e.self_device_time_total for e in dev if "nccl" in e.key.lower())
    busy = sum(e.self_device_time_total for e in dev) - nccl
    return dict(profile_steps=steps, profile_wall_ms=wall * 1e3, profile_device_ms=busy / 1e3,
                profile_nccl_ms=nccl / 1e3)


def run_tgv(comm: Comm, cfg: dict) -> dict:
    """The slab solver on this rank, one inner iteration a step: ``cfg``
    N, dtype ("float32" or "float64"), device ("cpu" or "cuda"), rtol,
    warmup, steps, dt, nu, check (the per-shard kernel checks, after the
    warm-up), time_comm (time a sum and a halo exchange), profile (this
    many more steps under torch.profiler: the device time), solve (after
    the run, ``set_state(get_state())`` and one ``solve``) and
    solver_options (``tgv_solver``'s).  Returns this rank's
    launch counts, traffic and times, and the last run's per-step stats;
    rank 0 also the canonical state (u, u1, u2 as (d, n); p, dp) and
    ``get_state``."""
    from ..assembly import kernels as kn
    from .launch import rank_device

    dtype = getattr(torch, cfg.get("dtype", "float64"))
    device = rank_device(comm, cfg.get("device", "cpu"))
    t0 = time.perf_counter()
    solver = tgv_solver(cfg["N"], dtype, device, cfg.get("rtol", 1e-8), device_mesh=comm,
                        solver_options=cfg.get("solver_options"))
    setup_s = time.perf_counter() - t0
    dt, nu = cfg.get("dt", DT), cfg.get("nu", NU)
    res = dict(rank=comm.rank, setup_s=setup_s, config=solver.config_report(),
               traffic=solver.halo_traffic_report())
    if cfg.get("warmup", 0):
        solver.run(cfg["warmup"], dt, nu, max_iter=1)
    if cfg.get("check"):
        res["kernels"] = kernel_checks(solver)
    kn.reset_counts()
    comm.reset_stats()
    comm.barrier()
    _sync(device)
    t0 = time.perf_counter()
    stats = solver.run(cfg["steps"], dt, nu, max_iter=1)
    _sync(device)
    wall = time.perf_counter() - t0
    res.update(stats=stats, wall_s=wall, steps_per_s=cfg["steps"] / wall,
               launches={k: v for k, v in kn.launches.items() if v},
               plain_calls={k: v for k, v in kn.plain_calls.items() if v},
               comm={k: list(v) for k, v in comm.stats.items()})
    # copies (a later step writes the Functions in place); get_state is a
    # collective, so every rank reads them
    f = lambda g: np.array(g.x.array.double().cpu().numpy())
    canonical = lambda: dict(u=np.stack([f(g) for g in solver._u]),
                             u1=np.stack([f(g) for g in solver._u1]),
                             u2=np.stack([f(g) for g in solver._u2]),
                             p=f(solver._p), dp=f(solver._dp), state=solver.get_state())
    out = canonical()
    if cfg.get("solve"):  # the state written back, then one solve() of max_iter 2
        solver.set_state(out["state"])
        res["solve_diff"] = solver.solve(dt, nu, max_iter=2)
        res["solve_stats"] = solver.last_stats
        after = canonical()
        if comm.rank == 0:
            res["solve"] = after
    if comm.rank == 0:
        res.update(out)
    if cfg.get("time_comm"):
        res.update(_time_comm(solver))
    if cfg.get("profile"):
        res.update(_profile(solver, cfg["profile"], dt, nu))
    return res


def iters_per_step(stats: dict) -> dict:
    """The mean over a run's steps of each solve family's iterations a
    step (the components' summed)."""
    return {k: float(np.mean(np.asarray(stats[k + "_iters"]).reshape(
        len(stats[k + "_iters"]), -1).sum(axis=1))) for k in ("u", "p", "c")}


def refusals(comm: Comm) -> dict:
    """What the slab path refuses once the group exists: a leading cube
    count that the ranks do not divide, the split-phase API; the lumped
    update's fall-back to the mass CG (on a solver given a 1-D
    ``DeviceMesh``); the (rank, size) of a DeviceMesh's and the world
    group's ``Comm``.  Each refusal's message, and
    whether this process imported anything of JAX."""
    import sys

    out = dict(jax_free=not any(m.split(".")[0] in ("jax", "jaxlib", "oasisx_tpu")
                                for m in sys.modules))
    try:
        tgv_solver((comm.size * 2 + 1, 4, 4), torch.float64, "cpu", 1e-8, device_mesh=comm)
        out["ndev"] = None
    except NotImplementedError as e:
        out["ndev"] = str(e)
    # a 1-D DeviceMesh as the device_mesh, and the world's ProcessGroup
    from torch.distributed.device_mesh import DeviceMesh

    from .comm import as_comm

    mesh = DeviceMesh("cpu", list(range(comm.size)))
    world = as_comm(torch.distributed.group.WORLD)
    out["groups"] = [(c.rank, c.size) for c in (as_comm(mesh), world)]
    s = tgv_solver((comm.size * 2, 2, 2), torch.float64, "cpu", 1e-8, device_mesh=mesh,
                   solver_options={"scalar": {"pc_type": "lumped"}})
    out["velocity_update"] = s.config_report()["velocity_update"]
    try:
        s.assemble_first(DT, NU)
        out["split"] = None
    except NotImplementedError as e:
        out["split"] = str(e)
    return out


def slab_ops(comm: Comm, path: str) -> dict:
    """The slab operators on the inputs of ``path`` (an .npz: dim, N, du,
    dp; canonical vectors xv, xq, u, uab; a0, a1 of A0 = a0 M + a1 K;
    yv, yq in the global slab-flat layout for the fold), in float64 on the
    CPU.  Returns this rank's slab of each output."""
    from ..assembly import kernels as kn
    from ..assembly.cubes import build_cube_ops
    from ..assembly.reference_tensors import build_reference_tensors
    from ..assembly.structured import build_structured_map
    from ..meshes import create_box, create_rectangle
    from ..spaces.functionspace import FunctionSpace
    from . import slab as sl

    z = np.load(path)
    dim, N, du, dq = (int(z[k]) for k in ("dim", "N", "du", "dp"))
    if dim == 2:
        mesh = create_rectangle((-1.0, -1.0), (1.0, 1.0), (N, N))
    else:
        mesh = create_box((-1.0, -1.0, -1.0), (1.0, 1.0, 1.0), (N, N, N))
    V, Q = FunctionSpace(mesh, ("Lagrange", du)), FunctionSpace(mesh, ("Lagrange", dq))
    (sv, gf_v, _), (sq, gf_q, _) = (build_structured_map(mesh, S.element, S.dofmap)
                                    for S in (V, Q))
    info = sl.build_slab(sv, gf_v, sq, gf_q, comm.size)
    ops = build_cube_ops(mesh, build_reference_tensors(V.element, Q.element), sv, sq,
                         torch.float64, device="cpu")
    svl, sql = info.sm_v_loc, info.sm_q_loc
    k, nv, nq = comm.rank, info.npad_v_loc, info.npad_q_loc
    t = lambda a: torch.as_tensor(np.asarray(a, np.float64))

    def local(arr, perm, n):
        dofs, loc = sl.local_part(perm, n, k)
        out = np.zeros(arr.shape[:-1] + (n,))
        out[..., loc] = arr[..., dofs]
        return t(out)

    xv, xq = local(z["xv"], info.perm_v, nv), local(z["xq"], info.perm_q, nq)
    u, uab = local(z["u"], info.perm_v, nv), local(z["uab"], info.perm_v, nv)
    A0 = float(z["a0"]) * ops.M_c + float(z["a1"]) * ops.K_c
    uq = sl.conv_uq_slab(ops, uab, svl, comm)
    d = mesh.dim
    nl = ops.M_c.shape[0]
    U = kn.cube_gather_plain(sl.halo_refresh(uab, svl, comm), svl)
    W = kn.build_w(torch.as_tensor(kn.conv_weight_tensor(ops)), A0, U.reshape(d * nl, -1))
    app = lambda f, x, si, so: sl.slab_apply(f, x, si, so, comm)
    out = dict(
        refresh_v=sl.halo_refresh(t(z["yv"][k * nv:(k + 1) * nv]), svl, comm),
        refresh_q=sl.halo_refresh(t(z["yq"][k * nq:(k + 1) * nq]), sql, comm),
        fold_v=sl.halo_fold(t(z["yv"][k * nv:(k + 1) * nv]), svl, comm),
        fold_q=sl.halo_fold(t(z["yq"][k * nq:(k + 1) * nq]), sql, comm),
        M=sl.matvec_cube_slab(xv, ops.M_c, svl, comm),
        Ap=sl.matvec_cube_slab(xq, ops.Ap_c, sql, comm),
        mixed=sl.mixed_all_slab(xq, ops.B_c, svl, sql, comm),
        div=sl.divergence_slab(u, ops.B_c, svl, sql, comm),
        diag=sl.diag_cube_slab(ops.Ap_c, sql, comm),
        uq=uq,
        tent=sl.tentative_matvec_slab(ops, A0, uq, xv, svl, comm),
        rhs=sl.rhs_matvec_slab(ops, A0, uq, xv, svl, comm),
        conv_diag=sl.conv_diag_slab(ops, uq, svl, comm),
        # each kernel's plain version between the halo exchanges
        k_M=app(lambda v: kn.matvec_const_plain(v, ops.M_c, svl), xv, svl, svl),
        k_win=app(lambda v: kn.matvec_win_plain(W, v, svl), xv[None], svl, svl)[0],
        k_mixed=app(lambda q: kn.mixed_plain(q, ops.B_c, svl, sql), xq, sql, svl),
        k_div=app(lambda v: kn.divergence_plain(v, ops.B_c, svl, sql), u, svl, sql),
    )
    return {key: v.numpy() for key, v in out.items()}


def misbehave(comm: Comm, rank: int, how: str) -> None:
    """Rank ``rank`` raises (``how`` "raise") or stalls for a minute
    ("stall") while the others wait in a sum over ranks: the launcher's
    failure and time-limit paths."""
    if comm.rank == rank:
        if how == "raise":
            raise ValueError(f"rank {rank} fails on purpose")
        time.sleep(60.0)
    comm.sum(torch.ones(1))


def slab_checks(comm: Comm, path: str, cfgs: list) -> dict:
    """``slab_ops``, ``run_tgv`` of each of ``cfgs`` and ``refusals`` in
    one group (the tests' one spawn per world)."""
    return dict(ops=slab_ops(comm, path), runs=[run_tgv(comm, c) for c in cfgs],
                refusals=refusals(comm))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="bench.py's problem on the slab path")
    ap.add_argument("-N", type=int, default=16)
    ap.add_argument("--world", type=int, default=2, help="ranks to spawn (not under torchrun)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dtype", default="float32")
    ap.add_argument("--rtol", type=float, default=1e-5)
    ap.add_argument("--warmup", type=int, default=5)
    ap.add_argument("--steps", type=int, default=25)
    ap.add_argument("--backend", default=None, help="nccl or gloo (default: nccl where each "
                    "rank has a card, else gloo)")
    a = ap.parse_args(argv)
    cfg = dict(N=a.N, device=a.device, dtype=a.dtype, rtol=a.rtol, warmup=a.warmup,
               steps=a.steps, time_comm=True)
    if "RANK" in os.environ:  # under torchrun
        from .launch import run_env

        res = [run_env(run_tgv, (cfg,), backend=a.backend)]
        if res[0]["rank"] != 0:
            return 0
    else:
        from .launch import launch

        backend = a.backend or ("nccl" if a.device == "cuda" and
                                torch.cuda.device_count() >= a.world > 1 else "gloo")
        res = launch(run_tgv, a.world, (cfg,), backend=backend)
    r = res[0]
    print(json.dumps(dict(
        N=a.N, world=r["config"]["ndev"], backend=r["config"]["backend"],
        steps_per_s=r["steps_per_s"], setup_s=r["setup_s"],
        iters=iters_per_step(r["stats"]),
        comm=r["comm"], sum_ms=r["sum_ms"], halo_ms=r["halo_ms"], traffic=r["traffic"])))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
