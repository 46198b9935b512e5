"""Rank functions of the sharded solver (the slab path, the graph-halo
path and the replicated mode), and its command line.

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
  a ``.npz`` file, each rank's slab of the outputs; ``mesh_checks``,
  ``slab_checks`` and ``misbehave``: the tests' other rank functions.
- ``halo_solver``: the problems of the general path (graph-halo, or the
  replicated mode with ``options`` ``{"replicated": True}``) and of the
  split step: bench.py's vessel (the deformed box on the general path), the
  DFG cylinder channel with its ``PressureBC(0)`` outlet (``res``,
  ``rotational``), the unit square with its ``PressureBC`` outlet, the 8 x 8
  rectangle of the split-phase cases, and bench.py's box.
- ``run_halo``: as ``run_tgv`` for those, graph-halo or replicated;
  ``halo_kernel_checks``: K14 (K18 under the band layout) per shard between
  the halo refresh and fold against its plain version; ``halo_ops`` and
  ``halo_checks``: the tests' rank functions.
- ``split_step``: one step of the split-phase API under the mesh, after
  ``run`` warm-up steps, on any mode: each phase's launches and wall, the
  diff, the reasons and iterations, u and ps; and the dense tentative
  matrix.  ``run_tgv`` and ``run_halo`` end with one under ``split``.

Command line (the same entry for the launcher and for torchrun)::

    python -m oasisx_tpu_torch.parallel.ranks --world 2 -N 16 --steps 10
    python -m oasisx_tpu_torch.parallel.ranks --world 2 --problem vessel -N 16
    python -m oasisx_tpu_torch.parallel.ranks --world 2 --problem vessel -N 16 --replicated
    python -m oasisx_tpu_torch.parallel.ranks --world 2 --problem box -N 16 --split
    torchrun --standalone --nproc-per-node 2 -m oasisx_tpu_torch.parallel.ranks -N 16 --steps 10

prints rank 0's steps/s, iterations a step and traffic as one JSON line
(with ``--split``: one split step's phase walls, reasons and launches after
the warm-up steps).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import time

import numpy as np
import torch

from .comm import Comm
from .graph import halo_fold, halo_refresh

DT, NU = 2e-3, 1.0 / 1600.0  # bench.py's step and viscosity
TGV = (
    lambda x: np.sin(np.pi * x[0]) * np.cos(np.pi * x[1]) * np.cos(np.pi * x[2]),
    lambda x: -np.cos(np.pi * x[0]) * np.sin(np.pi * x[1]) * np.cos(np.pi * x[2]),
    lambda x: np.zeros_like(x[0]),
)


def _options(rtol: float, solver_options: dict | None) -> dict:
    opts = {"ksp_rtol": rtol, "ksp_max_it": 2000}
    return {k: dict(opts, **(solver_options or {}).get(k, {}))
            for k in ("tentative", "pressure", "scalar")}


def tgv_solver(N, dtype, device, rtol: float, device_mesh=None,
               solver_options: dict | None = None, options: dict | None = None):
    """The bench problem at N cells an axis (a tuple: the box's cells), the
    initial u1 = u2 = the Taylor-Green field; ``solver_options`` adds to a
    solve family's ("tentative", "pressure", "scalar"); ``options`` are the
    solver's."""
    from .. import DirichletBC, FractionalStep_AB_CN, LocatorMethod
    from ..meshes import create_box, meshtags

    cells = (N, N, N) if isinstance(N, int) else tuple(N)
    mesh = create_box((-1.0, -1.0, -1.0), (1.0, 1.0, 1.0), cells)
    facets = mesh.exterior_facet_indices()
    tags = meshtags(mesh, mesh.dim - 1, facets, np.full_like(facets, 1))
    bcs_u = [[DirichletBC(f, LocatorMethod.TOPOLOGICAL, (tags, 1))] for f in TGV]
    solver = FractionalStep_AB_CN(
        mesh, ("Lagrange", 2), ("Lagrange", 1), bcs_u=bcs_u, bcs_p=[],
        solver_options=_options(rtol, solver_options), options=options,
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
    ms.  On the card only the device's activity is recorded (not the
    host's thousands of small ops a step)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    dev = solver._device
    _sync(dev)
    on_card = torch.device(dev).type == "cuda"
    with profile(activities=[ProfilerActivity.CUDA if on_card else ProfilerActivity.CPU]) as prof:
        t0 = time.perf_counter()
        solver.run(steps, dt, nu)
        _sync(dev)
        wall = time.perf_counter() - t0
    dev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    nccl = sum(e.self_device_time_total for e in dev if "nccl" in e.key.lower())
    busy = sum(e.self_device_time_total for e in dev) - nccl
    return dict(profile_steps=steps, profile_wall_ms=wall * 1e3, profile_device_ms=busy / 1e3,
                profile_nccl_ms=nccl / 1e3)


@contextlib.contextmanager
def _card_alone(comm: Comm, lock):
    """The block with the card to this group alone: ``lock`` (a
    ``multiprocessing`` lock of the spawn context shared by groups that run
    at once on one card, or None: no other group) held by rank 0 from a
    barrier before the block to one after it, so that no other group's work
    runs while this one's steps, profile and kernels are timed."""
    if lock is None:
        yield
        return
    if comm.rank == 0:
        lock.acquire()
    try:
        comm.barrier()
        yield
        comm.barrier()
    finally:
        if comm.rank == 0:
            lock.release()


def run_tgv(comm: Comm, cfg: dict) -> dict:
    """The slab solver on this rank, one inner iteration a step: ``cfg``
    N, dtype ("float32" or "float64"), device ("cpu" or "cuda"), rtol,
    warmup, steps, dt, nu, check (the per-shard kernel checks, after the
    warm-up), time_comm (time a sum and a halo exchange), profile (this
    many more steps under torch.profiler: the device time), split (one
    split step after the run, ``_split_result``, before any of the
    following), solve (after the run, ``set_state(get_state())`` and one
    ``solve``), solver_options (``tgv_solver``'s) and card_lock
    (``_card_alone``'s lock: the timed steps to the profile with the card
    to this group).  Returns this rank's launch counts, traffic and times,
    and the last run's per-step stats;
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
    with _card_alone(comm, cfg.get("card_lock")):
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
        if cfg.get("split"):
            res["split"] = _split_result(comm, solver, dt, nu)
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


def _jax_free() -> bool:
    """Whether this process imported nothing of JAX."""
    import sys

    return not any(m.split(".")[0] in ("jax", "jaxlib", "oasisx_tpu") for m in sys.modules)


def _split_phases(solver, dt, nu) -> dict:
    """One step of the split-phase API in the JAX package's order (ps <- p,
    assemble_first, velocity_tentative_assemble, velocity_tentative_solve,
    pressure_assemble, pressure_solve, velocity_update; the caller does not
    rotate): the diff, the reasons and iterations of the u, p (rotational
    update: rot) and c solves, and each phase's host seconds (the device
    synchronised around it), launches and plain calls."""
    from ..assembly import kernels as kn

    phases, dev, iters = {}, solver._device, {}
    for key, name in (("u", "_tentative_solve"), ("p", "_pressure_solve"),
                      ("rot", "_rotational_update"), ("c", "_velocity_update")):
        def wrap(*args, f=getattr(solver, name), key=key):  # records the solve's iterations
            out = f(*args)
            iters[key] = out[0].iters
            return out

        setattr(solver, name, wrap)

    def phase(name, fn):
        launches, plain = dict(kn.launches), dict(kn.plain_calls)
        _sync(dev)
        t = time.perf_counter()
        out = fn()
        _sync(dev)
        phases[name] = dict(
            s=time.perf_counter() - t,
            launches={k: v - launches.get(k, 0) for k, v in kn.launches.items()
                      if v != launches.get(k, 0)},
            plain_calls={k: v - plain.get(k, 0) for k, v in kn.plain_calls.items()
                         if v != plain.get(k, 0)})
        return out

    solver._ps.x.array.copy_(solver._p.x.array)
    phase("assemble_first", lambda: solver.assemble_first(dt, nu))
    phase("velocity_tentative_assemble", solver.velocity_tentative_assemble)
    diff, u_reasons = phase("velocity_tentative_solve", solver.velocity_tentative_solve)
    phase("pressure_assemble", lambda: solver.pressure_assemble(dt))
    p_reason = phase("pressure_solve", lambda: solver.pressure_solve(nu))
    c_reasons = phase("velocity_update", lambda: solver.velocity_update(dt))
    for name in ("_tentative_solve", "_pressure_solve", "_rotational_update", "_velocity_update"):
        delattr(solver, name)
    return dict(diff=diff, reasons=dict(u=u_reasons, p=p_reason, c=c_reasons), phases=phases,
                iters={k: np.asarray(v.cpu()).tolist() for k, v in iters.items()})


def mesh_checks(comm: Comm) -> dict:
    """What the sharded solver does once the group exists: the path a
    leading cube count that the ranks do not divide takes (graph-halo); on a
    solver given a 1-D ``DeviceMesh`` (the slab path on the box of (2 world,
    2, 2) cells), the lumped update's fall-back to the mass CG, one split
    step (its diff and reasons) and the dense tentative matrix after it
    (rank 0); the (rank, size) of a DeviceMesh's and the world group's
    ``Comm``; and whether this process imported anything of JAX."""
    out = dict(jax_free=_jax_free())
    s = tgv_solver((comm.size * 2 + 1, 4, 4), torch.float64, "cpu", 1e-8, device_mesh=comm)
    out["ndev"] = s.config_report()["sharding"]
    # a 1-D DeviceMesh as the device_mesh, and the world's ProcessGroup
    from torch.distributed.device_mesh import DeviceMesh

    from .comm import as_comm

    mesh = DeviceMesh("cpu", list(range(comm.size)))
    world = as_comm(torch.distributed.group.WORLD)
    out["groups"] = [(c.rank, c.size) for c in (as_comm(mesh), world)]
    s = tgv_solver((comm.size * 2, 2, 2), torch.float64, "cpu", 1e-8, device_mesh=mesh,
                   solver_options={"scalar": {"pc_type": "lumped"}})
    rep = s.config_report()
    out["velocity_update"], out["sharding"] = rep["velocity_update"], rep["sharding"]
    split = _split_phases(s, DT, NU)
    out["split"] = dict(diff=split["diff"], reasons=split["reasons"])
    A = s.tentative_matrix_dense()
    if comm.rank == 0:
        out["dense"] = A
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


ROUTED = ("unstructured", "structured_false", "pressure_bc", "rotational", "slab_false")
# options["replicated"] on a box whose slabs divide (the slab path, taken
# first), on an unstructured mesh and with a PressureBC (the replicated mode)
ROUTED_REPLICATED = ("replicated_slab", "replicated_unstructured", "replicated_pressure_bc")


def routing(comm: Comm, cases=ROUTED + ROUTED_REPLICATED) -> dict:
    """The sharding mode the solver takes, on the box of 2 cells an axis
    with every exterior facet tagged 1, for each case the JAX package sends
    to graph-halo (an unstructured mesh, ``structured`` False, a PressureBC,
    the rotational update, ``slab`` False) and each of ROUTED_REPLICATED."""
    from .. import DirichletBC, FractionalStep_AB_CN, LocatorMethod, PressureBC
    from ..meshes import create_box, meshtags

    out = {}
    for case in cases:
        m = create_box((0.0, 0.0, 0.0), (1.0, 1.0, 1.0), (2, 2, 2))
        facets = m.exterior_facet_indices()
        tags = meshtags(m, m.dim - 1, facets, np.full_like(facets, 1))
        rep = case.startswith("replicated_")
        base = case[len("replicated_"):] if rep else case
        kw = {"unstructured": {}, "slab": {}, "structured_false": {"options": {"structured": False}},
              "pressure_bc": {"bcs_p": [PressureBC(0.0, (tags, 1))]},
              "rotational": {"rotational": True}, "slab_false": {"options": {"slab": False}}}[base]
        if rep:
            kw["options"] = dict(kw.get("options", {}), replicated=True)
        if base == "unstructured":
            m.structured = None
        bcs = [[DirichletBC(0.0, LocatorMethod.TOPOLOGICAL, (tags, 1))] for _ in range(3)]
        s = FractionalStep_AB_CN(m, ("Lagrange", 2), ("Lagrange", 1), bcs, device="cpu",
                                 dtype=torch.float64, device_mesh=comm, **kw)
        out[case] = s.config_report()["sharding"]
    return out


def slab_checks(comm: Comm, path: str, cfgs: list, splits=()) -> dict:
    """``slab_ops``, ``run_tgv`` of each of ``cfgs``, ``mesh_checks`` and
    ``split_step`` of each of ``splits`` in one group (the tests' one spawn
    per world)."""
    return dict(ops=slab_ops(comm, path), runs=[run_tgv(comm, c) for c in cfgs],
                checks=mesh_checks(comm), splits=[split_step(comm, c) for c in splits])


# ---------------------------------------------------------------------------
# the graph-halo path
# ---------------------------------------------------------------------------

CYL_L, CYL_H, CYL_UM = 2.2, 0.41, 0.3  # the DFG channel and its inflow peak
CYL_DT, CYL_NU = 2e-3, 1e-3  # the cylinder's step and viscosity


def deform_vessel(mesh):
    """bench.py's vessel: a taper, a bulge and a curved centreline applied
    to a box mesh, marked unstructured."""
    x = mesh.x.copy()
    lo, hi = x[:, 0].min(), x[:, 0].max()
    s = (x[:, 0] - lo) / (hi - lo)
    r = (1.0 - 0.25 * s) * (1.0 + 0.55 * np.exp(-(((s - 0.55) / 0.12) ** 2)))
    x[:, 1] = 0.45 * np.sin(np.pi * s) + 1.0 * r * x[:, 1]
    x[:, 2] = 0.3 * np.sin(np.pi * s * 0.9) + 0.8 * r * x[:, 2]
    mesh.x[:] = x
    mesh.structured = None
    return mesh


def vessel_solver(N: int, dtype, device, rtol: float, device_mesh=None,
                  solver_options: dict | None = None, options: dict | None = None):
    """bench.py's unstructured configuration: the Taylor-Green problem on
    the vessel-deformed box of N cells an axis, ``low_memory_version``
    False; ``options`` add to the solver's."""
    from .. import DirichletBC, FractionalStep_AB_CN, LocatorMethod
    from ..meshes import create_box, meshtags

    mesh = deform_vessel(create_box((-1.0, -1.0, -1.0), (1.0, 1.0, 1.0), (N, N, N)))
    facets = mesh.exterior_facet_indices()
    tags = meshtags(mesh, mesh.dim - 1, facets, np.full_like(facets, 1))
    bcs_u = [[DirichletBC(f, LocatorMethod.TOPOLOGICAL, (tags, 1))] for f in TGV]
    solver = FractionalStep_AB_CN(
        mesh, ("Lagrange", 2), ("Lagrange", 1), bcs_u=bcs_u, bcs_p=[],
        solver_options=_options(rtol, solver_options),
        options=dict({"low_memory_version": False}, **(options or {})),
        dtype=dtype, device=device, device_mesh=device_mesh,
    )
    for f, u1, u2 in zip(TGV, solver._u1, solver._u2):
        u1.interpolate(f)
        u2.interpolate(f)
    return solver


def cylinder_solver(res: int, dtype, device, rtol: float, device_mesh=None,
                    solver_options: dict | None = None, options: dict | None = None,
                    rotational: bool = False, um=lambda: CYL_UM):
    """The DFG cylinder channel (tests/test_graph_halo.py's set-up): a
    parabolic inflow of peak ``um()`` (read each time the boundary values
    are evaluated), no-slip walls and cylinder, a ``PressureBC(0)`` outlet;
    zero initial state."""
    from .. import DirichletBC, FractionalStep_AB_CN, LocatorMethod, PressureBC
    from ..meshes import create_cylinder_channel, locate_entities_boundary, meshtags

    mesh = create_cylinder_channel(res)
    inlet = locate_entities_boundary(mesh, 1, lambda x: np.isclose(x[0], 0.0))
    outlet = locate_entities_boundary(mesh, 1, lambda x: np.isclose(x[0], CYL_L))
    others = np.setdiff1d(mesh.exterior_facet_indices(), np.hstack([inlet, outlet]))
    facets = np.hstack([inlet, others, outlet])
    values = np.hstack([np.full_like(inlet, 1), np.full_like(others, 2),
                        np.full_like(outlet, 3)]).astype(np.int32)
    tags = meshtags(mesh, 1, facets, values)
    inflow = lambda x: 4.0 * um() * x[1] * (CYL_H - x[1]) / CYL_H**2
    T = LocatorMethod.TOPOLOGICAL
    bcs_u = [[DirichletBC(inflow, T, (tags, 1)), DirichletBC(0.0, T, (tags, 2))],
             [DirichletBC(0.0, T, (tags, 1)), DirichletBC(0.0, T, (tags, 2))]]
    return FractionalStep_AB_CN(
        mesh, ("Lagrange", 2), ("Lagrange", 1), bcs_u=bcs_u, bcs_p=[PressureBC(0.0, (tags, 3))],
        rotational=rotational, solver_options=_options(rtol, solver_options), options=options,
        dtype=dtype, device=device, device_mesh=device_mesh,
    )


SQUARE_DT, SQUARE_NU = 0.05, 0.1  # the unit square's step and viscosity
RECT_DT = RECT_NU = 0.01  # the split-phase rectangle's


def square_solver(dtype, device, rtol: float, device_mesh=None, solver_options=None,
                  options=None):
    """tests/test_sharding.py's problem: the unit square of 10 cells an
    axis, u = (sin(pi y), 0) on x = 0, no slip on y = 0 and 1, a
    ``PressureBC(1 + 0.1 y)`` outlet on x = 1, both components of u1 and u2
    0.1 sin(pi x) sin(pi y)."""
    from .. import DirichletBC, FractionalStep_AB_CN, LocatorMethod, PressureBC
    from ..meshes import create_unit_square, locate_entities_boundary, meshtags

    mesh = create_unit_square(10)
    side = lambda f: locate_entities_boundary(mesh, 1, f)
    left = side(lambda x: np.isclose(x[0], 0))
    tb = side(lambda x: np.isclose(x[1], 0) | np.isclose(x[1], 1))
    right = side(lambda x: np.isclose(x[0], 1))
    values = np.hstack([np.full_like(left, 1), np.full_like(tb, 2),
                        np.full_like(right, 3)]).astype(np.int32)
    tags = meshtags(mesh, 1, np.hstack([left, tb, right]), values)
    T = LocatorMethod.TOPOLOGICAL
    bcs_u = [[DirichletBC(lambda x: np.sin(np.pi * x[1]), T, (tags, 1)),
              DirichletBC(0.0, T, (tags, 2))],
             [DirichletBC(0.0, T, (tags, 1)), DirichletBC(0.0, T, (tags, 2))]]
    s = FractionalStep_AB_CN(
        mesh, ("Lagrange", 2), ("Lagrange", 1), bcs_u=bcs_u,
        bcs_p=[PressureBC(lambda x: 1.0 + 0.1 * x[1], (tags, 3))],
        solver_options=_options(rtol, solver_options), options=options, dtype=dtype,
        device=device, device_mesh=device_mesh)
    for f in (*s._u1, *s._u2):
        f.interpolate(lambda x: 0.1 * np.sin(np.pi * x[0]) * np.sin(np.pi * x[1]))
    return s


def rect_solver(dtype, device, rtol: float, device_mesh=None, solver_options=None,
                options=None):
    """tests/test_graph_halo.py's split-phase and dense-matrix problem: the
    rectangle [-1, 1]^2 of 8 x 8 cells, P2/P1, the Taylor-Green velocity
    (-cos(pi x) sin(pi y), cos(pi y) sin(pi x)) on every boundary facet and
    in u1 and u2."""
    from .. import DirichletBC, FractionalStep_AB_CN, LocatorMethod
    from ..meshes import create_rectangle, meshtags

    ux = lambda x: -np.cos(np.pi * x[0]) * np.sin(np.pi * x[1])
    uy = lambda x: np.cos(np.pi * x[1]) * np.sin(np.pi * x[0])
    mesh = create_rectangle((-1.0, -1.0), (1.0, 1.0), (8, 8))
    facets = mesh.exterior_facet_indices()
    tags = meshtags(mesh, 1, facets, np.full_like(facets, 3))
    T = LocatorMethod.TOPOLOGICAL
    s = FractionalStep_AB_CN(
        mesh, ("Lagrange", 2), ("Lagrange", 1),
        bcs_u=[[DirichletBC(ux, T, (tags, 3))], [DirichletBC(uy, T, (tags, 3))]], bcs_p=[],
        solver_options=_options(rtol, solver_options), options=options, dtype=dtype,
        device=device, device_mesh=device_mesh)
    for f, g in ((s._u1[0], ux), (s._u1[1], uy), (s._u2[0], ux), (s._u2[1], uy)):
        f.interpolate(g)
    return s


def halo_solver(cfg: dict, dtype, device, device_mesh=None):
    """The problem of ``cfg``: "problem" "vessel" (N), "cylinder" (res,
    rotational), "square", "rect" or "box" (bench.py's Taylor-Green box, N);
    rtol, solver_options and options as those functions take them."""
    kw = dict(device_mesh=device_mesh, solver_options=cfg.get("solver_options"),
              options=cfg.get("options"))
    rtol = cfg.get("rtol", 1e-8)
    problem = cfg["problem"]
    if problem == "vessel":
        return vessel_solver(cfg["N"], dtype, device, rtol, **kw)
    if problem == "square":
        return square_solver(dtype, device, rtol, **kw)
    if problem == "rect":
        return rect_solver(dtype, device, rtol, **kw)
    if problem == "box":
        return tgv_solver(cfg["N"], dtype, device, rtol, **kw)
    return cylinder_solver(cfg["res"], dtype, device, rtol,
                           rotational=cfg.get("rotational", False), **kw)


def step_size(cfg: dict) -> tuple[float, float]:
    """(dt, nu) of ``cfg``: its own, else its problem's."""
    dt, nu = {"square": (SQUARE_DT, SQUARE_NU), "rect": (RECT_DT, RECT_NU),
              "cylinder": (CYL_DT, CYL_NU)}.get(cfg["problem"], (DT, NU))
    return cfg.get("dt", dt), cfg.get("nu", nu)


def _device_ms(fn, device, reps: int = 20) -> float:
    """Mean ms a call: on the card the device time of ``reps`` back-to-back
    calls queued behind a spin kernel (so the host's enqueueing is not
    timed), on the CPU the host clock."""
    for _ in range(3):
        fn()
    if torch.device(device).type != "cuda":
        t = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t) * 1e3 / reps
    torch.cuda.synchronize(device)
    t = time.perf_counter()
    fn()
    spin_s = min(1.5 * reps * (time.perf_counter() - t) + 1e-4, 0.05)
    torch.cuda.synchronize(device)
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(2.0e9 * spin_s))
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize(device)
    return e0.elapsed_time(e1) / reps


def _local_csr(cd: torch.Tensor, elems: torch.Tensor, n: int) -> torch.Tensor:
    """The rank's local operator of an element stack as a CSR tensor (the
    library call's operand)."""
    nd = cd.shape[1]
    rows = cd[:, :, None].expand(-1, nd, nd).reshape(-1)
    cols = cd[:, None, :].expand(-1, nd, nd).reshape(-1)
    coo = torch.sparse_coo_tensor(torch.stack([rows, cols]), elems.reshape(-1), (n, n))
    return coo.coalesce().to_sparse_csr()


def halo_kernel_checks(solver, dt, nu, seed: int = 0, timed: bool = False) -> dict:
    """This rank's products between the halo refresh and fold, the kernel
    against its plain version on the same inputs: K14 (K18 on the band
    tables under the band layout) at batch d on A_lhs (of the solver's next
    step) and on M, at batch 1 on Ap.  Inputs: float64 normal draws from
    ``seed`` and the rank on the owned slots (0 elsewhere), cast, then
    refreshed.  Of each product: the kernel's own output against the plain
    version's on every slot before the fold (``raw_rel_err``: the halo
    slots' partial sums are what the fold sends to their owners) and its
    sentinel slot exactly 0 (``sentinel_zero``); after the fold the largest
    error, absolute and relative to the largest output, and whether every
    halo and sentinel slot is exactly 0 (``halo_zero``: the fold's mask,
    which a non-finite value would survive).  On the CPU both sides are the
    plain version.  With ``timed``, the kernel alone on its input in its
    own layout (the ranks one after another): the kernel's, the plain
    version's and the library call's (a CSR product of the local operator)
    ms, and the bytes (operator entries with their columns, input and
    output once) and operations of the bound."""
    from ..assembly.band import BandAssembly
    from ..la import band as lb
    from ..la import ell

    sh, comm, dev, dt_ = solver._halo, solver._comm, solver._device, solver._dtype
    st = solver._state_from_functions()
    A = solver._assemble_first(st["u1"], st["u2"], dt, nu, solver._h_qvals())[0]
    gen = torch.Generator().manual_seed(seed * 1000 + comm.rank)
    ctx, d = solver._ctx, solver._mesh.dim
    out = {}
    for name, E, sp in (("A_lhs", A, "v"), ("M", solver._M_elems, "v"),
                        ("Ap", solver._Ap_elems, "q")):
        hr = sh.rounds_v if sp == "v" else sh.rounds_q
        n = hr.ownmask.shape[0]
        x = torch.randn((d, n) if sp == "v" else (n,), generator=gen, dtype=torch.float64)
        xr = halo_refresh(x.to(dev, dt_) * hr.ownmask, hr, comm)
        vals, asm = solver._op_values(E, sp)
        if isinstance(asm, BandAssembly):
            kname, xk, back = "band_matvec", lb.to_band(xr, asm), lambda y: lb.from_band(y, asm)
            kfn = lambda t: lb.band_matvec(vals, *asm.tables, t)
            pfn = lambda t: lb.band_matvec_plain(vals, *asm.tables, t)
        else:
            kname, xk, back = "ell_matvec", xr, lambda y: y
            kfn = lambda t: ell.ell_matvec(vals, asm.cols, asm.widths, t)
            pfn = lambda t: ell.ell_matvec_plain(vals, asm.cols, t)
        yk, yp = back(kfn(xk)), back(pfn(xk))
        raw = float(torch.max(torch.abs(yk - yp))) / max(float(torch.max(torch.abs(yp))), 1e-300)
        y, ref = halo_fold(yk, hr, comm), halo_fold(yp, hr, comm)
        scale = float(torch.max(torch.abs(ref)))
        err = float(torch.max(torch.abs(y - ref)))
        rec = out[f"{kname} {name}"] = dict(
            rel_err=err / max(scale, 1e-300), max_abs_err=err, max_out=scale, raw_rel_err=raw,
            sentinel_zero=bool(torch.all(yk[..., -1] == 0)),
            halo_zero=bool(torch.all(y[..., hr.ownmask == 0] == 0)), shape=list(x.shape))
        if not timed:
            continue
        isz = xr.element_size()
        nb = x.shape[0] if x.dim() == 2 else 1
        csr = _local_csr(ctx.cd_v if sp == "v" else ctx.cd_q, E, n)
        xt = xr.T.contiguous() if x.dim() == 2 else xr
        times = {}
        for r in range(comm.size):  # one rank at a time on a shared card
            if r == comm.rank:
                times = dict(ms=_device_ms(lambda: kfn(xk), dev),
                             plain_ms=_device_ms(lambda: pfn(xk), dev, reps=5),
                             library_ms=_device_ms(lambda: csr @ xt, dev))
            comm.barrier()
        rec.update(times, bytes=(isz + 4) * asm.nnz + isz * 2 * nb * n,
                   flops=2.0 * asm.nnz * nb)
    return out


def _time_halo(solver, reps: int = 50) -> dict:
    """Host-clock ms of one sum over ranks (one value) and of one halo
    refresh of the velocity (d components) under graph-halo, or of one sum
    of a whole velocity component under the replicated mode (a product's
    sum), each the mean of ``reps``."""
    comm, dev = solver._comm, solver._device
    one = torch.ones(1, dtype=solver._dtype, device=dev)
    u = solver._state_from_functions()["u"]
    second = (("halo_ms", lambda: halo_refresh(u, solver._halo.rounds_v, comm))
              if solver._halo is not None else ("vector_sum_ms", lambda: comm.sum(u[0])))
    out = {}
    for name, fn in (("sum_ms", lambda: comm.sum(one)), second):
        fn()
        comm.barrier()
        _sync(dev)
        t = time.perf_counter()
        for _ in range(reps):
            fn()
        _sync(dev)
        out[name] = (time.perf_counter() - t) * 1e3 / reps
    return out


def _solver(comm: Comm, cfg: dict):
    """(the solver of ``cfg`` on this rank, its device, the set-up
    seconds), with the JAX references the cfg hands in: ``p_cheb`` (the
    Chebyshev bounds) and ``coarse_inv`` (the AMG's coarse inverse)."""
    from .launch import rank_device

    dtype = getattr(torch, cfg.get("dtype", "float64"))
    device = rank_device(comm, cfg.get("device", "cpu"))
    t0 = time.perf_counter()
    solver = halo_solver(cfg, dtype, device, device_mesh=comm)
    setup_s = time.perf_counter() - t0
    if cfg.get("p_cheb") is not None:
        solver._p_cheb = dict(cfg["p_cheb"])
    if cfg.get("coarse_inv") is not None:
        solver._amg.coarse_inv = torch.as_tensor(np.asarray(cfg["coarse_inv"]),
                                                 device=device).to(dtype)
    return solver, device, setup_s


def _canonical(solver) -> dict:
    """Copies of the solver's canonical state Functions, float64 (a later
    step writes the arrays in place)."""
    f = lambda g: np.array(g.x.array.double().cpu().numpy())
    return dict(u=np.stack([f(g) for g in solver._u]), u1=np.stack([f(g) for g in solver._u1]),
                u2=np.stack([f(g) for g in solver._u2]), p=f(solver._p), dp=f(solver._dp))


def _digest(solver) -> str:
    """A hash of the bits of the solver's state Functions on this rank."""
    import hashlib

    h = hashlib.sha256()
    for g in (*solver._u, *solver._u1, *solver._u2, solver._p, solver._dp):
        h.update(g.x.array.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def run_halo(comm: Comm, cfg: dict) -> dict:
    """The general path's solver of ``cfg`` (``halo_solver``'s keys: graph-
    halo, or the replicated mode with ``options`` ``{"replicated": True}``;
    and dtype, device, warmup, steps, dt, nu, check, time_comm, profile as
    ``run_tgv`` takes them; max_iter 1, or ``solve_iter``: the steps as
    ``solve(max_iter=solve_iter)`` calls; time_kernels: the checks'
    products timed; ``p_cheb``: the Chebyshev bounds to use, ``coarse_inv``:
    the AMG's coarse inverse to use; ``split``: one split step after the
    run, ``_split_result``; ``until``: at the end, more steps to this many
    in all, the canonical state after them on rank 0 as ``until``) on this
    rank; card_lock as ``run_tgv`` takes it, from the checks to the
    profile.  Returns its set-up seconds by part, config, traffic, launch
    counts, per-step stats and times, and a digest of its state's bits;
    rank 0 also the canonical state (before the split step) and
    ``get_state``."""
    from ..assembly import kernels as kn

    solver, device, setup_s = _solver(comm, cfg)
    dt, nu = step_size(cfg)
    halo = solver._halo is not None
    res = dict(rank=comm.rank, setup_s=setup_s,
               setup_parts=dict(solver._halo.times) if halo else {},
               config=solver.config_report(), traffic=solver.halo_traffic_report())
    clock = [time.perf_counter()]
    times = res["times"] = {}

    def lap(name):  # host seconds of each part after the set-up
        clock.append(time.perf_counter())
        times[name] = clock[-1] - clock[-2]

    if cfg.get("warmup", 0):
        solver.run(cfg["warmup"], dt, nu, max_iter=1)
    lap("warmup_s")
    with _card_alone(comm, cfg.get("card_lock")):
        lap("card_wait_s")
        if cfg.get("check") and halo:
            res["kernels"] = halo_kernel_checks(solver, dt, nu,
                                                timed=cfg.get("time_kernels", False))
        lap("check_s")
        kn.reset_counts()
        comm.reset_stats()
        comm.barrier()
        _sync(device)
        t0 = time.perf_counter()
        if cfg.get("solve_iter"):
            per = []
            for _ in range(cfg["steps"]):
                solver.solve(dt, nu, max_iter=cfg["solve_iter"])
                per.append(solver.last_stats)
            stats = {k: np.stack([np.asarray(p[k]) for p in per]) for k in per[0]}
        else:
            stats = solver.run(cfg["steps"], dt, nu, max_iter=1)
        _sync(device)
        wall = time.perf_counter() - t0
        res.update(stats=stats, wall_s=wall, steps_per_s=cfg["steps"] / wall,
                   launches={k: v for k, v in kn.launches.items() if v},
                   plain_calls={k: v for k, v in kn.plain_calls.items() if v},
                   comm={k: list(v) for k, v in comm.stats.items()}, digest=_digest(solver))
        out = dict(_canonical(solver), state=solver.get_state())
        lap("steps_and_state_s")
        if comm.rank == 0:
            res.update(out)
        if cfg.get("split"):
            res["split"] = _split_result(comm, solver, dt, nu)
            lap("split_s")
        if cfg.get("time_comm"):
            res.update(_time_halo(solver))
        lap("time_comm_s")
        if cfg.get("profile"):
            res.update(_profile(solver, cfg["profile"], dt, nu))
        lap("profile_s")
    if cfg.get("until"):  # more steps, to this many in all
        more = cfg["until"] - (cfg.get("warmup", 0) + cfg["steps"] + cfg.get("profile", 0))
        if more > 0:
            solver.run(more, dt, nu, max_iter=1)
        if comm.rank == 0:
            res["until"] = _canonical(solver)
        lap("until_s")
    return res


def _split_result(comm: Comm, solver, dt, nu) -> dict:
    """``_split_phases`` on this rank's solver; rank 0 also u (d, n) and ps,
    canonical."""
    comm.barrier()
    res = dict(rank=comm.rank, config=solver.config_report(), **_split_phases(solver, dt, nu))
    if comm.rank == 0:
        f = lambda g: np.array(g.x.array.double().cpu().numpy())
        res.update(u=np.stack([f(g) for g in solver._u]), ps=f(solver._ps))
    return res


def split_step(comm: Comm, cfg: dict) -> dict:
    """One split step under the mesh (``_split_result``) of the solver of
    ``cfg`` (``halo_solver``'s keys, any sharded mode; dtype, device; p_cheb
    and coarse_inv as ``run_halo`` takes them), after ``warmup`` ``run``
    steps; with ``dense``, the dense tentative matrix of that step's
    operator after it (a collective) and its launches.  Returns this rank's
    set-up seconds, config, diff, reasons and iterations and each phase's
    seconds, launches and plain calls; rank 0 also u (d, n) and ps,
    canonical, and the matrix."""
    from ..assembly import kernels as kn

    solver, _, setup_s = _solver(comm, cfg)
    dt, nu = step_size(cfg)
    if cfg.get("warmup", 0):
        solver.run(cfg["warmup"], dt, nu, max_iter=1)
    res = dict(_split_result(comm, solver, dt, nu), setup_s=setup_s)
    if cfg.get("dense"):
        launches = dict(kn.launches)
        A = solver.tentative_matrix_dense()
        res["dense_launches"] = {k: v - launches.get(k, 0) for k, v in kn.launches.items()
                                 if v != launches.get(k, 0)}
        if comm.rank == 0:
            res["dense"] = A
    return res


def halo_ops(comm: Comm, path: str) -> dict:
    """The graph-halo exchange and products on the inputs of ``path`` (an
    .npz: problem "cylinder" with res, or "vessel" with N; yv, yq, xv, xq
    in the stacked local layout; elems_v, elems_q element stacks of every
    cell), in float64 on the CPU: ``halo_refresh`` of xv / xq (owned slots
    set), ``halo_fold`` of yv / yq (any slots set), and refresh -> the
    plain K14 (and K18, on the band tables) on the rank's local operator
    of the element stacks -> fold.  Returns this rank's block of each."""
    from ..assembly.band import band_values, build_band_assembly
    from ..la import band as lb
    from ..la import ell
    from .graph import build_ell_assembly, ell_values

    z = np.load(path)
    cfg = dict(problem=str(z["problem"]), res=int(z["res"]), N=int(z["N"]))
    solver = halo_solver(cfg, torch.float64, "cpu", device_mesh=comm)
    sh = solver._halo
    k = comm.rank
    t = lambda a: torch.as_tensor(np.asarray(a, np.float64))
    blk = lambda a, n: t(a[..., k * n:(k + 1) * n])
    nv, nq = sh.hx_v.nloc, sh.hx_q.nloc
    out = dict(refresh_v=halo_refresh(blk(z["xv"], nv), sh.rounds_v, comm),
               refresh_q=halo_refresh(blk(z["xq"], nq), sh.rounds_q, comm),
               fold_v=halo_fold(blk(z["yv"], nv), sh.rounds_v, comm),
               fold_q=halo_fold(blk(z["yq"], nq), sh.rounds_q, comm))
    for sp, hx, hr, n in (("v", sh.hx_v, sh.rounds_v, nv), ("q", sh.hx_q, sh.rounds_q, nq)):
        cd = sh.ctx.cd_v if sp == "v" else sh.ctx.cd_q
        E = t(z["elems_" + sp][sh.cells])
        x = halo_refresh(blk(z["x" + sp], n), hr, comm)
        ea = build_ell_assembly(cd.numpy(), n, "cpu")
        out["ell_" + sp] = halo_fold(ell.ell_matvec_plain(ell_values(E, ea), ea.cols, x), hr, comm)
        ba = build_band_assembly(cd.numpy(), n, "cpu")
        yb = lb.band_matvec_plain(band_values(E, ba), *ba.tables, lb.to_band(x, ba))
        out["band_" + sp] = halo_fold(lb.from_band(yb, ba), hr, comm)
    return {key: v.numpy() for key, v in out.items()}


def halo_checks(comm: Comm, path: str | None, cfgs: list, splits=()) -> dict:
    """``halo_ops`` (with a ``path``), ``run_halo`` of each of ``cfgs`` and
    ``split_step`` of each of ``splits`` in one group, and whether this
    process imported anything of JAX."""
    out = dict(runs=[run_halo(comm, c) for c in cfgs], splits=[split_step(comm, c) for c in splits],
               jax_free=_jax_free())
    if path is not None:
        out["ops"] = halo_ops(comm, path)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="bench.py's problem on the sharded solver")
    ap.add_argument("--problem", default="box", choices=("box", "vessel", "cylinder"),
                    help="box: bench.py's structured problem (the slab path); vessel: its "
                         "unstructured one, cylinder: the DFG channel with its outlet (the "
                         "graph-halo path, or the replicated mode with --replicated)")
    ap.add_argument("-N", type=int, default=16)
    ap.add_argument("--res", type=int, default=30, help="the cylinder's resolution")
    ap.add_argument("--replicated", action="store_true",
                    help="options['replicated'] (the vessel and the cylinder)")
    ap.add_argument("--split", action="store_true",
                    help="after the warm-up steps, one step of the split-phase API in place "
                         "of the timed steps")
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
    fn = run_tgv
    if a.problem != "box" or a.split:
        fn = split_step if a.split else run_halo
        cfg.update(problem=a.problem, res=a.res)
        if a.replicated:
            cfg["options"] = {"replicated": True}
    if "RANK" in os.environ:  # under torchrun
        from .launch import run_env

        res = [run_env(fn, (cfg,), backend=a.backend)]
        if res[0]["rank"] != 0:
            return 0
    else:
        from .launch import launch

        backend = a.backend or ("nccl" if a.device == "cuda" and
                                torch.cuda.device_count() >= a.world > 1 else "gloo")
        res = launch(fn, a.world, (cfg,), backend=backend)
    r = res[0]
    head = dict(problem=a.problem, N=a.N, res=a.res, sharding=r["config"]["sharding"],
                world=r["config"]["ndev"], backend=r["config"]["backend"], setup_s=r["setup_s"])
    if a.split:
        print(json.dumps(dict(head, diff=r["diff"], reasons={k: np.asarray(v).tolist() for k, v in
                                                             r["reasons"].items()},
                              phases=r["phases"])))
        return 0
    if "digest" in r:  # every rank's state bits rank 0's (under the launcher, which has them all)
        head["same_bits"] = len({o["digest"] for o in res}) == 1
    print(json.dumps(dict(
        head, steps_per_s=r["steps_per_s"], iters=iters_per_step(r["stats"]), comm=r["comm"],
        **{k: r[k] for k in ("sum_ms", "halo_ms", "vector_sum_ms") if k in r},
        traffic=r["traffic"])))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
