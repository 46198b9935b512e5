#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

1. Card: requires torch.cuda; prints the device and nvidia-smi's name and
   power limit.
2. Build: compiles the CUDA kernels of oasisx_tpu_torch/csrc (first use).
3. Kernels: at the bench shapes (3D Taylor-Green, N=36, P2/P1) each
   kernel against its plain PyTorch version, in float64 and float32, both
   timed with CUDA events.  The cube operators (K5, K3, K6, K7) on random
   data, max relative error 1e-12 (f64) and 1e-5 (f32), padded outputs
   exactly 0; the cube gather (K8) on the Taylor-Green initial uab, equal.
   The whole solves on the main path's systems: the mass CG (K4) on M_c
   with a random rhs, the MG pressure CG (K1) on Ap_c with a demeaned
   random rhs and its 3-level MG, the BiCGStab (K2) on the W of the
   Taylor-Green initial state with the mesh's bc rows; x to 1e-10 relative
   with equal iteration counts in f64 (rtol 1e-8), to 10 rtol with
   iterations within 1 per row in f32 (rtol 1e-5), and a second kernel
   call bit-identical to the first.  The plain solves loop on the host
   with their operators on the cube kernels' plain versions.
4. Main path: the 3D Taylor-Green IPCS solver at N=36 (1,167,051 velocity
   dofs) in float32 on the card, bench settings (dt 2e-3, nu 1/1600, rtol
   1e-5, max_iter 1): 5 warm-up steps, then 25 timed steps with every
   launch counter reset before them.  Velocity finite, every solve
   converged, every kernel launched, no plain version called, no host
   read inside a step (host_syncs 0).
5. GPU against CPU: N=6 in float64, 3 steps from the same state on cuda
   and on cpu; u and p agree to 1e-10 relative with equal iteration counts.

Prints the kernels' JSON line (per kernel: "ms", "plain_ms" and
"max_abs_err" of one call at its first case's shape, named in "case", and
every case under "cases"), the nvidia-smi line, and last
{"ok": true, "device": {...}}.  Exits non-zero, with no result line, on
any failure or when there is no card.

--profile N adds a torch.profiler window of N more steps after phase 4:
device time by kernel, the device's busy share of the window, and a
Chrome trace in build/chip_smoke_trace.json.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

TPU_ERA_ITERS = {"u": 0.88, "p": 5.0, "c": 2.2266666666666666}  # BENCH_r05.json
REPLACES = {
    "matvec_const": "oasisx_tpu/assembly/pallas_ops.py:2019",  # make_matvec_pf (K5)
    "matvec_win": "oasisx_tpu/assembly/pallas_ops.py:1949",  # make_matvec_win (K3)
    "mixed": "oasisx_tpu/assembly/pallas_ops.py:1862",  # make_mixed_pf (K6)
    "divergence": "oasisx_tpu/assembly/pallas_ops.py:1906",  # make_divergence_pf (K7)
    "cube_gather": "oasisx_tpu/assembly/pallas_ops.py:524",  # make_gather (K8)
    "cg_mass": "oasisx_tpu/assembly/pallas_ops.py:1770",  # make_cg_iter_pf (K4)
    "bicgstab": "oasisx_tpu/assembly/pallas_ops.py:1058",  # make_bicgstab_iter (K2)
    "pressure_mg": "oasisx_tpu/assembly/pallas_ops.py:128",  # make_pressure_cg (K1)
}
SOURCE = {name: "oasisx_tpu_torch/csrc/cube_ops.cu" for name in REPLACES}
SOURCE.update(dict.fromkeys(("cg_mass", "bicgstab", "pressure_mg"),
                            "oasisx_tpu_torch/csrc/krylov_ops.cu"))
SOLVE_RTOL = {"float64": 1e-8, "float32": 1e-5}
DT, NU = 2e-3, 1.0 / 1600.0
N, WARMUP, STEPS = 36, 5, 25  # bench.py's size; steps timed after the warm-up


class SmokeError(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeError(msg)


def tgv_solver(N: int, dtype, device, rtol: float):
    """The bench problem (bench.py build_solver) on the port."""
    import numpy as np

    from oasisx_tpu_torch import DirichletBC, FractionalStep_AB_CN, LocatorMethod
    from oasisx_tpu_torch.meshes import create_box, meshtags

    mesh = create_box((-1.0, -1.0, -1.0), (1.0, 1.0, 1.0), (N, N, N))
    facets = mesh.exterior_facet_indices()
    tags = meshtags(mesh, mesh.dim - 1, facets, np.full_like(facets, 1))
    fs = (
        lambda x: np.sin(np.pi * x[0]) * np.cos(np.pi * x[1]) * np.cos(np.pi * x[2]),
        lambda x: -np.cos(np.pi * x[0]) * np.sin(np.pi * x[1]) * np.cos(np.pi * x[2]),
        lambda x: np.zeros_like(x[0]),
    )
    bcs_u = [[DirichletBC(f, LocatorMethod.TOPOLOGICAL, (tags, 1))] for f in fs]
    opts = {"ksp_rtol": rtol, "ksp_max_it": 2000}
    solver = FractionalStep_AB_CN(
        mesh, ("Lagrange", 2), ("Lagrange", 1), bcs_u=bcs_u, bcs_p=[],
        solver_options={"tentative": dict(opts), "pressure": dict(opts), "scalar": dict(opts)},
        dtype=dtype, device=device,
    )
    for f, u1, u2 in zip(fs, solver._u1, solver._u2):
        u1.interpolate(f)
        u2.interpolate(f)
    return solver


def _sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def time_ms(fn, device, reps: int = 20, warmup: int = 3) -> float:
    """Mean time per call: CUDA events on the card, the host clock on CPU."""
    import torch

    for _ in range(warmup):
        fn()
    if torch.device(device).type == "cuda":
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(reps):
            fn()
        t1.record()
        torch.cuda.synchronize()
        return t0.elapsed_time(t1) / reps
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t) * 1e3 / reps


def kernel_cases(solver, dtype, device, seed: int = 0):
    """(kernel, label, kernel call, plain call, padded-output mask) at the
    solver's shapes, on random inputs made from ``seed``."""
    import numpy as np
    import torch

    from oasisx_tpu_torch.assembly import cubes as cub
    from oasisx_tpu_torch.assembly import kernels as kn

    cu, sm_v, sm_q = solver._cu, solver._sm_v, solver._sm_q
    d = solver._mesh.dim
    g = torch.Generator().manual_seed(seed)
    rnd = lambda *shape: torch.randn(*shape, generator=g, dtype=torch.float64).to(device, dtype)
    valid_v = (solver._pv(torch.ones(solver._gf_v.shape[0], device=device)) != 0)
    valid_q = (solver._pq(torch.ones(solver._gf_q.shape[0], device=device)) != 0)
    c = lambda t: t.to(device, dtype).contiguous()
    xv = rnd(d, solver._npad_v) * valid_v
    xq = rnd(solver._npad_q) * valid_q
    nl = cub.num_slots(sm_v)
    W = rnd(nl * nl, int(np.prod(sm_v[1])))
    M_c, Ap_c, B_c, G_c = c(cu.M_c), c(cu.Ap_c), c(cu.B_c), c(cu.G_c)
    st = solver._state_from_functions()
    uab = c(1.5 * st["u1"] - 0.5 * st["u2"])
    all_valid = torch.ones(d, nl, int(np.prod(sm_v[1])), dtype=torch.bool, device=device)
    return [
        ("cube_gather", "TGV uab",
         lambda: kn.cube_gather(uab, sm_v), lambda: kn.cube_gather_plain(uab, sm_v), all_valid),
        ("matvec_const", "M_c batch 3",
         lambda: kn.matvec_const(xv, M_c, sm_v), lambda: kn.matvec_const_plain(xv, M_c, sm_v),
         valid_v),
        ("matvec_const", "Ap_c batch 1",
         lambda: kn.matvec_const(xq[None], Ap_c, sm_q),
         lambda: kn.matvec_const_plain(xq[None], Ap_c, sm_q), valid_q),
        ("matvec_win", "W batch 3",
         lambda: kn.matvec_win(W, xv, sm_v), lambda: kn.matvec_win_plain(W, xv, sm_v), valid_v),
        ("mixed", "B_c",
         lambda: kn.mixed(xq, B_c, sm_v, sm_q), lambda: kn.mixed_plain(xq, B_c, sm_v, sm_q),
         valid_v),
        ("mixed", "G_c",
         lambda: kn.mixed(xq, G_c, sm_v, sm_q), lambda: kn.mixed_plain(xq, G_c, sm_v, sm_q),
         valid_v),
        ("divergence", "B_c",
         lambda: kn.divergence(xv, B_c, sm_v, sm_q),
         lambda: kn.divergence_plain(xv, B_c, sm_v, sm_q), valid_q),
    ]


def compare_kernels(solver, device) -> dict:
    """Phase 3: every kernel against its plain version in f64 and f32.

    Returns, per kernel, a list of its cases in float32, each with its own
    max abs error and its time per call (kernel and plain version) at that
    one shape."""
    import torch

    tols = {torch.float64: 1e-12, torch.float32: 1e-5}
    out: dict = {}
    for dtype, tol in tols.items():
        for name, label, kfn, pfn, valid in kernel_cases(solver, dtype, device):
            yk = kfn()
            yp = pfn()
            _sync(device)
            scale = float(yp.abs().max())
            err = float((yk - yp).abs().max())
            rel = err / max(scale, 1e-300)
            pad_zero = bool((yk[..., ~valid] == 0).all())
            tag = str(dtype).replace("torch.", "")
            print(f"  {name:13s} {label:13s} {tag}: max abs err {err:.3e}, rel {rel:.3e}"
                  f" (tol {tol:g}), padding zero: {pad_zero}")
            check(rel <= tol, f"{name} ({label}, {tag}) disagrees: rel err {rel:.3e}")
            check(pad_zero, f"{name} ({label}, {tag}) wrote non-zero padding")
            if dtype != torch.float32:
                continue
            # one call at the main path's shape; plain, kernel, kernel, plain
            p1 = time_ms(pfn, device)
            k1 = time_ms(kfn, device)
            k2 = time_ms(kfn, device)
            p2 = time_ms(pfn, device)
            print(f"    {label}: kernel {k1:.4f} / {k2:.4f} ms, plain {p1:.4f} / {p2:.4f} ms")
            out.setdefault(name, []).append(
                {"case": label, "max_abs_err": err, "ms": min(k1, k2), "plain_ms": min(p1, p2)})
    return out


def solve_cases(solver, device, seed: int = 1):
    """(kernel, label, kernel solve, plain solve) on the main path's systems
    of ``solver`` (its dtype), each returning a KrylovResult."""
    import numpy as np
    import torch

    from oasisx_tpu_torch.assembly import kernels as kn
    from oasisx_tpu_torch.la import fused
    from oasisx_tpu_torch.la.pressure_mg import PressureMGCG

    dtype = solver._dtype
    rtol = SOLVE_RTOL[str(dtype).replace("torch.", "")]
    cu, sm_v, sm_q = solver._cu, solver._sm_v, solver._sm_q
    d, maxiter = solver._mesh.dim, 2000
    g = torch.Generator().manual_seed(seed)
    rnd = lambda *shape: torch.randn(*shape, generator=g, dtype=torch.float64).to(device, dtype)
    valid_v = (solver._pv(torch.ones(solver._gf_v.shape[0], device=device)) != 0)

    # K4: M x = b, x0 = 0 (so r0 = b)
    b = rnd(d, solver._npad_v) * valid_v
    x0 = torch.zeros_like(b)
    bn = torch.linalg.vector_norm(b, dim=-1)
    mass = lambda v: kn.matvec_const_plain(v, cu.M_c, sm_v)

    # K1: Ap x = b - mean(b), x0 = 0, the solver's MG hierarchy
    Ap64 = cu.Ap_c.detach().cpu().double().numpy()
    diag = solver._Ap_diag.detach().cpu().double().numpy()
    invd = np.where(diag != 0, 1.0 / np.where(diag != 0, diag, 1.0), 1.0)
    pcg = PressureMGCG(sm_q, cu.Ap_c, invd, kn.build_pressure_mg_data(sm_q, Ap64), rtol, maxiter)
    bq = rnd(solver._npad_q)
    bq = bq - bq.mean()
    xq = torch.zeros_like(bq)

    # K2: the first tentative solve from the Taylor-Green initial state
    st = solver._state_from_functions()
    u1, u2 = st["u1"], st["u2"]
    W, uq, b_first = solver._assemble_first(u1, u2, DT, NU)
    tdiag = solver._tentative_diag(uq, DT, NU)
    bc, masks, zmask = solver._bc_values(), solver._bc_masks, solver._zmask
    rhs = torch.where(masks, bc, b_first)
    tx0 = torch.where(masks, bc, 2.0 * u1 - u2)
    r0 = zmask * (rhs - kn.matvec_win(W, tx0, sm_v))
    tbn = torch.linalg.vector_norm(rhs, dim=-1)
    tinvd = torch.where(tdiag != 0, 1.0 / tdiag, 1.0)
    win = lambda v: kn.matvec_win_plain(W, v, sm_v)
    return rtol, [
        ("cg_mass", "M_c, random rhs",
         lambda: fused.cg_mass(cu.M_c, b, x0, solver._M_invd, bn, sm_v, rtol, maxiter),
         lambda: fused.cg_from_r0(mass, b, x0, solver._M_invd, bn, rtol, maxiter)),
        ("pressure_mg", f"Ap_c, {len(pcg.levels)} levels",
         lambda: pcg.solve(bq, xq),
         lambda: pcg.solve_plain(bq, xq, matvec=kn.matvec_const_plain)),
        ("bicgstab", "TGV first step",
         lambda: fused.bicgstab(W, r0, tx0, zmask, tinvd, tbn, sm_v, rtol, maxiter),
         lambda: fused.bicgstab_from_r0(win, r0, tx0, zmask, tinvd, tbn, rtol, maxiter)),
    ]


def compare_solves(solvers: dict, device) -> dict:
    """Phase 3, whole solves: each kernel against its plain host-loop
    version, per dtype; f32 cases timed.  Returns per kernel its f32 case."""
    import numpy as np
    import torch

    out: dict = {}
    for tag, solver in solvers.items():
        rtol, cases = solve_cases(solver, device)
        for name, label, kfn, pfn in cases:
            rk, rk2, rp = kfn(), kfn(), pfn()
            _sync(device)
            err = float((rk.x - rp.x).abs().max())
            rel = err / max(float(rp.x.abs().max()), 1e-300)
            ik = np.atleast_1d(rk.iters.cpu().numpy())
            ip = np.atleast_1d(rp.iters.cpu().numpy())
            same = bool(torch.equal(rk.x, rk2.x) and torch.equal(rk.iters, rk2.iters))
            tol = 1e-10 if tag == "float64" else 10 * rtol
            print(f"  {name:13s} {label:18s} {tag}: x rel err {rel:.3e} (tol {tol:g}), iterations"
                  f" kernel {ik.tolist()} plain {ip.tolist()}, repeat bit-identical: {same}")
            check(bool(rk.converged.all()) and bool(rp.converged.all()),
                  f"{name} ({tag}) did not converge")
            check(rel <= tol, f"{name} ({tag}) disagrees: rel err {rel:.3e}")
            if tag == "float64":
                check(np.array_equal(ik, ip), f"{name} (f64) iterations differ: {ik} {ip}")
            else:
                check(np.abs(ik - ip).max() <= 1, f"{name} (f32) iterations differ: {ik} {ip}")
            check(same, f"{name} ({tag}): a second kernel call differs from the first")
            if tag != "float32":
                continue
            p1 = time_ms(pfn, device, reps=3, warmup=1)
            k1 = time_ms(kfn, device, reps=10)
            k2 = time_ms(kfn, device, reps=10)
            p2 = time_ms(pfn, device, reps=3, warmup=1)
            print(f"    {label}: kernel {k1:.4f} / {k2:.4f} ms, plain {p1:.4f} / {p2:.4f} ms,"
                  f" {int(ik.sum())} iterations")
            out[name] = [{"case": label, "max_abs_err": err, "ms": min(k1, k2),
                          "plain_ms": min(p1, p2), "iters": ik.tolist()}]
    return out


def drive_main_path(solver, warmup: int, steps: int, device) -> dict:
    """Phase 4: warm-up steps, reset counters, timed steps; returns stats."""
    import numpy as np
    import torch

    from oasisx_tpu_torch.assembly import kernels as kn

    solver.run(warmup, DT, NU, max_iter=1)
    _sync(device)
    kn.reset_counts()
    t0 = time.perf_counter()
    stats = solver.run(steps, DT, NU, max_iter=1)
    _sync(device)
    wall = time.perf_counter() - t0
    launches = dict(kn.launches)
    plain = dict(kn.plain_calls)
    u = np.stack([f.x.array.detach().cpu().numpy() for f in solver._u])
    check(np.isfinite(u).all(), "velocity is not finite")
    for fam in ("u", "p", "c"):
        check(bool(np.all(stats[f"{fam}_converged"])), f"a {fam} solve did not converge")
    for name in kn.KERNELS:
        check(launches[name] > 0, f"kernel {name} was not launched on the main path")
        check(plain[name] == 0, f"plain {name} ran on the main path ({plain[name]} calls)")
    if torch.device(device).type == "cuda":
        check(bool(np.all(stats["host_syncs"] == 0)),
              f"host reads inside the steps: {stats['host_syncs'].tolist()}")
    return dict(stats=stats, wall=wall, launches=launches, plain=plain)


def profile_steps(solver, steps: int, path: str) -> None:
    """torch.profiler over ``steps`` more main-path steps."""
    import os

    import torch
    from torch.profiler import ProfilerActivity, profile

    _sync("cuda")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        solver.run(steps, DT, NU, max_iter=1)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    from torch.autograd import DeviceType

    # device-side events only: a CPU op's device time repeats its kernels'
    ka = prof.key_averages()
    dev = sorted((e for e in ka if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0),
                 key=lambda e: -e.self_device_time_total)
    busy = sum(e.self_device_time_total for e in dev)
    count = sum(e.count for e in dev)
    print(f"  profile: {steps} steps, wall {wall_us / 1e3:.3f} ms, device busy "
          f"{busy / 1e3:.3f} ms ({100 * busy / wall_us:.1f}%), idle {100 - 100 * busy / wall_us:.1f}%, "
          f"{count / steps:.1f} device kernels a step")
    for e in dev[:15]:
        print(f"    {e.self_device_time_total / 1e3:9.3f} ms {e.count:7d} x  {e.key[:90]}")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    prof.export_chrome_trace(path)


def gpu_vs_cpu(N: int = 6, steps: int = 3) -> None:
    """Phase 5: the port on cuda and on cpu from the same state, float64."""
    import numpy as np
    import torch

    runs = {}
    for dev in ("cuda", "cpu"):
        s = tgv_solver(N, torch.float64, dev, rtol=1e-8)
        st = s.run(steps, DT, NU, max_iter=1)
        u = np.stack([f.x.array.detach().cpu().numpy() for f in s._u])
        p = s._p.x.array.detach().cpu().numpy()
        runs[dev] = (u, p, st)
    (ug, pg, sg), (uc, pc, sc) = runs["cuda"], runs["cpu"]
    du = np.abs(ug - uc).max() / np.abs(uc).max()
    dp = np.abs(pg - pc).max() / np.abs(pc).max()
    print(f"  N={N} f64 {steps} steps: u rel diff {du:.3e}, p rel diff {dp:.3e}")
    for k in ("u_iters", "p_iters", "c_iters"):
        print(f"  {k}: cuda {sg[k].tolist()} cpu {sc[k].tolist()}")
        check(np.array_equal(sg[k], sc[k]), f"{k} differ between cuda and cpu")
    check(du <= 1e-10 and dp <= 1e-10, f"cuda and cpu disagree (u {du:.3e}, p {dp:.3e})")


def nvidia_smi() -> str:
    try:
        r = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
        return r.stdout.strip().splitlines()[0] if r.returncode == 0 and r.stdout.strip() else "not available"
    except (OSError, subprocess.TimeoutExpired):
        return "not available"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", type=int, default=0, metavar="STEPS",
                    help="profile this many more steps after the main path")
    args = ap.parse_args()

    import torch

    # 1. card
    check(torch.cuda.is_available(), "no CUDA device (torch.cuda.is_available() is false)")
    try:
        import oasisx_tpu_torch  # noqa: F401
        from oasisx_tpu_torch import _build
        from oasisx_tpu_torch.assembly import kernels as kn
    except ImportError as e:
        raise SmokeError(f"oasisx_tpu_torch not importable; run from a checkout ({e})")
    check("jax" not in sys.modules, "jax was imported")
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    print(f"[1] card: {kind}; nvidia-smi: {smi}; torch {torch.__version__} cuda {torch.version.cuda}")

    # 2. build
    t0 = time.perf_counter()
    _build.library()
    print(f"[2] build: {time.perf_counter() - t0:.1f} s (nvcc {_build.build_seconds})")
    if _build.build_log.strip():
        print(_build.build_log.strip())

    # 4a. main-path setup (its shapes feed phase 3)
    t0 = time.perf_counter()
    solver = tgv_solver(N, torch.float32, "cuda", rtol=1e-5)
    _sync("cuda")
    setup_s = time.perf_counter() - t0
    nvel = 3 * solver._Vi[0][0].num_dofs
    print(f"[4] setup N={N}: {setup_s:.1f} s, {nvel} velocity dofs")

    # 3. kernels against their plain versions
    print(f"[3] kernels against plain versions (N={N} shapes)")
    kres = compare_kernels(solver, "cuda")
    solver64 = tgv_solver(N, torch.float64, "cuda", rtol=SOLVE_RTOL["float64"])
    kres.update(compare_solves({"float64": solver64, "float32": solver}, "cuda"))
    del solver64

    # 4b. main path
    res = drive_main_path(solver, WARMUP, STEPS, "cuda")
    st = res["stats"]
    sps = STEPS / res["wall"]
    mean = lambda k: float(st[k].sum(axis=-1).mean()) if st[k].ndim > 1 else float(st[k].mean())
    print(f"[4] main path: {STEPS} steps in {res['wall']:.3f} s = {sps:.4f} steps/s "
          f"({nvel * sps / 1e6:.3f} MDOF-updates/s) on {smi}")
    print(f"    per step mean iterations (summed over components): u {mean('u_iters'):.3f} "
          f"p {mean('p_iters'):.3f} c {mean('c_iters'):.3f}; TPU-era reference "
          f"(BENCH_r05.json, per-component means): {TPU_ERA_ITERS}")
    print(f"    per-component means: u {float(st['u_iters'].mean()):.3f} "
          f"c {float(st['c_iters'].mean()):.3f}")
    print(f"    worst exit residuals: u {float(st['u_res'].max()):.3e} "
          f"p {float(st['p_res'].max()):.3e} c {float(st['c_res'].max()):.3e}")
    print(f"    host syncs per step: {float(st['host_syncs'].mean()):.2f} in the steps "
          f"(+1 stats read per run call); "
          f"launches {res['launches']} ({sum(res['launches'].values()) / STEPS:.2f} a step); "
          f"plain calls {res['plain']}")

    if args.profile:
        profile_steps(solver, args.profile, "build/chip_smoke_trace.json")

    # 5. GPU against CPU
    print("[5] cuda against cpu")
    gpu_vs_cpu()

    # per kernel: its first case's numbers, and every case under "cases"
    kernels = [
        {"name": n, "route": "cuda", "source": SOURCE[n], "replaces": REPLACES[n],
         "launches": res["launches"][n], **kres[n][0], "cases": kres[n]}
        for n in kn.KERNELS
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeError as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        sys.exit(1)
