"""Taylor-Green vortex at Re=1600 through the dissipation peak on the port
(the JAX package's scripts/fidelity_tgv.py).

The standard Taylor-Green field (u = (sin x cos y cos z, -cos x sin y
cos z, 0), nu = 1/1600) on the symmetry sub-box [0, pi]^3, whose faces
are free-slip planes of the flow: each face is tagged by its normal (1 x,
2 y, 3 z) and velocity component g is held at 0 on the faces of tag g + 1
only (Dirichlet rows a component), the tangential components left to the
weak form's natural condition.  P2/P1, rtol 1e-6 and at most 2000
iterations on all three solve families, ``max_iter=1``: the structured path
(K8, K5, K3, K6, K2, K7, K1, K4 and the W build every step on the card).

The kinetic energy E(t) = 1/2 sum_g u_g^T M u_g / pi^3 (M the consistent
mass, applied by K5 at batch 3 on the card) is taken by ``run``'s
``step_callback`` on the device and read once a ``--window`` of steps; the
dissipation eps = -dE/dt by central differences (one-sided at the ends),
its peak read after a 9-point moving average.  Prints one JSON line with
the JAX script's keys (``platform``: the card's name, or "cpu") and the
steps a second, iterations and worst exit residuals of the run; writes t,
E, eps and meta to ``--out`` (default under the repository's git-ignored
``build/``).  ``--compare PATH`` holds the run against one of the
repository's curves (``fidelity_tgv_N32_f64.npz``, ...): max |dE| over the
times both cover, and both curves' smoothed peak eps and its time.

Usage:
    python -m oasisx_tpu_torch.demo.fidelity_tgv [-N 32] [--dt 0.01]
        [--T 10] [--window 100] [--out PATH] [--compare PATH]
        [--device cuda] [--dtype float32]
"""

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

from oasisx_tpu_torch import DirichletBC, FractionalStep_AB_CN, LocatorMethod
from oasisx_tpu_torch.assembly import kernels as kn
from oasisx_tpu_torch.main import add_device_args
from oasisx_tpu_torch.meshes import create_box, meshtags

L = np.pi
NU = 1.0 / 1600.0
SMOOTH = 9  # points of the moving average before the peak read-off (FIDELITY.md)
PUBLISHED_PEAK = "0.0122-0.0126 at t~9.0 (van Rees et al. 2011, 512^3 spectral)"
BUILD = Path(__file__).resolve().parents[2] / "build"


def build_solver(N, dtype, device, rtol=1e-6):
    """The sub-box problem at N cells an axis with the Taylor-Green field
    in u1 and u2."""
    mesh = create_box((0.0, 0.0, 0.0), (L, L, L), (N, N, N))
    facets = mesh.exterior_facet_indices()
    mids = mesh.midpoints(mesh.dim - 1, facets)
    vals = np.zeros(len(facets), dtype=np.int32)
    on = lambda a: np.isclose(mids[:, a], 0.0, atol=1e-10) | np.isclose(mids[:, a], L, atol=1e-10)
    for axis in range(3):
        vals[(vals == 0) & on(axis)] = axis + 1
    assert (vals > 0).all()
    tags = meshtags(mesh, mesh.dim - 1, facets, vals)
    # free-slip symmetry planes: the normal component 0 only
    bcs_u = [[DirichletBC(0.0, LocatorMethod.TOPOLOGICAL, (tags, g + 1))] for g in range(3)]
    solver = FractionalStep_AB_CN(
        mesh, ("Lagrange", 2), ("Lagrange", 1), bcs_u, [],
        solver_options={k: {"ksp_rtol": rtol, "ksp_max_it": 2000}
                        for k in ("tentative", "pressure", "scalar")},
        dtype=dtype, device=device,
    )
    fields = (
        lambda x: np.sin(x[0]) * np.cos(x[1]) * np.cos(x[2]),
        lambda x: -np.cos(x[0]) * np.sin(x[1]) * np.cos(x[2]),
        lambda x: np.zeros_like(x[0]),
    )
    for f, u1, u2 in zip(fields, solver._u1, solver._u2):
        u1.interpolate(f)
        u2.interpolate(f)
    return solver


def energy_fn(solver):
    """u (3, npad) on the structured grid -> E = 1/2 sum_g u_g^T M u_g / |O|,
    a 0-d tensor on the solver's device (M by K5 at batch 3 on the card)."""
    if not solver._structured:
        raise ValueError("the energy is taken on the structured path's grid")
    cu, sm_v, vol = solver._cu, solver._sm_v, solver._vol
    return lambda u: 0.5 * torch.sum(u * kn.matvec_const(u, cu.M_c, sm_v)) / vol


def dissipation(E, dt):
    """eps = -dE/dt: central differences inside, one-sided at the ends."""
    eps = np.empty_like(E)
    eps[1:-1] = -(E[2:] - E[:-2]) / (2 * dt)
    eps[0] = -(E[1] - E[0]) / dt
    eps[-1] = -(E[-1] - E[-2]) / dt
    return eps


def smoothed_peak(t, eps, width=SMOOTH):
    """(peak, t_peak) of eps after a centred moving average of ``width``
    points, or of all of them on a shorter curve (the ends, where the window
    does not fit, are left out)."""
    width = min(width, len(eps))
    s = np.convolve(eps, np.ones(width) / width, mode="valid")
    i = int(np.argmax(s))
    return float(s[i]), float(t[i + width // 2])


def compare(t, E, eps, ref_path):
    """The run (t, E, eps) against the curve in ``ref_path`` (keys t, E,
    eps): max |E - E_ref| over the times both cover (E_ref interpolated
    onto the run's times), and both smoothed peaks."""
    ref = np.load(ref_path)
    sel = t <= ref["t"][-1] + 1e-9
    dE = np.abs(E[sel] - np.interp(t[sel], ref["t"], ref["E"]))
    peak, t_peak = smoothed_peak(t, eps)
    rpeak, rt_peak = smoothed_peak(ref["t"], ref["eps"])
    return {
        "reference": str(ref_path), "max_abs_dE": float(dE.max()),
        "t_max_abs_dE": float(t[sel][int(np.argmax(dE))]),
        "peak_smoothed": peak, "t_peak_smoothed": t_peak,
        "ref_peak_smoothed": rpeak, "ref_t_peak_smoothed": rt_peak,
        "peak_rel_diff": (peak - rpeak) / rpeak,
    }


def main(argv=None):
    ap = argparse.ArgumentParser(formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    ap.add_argument("-N", type=int, default=32)
    ap.add_argument("--dt", type=float, default=0.01)
    ap.add_argument("--T", type=float, default=10.0)
    ap.add_argument("--window", type=int, default=100, help="steps a run() call")
    ap.add_argument("--out", type=str, default=None,
                    help="npz of t, E, eps, meta (default build/fidelity_tgv_N<N>_<dtype>.npz)")
    ap.add_argument("--compare", type=str, default=None, metavar="PATH",
                    help="a curve (npz of t, E, eps) to hold the run against")
    add_device_args(ap)
    args = ap.parse_args(argv)

    N, dt = args.N, args.dt
    solver = build_solver(N, args.dtype, args.device)
    energy = energy_fn(solver)
    st0 = solver._state_from_functions()
    E = [float(energy(st0["u1"]))]
    nsteps = int(round(args.T / dt))
    stats = {k: [] for k in ("u_iters", "p_iters", "c_iters", "u_res", "p_res", "c_res")}
    t0 = time.perf_counter()
    done = 0
    # one callback for the whole run: run's graph is keyed by its identity
    callback = lambda s, t: energy(s["u"])  # noqa: E731
    while done < nsteps:
        n = min(args.window, nsteps - done)
        st = solver.run(n, dt, NU, max_iter=1, step_callback=callback, t0=done * dt)
        E.extend(np.asarray(st["callback"], dtype=np.float64).tolist())
        for k in stats:
            stats[k].append(st[k])
        done += n
        el = time.perf_counter() - t0
        print(f"t={done * dt:6.2f}  E={E[-1]:.6f}  [{el:6.1f}s, {el / done * 1e3:.1f} ms/step]",
              file=sys.stderr, flush=True)
        if not np.isfinite(E[-1]):
            raise RuntimeError(f"the energy is not finite at t={done * dt}")
    wall = time.perf_counter() - t0
    st = {k: np.concatenate(v) for k, v in stats.items()}

    E = np.asarray(E)
    times = np.arange(len(E)) * dt
    eps = dissipation(E, dt)
    ipk = int(np.argmax(eps))
    dev = solver._device
    out = {
        "N": N, "dt": dt, "dtype": str(solver._dtype).replace("torch.", ""),
        "platform": torch.cuda.get_device_name(dev) if dev.type == "cuda" else dev.type,
        "E0": float(E[0]), "peak_dissipation": float(eps[ipk]), "t_peak": float(times[ipk]),
        "published_peak": PUBLISHED_PEAK,
        "steps": nsteps, "wall_s": wall, "steps_per_s": nsteps / wall,
        "velocity_dofs": 3 * solver._Vi[0][0].num_dofs,
        "mean_iters": {f: float(st[f"{f}_iters"].sum(axis=-1).mean()) if st[f"{f}_iters"].ndim > 1
                       else float(st[f"{f}_iters"].mean()) for f in ("u", "p", "c")},
        "max_iters": {f: int(st[f"{f}_iters"].max()) for f in ("u", "p", "c")},
        "worst_exit_res": {f: float(st[f"{f}_res"].max()) for f in ("u", "p", "c")},
    }
    if args.compare:
        out["compare"] = compare(times, E, eps, args.compare)
    path = Path(args.out) if args.out else BUILD / f"fidelity_tgv_N{N}_{out['dtype']}.npz"
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez(path, t=times, E=E, eps=eps, meta=json.dumps(out))
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
