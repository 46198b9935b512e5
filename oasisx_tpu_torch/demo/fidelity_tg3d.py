"""3D Taylor-Green kinetic-energy decay on the card in float32 against the
CPU in float64 (the JAX package's scripts/fidelity_tg3d.py on the port).

The bench problem (bench.py's ``build_solver``: the box [-1, 1]^3 with the
Taylor-Green field held on every face, rtol 1e-6) at N cells an axis, dt
2e-3, nu 1/1600, ``--steps`` steps with the kinetic energy after every
``--chunk`` (``fidelity_tgv.energy_fn``: 1/2 sum_g u_g^T M u_g / |O|).  It
runs twice, the same configuration: in float32 on ``--device`` (default
the card) and in float64 on the CPU through the port's plain versions.
Prints one JSON line: the largest |E_f32 - E_f64| / E_f64(0) over the
readings, both runs' wall time (set-up excluded) and the device; writes
both curves to ``--out`` (default under the repository's git-ignored
``build/``).

Usage:
    python -m oasisx_tpu_torch.demo.fidelity_tg3d [-N 16] [--steps 150]
        [--chunk 25] [--out PATH] [--device cuda]
"""

import argparse
import json
import time
from pathlib import Path

import numpy as np
import torch

from oasisx_tpu_torch import DirichletBC, FractionalStep_AB_CN, LocatorMethod
from oasisx_tpu_torch.config import resolve_device
from oasisx_tpu_torch.demo.fidelity_tgv import BUILD, NU, energy_fn
from oasisx_tpu_torch.meshes import create_box, meshtags

DT = 2e-3


def build_solver(N, dtype, device, rtol=1e-6):
    """bench.py's ``build_solver`` (structured mode, no environment
    overrides) on the port."""
    mesh = create_box((-1.0, -1.0, -1.0), (1.0, 1.0, 1.0), (N, N, N))
    facets = mesh.exterior_facet_indices()
    tags = meshtags(mesh, mesh.dim - 1, facets, np.full_like(facets, 1))
    fields = (
        lambda x: np.sin(np.pi * x[0]) * np.cos(np.pi * x[1]) * np.cos(np.pi * x[2]),
        lambda x: -np.cos(np.pi * x[0]) * np.sin(np.pi * x[1]) * np.cos(np.pi * x[2]),
        lambda x: np.zeros_like(x[0]),
    )
    bcs_u = [[DirichletBC(f, LocatorMethod.TOPOLOGICAL, (tags, 1))] for f in fields]
    opts = {"ksp_rtol": rtol, "ksp_max_it": 2000}
    solver = FractionalStep_AB_CN(
        mesh, ("Lagrange", 2), ("Lagrange", 1), bcs_u=bcs_u, bcs_p=[],
        solver_options={"tentative": dict(opts), "pressure": dict(opts), "scalar": dict(opts)},
        options={"low_memory_version": False}, dtype=dtype, device=device,
    )
    for f, u1, u2 in zip(fields, solver._u1, solver._u2):
        u1.interpolate(f)
        u2.interpolate(f)
    return solver


def run(N, dtype, device, steps, chunk):
    """(t, E, wall seconds): E before the first step and after every chunk."""
    solver = build_solver(N, dtype, device)
    energy = energy_fn(solver)
    E = [float(energy(solver._state_from_functions()["u1"]))]
    t0 = time.perf_counter()
    for _ in range(steps // chunk):
        solver.run(chunk, DT, NU, max_iter=1)
        E.append(float(energy(solver._state_from_functions()["u1"])))
    wall = time.perf_counter() - t0
    return chunk * DT * np.arange(len(E)), np.asarray(E), wall


def main(argv=None):
    ap = argparse.ArgumentParser(formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    ap.add_argument("-N", type=int, default=16)
    ap.add_argument("--steps", type=int, default=150)
    ap.add_argument("--chunk", type=int, default=25, help="steps between energy readings")
    ap.add_argument("--out", type=str, default=None,
                    help="npz of both curves (default build/fidelity_tg3d.npz)")
    ap.add_argument("--device", type=str, default=None,
                    help="torch device of the float32 run (default: the card)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    ts, e_dev, wall_dev = run(args.N, torch.float32, device, args.steps, args.chunk)
    _, e_cpu, wall_cpu = run(args.N, torch.float64, "cpu", args.steps, args.chunk)
    rel = np.abs(e_dev - e_cpu) / np.abs(e_cpu[0])
    out = {
        "N": args.N, "dt": DT, "steps": args.steps, "nu": NU,
        "max_rel_energy_dev": float(rel.max()), "wall_dev": wall_dev, "wall_cpu": wall_cpu,
        "platform": torch.cuda.get_device_name(device) if device.type == "cuda" else device.type,
    }
    path = Path(args.out) if args.out else BUILD / "fidelity_tg3d.npz"
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez(path, t=ts, energy_f32_dev=e_dev, energy_f64_cpu=e_cpu, meta=json.dumps(out))
    print(json.dumps(out))
    return dict(out, t=ts.tolist(), energy_f32_dev=e_dev.tolist(), energy_f64_cpu=e_cpu.tolist())


if __name__ == "__main__":
    main()
