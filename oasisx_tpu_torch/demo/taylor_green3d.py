"""3D Taylor-Green vortex at Re=1600: the kinetic energy E(t) = (1/|O|) int
|u|^2/2 dx and the dissipation -dE/dt over time (the JAX package's
demo/taylor_green3d.py on the port).

The box [-pi, pi]^3 takes the structured path; the analytic initial field
is held on the boundary by Dirichlet conditions (the classical problem is
periodic, so this tracks the early-time dissipation curve).  The energy is
integrated on the solver's device after each chunk of ``run`` steps.

Usage:
    python -m oasisx_tpu_torch.demo.taylor_green3d [-N 24] [-dt 5e-3] [-T 1]
        [-Re 1600] [--chunk 20] [--device cuda] [--dtype float32]
"""

import argparse
import json
import time

import numpy as np

from oasisx_tpu_torch import DirichletBC, FractionalStep_AB_CN, LocatorMethod
from oasisx_tpu_torch.forms import expr as E
from oasisx_tpu_torch.main import add_device_args
from oasisx_tpu_torch.meshes import create_box, meshtags


def main(argv=None):
    parser = argparse.ArgumentParser(formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("-N", type=int, default=24, help="cells per axis")
    parser.add_argument("-dt", type=float, default=5e-3)
    parser.add_argument("-T", type=float, default=1.0)
    parser.add_argument("-Re", type=float, default=1600.0)
    parser.add_argument("--chunk", type=int, default=20, help="steps per run() call")
    add_device_args(parser)
    args = parser.parse_args(argv)
    nu = 1.0 / args.Re
    L = np.pi

    mesh = create_box((-L, -L, -L), (L, L, L), (args.N,) * 3)
    facets = mesh.exterior_facet_indices()
    tags = meshtags(mesh, 2, facets, np.full_like(facets, 1))

    def ux(x):
        return np.sin(x[0]) * np.cos(x[1]) * np.cos(x[2])

    def uy(x):
        return -np.cos(x[0]) * np.sin(x[1]) * np.cos(x[2])

    def uz(x):
        return np.zeros_like(x[0])

    bcs_u = [[DirichletBC(f, LocatorMethod.TOPOLOGICAL, (tags, 1))] for f in (ux, uy, uz)]
    solver = FractionalStep_AB_CN(
        mesh,
        ("Lagrange", 2),
        ("Lagrange", 1),
        bcs_u=bcs_u,
        bcs_p=[],
        solver_options={
            "tentative": {"ksp_rtol": 1e-6},
            "pressure": {"ksp_rtol": 1e-6},
            "scalar": {"ksp_rtol": 1e-6},
        },
        dtype=args.dtype,
        device=args.device,
    )
    for f, u1, u2 in zip((ux, uy, uz), solver._u1, solver._u2):
        u1.interpolate(f)
        u2.interpolate(f)
    vol = solver._vol
    # |u_h|^2 of P2 components is of degree 4: a degree-4 rule integrates it exactly
    ev = E.QPEvaluator(mesh, 4, solver._dtype, solver._device)
    u1 = E.as_vector([E.as_expr(f) for f in solver._u1])

    def kinetic_energy():
        return 0.5 * float(ev.integrate(E.inner(u1, u1))) / vol

    nchunks = int(round(args.T / args.dt / args.chunk))
    ts, energies = [0.0], [kinetic_energy()]
    t0 = time.perf_counter()
    for c in range(nchunks):
        solver.run(args.chunk, args.dt, nu, max_iter=1)
        ts.append((c + 1) * args.chunk * args.dt)
        energies.append(kinetic_energy())
    wall = time.perf_counter() - t0
    diss = -np.gradient(np.asarray(energies), np.asarray(ts))
    out = {
        "t": ts,
        "kinetic_energy": energies,
        "dissipation": diss.tolist(),
        "steps_per_sec": nchunks * args.chunk / wall,
        "velocity_dofs": 3 * solver._Vi[0][0].num_dofs,
    }
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
