"""2D channel (Poiseuille) flow: parabolic inlet, no-slip walls, a pressure
outlet (PressureBC).  The steady solution is the parabola u = (4 y (1-y),
0), which the IPCS scheme must reproduce; this runs the outlet's surface
terms and the general path end to end (the JAX package's demo/channel.py
on the port).  Returns the largest deviations from it, per component.

Usage:
    python -m oasisx_tpu_torch.demo.channel [-N 16] [-dt 0.01] [-T 2] [-nu 0.1]
        [--device cuda] [--dtype float32]
"""

import argparse
import logging

import numpy as np

from oasisx_tpu_torch import DirichletBC, FractionalStep_AB_CN, LocatorMethod, PressureBC
from oasisx_tpu_torch.main import add_device_args
from oasisx_tpu_torch.meshes import create_rectangle, locate_entities_boundary, meshtags

logger = logging.getLogger("oasisx_tpu_torch.channel")


def main(argv=None):
    parser = argparse.ArgumentParser(formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("-N", type=int, default=16)
    parser.add_argument("-dt", type=float, default=0.01)
    parser.add_argument("-T", type=float, default=2.0)
    parser.add_argument("-nu", type=float, default=0.1)
    add_device_args(parser)
    args = parser.parse_args(argv)

    L, H = 4.0, 1.0
    mesh = create_rectangle((0, 0), (L, H), (4 * args.N, args.N))
    dim = mesh.dim - 1
    inlet_f = locate_entities_boundary(mesh, dim, lambda x: np.isclose(x[0], 0.0))
    walls_f = locate_entities_boundary(
        mesh, dim, lambda x: np.isclose(x[1], 0.0) | np.isclose(x[1], H)
    )
    outlet_f = locate_entities_boundary(mesh, dim, lambda x: np.isclose(x[0], L))
    facets = np.hstack([inlet_f, walls_f, outlet_f])
    values = np.hstack(
        [
            np.full_like(inlet_f, 1, dtype=np.int32),
            np.full_like(walls_f, 2, dtype=np.int32),
            np.full_like(outlet_f, 3, dtype=np.int32),
        ]
    )
    tags = meshtags(mesh, dim, facets, values)

    def inflow(x):
        return 4.0 * x[1] * (H - x[1]) / H**2

    bcs_u = [
        [
            DirichletBC(inflow, LocatorMethod.TOPOLOGICAL, (tags, 1)),
            DirichletBC(0.0, LocatorMethod.TOPOLOGICAL, (tags, 2)),
        ],
        [
            DirichletBC(0.0, LocatorMethod.TOPOLOGICAL, (tags, 1)),
            DirichletBC(0.0, LocatorMethod.TOPOLOGICAL, (tags, 2)),
        ],
    ]
    bcs_p = [PressureBC(0.0, (tags, 3))]

    solver = FractionalStep_AB_CN(
        mesh,
        ("Lagrange", 2),
        ("Lagrange", 1),
        bcs_u=bcs_u,
        bcs_p=bcs_p,
        solver_options={
            "tentative": {"ksp_rtol": 1e-10},
            "pressure": {"ksp_rtol": 1e-10},
            "scalar": {"ksp_rtol": 1e-10},
        },
        dtype=args.dtype,
        device=args.device,
    )

    nsteps = int(round(args.T / args.dt))
    for step in range(1, nsteps + 1):
        solver.solve(args.dt, args.nu, max_iter=2)
        if step % 20 == 0:
            logger.info("step %d/%d", step, nsteps)

    # compare with the exact parabolic profile
    x = solver._Vi[0][0].dof_coords
    exact = 4.0 * x[:, 1] * (H - x[:, 1]) / H**2
    ux, uy = (f.x.array.detach().cpu().double().numpy() for f in solver._u[:2])
    err_x = np.abs(ux - exact).max()
    err_y = np.abs(uy).max()
    logger.info("max|u_x - parabola| = %.3e, max|u_y| = %.3e", err_x, err_y)
    return err_x, err_y


if __name__ == "__main__":
    logging.basicConfig()
    logger.setLevel(logging.INFO)
    main()
