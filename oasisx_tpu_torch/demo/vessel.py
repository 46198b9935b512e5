"""Pulsatile flow through a curved, bulged vessel: a tetrahedral duct with
a curved centerline and a bulge, a pulsatile inflow re-evaluated every step
(DirichletBC.update_bc), and a pressure outlet; or a patient mesh with
tagged inlet, wall and outlet surfaces (``--mesh-path``, .msh v2.2/v4.1
or .npz, through ``oasisx_tpu_torch.io.import_mesh_with_tags``).  The JAX
package's demo/vessel.py on the port: the general path in 3D with
time-dependent boundary values and an outlet.

Usage:
    python -m oasisx_tpu_torch.demo.vessel [--n-axial 24] [--n-cross 5]
        [-dt 0.01] [-T 1] [-nu 0.04] [--mesh-path demo/meshes/patient_vessel.msh]
        [--device cuda] [--dtype float32]
"""

import argparse
import json
import logging

import numpy as np

from oasisx_tpu_torch import DirichletBC, FractionalStep_AB_CN, LocatorMethod, PressureBC
from oasisx_tpu_torch.io import import_mesh_with_tags
from oasisx_tpu_torch.main import add_device_args
from oasisx_tpu_torch.meshes import create_box, locate_entities_boundary, meshtags

logger = logging.getLogger("oasisx_tpu_torch.vessel")

L = 10.0


def make_vessel(n_axial=30, n_cross=6):
    """Deformed box: curved centerline + aneurysm bulge around x=L/2."""
    mesh = create_box((0.0, -1.0, -1.0), (L, 1.0, 1.0), (n_axial, n_cross, n_cross))
    x = mesh.x.copy()
    s = x[:, 0]
    r = 1.0 + 0.4 * np.exp(-((s - L / 2) ** 2))  # bulge
    yc = 0.3 * np.sin(np.pi * s / L)  # curved centerline
    x[:, 1] = yc + r * x[:, 1]
    x[:, 2] = r * x[:, 2]
    mesh.x[:] = x
    mesh.structured = None  # deformed: general unstructured path
    return mesh


class PulsatileInflow:
    """Blunted parabolic profile scaled by a pulse waveform."""

    def __init__(self, period=1.0):
        self.t = 0.0
        self.period = period

    def waveform(self):
        tau = (self.t % self.period) / self.period
        return 1.0 + 0.75 * np.sin(2 * np.pi * tau)

    def eval(self, x):
        prof = np.clip((1 - x[1] ** 2) * (1 - x[2] ** 2), 0.0, None)
        return self.waveform() * prof


def main(argv=None):
    parser = argparse.ArgumentParser(formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("--n-axial", type=int, default=24)
    parser.add_argument("--n-cross", type=int, default=5)
    parser.add_argument("-dt", type=float, default=0.01)
    parser.add_argument("-T", type=float, default=1.0)
    parser.add_argument("-nu", type=float, default=0.04)
    parser.add_argument(
        "--mesh-path", type=str, default=None,
        help="Patient mesh (.msh v2.2/v4.1 or .npz) with tagged surfaces: "
        "inlet/wall/outlet physical groups (override ids via --inlet-tag etc.)",
    )
    parser.add_argument("--inlet-tag", type=int, default=1)
    parser.add_argument("--wall-tag", type=int, default=2)
    parser.add_argument("--outlet-tag", type=int, default=3)
    add_device_args(parser)
    args = parser.parse_args(argv)

    if args.mesh_path is not None:
        mesh, tags = import_mesh_with_tags(args.mesh_path)
        if tags is None:
            raise SystemExit(
                f"{args.mesh_path} carries no tagged surfaces; the vessel "
                "config needs inlet/wall/outlet physical groups"
            )
        got = set(np.unique(tags.values).tolist())
        need = {args.inlet_tag, args.wall_tag, args.outlet_tag}
        if not need <= got:
            raise SystemExit(f"mesh tags {sorted(got)} do not include {sorted(need)}")
        # remap user tag ids onto the demo's 1/2/3 convention
        remap = {args.inlet_tag: 1, args.wall_tag: 2, args.outlet_tag: 3}
        vals = np.array([remap.get(int(v), 0) for v in tags.values], dtype=np.int32)
        keep = vals > 0
        tags = meshtags(mesh, mesh.dim - 1, tags.indices[keep], vals[keep])
    else:
        mesh = make_vessel(args.n_axial, args.n_cross)
        dim = mesh.dim - 1
        inlet_f = locate_entities_boundary(mesh, dim, lambda x: np.isclose(x[0], 0.0))
        outlet_f = locate_entities_boundary(mesh, dim, lambda x: np.isclose(x[0], L))
        ext = mesh.exterior_facet_indices()
        wall_f = np.setdiff1d(ext, np.concatenate([inlet_f, outlet_f]))
        facets = np.concatenate([inlet_f, wall_f, outlet_f])
        values = np.concatenate(
            [
                np.full_like(inlet_f, 1, dtype=np.int32),
                np.full_like(wall_f, 2, dtype=np.int32),
                np.full_like(outlet_f, 3, dtype=np.int32),
            ]
        )
        tags = meshtags(mesh, dim, facets, values)

    inflow = PulsatileInflow()
    zero = lambda tag: DirichletBC(0.0, LocatorMethod.TOPOLOGICAL, (tags, tag))
    bcs_u = [
        [DirichletBC(inflow.eval, LocatorMethod.TOPOLOGICAL, (tags, 1)), zero(2)],
        [zero(1), zero(2)],
        [zero(1), zero(2)],
    ]
    bcs_p = [PressureBC(0.0, (tags, 3))]
    solver = FractionalStep_AB_CN(
        mesh,
        ("Lagrange", 2),
        ("Lagrange", 1),
        bcs_u=bcs_u,
        bcs_p=bcs_p,
        solver_options={
            "tentative": {"ksp_rtol": 1e-7},
            "pressure": {"ksp_rtol": 1e-7},
            "scalar": {"ksp_rtol": 1e-7},
        },
        dtype=args.dtype,
        device=args.device,
    )

    nsteps = int(round(args.T / args.dt))
    series, converged = [], []
    for step in range(1, nsteps + 1):
        inflow.t = step * args.dt
        solver.solve(args.dt, args.nu, max_iter=1)
        umax = max(float(f.x.array.abs().max()) for f in solver._u)
        st = solver.last_stats
        converged.append(bool(st["u_converged"].all() and st["p_converged"]
                              and st["c_converged"].all()))
        series.append((inflow.t, inflow.waveform(), umax))
        if step % 20 == 0 or step == nsteps:
            logger.info("t=%.2f waveform=%.3f max|u|=%.3f", *series[-1])
        if not np.isfinite(umax):
            raise RuntimeError(f"diverged at t={inflow.t}")

    out = {
        "t": [s[0] for s in series],
        "waveform": [s[1] for s in series],
        "max_velocity": [s[2] for s in series],
        "velocity_dofs": 3 * solver._Vi[0][0].num_dofs,
        "converged": converged,
    }
    print(json.dumps({k: v if not isinstance(v, list) else v[-3:] for k, v in out.items()}))
    return out


if __name__ == "__main__":
    logging.basicConfig()
    logger.setLevel(logging.INFO)
    main()
