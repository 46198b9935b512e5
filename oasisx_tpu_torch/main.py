"""Command-line entry point: ``python -m oasisx_tpu_torch``.

The JAX package's CLI on the port, with its arguments, problem and output:
imports a mesh (or falls back to the 10x10 unit square), sets no-slip walls
on every exterior facet, and advances the IPCS scheme on the card, logging
every 10th step, writing the output series every step and a checkpoint
every ``--checkpoint-every`` steps and at the end.  With zero initial
velocity and no forcing the default problem stays zero: a diff of 0 and 0
Krylov iterations are its right answer.
"""

from __future__ import annotations

import argparse
import logging

import numpy as np


def get_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="oasisx_tpu_torch: IPCS Navier-Stokes solver on PyTorch and CUDA",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    parser.add_argument("--mesh-path", type=str, default=None, dest="mesh_path",
                        help="Mesh file (.npz or Gmsh .msh); default: unit square")
    parser.add_argument("-dt", type=float, default=0.01, help="Time step")
    parser.add_argument("-T", type=float, default=1.0, help="End time")
    parser.add_argument("-nu", type=float, default=0.01, help="Kinematic viscosity")
    parser.add_argument("-u", dest="u_deg", type=int, default=2, help="Velocity degree")
    parser.add_argument("-p", dest="p_deg", type=int, default=1, help="Pressure degree")
    parser.add_argument("--rotational", action="store_true", help="Rotational pressure update")
    parser.add_argument(
        "--low-memory",
        action=argparse.BooleanOptionalAction,
        default=True,
        help="Direct-action assembly (--no-low-memory selects the "
        "preassembled-matrix strategy, low_memory_version=False)",
    )
    parser.add_argument("--max-inner-iter", type=int, default=1)
    parser.add_argument("--output", type=str, default=None, help="Output series stem (.pvd/.vtu)")
    parser.add_argument("--checkpoint", type=str, default=None, help="Checkpoint file (.npz)")
    parser.add_argument("--checkpoint-every", type=int, default=50)
    add_device_args(parser)
    return parser


def add_device_args(parser: argparse.ArgumentParser) -> None:
    """``--device`` (default: the card; no fallback to the CPU) and
    ``--dtype`` (default float32) of the solver, for the CLI and the demos."""
    parser.add_argument("--device", type=str, default=None,
                        help="torch device of the solver (default: the card)")
    parser.add_argument("--dtype", type=str, default="float32", choices=("float32", "float64"),
                        help="the solver's floating-point type")


def main(argv=None) -> None:
    args = get_parser().parse_args(argv)
    if args.dt <= 0 or args.T <= 0:
        get_parser().error("-dt and -T must be positive")
    logging.getLogger("oasisx_tpu_torch").setLevel(logging.INFO)
    logger = logging.getLogger("oasisx_tpu_torch.main")

    from . import DirichletBC, FractionalStep_AB_CN, LocatorMethod
    from .io import Checkpoint, VTXWriter, import_mesh
    from .meshes import meshtags

    mesh = import_mesh(args.mesh_path)
    facets = mesh.exterior_facet_indices()
    tags = meshtags(mesh, mesh.dim - 1, facets, np.full_like(facets, 1))
    bcs_u = [
        [DirichletBC(0.0, LocatorMethod.TOPOLOGICAL, (tags, 1))] for _ in range(mesh.dim)
    ]
    solver = FractionalStep_AB_CN(
        mesh,
        ("Lagrange", args.u_deg),
        ("Lagrange", args.p_deg),
        bcs_u=bcs_u,
        bcs_p=[],
        rotational=args.rotational,
        options={"low_memory_version": args.low_memory},
        dtype=args.dtype,
        device=args.device,
    )

    writer = VTXWriter(args.output, [solver.u, solver._p]) if args.output else None
    ckpt = Checkpoint(args.checkpoint) if args.checkpoint else None

    t, step = 0.0, 0
    nsteps = int(round(args.T / args.dt))
    for step in range(1, nsteps + 1):
        t += args.dt
        diff = solver.solve(args.dt, args.nu, max_iter=args.max_inner_iter)
        if step % 10 == 0 or step == nsteps:
            logger.info(
                "step %d/%d t=%.4f diff=%.3e u_iters=%s p_iters=%s",
                step, nsteps, t, diff,
                solver.last_stats["u_iters"], solver.last_stats["p_iters"],
            )
        if writer:
            writer.write(t)
        if ckpt and step % args.checkpoint_every == 0:
            ckpt.save(solver, t, step)
    if writer:
        writer.close()
    if ckpt:
        ckpt.save(solver, t, step)


if __name__ == "__main__":
    main()
