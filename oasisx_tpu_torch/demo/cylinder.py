"""DFG 2D cylinder benchmark (Schaefer-Turek): channel flow past a cylinder;
drag and lift coefficients (and, for the unsteady 2D-2 case, the Strouhal
number from the lift signal), on the port (the JAX package's
demo/cylinder.py).

2D-1 (default): Um=0.3, nu=1e-3 -> Re=20, steady; reference values
Cd ~ 5.58, Cl ~ 0.0106 (fine-mesh literature values).
2D-2 (--Um 1.5): Re=100, vortex shedding; St ~ 0.30.

Runs the general path with its PressureBC outlet; the force on the
cylinder is ``assembly.facets.surface_traction`` taken by ``run``'s step
callback on the device (inside the step's CUDA graph on the card: one
callback for the whole run), read once a chunk.

Usage:
    python -m oasisx_tpu_torch.demo.cylinder [--res 40] [-dt 2e-3] [-T 0.5]
        [--Um 0.3] [--chunk 200] [--refine-levels 0] [--device cuda]
        [--dtype float32]
"""

import argparse
import json
import logging

import numpy as np

from oasisx_tpu_torch import DirichletBC, FractionalStep_AB_CN, LocatorMethod, PressureBC
from oasisx_tpu_torch.assembly.facets import build_facet_context, surface_traction
from oasisx_tpu_torch.main import add_device_args
from oasisx_tpu_torch.meshes import locate_entities_boundary, meshtags
from oasisx_tpu_torch.meshes.generation import create_cylinder_channel

logger = logging.getLogger("oasisx_tpu_torch.cylinder")

L, H, D = 2.2, 0.41, 0.1
CENTER = (0.2, 0.2)


def strouhal_from_lift(ts, cls):
    """St from linearly-interpolated upward zero crossings of the lift
    signal (sub-sample period resolution), with an FFT cross-check."""
    c = np.asarray(cls) - np.mean(cls)
    s = np.sign(c)
    idx = np.where((s[:-1] < 0) & (s[1:] > 0))[0]
    if len(idx) < 3:
        return None, None
    tc = ts[idx] + (ts[idx + 1] - ts[idx]) * (-c[idx]) / (c[idx + 1] - c[idx])
    period = float(np.mean(np.diff(tc)))
    # FFT peak (rectangular window; fine for >3 periods)
    dt_s = float(ts[1] - ts[0])
    freqs = np.fft.rfftfreq(len(c), dt_s)
    amp = np.abs(np.fft.rfft(c))
    f_fft = float(freqs[np.argmax(amp[1:]) + 1])
    return 1.0 / period, f_fft


def main(argv=None):
    parser = argparse.ArgumentParser(formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("--res", type=int, default=40)
    parser.add_argument("-dt", type=float, default=2e-3)
    parser.add_argument("-T", type=float, default=0.5)
    parser.add_argument("--T0", type=float, default=0.0,
                        help="transient cutoff: stats use t > T0 only")
    parser.add_argument("--Um", type=float, default=0.3)
    parser.add_argument("-nu", type=float, default=1e-3)
    parser.add_argument("--chunk", type=int, default=200,
                        help="steps per on-device run() window")
    parser.add_argument("--refine-levels", type=int, default=0,
                        help="red-green refinement levels near the cylinder"
                        " (curved-boundary projection at every level)")
    parser.add_argument("--refine-dist", type=float, default=2.5,
                        help="refine cells within this many radii of the center")
    add_device_args(parser)
    args = parser.parse_args(argv)

    mesh = create_cylinder_channel(args.res)
    if args.refine_levels:
        # boundary-layer resolution at the cylinder (Cd_max /
        # Cl_amp vs the Schaefer-Turek band; the coarse polygon boundary
        # is what overshoots the drag).  Midpoints of circle edges are
        # re-projected, so the polygon error shrinks O(h^2) per level.
        from oasisx_tpu_torch.meshes.generation import refine_triangles

        c = np.asarray(CENTER)
        r = D / 2

        def project(p):
            d = np.linalg.norm(p - c, axis=1)
            on = np.abs(d - r) < 0.3 * r
            q = p.copy()
            q[on] = c + (p[on] - c) * (r / d[on])[:, None]
            return q

        for _ in range(args.refine_levels):
            cent = mesh.x[mesh.cells].mean(axis=1)
            markd = np.linalg.norm(cent - c, axis=1) < r * args.refine_dist
            mesh = refine_triangles(mesh, markd, project=project)
        logger.info("refined mesh: %d cells", len(mesh.cells))
    dim = 1
    inlet_f = locate_entities_boundary(mesh, dim, lambda x: np.isclose(x[0], 0.0))
    outlet_f = locate_entities_boundary(mesh, dim, lambda x: np.isclose(x[0], L))
    walls_f = locate_entities_boundary(
        mesh, dim, lambda x: np.isclose(x[1], 0.0) | np.isclose(x[1], H)
    )
    ext = mesh.exterior_facet_indices()
    mid = mesh.x[mesh.topology.facets[ext]].mean(axis=1)
    cyl_f = ext[np.linalg.norm(mid - np.asarray(CENTER), axis=1) < 0.9 * D]
    facets = np.hstack([inlet_f, walls_f, cyl_f, outlet_f])
    values = np.hstack(
        [
            np.full_like(inlet_f, 1, dtype=np.int32),
            np.full_like(walls_f, 2, dtype=np.int32),
            np.full_like(cyl_f, 4, dtype=np.int32),
            np.full_like(outlet_f, 3, dtype=np.int32),
        ]
    )
    tags = meshtags(mesh, dim, facets, values)

    Um = args.Um

    def inflow(x):
        return 4.0 * Um * x[1] * (H - x[1]) / H**2

    zero_walls = DirichletBC(0.0, LocatorMethod.TOPOLOGICAL, (tags, 2))
    zero_cyl = DirichletBC(0.0, LocatorMethod.TOPOLOGICAL, (tags, 4))
    bcs_u = [
        [DirichletBC(inflow, LocatorMethod.TOPOLOGICAL, (tags, 1)), zero_walls, zero_cyl],
        [
            DirichletBC(0.0, LocatorMethod.TOPOLOGICAL, (tags, 1)),
            DirichletBC(0.0, LocatorMethod.TOPOLOGICAL, (tags, 2)),
            DirichletBC(0.0, LocatorMethod.TOPOLOGICAL, (tags, 4)),
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
            "tentative": {"ksp_rtol": 1e-8},
            "pressure": {"ksp_rtol": 1e-8},
            "scalar": {"ksp_rtol": 1e-8},
        },
        dtype=args.dtype,
        device=args.device,
    )

    # cylinder facet context for traction integration
    fctx = build_facet_context(
        mesh, solver._V.element, solver._Q.element, cyl_f, solver._Vi[0][0].dofmap.cell_dofs,
        solver._dtype, solver._device,
    )
    Ubar = 2.0 * Um / 3.0
    scale = 2.0 / (Ubar**2 * D)

    # per-step Cd/Cl by the step callback, kept on the device until the
    # chunk's stats are read: force on the body = - (force on the fluid through the surface)
    nu_ = args.nu

    def traction_cb(state, t):
        return -surface_traction(solver._ctx, fctx, state["u"], state["p"], nu_)

    nsteps = int(round(args.T / args.dt))
    chunk = max(1, args.chunk)
    cds, cls = [], []
    done = 0
    while done < nsteps:
        n = min(chunk, nsteps - done)
        stats = solver.run(n, args.dt, args.nu, max_iter=1,
                           step_callback=traction_cb,
                           t0=done * args.dt)
        F = np.asarray(stats["callback"])  # (n, 2)
        cds.append(scale * F[:, 0])
        cls.append(scale * F[:, 1])
        done += n
        logger.info(
            "t=%.3f Cd=%.4f Cl=%.5f (u_it %.1f p_it %.1f)",
            done * args.dt, cds[-1][-1], cls[-1][-1],
            float(np.mean(stats["u_iters"])), float(np.mean(stats["p_iters"])),
        )
    cds = np.concatenate(cds)
    cls = np.concatenate(cls)
    ts = args.dt * np.arange(1, nsteps + 1)
    out = {"t_end": float(ts[-1]), "Cd": float(cds[-1]), "Cl": float(cls[-1])}
    # post-transient stats (DFG 2D-2: report Cd_max, Cl_max, St over the
    # periodic regime; literature St ~ 0.295-0.305, Cd_max ~ 3.22-3.24)
    sel = ts > args.T0
    if sel.any():
        out["Cd_max"] = float(cds[sel].max())
        out["Cl_max"] = float(cls[sel].max())
        out["Cl_amp"] = float((cls[sel].max() - cls[sel].min()) / 2)
        f_zc, f_fft = strouhal_from_lift(ts[sel], cls[sel])
        if f_zc is not None:
            out["Strouhal"] = float(f_zc * D / Ubar)
            out["Strouhal_fft"] = float(f_fft * D / Ubar)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    logging.basicConfig()
    logger.setLevel(logging.INFO)
    main()
