"""Taylor-Green convergence demo: P2/P1 IPCS on [-1, 1]^2 with a
manufactured solution, space-time L2 errors per refinement, and log-log
convergence rates (the JAX package's demo/taylor_green.py on the port).

Usage:
    python -m oasisx_tpu_torch.demo.taylor_green -N 8 -N 16 -N 32 -dt 0.005
        [-nu 0.01] [-T0 0] [-T1 1] [-u 2] [-p 1] [--low-memory] [--rotational]
        [--write-output] [--use-run] [--device cuda] [--dtype float64]

The errors of a step are integrals on the solver's device in its dtype, at
quadrature degree 8; with ``--use-run`` the whole window is one ``run`` call
with a per-step Dirichlet table and the errors taken by its step callback.
"""

import argparse
import logging

import numpy as np
import torch

from oasisx_tpu_torch import DirichletBC, FractionalStep_AB_CN, LocatorMethod
from oasisx_tpu_torch.assembly.geometry import compute_cell_geometry
from oasisx_tpu_torch.elements.quadrature import quadrature
from oasisx_tpu_torch.forms import expr as E
from oasisx_tpu_torch.io import VTXWriter
from oasisx_tpu_torch.main import add_device_args
from oasisx_tpu_torch.meshes import create_rectangle, meshtags
from oasisx_tpu_torch.spaces import Constant

logger = logging.getLogger("oasisx_tpu_torch.taylor_green")


class U:
    """Manufactured Taylor-Green velocity."""

    def __init__(self, t, nu):
        self.t = t
        self.nu = nu

    def eval_x(self, x):
        return (
            -np.cos(np.pi * x[0])
            * np.sin(np.pi * x[1])
            * np.exp(-2.0 * self.nu * np.pi**2 * float(self.t))
        )

    def eval_y(self, x):
        return (
            np.cos(np.pi * x[1])
            * np.sin(np.pi * x[0])
            * np.exp(-2.0 * self.nu * np.pi**2 * float(self.t))
        )


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description="Taylor-Green convergence demo",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    parser.add_argument("-N", "--refinement", type=int, dest="Ns", action="append", required=True)
    parser.add_argument("-T0", "--T-start", dest="T_start", type=float, default=0)
    parser.add_argument("-T1", "--T-end", dest="T_end", type=float, default=1)
    parser.add_argument("-dt", dest="dt", type=float, default=0.1)
    parser.add_argument("-nu", dest="nu", type=float, default=0.01)
    parser.add_argument("-u", dest="u_deg", type=int, default=2)
    parser.add_argument("-p", dest="p_deg", type=int, default=1)
    parser.add_argument("-lm", "--low-memory", dest="lm", action="store_true", default=False)
    parser.add_argument("-r", "--rotational", dest="rot", action="store_true", default=False)
    parser.add_argument("--write-output", action="store_true", default=False,
                        help="write u.bp and p.bp series (VTXWriter) in the working directory")
    parser.add_argument(
        "--use-run", action="store_true", default=False,
        help="advance the whole window with one solver.run() call, a per-step "
        "BC table and the error functionals in its step callback",
    )
    add_device_args(parser)
    return parser.parse_args(argv)


def _run_window_errors(solver, mesh, inputs, u_time, num_steps, dt, nu):
    """One ``run`` call over the window: a per-step Dirichlet table and the
    per-step space-time error functionals in the step callback, kept on the
    device.  Returns errs (2, num_steps)."""
    T0 = inputs.T_start
    times = [T0 + (i + 1) * dt for i in range(num_steps)]

    def upd(t):
        u_time.value = np.asarray(t)

    table = solver.bc_value_table(times, update=upd)

    dev, dtype = solver._device, solver._dtype
    on = lambda a: torch.as_tensor(np.asarray(a, np.float64), device=dev).to(dtype)
    # the quadrature-degree-8 rule of the per-step errors (E.assemble_scalar's)
    pts, w = quadrature(mesh.cell_type, 8)
    el_u, el_q = solver._Vi[0][0].element, solver._Q.element
    phi_u = on(el_u.tabulate(pts)[0])  # (nq, ndv)
    phi_q = on(el_q.tabulate(pts)[0])
    detJ = on(compute_cell_geometry(mesh.x, mesh.cells, mesh.dim).detJ)
    wq = on(w)
    v0 = mesh.x[mesh.cells[:, 0]]
    J = np.stack([mesh.x[mesh.cells[:, k + 1]] - v0 for k in range(mesh.dim)], axis=2)
    xq = on(v0[:, None, :] + np.einsum("cgd,qd->cqg", J, pts))  # (nc, nq, dim)
    cd_u = torch.as_tensor(solver._Vi[0][0].dofmap.cell_dofs, dtype=torch.long, device=dev)
    cd_q = torch.as_tensor(solver._Q.dofmap.cell_dofs, dtype=torch.long, device=dev)
    pi = np.pi

    def err_cb(state, t):  # t: a 0-d tensor; torch only, so that the step's graph holds it
        u, p = solver._uv(state["u"]), solver._uq(state["p"])
        decay_u = torch.exp(-2 * pi**2 * nu * t)
        uex = torch.stack([
            -torch.cos(pi * xq[..., 0]) * torch.sin(pi * xq[..., 1]),
            torch.sin(pi * xq[..., 0]) * torch.cos(pi * xq[..., 1]),
        ]) * decay_u
        du = torch.einsum("qj,gcj->gcq", phi_u, u[:, cd_u]) - uex
        err_u = torch.einsum("gcq,q,c->", du * du, wq, detJ)
        decay_p = torch.exp(-4 * pi**2 * nu * (t - dt / 2.0))
        pex = -0.25 * (torch.cos(2 * pi * xq[..., 0]) + torch.cos(2 * pi * xq[..., 1])) * decay_p
        dp_ = torch.einsum("qj,cj->cq", phi_q, p[cd_q]) - pex
        err_p = torch.einsum("cq,q,c->", dp_ * dp_, wq, detJ)
        return torch.stack([err_u, err_p])

    stats = solver.run(num_steps, dt, nu, max_iter=1, bc_vals_seq=table, step_callback=err_cb,
                       t0=T0)
    return np.asarray(stats["callback"]).T  # (2, num_steps)


def main(argv=None):
    inputs = parse_args(argv)
    dt, nu = inputs.dt, inputs.nu
    if not inputs.T_start < inputs.T_end:
        raise ValueError("T0 must be below T1")
    if not inputs.u_deg > inputs.p_deg:
        raise ValueError("the velocity degree must exceed the pressure degree")
    num_steps = int((inputs.T_end - inputs.T_start) // dt)
    solver_options = {
        "tentative": {"ksp_type": "preonly", "pc_type": "lu"},
        "pressure": {"ksp_type": "preonly", "pc_type": "lu"},
        "scalar": {"ksp_type": "preonly", "pc_type": "lu"},
    }

    space_errors = np.zeros((2, len(inputs.Ns)))
    hs = np.zeros(len(inputs.Ns))
    for n, N in enumerate(inputs.Ns):
        mesh = create_rectangle((-1, -1), (1, 1), (N, N))
        facets = mesh.exterior_facet_indices()
        value = np.int32(3)
        facet_tags = meshtags(mesh, mesh.dim - 1, facets, np.full_like(facets, value))

        u_time = Constant(inputs.T_start)
        p_time = inputs.T_start - dt / 2.0
        u_ex = U(t=u_time, nu=nu)
        bcx = DirichletBC(u_ex.eval_x, LocatorMethod.TOPOLOGICAL, (facet_tags, value))
        bcy = DirichletBC(u_ex.eval_y, LocatorMethod.TOPOLOGICAL, (facet_tags, value))

        solver = FractionalStep_AB_CN(
            mesh,
            ("Lagrange", inputs.u_deg),
            ("Lagrange", inputs.p_deg),
            bcs_u=[[bcx], [bcy]],
            bcs_p=[],
            rotational=inputs.rot,
            solver_options=solver_options,
            options={"low_memory_version": inputs.lm},
            dtype=inputs.dtype,
            device=inputs.device,
        )

        # initial conditions
        u_time.value = np.asarray(inputs.T_start - dt)
        solver._u2[0].interpolate(u_ex.eval_x)
        solver._u2[1].interpolate(u_ex.eval_y)
        u_time.value = np.asarray(inputs.T_start)
        solver._u1[0].interpolate(u_ex.eval_x)
        solver._u1[1].interpolate(u_ex.eval_y)
        solver._p.interpolate(
            lambda x: -0.25
            * (np.cos(2 * np.pi * x[0]) + np.cos(2 * np.pi * x[1]))
            * np.exp(-4 * np.pi**2 * nu * p_time)
        )

        writers = []
        if inputs.write_output:
            writers = [
                VTXWriter("u.bp", [solver.u]),
                VTXWriter("p.bp", [solver._p]),
            ]

        x = E.SpatialCoordinate(mesh)
        errs = np.zeros((2, num_steps))
        if inputs.use_run and not writers:
            errs = _run_window_errors(solver, mesh, inputs, u_time, num_steps, dt, nu)
            hmax = mesh.h().max()
            hs[n] = hmax
            space_errors[:, n] = [np.sqrt(dt * errs[0].sum()), np.sqrt(dt * errs[1].sum())]
            logger.info(
                "hmax=%.4e space_time_u_L2=%.6e space_time_p_L2=%.6e (run path)",
                hmax, space_errors[0, n], space_errors[1, n],
            )
            continue
        # one evaluator of the degree-8 rule for the whole window
        ev = E.QPEvaluator(mesh, 8, solver._dtype, solver._device)
        for i in range(num_steps):
            u_time.value = np.asarray(float(u_time.value) + dt)
            p_time += dt
            solver.solve(dt, nu, max_iter=1)

            decay_u = float(np.exp(-2 * np.pi**2 * nu * float(u_time.value)))
            man_u = E.as_vector(
                [
                    -E.sin(E.pi * x[1]) * E.cos(E.pi * x[0]) * decay_u,
                    E.sin(E.pi * x[0]) * E.cos(E.pi * x[1]) * decay_u,
                ]
            )
            decay_p = float(np.exp(-4 * np.pi**2 * nu * p_time))
            man_p = -0.25 * (E.cos(2 * E.pi * x[0]) + E.cos(2 * E.pi * x[1])) * decay_p
            uf = E.as_expr(solver.u)
            du = E.as_vector([uf[0] - man_u.comps[0], uf[1] - man_u.comps[1]])
            err_u = float(ev.integrate(E.inner(du, du)))
            dpe = E.as_expr(solver._p) - man_p
            err_p = float(ev.integrate(dpe * dpe))
            logger.debug("t=%.4f error_u=%.3e error_p=%.3e", float(u_time.value), err_u, err_p)
            errs[:, i] = [err_u, err_p]
            for w in writers:
                w.write(float(u_time.value))
        for w in writers:
            w.close()

        hmax = mesh.h().max()
        hs[n] = hmax
        space_errors[:, n] = [np.sqrt(dt * errs[0].sum()), np.sqrt(dt * errs[1].sum())]
        logger.info(
            "hmax=%.4e space_time_u_L2=%.6e space_time_p_L2=%.6e",
            hmax, space_errors[0, n], space_errors[1, n],
        )

    order = np.argsort(hs)[::-1]
    hs = hs[order]
    space_errors = space_errors[:, order]
    rate_u = np.log(space_errors[0, 1:] / space_errors[0, :-1]) / np.log(hs[1:] / hs[:-1])
    rate_p = np.log(space_errors[1, 1:] / space_errors[1, :-1]) / np.log(hs[1:] / hs[:-1])
    logger.info("Convergence rates u: %s", rate_u)
    logger.info("Convergence rates p: %s", rate_p)
    return rate_u, rate_p


if __name__ == "__main__":
    logging.basicConfig()
    logger.setLevel(logging.INFO)
    main()
