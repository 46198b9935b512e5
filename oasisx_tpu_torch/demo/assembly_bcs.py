"""The tentative-velocity system with Dirichlet BCs under both assembly
strategies: the split-phase API builds the matrix (BC rows with a unit
diagonal, ``tentative_matrix_dense``) and the right-hand side (BC values on
the BC rows, ``velocity_tentative_solve``'s) with direct vector assembly of
the mixed terms (``low_memory_version`` True, "action") and with the
preassembled mixed matrices (False, "matvec"), checks that the two agree,
and times ``assemble_first`` + ``velocity_tentative_assemble`` (the JAX
package's demo/assembly_bcs.py on the port).

The two strategies differ only on the general path, so the mesh is sent
there (``structured: False``).  Times are host-clock times of the two
phases, the device synchronised before each reading; per degree and method
the mean, standard deviation and least time over ``--repeats`` are printed,
and with ``--outfile`` written to <outfile>.csv.

Usage:
    python -m oasisx_tpu_torch.demo.assembly_bcs [--dim 3] [-n 10]
        [--max-degree 3] [--repeats 3] [--outfile NAME] [--device cuda]
        [--dtype float32]
"""

import argparse
import csv
import time

import numpy as np
import torch

from oasisx_tpu_torch import DirichletBC, FractionalStep_AB_CN, LocatorMethod
from oasisx_tpu_torch.fracstep import DENSE_MAX_DOFS
from oasisx_tpu_torch.main import add_device_args
from oasisx_tpu_torch.meshes import create_unit_cube, create_unit_square, meshtags


def build(mesh, deg, low_memory, dtype, device):
    facets = mesh.exterior_facet_indices()
    tags = meshtags(mesh, mesh.dim - 1, facets, np.full_like(facets, 1))
    bcs_u = [
        [DirichletBC(0.5, LocatorMethod.TOPOLOGICAL, (tags, 1))] for _ in range(mesh.dim)
    ]
    solver = FractionalStep_AB_CN(
        mesh,
        ("Lagrange", deg),
        ("Lagrange", 1),
        bcs_u=bcs_u,
        bcs_p=[],
        options={"low_memory_version": low_memory, "structured": False},
        dtype=dtype,
        device=device,
    )
    rng = np.random.RandomState(0)
    for f in solver._u1 + solver._u2:
        f.x.array.copy_(torch.as_tensor(rng.randn(f.x.array.shape[0]) * 0.1))
    solver._ps.x.array.copy_(torch.as_tensor(rng.randn(solver._ps.x.array.shape[0])))
    return solver


def _sync(solver):
    if solver._device.type == "cuda":
        torch.cuda.synchronize(solver._device)


def run_strategy(solver, dt, nu, repeats):
    ts = []
    for _ in range(repeats):
        _sync(solver)
        t0 = time.perf_counter()
        solver.assemble_first(dt, nu)
        solver.velocity_tentative_assemble()
        _sync(solver)
        ts.append(time.perf_counter() - t0)
    A = solver.tentative_matrix_dense() if solver._Vi[0][0].num_dofs < DENSE_MAX_DOFS else None
    # the system's right-hand side: the BC values on the BC rows
    mask, vals = solver._bc_masks, solver._bc_values()
    rhs = torch.where(mask, vals, solver._read_v(solver._rhs1))
    return ts, A, solver._uv(rhs).detach().cpu().double().numpy()


def report(results: dict, outfile: str | None) -> None:
    """Per degree, dofs and method: the mean, standard deviation and least
    of the repeats' times, and their count; with ``outfile`` every repeat's
    row in <outfile>.csv."""
    rows = list(results.values())
    groups: dict = {}
    for r in rows:
        key = (r["P"], r["num_dofs"], r["method"], r["procs"])
        groups.setdefault(key, []).append(r["time (s)"])
    print(f"{'P':>3} {'num_dofs':>9} {'method':>7} {'procs':>5} {'mean':>12} {'std':>12} "
          f"{'min':>12} {'count':>5}")
    for (P, nd, method, procs), ts in groups.items():
        t = np.asarray(ts)
        std = t.std(ddof=1) if t.size > 1 else float("nan")
        print(f"{P:>3} {nd:>9} {method:>7} {procs:>5} {t.mean() * 1e3:10.3f}ms "
              f"{std * 1e3:10.3f}ms {t.min() * 1e3:10.3f}ms {t.size:>5}")
    if outfile:
        with open(f"{outfile}.csv", "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=list(rows[0]))
            w.writeheader()
            w.writerows(rows)


def main(argv=None):
    parser = argparse.ArgumentParser(formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("--dim", type=int, default=3, choices=(2, 3))
    parser.add_argument("-n", type=int, default=10)
    parser.add_argument("--max-degree", type=int, default=3)
    parser.add_argument("--repeats", type=int, default=3)
    parser.add_argument("--outfile", default=None, help="basename of a CSV of the timings")
    add_device_args(parser)
    args = parser.parse_args(argv)
    dt, nu = 0.05, 0.01

    mesh = create_unit_cube(args.n) if args.dim == 3 else create_unit_square(3 * args.n)
    results, j = {}, 0
    print(f"{'P':>3} {'ndofs':>9} {'action [ms]':>12} {'matvec [ms]':>12} {'max|dRHS|':>10}")
    for deg in range(1, args.max_degree + 1):
        s_lm = build(mesh, deg, True, args.dtype, args.device)
        s_mv = build(mesh, deg, False, args.dtype, args.device)
        ts_lm, A_lm, rhs_lm = run_strategy(s_lm, dt, nu, args.repeats)
        ts_mv, A_mv, rhs_mv = run_strategy(s_mv, dt, nu, args.repeats)
        err = np.abs(rhs_lm - rhs_mv).max()
        # roundoff of the solver's dtype: 1e-14-level in float64
        rtol = 5e3 * torch.finfo(s_lm._dtype).eps
        if err > rtol * max(1.0, np.abs(rhs_lm).max()):
            raise RuntimeError(f"RHS mismatch between strategies: {err}")
        if A_lm is not None and np.abs(A_lm - A_mv).max() > rtol * np.abs(A_lm).max():
            raise RuntimeError("matrix mismatch between strategies")
        ndofs = s_lm._Vi[0][0].num_dofs
        print(
            f"{deg:>3} {ndofs:>9} {min(ts_lm)*1e3:>12.2f} "
            f"{min(ts_mv)*1e3:>12.2f} {err:>10.2e}"
        )
        for method, ts in (("action", ts_lm), ("matvec", ts_mv)):
            for t in ts:
                results[j] = {
                    "P": deg, "num_dofs": ndofs, "method": method, "time (s)": t, "procs": 1,
                }
                j += 1
    report(results, args.outfile)


if __name__ == "__main__":
    main()
