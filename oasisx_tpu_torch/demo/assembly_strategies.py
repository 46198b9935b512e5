"""Assembly strategies: the tentative right-hand side's pressure term
r_i = assemble(p v.dx(i) dx) by direct vector assembly ("action",
``engine.pressure_gradient_vecs``: the low_memory_version=True strategy)
and by products with the preassembled element matrices ("matvec",
``engine.pressure_gradient_mats`` then ``engine.matvec_vq`` a component:
low_memory_version=False), for velocity degrees 1 to ``--max-degree`` with
pressure degree max(du - 1, 1) (the JAX package's
demo/assembly_strategies.py on the port).

Both strategies run on one random p a degree; their agreement is asserted
before the repeats, to roundoff of the dtype (1e-10 in float64, 5e-5 in
float32, times max(1, |r_matvec|_inf)).  Each call is timed by
``utils.timers.Timer`` fenced on the solver's device (the host clock after
``torch.cuda.synchronize`` on the card); per degree and method the mean,
standard deviation and least time over ``--repeats`` are printed
(``demo.assembly_bcs.report``), and with ``--outfile`` written to
<outfile>.csv.

Usage:
    python -m oasisx_tpu_torch.demo.assembly_strategies [--dim 3] [-n 12]
        [--max-degree 4] [--repeats 3] [--outfile NAME] [--device cuda]
        [--dtype float32]
"""

import argparse

import numpy as np
import torch

from oasisx_tpu_torch.assembly import engine as eng
from oasisx_tpu_torch.config import real_dtype, resolve_device
from oasisx_tpu_torch.demo.assembly_bcs import report
from oasisx_tpu_torch.main import add_device_args
from oasisx_tpu_torch.meshes import create_unit_cube, create_unit_square
from oasisx_tpu_torch.spaces import FunctionSpace
from oasisx_tpu_torch.utils.timers import Timer, timing


def strategies(mesh, du, dp, dtype, device):
    """The two strategies on p = RandomState(0).randn(ndofs_q): returns
    (velocity dofs a component, action, matvec), each a callable giving
    r of shape (d, ndofs_v)."""
    V = FunctionSpace(mesh, ("Lagrange", du))
    Q = FunctionSpace(mesh, ("Lagrange", dp))
    ctx, _ = eng.build_device_context(
        mesh, V.element, V.dofmap.cell_dofs, V.num_dofs, Q.element, Q.dofmap.cell_dofs,
        Q.num_dofs, dtype, device,
    )
    p = torch.as_tensor(np.random.RandomState(0).randn(Q.num_dofs), device=device).to(dtype)
    mats = eng.pressure_gradient_mats(ctx)

    def action():
        return eng.pressure_gradient_vecs(ctx, p)

    def matvec():
        return torch.stack([eng.matvec_vq(ctx, mats[i], p) for i in range(mats.shape[0])])

    return V.num_dofs, action, matvec


def bench_degree(mesh, du, dp, repeats, dtype, device):
    """Asserts the strategies' agreement, then times ``repeats`` calls of
    each; returns (velocity dofs a component, action times, matvec times)."""
    ndofs, action, matvec = strategies(mesh, du, dp, dtype, device)
    r_a, r_m = action(), matvec()
    # the two strategies contract in different orders: agreement to the
    # roundoff of the dtype
    tol = 1e-10 if dtype == torch.float64 else 5e-5
    scale = max(1.0, float(r_m.abs().max()))
    err = float((r_a - r_m).abs().max())
    assert err < tol * scale, f"strategy mismatch at P{du}: {err:.3e}"
    times = {}
    for method, fn in (("action", action), ("matvec", matvec)):
        name = f"assembly_strategies P{du} {method}"
        times[method] = []
        for _ in range(repeats):
            before = timing(name)[1]
            with Timer(name, sync=device):
                fn()
            times[method].append(timing(name)[1] - before)
    return ndofs, times["action"], times["matvec"]


def main(argv=None):
    parser = argparse.ArgumentParser(formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("--dim", type=int, default=3, choices=(2, 3))
    parser.add_argument("--max-degree", type=int, default=4)
    parser.add_argument("-n", type=int, default=12, help="mesh resolution")
    parser.add_argument("--repeats", type=int, default=3)
    parser.add_argument("--outfile", default=None, help="basename of a CSV of the timings")
    add_device_args(parser)
    args = parser.parse_args(argv)
    dtype, device = real_dtype(args.dtype), resolve_device(args.device)

    mesh = create_unit_cube(args.n) if args.dim == 3 else create_unit_square(args.n * 3)
    results, j = {}, 0
    for du in range(1, args.max_degree + 1):
        ndofs, ts_a, ts_m = bench_degree(mesh, du, max(du - 1, 1), args.repeats, dtype, device)
        for method, ts in (("action", ts_a), ("matvec", ts_m)):
            for t in ts:
                results[j] = {
                    "P": du, "num_dofs": ndofs, "method": method, "time (s)": t, "procs": 1,
                }
                j += 1
    report(results, args.outfile)


if __name__ == "__main__":
    main()
