"""Where the float32 runs of two checkouts of the port part, step by step:
the N=35 Taylor-Green main path of ``chip_smoke.py`` (phase 4f, pressure by
K1's Chebyshev-Jacobi PCG), stepped one step at a time on the card after
the same warm-up.  After each step it keeps the velocity, the pressure, the
pressure solve's right-hand side and that solve's relative residual
(resnorm / |b|, as the step statistics give it) at its last iterations: the
solve is repeated from the same input with maxiter k - TAIL, ..., k - 1
before it runs to its end, k.

    python3 scripts/torch_step_divergence.py --tree DIR --out build/div_a.npz
    python3 scripts/torch_step_divergence.py --out build/div_b.npz
    python3 scripts/torch_step_divergence.py --compare build/div_a.npz build/div_b.npz

``--tree DIR`` runs the package of the checkout DIR, with its own
``chip_smoke.py`` building the solver (default: this checkout).
``--compare`` prints, per step, both runs' pressure iterations, their
residuals at the iterations both reached, and the relative differences of
the two runs' velocity, pressure and pressure right-hand side."""

import argparse
import importlib.util
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TAIL = 3  # residuals kept before the last iteration of each pressure solve


def run(tree: str, out: str, steps: int, n: int | None, device: str) -> None:
    root = os.path.abspath(tree)
    sys.path.insert(0, root)
    spec = importlib.util.spec_from_file_location("chip_smoke_tree",
                                                  os.path.join(root, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import torch

    n = n or cs.N_ODD
    solver = cs.tgv_solver(n, torch.float32, device, rtol=1e-5)
    pcg = solver._pcg
    solve = pcg.solve
    rec = {"tail": [], "b": []}

    def logged(b, x0):
        # the truncated solves first, so that the one returned is the last call
        maxiter = pcg.maxiter
        k = int(solve(b, x0).iters)
        bn = float(torch.linalg.vector_norm(b))
        tail = []
        for m in range(k - TAIL, k):
            if m < 0:
                tail.append(np.nan)
                continue
            pcg.maxiter = m
            tail.append(float(solve(b, x0).resnorm) / bn)
        pcg.maxiter = maxiter
        res = solve(b, x0)
        check = int(res.iters)
        if check != k:
            raise RuntimeError(f"the pressure solve is not repeatable: {k} then {check} iterations")
        rec["tail"].append(tail + [float(res.resnorm) / bn])
        rec["b"].append(b.detach().cpu().numpy())
        return res

    pcg.solve = logged
    fields = {k: [] for k in ("u", "p", "p_iters", "p_res", "u_iters", "u_res")}
    for _ in range(cs.WARMUP + steps):
        st = solver.run(1, cs.DT, cs.NU, max_iter=1)
        fields["u"].append(np.stack([f.x.array.detach().cpu().numpy() for f in solver._u]))
        fields["p"].append(solver._p.x.array.detach().cpu().numpy())
        for k in ("p_iters", "p_res", "u_iters", "u_res"):
            fields[k].append(np.asarray(st[k])[0])
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    np.savez(out, warmup=cs.WARMUP, tail=np.asarray(rec["tail"]), b=np.stack(rec["b"]),
             **{k: np.stack(v) for k, v in fields.items()})
    print(f"[divergence] {root}: {cs.WARMUP} + {steps} steps at N={n} on {device}; pressure "
          f"iterations {np.stack(fields['p_iters']).tolist()}; written to {out}")


def compare(a_path: str, b_path: str) -> None:
    a, b = np.load(a_path), np.load(b_path)
    warm = int(a["warmup"])
    rel = lambda x, y: float(np.abs(x - y).max() / np.abs(y).max())
    print(f"[divergence] {a_path} (a) against {b_path} (b); step numbers count from the end of "
          f"the {warm} warm-up steps (negative: warm-up); relative residual resnorm / |b| of "
          f"each pressure solve at the iterations both runs reached (the last {TAIL + 1} of "
          "each)")
    for s in range(a["p_iters"].shape[0]):
        ka, kb = int(a["p_iters"][s]), int(b["p_iters"][s])
        at = lambda r, k: {k - TAIL + i: v for i, v in enumerate(r[s]) if k - TAIL + i >= 0}
        ra, rb = at(a["tail"], ka), at(b["tail"], kb)
        both = " ".join(f"{k}: {ra[k]:.4e}/{rb[k]:.4e}" for k in sorted(set(ra) & set(rb)))
        bn = np.linalg.norm(b["b"][s])
        print(f"  step {s - warm:3d}: p iterations {ka}/{kb}{' DIFFER' if ka != kb else ''}; "
              f"u iterations {a['u_iters'][s].tolist()}/{b['u_iters'][s].tolist()}; "
              f"residuals {both}; rel diff u {rel(a['u'][s], b['u'][s]):.3e} "
              f"p {rel(a['p'][s], b['p'][s]):.3e}, |b_a - b_b| / |b_b| "
              f"{np.linalg.norm(a['b'][s] - b['b'][s]) / bn:.3e}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=REPO, metavar="DIR", help="the checkout to run")
    ap.add_argument("--out", metavar="NPZ", help="where to write the run's record")
    ap.add_argument("--steps", type=int, default=25, help="steps after the warm-up")
    ap.add_argument("--n", type=int, help="cells an axis (default chip_smoke's N_ODD, 35)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--compare", nargs=2, metavar="NPZ", help="compare two records")
    args = ap.parse_args()
    if args.compare:
        compare(*args.compare)
    elif args.out:
        run(args.tree, args.out, args.steps, args.n, args.device)
    else:
        ap.error("give --out or --compare")
    return 0


if __name__ == "__main__":
    sys.exit(main())
