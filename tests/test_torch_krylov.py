"""The port's Krylov solvers against ``oasisx_tpu.la`` on small dense
systems in float64: equal iteration counts, solutions to 1e-10, and the
f32 rtol floor."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from oasisx_tpu import la as jla  # noqa: E402
from oasisx_tpu_torch.la import krylov as tk  # noqa: E402

N = 40


def _spd(rng, singular=False):
    Q = rng.standard_normal((N, N))
    A = Q @ Q.T + N * np.eye(N)
    if singular:  # constant nullspace, like the pure-Neumann pressure Poisson
        P = np.eye(N) - np.ones((N, N)) / N
        A = P @ A @ P
    return A


def _close(x, ref):
    ref = np.asarray(ref)
    assert np.abs(x.numpy() - ref).max() <= 1e-10 * np.abs(ref).max()


@pytest.mark.parametrize("singular", [False, True], ids=["spd", "nullspace"])
def test_cg(singular):
    rng = np.random.default_rng(11)
    A = _spd(rng, singular)
    b, x0, d = rng.standard_normal(N), rng.standard_normal(N), np.abs(np.diag(A))
    nv = np.ones(N) if singular else None
    kw = dict(rtol=1e-9, maxiter=200, project_nullspace=singular)
    ref = jla.cg(lambda v: jnp.asarray(A) @ v, jnp.asarray(b), x0=jnp.asarray(x0),
                 M=jla.jacobi_preconditioner(jnp.asarray(d)),
                 nullvec=None if nv is None else jnp.asarray(nv), **kw)
    At = torch.tensor(A)
    got = tk.cg(lambda v: At @ v, torch.tensor(b), x0=torch.tensor(x0),
                M=tk.jacobi_preconditioner(torch.tensor(d)),
                nullvec=None if nv is None else torch.tensor(nv), **kw)
    assert bool(got.converged) and int(got.iters) == int(ref.iters)
    assert got.syncs == int(got.iters) + 1
    _close(got.x, ref.x)


@pytest.mark.parametrize("solver", ["cg_batched", "bicgstab_batched"])
def test_batched(solver):
    """Three systems sharing one operator, rows converging at different
    iterations (active-row freezing)."""
    rng = np.random.default_rng(12)
    A = _spd(rng)
    if solver == "bicgstab_batched":
        A = A + 0.3 * N * np.triu(rng.standard_normal((N, N)), 1) / np.sqrt(N)
    B = rng.standard_normal((3, N)) * np.array([[1.0], [1e-3], [10.0]])
    X0 = np.zeros((3, N))
    X0[1] = np.linalg.solve(A, B[1]) * (1 + 1e-4)  # an almost-converged row
    d = np.abs(np.diag(A))
    ref = getattr(jla, solver)(lambda V: V @ jnp.asarray(A).T, jnp.asarray(B),
                               x0=jnp.asarray(X0), M=jla.jacobi_preconditioner(jnp.asarray(d)),
                               rtol=1e-9, maxiter=200)
    At = torch.tensor(A)
    got = getattr(tk, solver)(lambda V: V @ At.T, torch.tensor(B), x0=torch.tensor(X0),
                              M=tk.jacobi_preconditioner(torch.tensor(d)), rtol=1e-9,
                              maxiter=200)
    assert got.converged.all()
    assert np.array_equal(got.iters.numpy(), np.asarray(ref.iters))
    assert len(set(got.iters.tolist())) > 1
    _close(got.x, ref.x)


def test_effective_rtol_floor():
    assert tk._effective_rtol(1e-13, torch.float32) == pytest.approx(50 * np.finfo(np.float32).eps)
    assert tk._effective_rtol(1e-13, torch.float64) == 1e-13
    assert tk._effective_rtol(1e-5, torch.float32) == 1e-5
