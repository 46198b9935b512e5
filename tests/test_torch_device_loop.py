"""The device while loop (``la/device_loop.py``) and the Krylov solvers
written on it, on the CPU in float64, where the loop runs in Python.

- The loop itself: zero trips, a loop capped by its counter, a data-
  dependent early stop, a body that updates a carry tensor in place, and
  the host reads it counts (one a test of the condition).
- ``cg`` (plain, with the constant nullspace, with a ``nullvec``),
  ``bicgstab``, ``gmres`` (restart 5 and 30, an exact breakdown, the
  iteration limit), ``cg_batched`` and ``bicgstab_batched`` (batch 1-3)
  against ``oasisx_tpu.la.krylov`` on seeded operators (n <= 200): equal
  iterations, reasons and converged flags, x to 1e-10 relative.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from oasisx_tpu.la import krylov as jk  # noqa: E402
from oasisx_tpu_torch.la import device_loop as dl  # noqa: E402
from oasisx_tpu_torch.la import krylov as tk  # noqa: E402

N = 120


def _i(v):
    return torch.tensor(v, dtype=torch.int32)


def test_loop_zero_trips():
    calls = []
    (x, k), syncs = dl.while_loop(lambda x, k: k < 0, lambda x, k: calls.append(1) or (x, k),
                                  (torch.ones(3), _i(0)))
    assert not calls and syncs == 1 and int(k) == 0


def test_loop_capped_by_its_counter():
    (x, k), syncs = dl.while_loop(lambda x, k: k < 7, lambda x, k: (0.5 * x + 1.0, k + 1),
                                  (torch.zeros(4, dtype=torch.float64), _i(0)))
    ref = 0.0
    for _ in range(7):
        ref = 0.5 * ref + 1.0
    assert int(k) == 7 and syncs == 8
    assert torch.equal(x, torch.full((4,), ref, dtype=torch.float64))


def test_loop_early_stop_and_in_place_body():
    """Halve a vector until its norm is at most 1 (4 trips from 10), the
    body writing the vector in place and returning it."""
    def body(v, k):
        v.mul_(0.5)
        return v, k + 1

    v0 = torch.full((4,), 5.0, dtype=torch.float64)
    (v, k), syncs = dl.while_loop(lambda v, k: (torch.linalg.vector_norm(v) > 1.0) & (k < 100),
                                  body, (v0, _i(0)))
    assert int(k) == 4 and syncs == 5 and v is v0
    assert torch.equal(v, torch.full((4,), 5.0 / 16, dtype=torch.float64))


def test_loop_buffers_refuse_a_changed_carry():
    """The carry buffers of a captured loop (``_assign``) refuse a shape or
    type the body changed, and take outputs that alias another buffer."""
    with pytest.raises(ValueError, match="changed carry 0"):
        dl._assign((torch.zeros(3),), (torch.zeros(4),))
    with pytest.raises(ValueError, match="returned 1 values for a carry of 2"):
        dl._assign((torch.zeros(3), torch.zeros(3)), (torch.zeros(3),))
    a, b = torch.zeros(3), torch.ones(3)
    dl._assign((a, b), (b, a))  # swapped: each output aliases the other buffer
    assert torch.equal(a, torch.ones(3)) and torch.equal(b, torch.zeros(3))


def _spd(rng, n=N, singular=False):
    Q = rng.standard_normal((n, n))
    A = Q @ Q.T / n + np.eye(n) * rng.uniform(0.5, 2.0, n)
    if singular:
        P = np.eye(n) - np.ones((n, n)) / n
        A = P @ A @ P
    return A


def _nonsym(rng, n=N):
    return _spd(rng, n) + 0.4 * rng.standard_normal((n, n)) / np.sqrt(n)


def _ops(A):
    Aj, At = jnp.asarray(A), torch.tensor(A)
    d = np.abs(np.diag(A))
    return (lambda v: Aj @ v, jk.jacobi_preconditioner(jnp.asarray(d)), lambda v: At @ v,
            tk.jacobi_preconditioner(torch.tensor(d)))


def _same(got, ref, reason=True):
    np.testing.assert_array_equal(np.asarray(got.iters), np.asarray(ref.iters))
    np.testing.assert_array_equal(np.asarray(got.converged), np.asarray(ref.converged))
    if reason:
        assert int(got.reason) == int(ref.reason)
    x = np.asarray(ref.x)
    assert np.abs(got.x.numpy() - x).max() <= 1e-10 * np.abs(x).max()


@pytest.mark.parametrize("case", ["plain", "nullspace", "nullvec"])
def test_cg_matches_jax(case):
    rng = np.random.default_rng(21)
    n = 150
    A = _spd(rng, n, singular=case == "nullspace")
    nv = None
    if case == "nullvec":  # a weighted nullspace vector: A projected against it
        nv = rng.uniform(0.5, 1.5, n)
        P = np.eye(n) - np.outer(nv, nv) / (nv @ nv)
        A = P @ A @ P
    b, x0 = rng.standard_normal(n), rng.standard_normal(n)
    mj, Mj, mt, Mt = _ops(A)
    kw = dict(rtol=1e-9, maxiter=300, project_nullspace=case != "plain")
    ref = jk.cg(mj, jnp.asarray(b), x0=jnp.asarray(x0), M=Mj,
                nullvec=None if nv is None else jnp.asarray(nv), **kw)
    got = tk.cg(mt, torch.tensor(b), x0=torch.tensor(x0), M=Mt,
                nullvec=None if nv is None else torch.tensor(nv), **kw)
    _same(got, ref)
    assert bool(got.converged) and got.syncs == int(got.iters) + 1


def test_bicgstab_matches_jax():
    rng = np.random.default_rng(22)
    A = _nonsym(rng, 180)
    b, x0 = rng.standard_normal(180), rng.standard_normal(180)
    mj, Mj, mt, Mt = _ops(A)
    ref = jk.bicgstab(mj, jnp.asarray(b), x0=jnp.asarray(x0), M=Mj, rtol=1e-10, maxiter=400)
    got = tk.bicgstab(mt, torch.tensor(b), x0=torch.tensor(x0), M=Mt, rtol=1e-10, maxiter=400)
    _same(got, ref)
    assert bool(got.converged)


def _perm_plus(n):
    """P + 3 I with P swapping coordinates 0 and 1: from b = e_0 the second
    Arnoldi step's vector is exactly 0 (an exact breakdown)."""
    A = 3.0 * np.eye(n)
    A[0, 1] = A[1, 0] = 1.0
    return A


@pytest.mark.parametrize("case", ["restart5", "restart30", "breakdown", "maxiter"])
def test_gmres_matches_jax(case):
    rng = np.random.default_rng(23)
    n = 200
    A = _perm_plus(n) if case == "breakdown" else _nonsym(rng, n)
    b = np.eye(n)[0] if case == "breakdown" else rng.standard_normal(n)
    x0 = np.zeros(n) if case == "breakdown" else rng.standard_normal(n)
    mj, Mj, mt, Mt = _ops(A)
    if case == "breakdown":
        Mj = Mt = None
    restart = {"restart5": 5, "restart30": 30, "breakdown": 5, "maxiter": 5}[case]
    kw = dict(rtol=1e-14 if case == "maxiter" else 1e-10,
              maxiter=9 if case == "maxiter" else 600, restart=restart)
    ref = jk.gmres(mj, jnp.asarray(b), x0=jnp.asarray(x0), M=Mj, **kw)
    got = tk.gmres(mt, torch.tensor(b), x0=torch.tensor(x0), M=Mt, **kw)
    _same(got, ref)
    if case == "maxiter":
        assert int(got.iters) == 9 and int(got.reason) == -3
    elif case != "breakdown":
        assert int(got.reason) == 2
        assert np.allclose(got.x.numpy(), np.linalg.solve(A, b), atol=1e-7)


@pytest.mark.parametrize("batch", [1, 2, 3])
@pytest.mark.parametrize("solver", ["cg_batched", "bicgstab_batched"])
def test_batched_matches_jax(solver, batch):
    rng = np.random.default_rng(24 + batch)
    n = 100
    A = _spd(rng, n) if solver == "cg_batched" else _nonsym(rng, n)
    B = rng.standard_normal((batch, n)) * np.array([1.0, 1e-3, 10.0])[:batch, None]
    X0 = rng.standard_normal((batch, n))
    Aj, At = jnp.asarray(A), torch.tensor(A)
    d = np.abs(np.diag(A))
    kw = dict(rtol=1e-10, maxiter=400)
    ref = getattr(jk, solver)(lambda X: X @ Aj.T, jnp.asarray(B), x0=jnp.asarray(X0),
                              M=lambda R: R / jnp.asarray(d), **kw)
    got = getattr(tk, solver)(lambda X: X @ At.T, torch.tensor(B), x0=torch.tensor(X0),
                              M=lambda R: R / torch.tensor(d), **kw)
    _same(got, ref, reason=False)
    assert bool(got.converged.all())
