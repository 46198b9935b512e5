"""The port's Chebyshev-Jacobi preconditioner and its bounds against the JAX
package's (``oasisx_tpu/la/krylov.py``), in float64 on the CPU.

The operator is the P1 pressure Laplacian of a structured grid, assembled
densely from the port's plain cube product, and handed to both packages as
the same matrix.  The preconditioner is deterministic and agrees to 1e-12.
The bound estimates start from random vectors that the two packages draw
differently (``jax.random`` against ``torch.Generator``), so they agree
only to what the power iteration resolves: each is held to the dense
``eigvalsh`` value instead, and ``validated_cheb_bounds`` to the same
accept / double decisions.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from oasisx_tpu.la import krylov as jk  # noqa: E402
from oasisx_tpu_torch.assembly import kernels as kn  # noqa: E402
from oasisx_tpu_torch.la import krylov as tk  # noqa: E402
from tests.test_torch_kernels import _both  # noqa: E402

CELLS = [(11, 11), (5, 5, 5)]


def dense_laplacian(cells):
    """(A dense, inv_diag, largest eigenvalue of D^-1 A) of the P1 pressure
    Laplacian on a structured grid of ``cells``."""
    _, tops, _, (sm_q, _, valid_q) = _both(cells)
    n = valid_q.size
    eye = torch.eye(n, dtype=torch.float64)
    A = torch.stack([kn.matvec_const_plain(eye[i], tops.Ap_c, sm_q) for i in range(n)], 1)
    A = A.numpy()
    diag = np.diag(A)
    w = np.linalg.eigvalsh(A / np.sqrt(np.outer(diag, diag)))
    return A, 1.0 / diag, float(w[-1])


@pytest.fixture(scope="module", params=CELLS, ids=lambda c: "x".join(map(str, c)))
def laplacian(request):
    return dense_laplacian(request.param)


def _ops(A, invd):
    At, Aj = torch.tensor(A), jnp.asarray(A)
    return (lambda x: At @ x, torch.tensor(invd)), (lambda x: Aj @ x, jnp.asarray(invd))


@pytest.mark.parametrize("degree", [1, 4, 8])
def test_chebyshev_preconditioner_matches_jax(laplacian, degree):
    A, invd, lam = laplacian
    (mt, it), (mj, ij) = _ops(A, invd)
    lmax = 1.02 * lam
    r = np.random.default_rng(degree).standard_normal(A.shape[0])
    zt = tk.chebyshev_preconditioner(mt, it, lmax / 30.0, lmax, degree)(torch.tensor(r))
    zj = np.asarray(jk.chebyshev_preconditioner(mj, ij, lmax / 30.0, lmax, degree)(jnp.asarray(r)))
    assert np.abs(zt.numpy() - zj).max() <= 1e-12 * np.abs(zj).max()


@pytest.mark.parametrize("scale", [1.02, 0.2], ids=["valid", "under"])
def test_validated_cheb_bounds_matches_jax(laplacian, scale):
    """A valid lmax comes back at once; one at 0.2x the true value is
    doubled as many times by both packages."""
    A, invd, lam = laplacian
    (mt, it), (mj, ij) = _ops(A, invd)
    got = tk.validated_cheb_bounds(mt, it, scale * lam, 4)
    ref = jk.validated_cheb_bounds(mj, ij, scale * lam, 4)
    assert got == pytest.approx(ref, rel=1e-15)
    if scale > 1:
        assert got == (scale * lam / 30.0, scale * lam)
    else:
        assert got[1] >= lam


def test_estimate_lmax_brackets_the_spectrum(laplacian):
    """Both packages' estimates lie within 5% of eigvalsh's, at or above
    0.98 of it."""
    A, invd, lam = laplacian
    (mt, it), (mj, ij) = _ops(A, invd)
    for est in (tk.estimate_lmax(mt, it), jk.estimate_lmax(mj, ij)):
        assert 0.98 * lam <= est <= 1.05 * lam, (est, lam)


def test_bound_start_vector_from_generator():
    """The start vector is drawn on the CPU in float64 from the generator
    and then cast: the same seed gives the same estimate in any dtype's
    rounding of it, and an explicit generator replaces the seed."""
    A = np.diag(np.arange(1.0, 41.0))
    mv = lambda x: torch.tensor(A, dtype=x.dtype) @ x
    iv = torch.ones(40, dtype=torch.float64)
    e64 = tk.estimate_lmax(mv, iv)
    e32 = tk.estimate_lmax(mv, iv.float())
    assert e32 == pytest.approx(e64, rel=1e-4)
    eg = tk.estimate_lmax(mv, iv, generator=torch.Generator().manual_seed(0))
    assert eg == e64
