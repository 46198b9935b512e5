"""The structured path's tentative ``ksp_type`` cg against the JAX package,
on the CPU in float64.

- The port runs batched CG on K3's product (its plain version on the CPU)
  with identity bc rows, the JAX package's kernel-path formulation; the
  JAX XLA path runs the same CG a component at a time on the element
  stack.  The bench problem (3D Taylor-Green on the box) at N=4, rtol
  1e-12, Jacobi-CG pressure on both, 3 steps with the tentative solves
  capped at 300 iterations: the tentative system is not symmetric, and
  from the second step on CG stalls there in both packages (x0 = 2 u1 -
  u2 is not the bc value on the bc rows after the velocity update), so
  the cap is reached where the JAX package reaches it.  Every u, p and c
  iteration count and converged flag equal, u and p to 1e-10 relative;
  the host reads a step (one a CG iteration) counted.
- ``config_report``: "cg" on that path, without K2 (bicgstab); GMRES keeps
  batched BiCGStab on the structured path, as the JAX kernel path does,
  and iterates exactly as the default bcgs.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import oasisx_tpu as J  # noqa: E402
import oasisx_tpu.meshes as JM  # noqa: E402
import oasisx_tpu_torch as T  # noqa: E402
import oasisx_tpu_torch.meshes as TM  # noqa: E402
from tests.test_torch_slice import DT, NU, TGV, _up  # noqa: E402

N, RTOL, STEPS, CG_CAP = 4, 1e-12, 3, 300


def _box(pkg, meshes, tentative, N=N, **kw):
    mesh = meshes.create_box((-1.0, -1.0, -1.0), (1.0, 1.0, 1.0), (N, N, N))
    facets = mesh.exterior_facet_indices()
    tags = meshes.meshtags(mesh, mesh.dim - 1, facets, np.full_like(facets, 1))
    bcs_u = [[pkg.DirichletBC(f, pkg.LocatorMethod.TOPOLOGICAL, (tags, 1))] for f in TGV]
    opts = {"ksp_rtol": RTOL, "ksp_max_it": 2000}
    solver = pkg.FractionalStep_AB_CN(
        mesh, ("Lagrange", 2), ("Lagrange", 1), bcs_u=bcs_u, bcs_p=[],
        solver_options={"tentative": dict(opts, **tentative),
                        "pressure": dict(opts, pc_type="jacobi"), "scalar": dict(opts)},
        dtype=np.float64, **kw,
    )
    for f, u1, u2 in zip(TGV, solver._u1, solver._u2):
        u1.interpolate(f)
        u2.interpolate(f)
    return solver


CG = {"ksp_type": "cg", "ksp_max_it": CG_CAP}
KEYS = ("u_iters", "p_iters", "c_iters", "u_converged", "p_converged", "c_converged")


def test_structured_cg_matches_jax_xla():
    ref = _box(J, JM, CG)
    rst = ref.run(STEPS, DT, NU, max_iter=1)
    s = _box(T, TM, CG, device="cpu")
    rep = s.config_report()
    assert rep["structured_fastpath"] and rep["tentative_method"] == "cg"
    assert rep["pressure_pc"] == "jacobi-pcg"
    assert "bicgstab" not in rep["path_kernels"] and "matvec_win" in rep["path_kernels"]
    st = s.run(STEPS, DT, NU, max_iter=1)
    for k in KEYS:
        assert np.array_equal(st[k], np.asarray(rst[k])), (k, st[k], rst[k])
    # the first step converges (x0's bc rows hold the bc values), the
    # stalled rows of the later steps reach the cap in both packages
    assert st["u_converged"][0].all() and (st["u_iters"][1:] == CG_CAP).any()
    u, p = _up(s)
    u0, p0 = _up(ref)
    assert np.abs(u - u0).max() <= 1e-10 * np.abs(u0).max()
    assert np.abs(p - p0).max() <= 1e-10 * np.abs(p0).max()
    # a read an iteration of the longest component, one for the tolerance
    assert np.all(st["host_syncs"] >= st["u_iters"].max(axis=-1) + 1)


def test_structured_gmres_runs_bicgstab():
    runs = {}
    for label, tent in (("gmres", {"ksp_type": "gmres"}), ("bcgs", {})):
        s = _box(T, TM, tent, device="cpu")
        rep = s.config_report()
        assert rep["tentative_method"] == "bcgs" and "bicgstab" in rep["path_kernels"]
        runs[label] = (s.run(2, DT, NU, max_iter=1), _up(s))
    (sg, (ug, pg)), (sb, (ub, pb)) = runs["gmres"], runs["bcgs"]
    assert np.array_equal(sg["u_iters"], sb["u_iters"])
    assert np.array_equal(ug, ub) and np.array_equal(pg, pb)
