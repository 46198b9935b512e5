"""``oasisx_tpu_torch.demo.assembly_strategies`` against the JAX package,
on the CPU in float64.

- Both strategies of the port ("action": ``engine.pressure_gradient_vecs``;
  "matvec": ``pressure_gradient_mats`` then ``matvec_vq`` a component) on
  the demo's random p against the JAX engine's ``pressure_gradient_vecs``
  and ``matvec_vq`` on the same p, in 2D and 3D at velocity degrees 1-3
  (pressure max(du - 1, 1)) on small unit meshes: 1e-12 relative to the
  largest entry.
- ``main`` runs at small sizes in float64 and float32, prints the
  mean/std/min/count table with a row a degree and method, and writes the
  CSV with ``--outfile``; ``bench_degree`` refuses strategies that
  disagree.
"""

import csv

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402
import oasisx_tpu.meshes as JM  # noqa: E402
from oasisx_tpu.assembly import engine as jeng  # noqa: E402
from oasisx_tpu.spaces import FunctionSpace as JFS  # noqa: E402

import oasisx_tpu_torch.meshes as TM  # noqa: E402
from oasisx_tpu_torch.demo import assembly_strategies as demo  # noqa: E402


def _jax_strategies(mesh, du, dp):
    V, Q = JFS(mesh, ("Lagrange", du)), JFS(mesh, ("Lagrange", dp))
    ctx, _ = jeng.build_device_context(mesh, V.element, V.dofmap.cell_dofs, V.num_dofs,
                                       Q.element, Q.dofmap.cell_dofs, Q.num_dofs, np.float64)
    p = jnp.asarray(np.random.RandomState(0).randn(Q.num_dofs))
    mats = jeng.pressure_gradient_mats(ctx)
    r_m = jnp.stack([jeng.matvec_vq(ctx, mats[i], p) for i in range(mats.shape[0])])
    return np.asarray(jeng.pressure_gradient_vecs(ctx, p)), np.asarray(r_m)


@pytest.mark.parametrize("dim,n", [(2, 2), (3, 2)])
@pytest.mark.parametrize("du", [1, 2, 3])
def test_strategies_match_jax(dim, n, du):
    dp = max(du - 1, 1)
    jmesh = JM.create_unit_cube(n) if dim == 3 else JM.create_unit_square(3 * n)
    tmesh = TM.create_unit_cube(n) if dim == 3 else TM.create_unit_square(3 * n)
    ra_ref, rm_ref = _jax_strategies(jmesh, du, dp)
    ndofs, action, matvec = demo.strategies(tmesh, du, dp, torch.float64, torch.device("cpu"))
    ra, rm = action().numpy(), matvec().numpy()
    assert ra.shape == ra_ref.shape == (dim, ndofs)
    scale = np.abs(ra_ref).max()
    assert np.abs(ra - ra_ref).max() <= 1e-12 * scale
    assert np.abs(rm - rm_ref).max() <= 1e-12 * scale
    assert np.abs(ra - rm).max() <= 1e-12 * scale


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_main_prints_table(dtype, capsys, tmp_path):
    out = tmp_path / "strategies"
    demo.main(["--dim", "2", "-n", "2", "--max-degree", "3", "--repeats", "2",
               "--device", "cpu", "--dtype", dtype, "--outfile", str(out)])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].split() == ["P", "num_dofs", "method", "procs", "mean", "std", "min",
                                "count"]
    rows = [ln.split() for ln in lines[1:]]
    assert [(r[0], r[2], r[-1]) for r in rows] == [
        (str(p), m, "2") for p in (1, 2, 3) for m in ("action", "matvec")]
    with open(f"{out}.csv") as f:
        assert len(list(csv.DictReader(f))) == 3 * 2 * 2


def test_bench_degree_refuses_disagreement(monkeypatch):
    mesh = TM.create_unit_square(4)
    real = demo.strategies

    def broken(*a, **kw):
        ndofs, action, matvec = real(*a, **kw)
        return ndofs, action, lambda: matvec() * (1.0 + 1e-6)

    monkeypatch.setattr(demo, "strategies", broken)
    with pytest.raises(AssertionError, match="strategy mismatch"):
        demo.bench_degree(mesh, 2, 1, 1, torch.float64, torch.device("cpu"))
