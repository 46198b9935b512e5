"""The XLA pressure MG (``la/multigrid.py``) against the JAX package's, on
the CPU in float64: the transfers, the level hierarchy and one V-cycle on
a 2D and a 3D structured mesh, to 1e-12 (the JAX side jitted: run op by op
it compiles each of its small ops)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import oasisx_tpu.meshes as JM  # noqa: E402
from oasisx_tpu.la import multigrid as JMG  # noqa: E402

import oasisx_tpu_torch.meshes as TM  # noqa: E402
from oasisx_tpu_torch.la import multigrid as TMG  # noqa: E402

MESHES = {
    "2d": lambda M: M.create_rectangle((0.0, 0.0), (np.pi, np.pi), (16, 8)),
    "3d": lambda M: M.create_box((-1.0, -1.0, -1.0), (1.0, 1.0, 1.0), (8, 8, 8)),
}


@pytest.mark.parametrize("shape_c", [(5, 3), (3, 4, 5)])
def test_transfers(shape_c):
    rng = np.random.default_rng(31)
    xc = rng.standard_normal(int(np.prod(shape_c)))
    shape_f = tuple(2 * n - 1 for n in shape_c)
    rf = rng.standard_normal(int(np.prod(shape_f)))
    got = TMG.prolong(torch.as_tensor(xc), shape_c).numpy()
    ref = np.asarray(jax.jit(JMG.prolong, static_argnums=1)(jnp.asarray(xc), shape_c))
    assert np.abs(got - ref).max() <= 1e-14 * np.abs(ref).max()
    got = TMG.restrict(torch.as_tensor(rf), shape_f).numpy()
    ref = np.asarray(jax.jit(JMG.restrict, static_argnums=1)(jnp.asarray(rf), shape_f))
    assert np.abs(got - ref).max() <= 1e-14 * np.abs(ref).max()
    # restriction is prolongation's transpose
    assert np.isclose(rf @ TMG.prolong(torch.as_tensor(xc), shape_c).numpy(),
                      TMG.restrict(torch.as_tensor(rf), shape_f).numpy() @ xc, rtol=1e-12)


@pytest.mark.parametrize("dim", ["2d", "3d"])
def test_vcycle(dim):
    jmg = JMG.StructuredPoissonMG(MESHES[dim](JM), dtype=np.float64)
    tmg = TMG.StructuredPoissonMG(MESHES[dim](TM), dtype=torch.float64, device="cpu")
    assert tmg.num_levels == jmg.num_levels >= 3
    for lt, lj in zip(tmg.levels, jmg.levels):
        assert lt["grid_shape"] == lj["grid_shape"]
        assert np.array_equal(lt["gridflat"], lj["gridflat"])
        assert np.abs(lt["inv_diag"].numpy() - np.asarray(lj["inv_diag"])).max() <= 1e-12 * \
            np.abs(np.asarray(lj["inv_diag"])).max()
    pj = np.asarray(jmg._coarse_pinv)
    assert np.abs(tmg._coarse_pinv.numpy() - pj).max() <= 1e-12 * np.abs(pj).max()
    rng = np.random.default_rng(32)
    r = rng.standard_normal(int(np.prod(jmg.levels[0]["grid_shape"])))
    got = tmg.vcycle(torch.as_tensor(r)).numpy()
    ref = np.asarray(jax.jit(jmg.vcycle)(jnp.asarray(r)))
    assert np.abs(got - ref).max() <= 1e-12 * np.abs(ref).max(), np.abs(got - ref).max()


def test_refuses_grids_that_do_not_coarsen():
    with pytest.raises(ValueError, match="coarsen"):
        TMG.StructuredPoissonMG(TM.create_box((0, 0, 0), (1, 1, 1), (5, 5, 5)),
                                dtype=torch.float64, device="cpu")
