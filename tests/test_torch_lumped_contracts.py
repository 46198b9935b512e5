"""The contracts of tests/test_lumped_update.py on the port's lumped
velocity update (the port alone, on the CPU in float64): within 2e-2 of the
CG update after 5 steps and not equal to it, stable over 150 steps at N=8
on the structured path, and the ``lumped: True`` alias on both paths."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import oasisx_tpu_torch as T  # noqa: E402
import oasisx_tpu_torch.meshes as TM  # noqa: E402
import oasisx_tpu_torch.spaces as TS  # noqa: E402
from tests.test_torch_lumped import DT, LUMPED, NU, _check_lumped, _tgv2d  # noqa: E402


def test_lumped_update_close_to_consistent():
    """Within 2e-2 of the CG update after 5 steps at N=12, and not equal to
    it (tests/test_lumped_update.py)."""
    a = _tgv2d(T, TM, TS, 12, scalar=LUMPED, rtol=1e-8, device="cpu")
    b = _tgv2d(T, TM, TS, 12, rtol=1e-8, device="cpu")
    assert b.config_report()["velocity_update"] == "cg"
    sa, sb = a.run(5, DT, 0.05, max_iter=1), b.run(5, DT, 0.05, max_iter=1)
    _check_lumped(a, sa)
    assert (sb["c_iters"] > 0).any()
    ua, ub = a._u[0].x.array.numpy(), b._u[0].x.array.numpy()
    scale = np.abs(ub).max()
    assert 0 < np.abs(ua - ub).max() < 2e-2 * scale


def test_lumped_update_long_horizon_stable():
    """150 steps of the decaying vortex at N=8, dt 2e-3, nu 1/1600: the
    lumped run tracks the CG run."""
    dt, nu = 2e-3, 1.0 / 1600.0
    a = _tgv2d(T, TM, TS, 8, scalar=LUMPED, dt=dt, nu=nu, rtol=1e-8, device="cpu")
    b = _tgv2d(T, TM, TS, 8, dt=dt, nu=nu, rtol=1e-8, device="cpu")
    sa = a.run(150, dt, nu, max_iter=1)
    b.run(150, dt, nu, max_iter=1)
    assert (sa["c_iters"] == 0).all() and sa["c_converged"].all()
    ua, ub = a._u[0].x.array.numpy(), b._u[0].x.array.numpy()
    assert np.isfinite(ua).all()
    scale = np.abs(ub).max()
    assert np.abs(ua).max() < 2 * scale
    assert np.abs(ua - ub).max() < 2e-2 * scale


@pytest.mark.parametrize("options", [None, {"structured": False}], ids=["structured", "general"])
def test_lumped_alias_key(options):
    s = _tgv2d(T, TM, TS, 8, scalar={"lumped": True}, options=options, device="cpu")
    assert s.config_report()["velocity_update"] == "lumped"
    s.solve(DT, NU, max_iter=1)
    assert (s.last_stats["c_iters"] == 0).all()
