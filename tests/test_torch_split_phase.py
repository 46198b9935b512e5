"""The split-phase API of the port's solver against the JAX package's, on the
CPU in float64.

- Phase by phase, 2 steps (each a sequence of ``ps = p``, the six methods,
  then ``u2 <- u1 <- u``, ``p <- ps``): ``_b_first``, ``_rhs1``, ``_b2``,
  ``_dp``, ``_ps`` and ``_u`` after each step to 1e-10 relative to their
  largest entry, the diff and every reason equal, against the JAX XLA path
  with the kernel path's tentative x0 and Jacobi-CG pressure (rtol 1e-12):
  the 6x6 Taylor-Green rectangle on the structured path, standard and
  rotational (where the structured update takes (div u, q) as -dt b2 with
  ``pressure_assemble``'s dt), the rectangle sent to the general path
  (``structured: False``), and the res=10 DFG cylinder with its outlet and
  the rotational update.
- The fused ``solve`` against the split sequence, one step, to 1e-9
  (tests/test_taylor_green.py's check, on the port).
- The reason codes: 2 where a solve converged, -3 where its iteration
  limit stopped it; ``RuntimeError`` before ``assemble_first``.

The split phases' launches are counted on the card by chip_smoke.py phase
4k; here each phase's plain calls are.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import oasisx_tpu as J  # noqa: E402
import oasisx_tpu.meshes as JM  # noqa: E402
import oasisx_tpu.spaces as JS  # noqa: E402
import oasisx_tpu_torch as T  # noqa: E402
import oasisx_tpu_torch.meshes as TM  # noqa: E402
import oasisx_tpu_torch.spaces as TS  # noqa: E402
from oasisx_tpu_torch.assembly import kernels as kn  # noqa: E402
from tests.test_torch_lumped import _tgv2d  # noqa: E402
from tests.test_torch_options import _cylinder  # noqa: E402
from tests.test_torch_slice import _kernel_path_x0  # noqa: E402

RTOL = 1e-10
DT, NU = 0.01, 0.01
JACOBI = {"pc_type": "jacobi"}
VECTORS = ("_b_first", "_rhs1", "_u", "_b2", "_dp", "_ps")


def _arr(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def split_step(s, dt, nu):
    """One step by the split phases (tests/test_taylor_green.py's sequence):
    returns the phases' vectors on the host and (diff, u reasons, p reason,
    c reasons)."""
    for bcs in s._bcs_u:
        for bc in bcs:
            bc.update_bc()
    s._ps.x.array[:] = s._p.x.array
    s.assemble_first(dt, nu)
    s.velocity_tentative_assemble()
    diff, ru = s.velocity_tentative_solve()
    s.pressure_assemble(dt)
    rp = s.pressure_solve(nu)
    rc = s.velocity_update(dt)
    out = {k: np.stack([_arr(f.x.array) for f in getattr(s, k)]) for k in VECTORS[:3]}
    out.update({k: _arr(getattr(s, k).x.array).copy() for k in VECTORS[3:]})
    for i in range(len(s._u)):
        s._u2[i].x.array[:] = s._u1[i].x.array
        s._u1[i].x.array[:] = s._u[i].x.array
    s._p.x.array[:] = s._ps.x.array
    return out, (diff, ru, rp, rc)


def _pair(case):
    """The JAX and the port solver of a case."""
    if case == "cylinder-rotational":
        pair = (_cylinder(J, JM, JACOBI, {}, rotational=True),
                _cylinder(T, TM, JACOBI, {}, rotational=True, device="cpu"))
        for s in pair:  # the inflow profile everywhere: no phase's vector is 0
            for f in (s._u1[0], s._u2[0]):
                f.interpolate(lambda x: 1.2 * x[1] * (0.41 - x[1]) / 0.41**2)
        return pair
    opts = {"structured": False} if case == "general" else None
    kw = dict(pressure=JACOBI, options=opts, rotational=case == "structured-rotational")
    return _tgv2d(J, JM, JS, 6, **kw), _tgv2d(T, TM, TS, 6, device="cpu", **kw)


CASES = ("structured", "structured-rotational", "general", "cylinder-rotational")


@pytest.mark.parametrize("case", CASES)
def test_split_phases_match_jax(case):
    sj, st = _pair(case)
    _kernel_path_x0(sj)
    rep = st.config_report()
    assert rep["structured_fastpath"] is case.startswith("structured")
    assert rep["pressure_update"] == ("rotational" if "rotational" in case else "standard")
    dt, nu = (2e-3, 1e-3) if case.startswith("cylinder") else (DT, NU)
    for step in range(2):
        kn.reset_counts()
        oj, rj = split_step(sj, dt, nu)
        ot, rt = split_step(st, dt, nu)
        for key in VECTORS:
            scale = np.abs(oj[key]).max()
            assert scale > 0, key
            err = np.abs(ot[key] - oj[key]).max() / scale
            assert err <= RTOL, (step, key, err)
        assert abs(rt[0] - rj[0]) <= RTOL * abs(rj[0])
        for a, b in zip(rt[1:], rj[1:]):
            np.testing.assert_array_equal(a, b)
            assert np.all(np.asarray(a) == 2)
        # the phases went through the step's own plain kernels
        if rep["structured_fastpath"]:
            assert kn.plain_calls["bicgstab"] == 1 and kn.plain_calls["divergence"] == 1
            assert kn.plain_calls["cg_mass"] == (2 if "rotational" in case else 1)
        else:
            assert kn.plain_calls["ell_bicgstab"] == 1


def test_fused_solve_matches_split_phase():
    """One fused step against the split sequence (x0 = 2 u1 - u2 against
    the split phase's u: the solves' tolerance apart)."""
    s1 = _tgv2d(T, TM, TS, 6, device="cpu")
    s2 = _tgv2d(T, TM, TS, 6, device="cpu")
    s1.solve(DT, NU, max_iter=1)
    split_step(s2, DT, NU)
    for a, b in zip(s1._u, s2._u):
        assert (a.x.array - b.x.array).abs().max() < 1e-9
    assert (s1._p.x.array - s2._p.x.array).abs().max() < 1e-9
    assert s1.config_report()["pressure_pc"] == "mg-pcg"


def test_reasons_and_order():
    """-3 where the iteration limit stops a solve, 2 where it converges;
    the tentative solve and the dense export refuse to run before
    assemble_first."""
    one = {"ksp_max_it": 1}
    s = _tgv2d(T, TM, TS, 6, device="cpu", tentative=one, pressure=one, scalar=one)
    with pytest.raises(RuntimeError, match="assemble_first"):
        s.velocity_tentative_solve()
    with pytest.raises(RuntimeError, match="assemble_first"):
        s.tentative_matrix_dense()
    _, (diff, ru, rp, rc) = split_step(s, DT, NU)
    assert ru.dtype == np.int32 and ru.tolist() == [-3, -3]
    assert rp == -3 and rc.tolist() == [-3, -3] and diff > 0
    ok = _tgv2d(T, TM, TS, 6, device="cpu")
    _, (_, ru, rp, rc) = split_step(ok, DT, NU)
    assert ru.tolist() == [2, 2] and rp == 2 and rc.tolist() == [2, 2]
