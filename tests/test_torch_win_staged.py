"""K3's cube-owned product (``csrc/cube_ops.cu`` ``oasisx_matvec_win``: phase
A a thread a cube into a stage, phase B K13's scatter with the zmask) on the
CPU, with NumPy and torch alone:

- the wrapper refuses a missing, short, mis-typed or flat stage before any
  launch, as K2's does (``_matvec_win_kernel`` checks before it loads the
  library, so CPU tensors show the refusal);
- the stage's leading size, ``kernels.STAGE_BATCH``, is the kernels'
  ``kMaxBatch`` (``csrc/cube_device.cuh``), the components of one launch;
- ``chip_smoke.py``'s K3 cases at the N=4 shapes, the new "W zmask batch 3"
  (the tentative solve's r0) included, each its kernel call against its
  plain call (both plain on the CPU) and against
  ``matvec_win_staged_plain``, the kernel's order of sums, to 1e-13 in
  float64 (1e-5 in float32);
- ``chip_smoke.py``'s sweep of K3 over every cube degree (1-3 in 3D; 1, 2,
  3 and 7 in 2D) at batch 1-5, with and without the multipliers, runs on
  the CPU on its two small grids (its large ones, which the card's
  cube-owned routes need, hold W of up to 0.6 GB).

The kernel runs only on the card, where ``chip_smoke.py`` holds every one of
these cases to its plain version and names the route of each launch.
"""

import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import chip_smoke as cs  # noqa: E402
from oasisx_tpu_torch import _build  # noqa: E402
from oasisx_tpu_torch.assembly import cubes as cub  # noqa: E402
from oasisx_tpu_torch.assembly import kernels as kn  # noqa: E402


@pytest.fixture(scope="module")
def solver():
    return cs.tgv_solver(4, torch.float64, "cpu", 1e-8)


@pytest.mark.parametrize("bad", ["none", "short", "int32", "float32", "flat", "batch"])
def test_wrapper_refuses_bad_stage(solver, bad):
    sm = solver._sm_v
    B = 5  # two launches: the stage holds one launch's STAGE_BATCH components
    nl, nc, npad = cub.num_slots(sm), int(np.prod(sm[1])), int(np.prod(sm[0]))
    S = kn.STAGE_BATCH
    f64 = dict(dtype=torch.float64)
    stage = {"none": None, "short": torch.zeros((S, nl, nc - 1), **f64),
             "int32": torch.zeros((S, nl, nc), dtype=torch.int32),
             "float32": torch.zeros((S, nl, nc), dtype=torch.float32),
             "flat": torch.zeros(S * nl * nc, **f64),
             "batch": torch.zeros((B, nl, nc), **f64)}[bad]
    x = torch.zeros((B, npad), **f64)
    W = torch.zeros((nl * nl, nc), **f64)
    with pytest.raises((TypeError, ValueError), match="stage"):
        kn._matvec_win_kernel(W, x, sm, None, x, stage)
    kn._check_stage(torch.zeros((S, nl, nc), **f64), S, nl, nc, torch.float64)


def test_stage_batch_is_the_kernels_batch():
    text = (_build._CSRC / "cube_device.cuh").read_text()
    assert int(re.search(r"constexpr int kMaxBatch = (\d+);", text).group(1)) == kn.STAGE_BATCH


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_chip_smoke_win_cases(solver, dtype):
    d = solver._mesh.dim
    cases = [c for c in cs.kernel_cases(solver, dtype, "cpu") if c[0] == "matvec_win"]
    assert [c[1] for c in cases] == ["W batch 3", "W premul zmask", "W batch 1", "W zmask batch 3"]
    assert [cs.win_case(c[1], solver) for c in cases] == [
        (d, False, False), (d, True, True), (1, False, False), (d, False, True)]
    tol = 1e-13 if dtype == torch.float64 else 1e-5
    for _, label, kfn, pfn, valid, work, _ in cases:
        yk, yp = kfn(), pfn()
        assert yk.dtype == dtype and torch.equal(yk, yp), label
        assert bool((yk[..., ~valid] == 0).all()), label
        assert min(work) >= 0 and work[0] > 0 and work[1] > 0, label
    # the zmask case is the r0 product of the tentative solve: zmask * (A_W x),
    # in the kernel's order of sums
    zm, sm = solver._zmask.to(dtype), solver._sm_v
    torch.manual_seed(0)
    W = torch.randn(cub.num_slots(sm) ** 2, int(np.prod(sm[1])), dtype=dtype)
    x = torch.randn(d, solver._npad_v, dtype=dtype)
    ref = kn.matvec_win_plain(W, x, sm, zmask=zm)
    got = kn.matvec_win_staged_plain(W, x, sm, zmask=zm)
    assert torch.equal(ref, zm * kn.matvec_win_plain(W, x, sm))
    assert float((got - ref).abs().max()) <= tol * float(ref.abs().max())


def test_chip_smoke_win_sweep():
    grids = cs.WIN_SWEEP[:2]
    assert [len(cells) for cells, _ in cs.WIN_SWEEP] == [3, 2, 3, 2]
    assert [degs for _, degs in grids] == [degs for _, degs in cs.WIN_SWEEP[2:]]
    cases = cs.win_sweep_cases("cpu", grids)
    seen = {(c[0], c[3], c[4]) for c in cases}
    labels = sorted({c[0] for c in cases})
    assert labels == sorted(["3D P1 5x6x7", "3D P2 5x6x7", "3D P3 5x6x7", "2D P1 9x11",
                             "2D P2 9x11", "2D P3 9x11", "2D P7 9x11"])
    assert len(seen) == len(labels) * 5 * 2
    assert {c[2] for c in cases} == {torch.float64, torch.float32}
    cs.check_win_sweep("cpu", grids)
