"""The port's solver state between calls, on the CPU in float64
(tests/test_resident_state.py's contracts, restated for the port).

The port keeps the state of the last ``run`` on the device with the tensor
versions of the Functions it wrote; the next call reuses it while those
versions are unchanged and rebuilds it from the Functions (with a zero
warm-start correction) once one was written.  So:

- back-to-back ``run`` windows equal one window, bit for bit;
- a host read between windows changes nothing, bit for bit;
- a write through ``x.array`` or ``interpolate`` is picked up: rewound to
  the initial state by writes, the next window repeats the first, bit for
  bit;
- a split-phase step writes the Functions, so the next ``run`` rebuilds
  its state from them: ``run`` after split steps equals the split sequence
  taking the same steps to the solves' tolerance (``run``'s tentative
  guess is 2 u1 - u2, the split phase's u), where a window started from
  the state parked before the split steps would be a step behind.
``scan_window`` (the JAX package's window bound) is not ported.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import oasisx_tpu_torch as T  # noqa: E402
import oasisx_tpu_torch.meshes as TM  # noqa: E402
import oasisx_tpu_torch.spaces as TS  # noqa: E402
from tests.test_torch_lumped import _tgv2d  # noqa: E402
from tests.test_torch_split_phase import split_step  # noqa: E402

DT, NU = 0.01, 0.05


def _fresh():
    return _tgv2d(T, TM, TS, 6, dt=DT, nu=NU, device="cpu")


def _snapshot(s):
    fs = [*s._u, *s._u1, *s._u2, s._p, s._ps, s._dp]
    return [f.x.array.clone() for f in fs]


def _equal(a, b):
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_split_windows_match_single_window():
    a, b = _fresh(), _fresh()
    a.run(3, DT, NU, max_iter=1)
    assert a._state_from_functions() is a._state  # parked for the next window
    a.run(3, DT, NU, max_iter=1)
    b.run(6, DT, NU, max_iter=1)
    _equal(_snapshot(a), _snapshot(b))


def test_host_read_between_windows_changes_nothing():
    a, b = _fresh(), _fresh()
    a.run(3, DT, NU, max_iter=1)
    _ = a._u[0].x.array.cpu().numpy(), a._p.x.array.sum()
    assert a._state_from_functions() is a._state
    a.run(3, DT, NU, max_iter=1)
    b.run(3, DT, NU, max_iter=1)
    b.run(3, DT, NU, max_iter=1)
    _equal(_snapshot(a), _snapshot(b))


@pytest.mark.parametrize("how", ["x.array", "interpolate"])
def test_host_write_between_windows_is_picked_up(how):
    s, init = _fresh(), _fresh()
    s.run(3, DT, NU, max_iter=1)
    ref = _snapshot(s)
    # rewind by writes to the initial state: the parked state must not shadow it
    for g, h in zip([*s._u, *s._u1, *s._u2, s._p, s._dp],
                    [*init._u, *init._u1, *init._u2, init._p, init._dp]):
        if how == "x.array":
            g.x.array[:] = h.x.array
        else:
            vals = h.x.array.numpy().copy()
            g.interpolate(lambda x, v=vals: v)
    assert s._state_from_functions() is not s._state
    s.run(3, DT, NU, max_iter=1)
    _equal(_snapshot(s), ref)


def test_split_step_then_run_picks_up_the_functions():
    a, b, stale = _fresh(), _fresh(), _fresh()
    for s in (a, b, stale):
        s.run(2, DT, NU, max_iter=1)
    for s in (a, b):
        split_step(s, DT, NU)
    a.run(1, DT, NU, max_iter=1)
    split_step(b, DT, NU)
    stale.run(1, DT, NU, max_iter=1)  # what a run from the parked state would give
    ua = torch.stack([f.x.array for f in a._u])
    ub = torch.stack([f.x.array for f in b._u])
    us = torch.stack([f.x.array for f in stale._u])
    scale = float(ub.abs().max())
    assert float((ua - ub).abs().max()) <= 1e-9 * scale
    assert float((a._p.x.array - b._p.x.array).abs().max()) <= 1e-9 * float(
        b._p.x.array.abs().max())
    assert float((us - ub).abs().max()) > 1e-4 * scale
    # the split sequence's rotation leaves p = ps; run writes ps = p
    assert torch.equal(a._ps.x.array, a._p.x.array)
