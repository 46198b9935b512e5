"""``oasisx_tpu_torch.utils.timers`` against ``oasisx_tpu.utils.timers``:
the same regions timed through both modules give the same counts and the
(count, total, mean) shape; ``timing_table``'s header and rows have the
JAX module's layout character for character once the times are equal;
``reset_timings`` empties both; ``Timer``'s ``sync`` takes a tensor, a
device, or a list, tuple or dict of them, and on the CPU waits for
nothing; ``profiler_trace`` writes a Chrome trace on the CPU."""

import json
import re

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402
import oasisx_tpu.utils.timers as jt  # noqa: E402
import oasisx_tpu_torch.utils as tu  # noqa: E402
from oasisx_tpu_torch.utils import timers as tt  # noqa: E402

REGIONS = {"assemble": 3, "solve/pressure": 1, "a region whose name is long enough": 2}


@pytest.fixture(autouse=True)
def _clean():
    jt.reset_timings()
    tt.reset_timings()
    yield
    jt.reset_timings()
    tt.reset_timings()


def _time_all():
    for name, n in REGIONS.items():
        for _ in range(n):
            with jt.Timer(name, sync=jnp.ones(3)):
                pass
            with tt.Timer(name, sync=torch.ones(3)):
                pass


def test_public_names():
    assert set(tu.__all__) == {"Timer", "timing", "timing_table", "reset_timings",
                               "profiler_trace"}


def test_counts_totals_and_shape():
    _time_all()
    for name, n in REGIONS.items():
        got, ref = tt.timing(name), jt.timing(name)
        assert isinstance(got, tuple) and len(got) == 3
        assert got[0] == ref[0] == n
        assert got[1] >= 0.0 and got[2] == pytest.approx(got[1] / n)
        assert got[1] == pytest.approx(sum(tt._timings[name]))
    assert tt.timing("never timed") == jt.timing("never timed") == (0, 0, 0.0)


def test_timing_table_layout():
    _time_all()
    # equal times in both modules: the tables must then be equal strings
    for name in REGIONS:
        tt._timings[name] = list(jt._timings[name])
    assert tt.timing_table() == jt.timing_table()
    lines = tt.timing_table().splitlines()
    assert lines[0] == "{:<40s} {:>6s} {:>12s} {:>12s}".format(
        "region", "calls", "total [s]", "mean [s]")
    assert [ln.split()[0] for ln in lines[1:2]] == ["a"]  # sorted by name
    assert all(re.fullmatch(r".{40} +\d+ +\d+\.\d{4} +\d+\.\d{6}", ln) for ln in lines[1:])


def test_reset_timings():
    _time_all()
    tt.reset_timings()
    assert tt.timing("assemble") == (0, 0, 0.0)
    assert tt.timing_table() == jt.timing_table().splitlines()[0]


def test_sync_arguments():
    # a tensor, a device name, a device, nested containers and other leaves:
    # nothing to wait for on the CPU
    assert tt._cuda_devices(torch.ones(2)) == set()
    assert tt._cuda_devices(["cpu", torch.device("cpu"), {"x": (torch.ones(1), 3)}]) == set()
    assert tt._cuda_devices("cuda:0") == {torch.device("cuda:0")}
    assert tt._cuda_devices({"a": [torch.device("cuda", 1)]}) == {torch.device("cuda", 1)}
    with tt.Timer("sync", sync={"u": torch.ones(2), "dev": "cpu"}):
        pass
    assert tt.timing("sync")[0] == 1


def test_timer_records_on_exception():
    with pytest.raises(ValueError):
        with tt.Timer("raises"):
            raise ValueError("inside the region")
    assert tt.timing("raises")[0] == 1


def test_profiler_trace_writes_chrome_trace(tmp_path):
    with tt.profiler_trace(str(tmp_path)) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    files = list(tmp_path.glob("trace_*.json"))
    assert len(files) == 1
    trace = json.loads(files[0].read_text())
    assert trace["traceEvents"]
    assert any("mm" in e.key for e in prof.key_averages())
