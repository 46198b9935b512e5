"""Profiling: named region timers and a torch.profiler trace hook (the JAX
package's ``utils/timers.py`` on the port).

``Timer`` is a host-clock region timer.  Given ``sync`` (a tensor, a
device, or a list, tuple or dict of them) it waits for the card before it
stops the clock, with ``torch.cuda.synchronize`` on every CUDA device
named there; a tensor or a device on the CPU waits for nothing.
``timing`` returns the (count, total, mean) of a region, the shape of
dolfinx's ``timing``, and ``timing_table`` prints every region.
``profiler_trace`` records the enclosed region with torch.profiler and
writes a Chrome trace.
"""

from __future__ import annotations

import os
import time
from collections import defaultdict
from contextlib import contextmanager

import torch

_timings: dict[str, list[float]] = defaultdict(list)


def _cuda_devices(sync) -> set:
    """The CUDA devices a ``sync`` argument names; other leaves name none."""
    if isinstance(sync, torch.Tensor):
        return {sync.device} if sync.device.type == "cuda" else set()
    if isinstance(sync, (str, torch.device)):
        dev = torch.device(sync)
        return {dev} if dev.type == "cuda" else set()
    if isinstance(sync, dict):
        sync = list(sync.values())
    if isinstance(sync, (list, tuple)):
        return set().union(*(_cuda_devices(s) for s in sync))
    return set()


@contextmanager
def Timer(name: str, sync=None):
    """Region timer.  Pass ``sync`` (a tensor, a device, or a list, tuple or
    dict of them) to wait for the work queued on their CUDA devices before
    stopping the clock."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        for dev in _cuda_devices(sync):
            torch.cuda.synchronize(dev)
        _timings[name].append(time.perf_counter() - t0)


def timing(name: str) -> tuple[int, float, float]:
    """(count, total, mean) for a named region — dolfinx.common.timing shape."""
    ts = _timings.get(name, [])
    total = sum(ts)
    return len(ts), total, total / len(ts) if ts else 0.0


def timing_table() -> str:
    rows = ["{:<40s} {:>6s} {:>12s} {:>12s}".format("region", "calls", "total [s]", "mean [s]")]
    for name in sorted(_timings):
        n, tot, mean = timing(name)
        rows.append(f"{name:<40s} {n:>6d} {tot:>12.4f} {mean:>12.6f}")
    return "\n".join(rows)


def reset_timings() -> None:
    _timings.clear()


@contextmanager
def profiler_trace(logdir: str = os.path.join("build", "profiler_trace")):
    """Record the enclosed region with torch.profiler (CPU activity, and
    CUDA's when a card is present) and write it as a Chrome trace,
    ``trace_<pid>_<ns>.json``, into ``logdir``; yields the profiler."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, f"trace_{os.getpid()}_{time.time_ns()}.json"))
