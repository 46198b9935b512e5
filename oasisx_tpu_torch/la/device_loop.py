"""A while loop on the device: the counterpart of ``jax.lax.while_loop``.

``while_loop(cond_fn, body_fn, carry)`` runs ``carry = body_fn(*carry)``
while ``cond_fn(*carry)`` (a 0-d bool tensor) holds, over a fixed tuple of
carry tensors whose shapes and types the body keeps.  It returns the last
carry and the host reads it made.

- Outside a capture (on the CPU, on the card in ``run``'s per-step loop, in
  the split-phase API and the sharded modes), it is a Python loop that reads the condition once a trip, as a host loop over a
  device scalar must: each read counts in the returned syncs.
- Inside ``step_graph.StepGraph.capture`` (``capturing``) it captures a
  CUDA conditional WHILE node (``csrc/graph_loop.cu``): the carry copied
  into buffers of the loop's own, a kernel setting the node's condition
  from ``cond_fn``'s value before the node, the body captured from a second
  stream into the node's body graph, each trip ending by copying the body's
  outputs into the buffers and setting the condition again on the device.
  A loop inside a body (a Krylov solve inside the inner ``max_iter`` loop, a
  GMRES cycle's Arnoldi steps inside its restart loop) is a node inside that
  body, captured from the next stream.  No host read: syncs 0.

The body's allocations come from the graph's memory pool: while the body is
captured, this thread's allocations are routed there
(``torch._C._cuda_beginAllocateCurrentThreadToPool``) in place of the
capture's own filter, which matches only the capturing stream.  A body may
return a carry tensor it updated in place (no copy then); an output that
shares memory with another carry buffer is cloned before the buffers are
written.

Each captured loop records its body's kernel launches (``RecordedCounts``,
which takes them out of the enclosing capture's count) and counts its trips
in a device counter that ``StepGraph`` zeroes before a call's replays and
reads with the stats after them, so that a replay's launches are counted as
many times as the body ran.  A node that cannot be built raises: there is no
eager fallback inside a capture.
"""

from __future__ import annotations

import contextlib
import ctypes
from typing import Callable

import torch

from ..assembly import kernels as kn

# the deepest nesting of loops inside one capture: the inner max_iter loop,
# a GMRES restart loop in it, its Arnoldi steps; one body stream a level
MAX_DEPTH = 4
# the most loops one capture holds (their trip counters are allocated before
# it begins)
MAX_LOOPS = 256


class LoopCapture:
    """The device loops captured into one CUDA graph: its memory pool, its
    device, the body streams (one a nesting level), the loops' trip
    counters and, for each loop in the order captured, (its body's
    ``RecordedCounts``, its trip counter).

    The counters are one tensor allocated before the capture, outside the
    graph's pool: a counter allocated inside a body would share memory with
    the body's temporaries of the trip before (the pool hands their blocks
    on in the order of the capture, which a loop's next trip repeats)."""

    def __init__(self, pool, device: torch.device):
        if device.index is None:
            device = torch.device(device.type, torch.cuda.current_device())
        self.pool, self.device, self.depth = pool, device, 0
        self.streams = [_body_stream(device, k) for k in range(MAX_DEPTH)]
        self.trips = torch.zeros(MAX_LOOPS, dtype=torch.int64, device=device)
        self.loops: list = []


_capture: LoopCapture | None = None
_streams: dict = {}


def _body_stream(device: torch.device, depth: int) -> torch.cuda.Stream:
    """The stream that captures the bodies at nesting level ``depth``, made
    once a device and level.  Its cuBLAS workspace is allocated at its
    first use, inside a body's capture, from that graph's pool and kept by
    torch for the stream.  (Setting it up before the capture moved the
    graph pool's memory, and a graph with no loop replayed ~3% slower on an
    H100.)"""
    key = (device.index, depth)
    if key not in _streams:
        _streams[key] = torch.cuda.Stream(device)
    return _streams[key]


@contextlib.contextmanager
def capturing(pool, device: torch.device):
    """The while loops called inside this block, while the current stream
    captures into a graph whose memory pool is ``pool``, become conditional
    nodes; yields the ``LoopCapture`` that lists them.  Enter it before the
    capture begins (it allocates the trip counters)."""
    global _capture
    prev, _capture = _capture, LoopCapture(pool, device)
    try:
        yield _capture
    finally:
        _capture = prev


def while_loop(cond_fn: Callable, body_fn: Callable, carry):
    """Run ``body_fn`` while ``cond_fn`` holds; returns (carry, host reads).

    ``cond_fn(*carry)`` is a 0-d bool tensor, ``body_fn(*carry)`` the next
    carry."""
    carry = tuple(carry)
    if not (carry[0].is_cuda and torch.cuda.is_current_stream_capturing()):
        syncs = 0
        while True:
            syncs += 1
            if not bool(cond_fn(*carry)):
                return carry, syncs
            carry = tuple(body_fn(*carry))
    if _capture is None or _capture.device != carry[0].device:
        raise RuntimeError("a device while loop inside a CUDA graph capture that is not a "
                           "StepGraph's (step_graph.StepGraph.capture)")
    return _node(_capture, cond_fn, body_fn, carry), 0


def _check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"device while loop: {what} failed with CUDA error {err} (a "
                           "conditional WHILE node needs CUDA 12.4 or later)")


def _shares(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.untyped_storage().data_ptr() == b.untyped_storage().data_ptr()


def _assign(bufs: tuple, out: tuple) -> None:
    """Write the body's outputs into the carry buffers; an output that is
    a buffer itself stays, one that shares another buffer's memory is
    cloned first (its source may be written before it is read)."""
    if len(out) != len(bufs):
        raise ValueError(f"the loop body returned {len(out)} values for a carry of {len(bufs)}")
    staged = []
    for i, (b, o) in enumerate(zip(bufs, out)):
        if o.shape != b.shape or o.dtype != b.dtype:
            raise ValueError(f"the loop body changed carry {i}: {tuple(b.shape)} {b.dtype} -> "
                             f"{tuple(o.shape)} {o.dtype}")
        if o is not b and any(_shares(o, c) for c in bufs):
            o = o.clone()
        staged.append(o)
    for b, o in zip(bufs, staged):
        if o is not b:
            b.copy_(o)


def _flag(cond) -> torch.Tensor:
    return cond.to(torch.bool).reshape(()).contiguous()


def _route_to_pool(device: torch.device, pool) -> None:
    """Route this thread's allocations to ``pool`` in place of the filter
    recording to it now (the capture's, or the enclosing body's)."""
    torch._C._cuda_endAllocateToPool(device.index, pool)
    torch._C._cuda_beginAllocateCurrentThreadToPool(device.index, pool)
    torch._C._cuda_releasePool(device.index, pool)  # the begin's reference: the graph holds one


def _node(cap: LoopCapture, cond_fn: Callable, body_fn: Callable, carry: tuple) -> tuple:
    """Capture the loop as a conditional WHILE node; returns its carry
    buffers, which hold the last carry once the node has run."""
    from .._build import library

    if cap.depth >= MAX_DEPTH or len(cap.loops) >= MAX_LOOPS:
        raise RuntimeError(f"device while loops nested deeper than {MAX_DEPTH}, or more than "
                           f"{MAX_LOOPS} in one capture")
    lib, dev = library(), cap.device
    bufs = tuple(t.clone() for t in carry)
    flag = _flag(cond_fn(*bufs))
    slot = len(cap.loops)  # a nested loop, captured inside the body, takes the next one
    cap.loops.append(None)
    trips = cap.trips[slot]  # zeroed before each call's replays
    stream = torch.cuda.current_stream(dev)
    body = cap.streams[cap.depth]
    handle = ctypes.c_ulonglong(0)
    _check(lib.oasisx_loop_open(ctypes.c_void_p(stream.cuda_stream),
                                ctypes.c_void_p(body.cuda_stream), ctypes.c_void_p(flag.data_ptr()),
                                ctypes.c_void_p(ctypes.addressof(handle))), "oasisx_loop_open")
    kn.launches["graph_loop"] += 1
    cap.depth += 1
    _route_to_pool(dev, cap.pool)
    try:
        with kn.RecordedCounts() as counts, torch.cuda.stream(body):
            _assign(bufs, tuple(body_fn(*bufs)))
            trips.add_(1)
            end = _flag(cond_fn(*bufs))
            _check(lib.oasisx_loop_close(ctypes.c_void_p(body.cuda_stream),
                                         ctypes.c_void_p(end.data_ptr()),
                                         ctypes.c_longlong(handle.value - (handle.value >> 63 << 64))),
                   "oasisx_loop_close")
            kn.launches["graph_loop"] += 1
    except BaseException:
        lib.oasisx_loop_abort(ctypes.c_void_p(body.cuda_stream))
        raise
    finally:
        cap.depth -= 1
        _route_to_pool(dev, cap.pool)
    cap.loops[slot] = (counts, trips)
    return bufs
