"""``FractionalStep_AB_CN.run``'s device program: one time step captured
as a CUDA graph and replayed once a step (the JAX package's ``jit`` of a
``lax.scan`` over ``_raw_step``, oasisx_tpu/fracstep.py:3332-3446).

A ``StepGraph`` holds the step's static buffers, which the captured step
reads and writes in place:

- the state (u, u1, u2, p, dp, duc), handed over at the end of each step
  in the order ``HAND_OVER`` (u2 <- u1 before u1 <- u: the step returns
  the old u1 as the new u2);
- the boundary values: one (d, n) vector, or a table of ``rows`` steps
  whose row the step selects by a device step index ``k``;
- the outlet values, likewise;
- the time ``t``, a 0-d tensor of the solver's dtype, advanced by dt each
  step as the JAX package's traced time is (t = t + dt);
- the per-step stats and the step callback's outputs, each a table of
  ``rows`` steps written at row ``k``.

``k`` advances at the end of the step, so ``run(n)`` is n replays and one
read of the tables.  On the card the first ``run`` warms the step up once
(its lazy set-up: the kernels' library, cuBLAS), puts the state back and
captures one step; the wrappers count the capture's launches in
``assembly.kernels.RecordedCounts``, which adds them once per replay.  The
step's device while loops (``la/device_loop.py``: the inner ``max_iter``
loop, the Krylov loops of the option solves) are conditional nodes in the
graph, each with a trip counter on the device; the counters are zeroed
before a call's replays and read with the tables after them, and each
loop's body launches are added once a trip.  On the CPU the same step body
runs n times without capture, its loops in Python.

A step callback must be torch on the device: a host read inside it (a
NumPy call on ``t``, ``float(t)``, ``.item()``) fails the capture, and the
error names the callback.  There is no eager fallback: ``run`` raises.
"""

from __future__ import annotations

import contextlib
import gc

import torch
import torch.utils._pytree as pytree

from .assembly import kernels as kn
from .la import device_loop as dl

# the order in which a step's new state overwrites the static state: the
# step returns the static u1 itself as the new u2, so u2 is written first
HAND_OVER = ("u2", "u1", "u", "p", "dp", "duc")
MIN_ROWS = 32  # the fewest steps the tables of a StepGraph hold


def table_rows(num_steps: int) -> int:
    """The rows of a StepGraph's tables for a call of ``num_steps`` steps:
    a power of two, at least ``MIN_ROWS``; a later call of at most as many
    steps replays the same graph."""
    return max(MIN_ROWS, 1 << (int(num_steps) - 1).bit_length())


def hand_over(dst: dict, src: dict) -> None:
    """Copy the state ``src`` into the buffers ``dst`` in ``HAND_OVER``'s
    order (no copy where ``src`` holds the buffer itself)."""
    for key in HAND_OVER:
        if src[key] is not dst[key]:
            dst[key].copy_(src[key])


@contextlib.contextmanager
def host_reads_allowed(device: torch.device):
    """Lift ``torch.cuda.set_sync_debug_mode`` for a read that the run
    makes on purpose (the stats, once a call), and set it back after."""
    if device.type != "cuda":
        yield
        return
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode(0)
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(prev)


class CallbackError(RuntimeError):
    """A step callback that failed inside the graph's body."""


class StepGraph:
    """The static buffers of ``key``'s step and, on the card, its graph.

    ``step(state, bc_vals, h_qvals)`` is the solver's step at fixed dt, nu,
    max_error and max_iter: it returns (new state, stats, host syncs).
    ``bc`` is the call's (d, n) boundary values or, with ``seq_bc``, its
    table (num_steps, d, n); ``h`` the outlets' values or tables, likewise
    with ``seq_h``."""

    def __init__(self, key, step, state: dict, bc, h: list, seq_bc: bool, seq_h: bool,
                 rows: int, dt: float, callback=None):
        self.key, self.step, self.callback, self.rows = key, step, callback, rows
        self.seq_bc, self.seq_h, self.dt = seq_bc, seq_h, dt
        self.device, dtype = bc.device, bc.dtype
        self.state = {k: torch.empty_like(v) for k, v in state.items()}
        row = lambda a: torch.empty((rows,) + tuple(a.shape[1:]), dtype=a.dtype, device=a.device)
        self.bc = row(bc) if seq_bc else torch.empty_like(bc)
        self.h = [row(a) if seq_h else torch.empty_like(a) for a in h]
        self.k = torch.zeros((), dtype=torch.long, device=self.device)
        self.t = torch.zeros((), dtype=dtype, device=self.device)
        self.stats = self.outs = self.spec = None  # tables, allocated by the first step
        self.graph = self.counts = self.trips = None
        self.loops: list = []  # the graph's while loops: (body's RecordedCounts, trip counter)
        self.syncs = self.replays = 0

    # --- the step body ----------------------------------------------------
    def _write(self, tables: dict | None, values: dict) -> dict:
        """Write the step's values into row k of their tables (allocated
        at the first step)."""
        if tables is None:
            tables = {n: torch.empty((self.rows,) + tuple(v.shape), dtype=v.dtype,
                                     device=self.device) for n, v in values.items()}
        kk = self.k.view(1)
        for n, v in values.items():
            tables[n].index_copy_(0, kk, v.unsqueeze(0))
        return tables

    def _callback(self, t: torch.Tensor) -> dict:
        name = getattr(self.callback, "__qualname__", None) or repr(self.callback)
        try:
            out = self.callback(dict(self.state), t)
        except Exception as e:
            raise CallbackError(f"step_callback {name} failed inside the run's step (a callback "
                                f"there must be torch on the device, with no host read): "
                                f"{type(e).__name__}: {e}") from e
        leaves, spec = pytree.tree_flatten(out)
        for leaf in leaves:
            if not isinstance(leaf, torch.Tensor) or leaf.device != self.device:
                raise CallbackError(f"step_callback {name} returned "
                                    f"{type(leaf).__name__} {leaf!r}: a callback returns "
                                    f"tensors on {self.device}")
        if self.spec is None:
            self.spec = spec
        return {str(i): leaf for i, leaf in enumerate(leaves)}

    def body(self) -> int:
        """One step on the static buffers; returns its host syncs."""
        kk = self.k.view(1)
        bc = self.bc.index_select(0, kk)[0] if self.seq_bc else self.bc
        h = [a.index_select(0, kk)[0] if self.seq_h else a for a in self.h]
        new, stats, syncs = self.step(self.state, bc, h)
        t = self.t + self.dt
        self.t.copy_(t)
        hand_over(self.state, new)
        self.stats = self._write(self.stats, stats)
        if self.callback is not None:
            self.outs = self._write(self.outs, self._callback(t))
        self.k.add_(1)
        return syncs

    # --- a call -----------------------------------------------------------
    def load(self, state: dict, bc, h: list, t0: float) -> None:
        """The call's state, boundary values and start time into the
        buffers, and k = 0."""
        hand_over(self.state, state)
        (self.bc[: bc.shape[0]] if self.seq_bc else self.bc).copy_(bc)
        for dst, src in zip(self.h, h):
            (dst[: src.shape[0]] if self.seq_h else dst).copy_(src)
        self.k.zero_()
        self.t.fill_(t0)

    def capture(self, t0: float) -> None:
        """Warm the step up once on the loaded buffers (its launches not
        counted), load them again, and capture one step, its while loops
        as conditional nodes in the graph's memory pool."""
        saved = {k: v.clone() for k, v in self.state.items()}
        with kn.RecordedCounts():
            self.body()
        hand_over(self.state, saved)
        self.k.zero_()
        self.t.fill_(t0)
        del saved
        graph, pool = torch.cuda.CUDAGraph(), torch.cuda.graph_pool_handle()
        # no garbage collection while capturing: a collected graph (one in a
        # reference cycle, as a step callback that holds its solver makes)
        # is destroyed by a CUDA call that a capture forbids, and the capture
        # fails; torch.cuda.graph collects once before it begins
        gc_on = gc.isenabled()
        gc.disable()
        try:
            with kn.RecordedCounts() as counts, dl.capturing(pool, self.device) as loops:
                with torch.cuda.graph(graph, pool=pool, capture_error_mode="thread_local"):
                    syncs = self.body()
        except Exception as e:
            cause = e
            while cause is not None and not isinstance(cause, CallbackError):
                cause = cause.__cause__ or cause.__context__
            if cause is not None:
                raise CallbackError(str(cause)) from e
            raise RuntimeError(f"capturing the step as a CUDA graph failed ({type(e).__name__}: "
                               f"{e}); the run mode is 'graph', which has no eager "
                               f"fallback") from e
        finally:
            if gc_on:
                gc.enable()
        self.graph, self.counts, self.syncs = graph, counts, syncs
        self.loops, self.trips = loops.loops, loops.trips[: len(loops.loops)]

    def run(self, n: int) -> list[int]:
        """n steps from the loaded buffers: n replays on the card (the
        loops' trip counters zeroed first), the body n times on the CPU.
        Returns each step's host syncs."""
        if self.graph is None:
            return [self.body() for _ in range(n)]
        if self.loops:
            self.trips.zero_()
        for _ in range(n):
            self.graph.replay()
        self.replays += n
        return [self.syncs] * n

    def read(self, n: int) -> tuple[dict, object]:
        """The first n rows of the stats and of the callback's outputs
        (None without a callback), on the host: the call's one read (a copy
        also on the CPU, where the next call writes the tables again).  On
        the card the loops' trips are read with them, and the wrappers'
        counters advanced by the capture's launches n times and by each
        loop body's launches once a trip."""
        host = lambda v: v[:n].to("cpu", copy=True).numpy()
        with host_reads_allowed(self.device):
            stats = {k: host(v) for k, v in self.stats.items()}
            trips = self.trips.tolist() if self.loops else []
            leaves = None if self.outs is None else \
                [host(self.outs[str(i)]) for i in range(len(self.outs))]
        if self.graph is not None:
            self.counts.replayed(n, [(body, t) for (body, _), t in zip(self.loops, trips)])
        if leaves is None:
            return stats, None
        return stats, pytree.tree_unflatten(leaves, self.spec)
