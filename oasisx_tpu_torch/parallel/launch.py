"""Start a group of rank processes and run one function on each.

``launch(fn, world, args)`` spawns ``world`` processes (the ``spawn`` start
method: each child imports ``fn``'s module afresh, so ``fn`` must live in
an importable module), joins them into one ``torch.distributed`` process
group through a ``file://`` rendezvous in a new directory under TMPDIR, calls
``fn(comm, *args)`` on each with its ``parallel.comm.Comm``, and returns the
ranks' results in rank order.  Results travel back pickled through files
in that directory, so a rank may return NumPy arrays of any size.

``start`` returns the running group at once (``Ranks``), so that the
caller can work while the ranks run, and ``join`` collects the results.

Time limits: the process group's collectives fail after ``pg_timeout``
seconds of waiting, and the whole group after ``timeout``; when a rank
fails or the time is up, every rank still running is killed and
``launch`` raises with the failed rank's traceback.  Each child runs torch
on one thread.

``rank_device(comm, device)`` names a rank's device: "cpu"; or, for
"cuda", ``cuda:{rank}`` under NCCL (a card a rank) and ``cuda:0`` under
gloo (ranks sharing the one card).

Under ``torchrun`` the same rank functions run through ``run_env``, which
joins the group from torchrun's environment variables.
"""

from __future__ import annotations

import datetime
import os
import pickle
import shutil
import tempfile
import time
import traceback

import torch
import torch.distributed as dist

from .comm import Comm

DEFAULT_PG_TIMEOUT = 60.0


def rank_device(comm: Comm, device: str) -> torch.device:
    if torch.device(device).type != "cuda":
        return torch.device(device)
    return torch.device("cuda", comm.rank if comm.backend == "nccl" else 0)


def _child(fn, rank, world, backend, init_file, pg_timeout, args, out_dir):
    os.environ["OMP_NUM_THREADS"] = "1"
    torch.set_num_threads(1)
    path = os.path.join(out_dir, f"rank{rank}")
    try:
        if backend == "nccl":
            torch.cuda.set_device(rank)
        dist.init_process_group(backend, init_method="file://" + init_file, rank=rank,
                                world_size=world,
                                timeout=datetime.timedelta(seconds=pg_timeout))
        try:
            result = fn(Comm(), *args)
        finally:
            dist.destroy_process_group()
        with open(path + ".tmp", "wb") as f:
            pickle.dump(result, f)
        os.replace(path + ".tmp", path + ".pkl")
    except BaseException:
        with open(path + ".err", "w") as f:
            f.write(traceback.format_exc())
        raise


class Ranks:
    """A started group of rank processes: ``join`` collects their results;
    as a context manager it kills whatever still runs on exit."""

    def __init__(self, fn, world: int, args: tuple, backend: str, pg_timeout: float):
        import multiprocessing as mp

        if world < 1:
            raise ValueError(f"world must be at least 1, got {world}")
        self.world = world
        self.tmp = tempfile.mkdtemp(prefix="oasisx_ranks_")
        init_file = os.path.join(self.tmp, "rendezvous")
        ctx = mp.get_context("spawn")
        self.procs = [ctx.Process(target=_child, daemon=True, args=(
            fn, r, world, backend, init_file, pg_timeout, args, self.tmp)) for r in range(world)]
        try:
            for p in self.procs:
                p.start()
        except BaseException:
            self.close()
            raise

    def _failed(self) -> str:
        time.sleep(0.5)  # a rank's partners fail after it: report them all
        msgs = []
        for r, p in enumerate(self.procs):
            err = os.path.join(self.tmp, f"rank{r}.err")
            if os.path.exists(err):
                msgs.append(f"rank {r}:\n{open(err).read()}")
            elif p.exitcode not in (None, 0):
                msgs.append(f"rank {r}: exit code {p.exitcode}")
        return f"{len(msgs)} of {self.world} ranks failed\n" + "\n".join(msgs)

    def join(self, timeout: float = 600.0) -> list:
        """The ranks' results in rank order.  Raises RuntimeError when a
        rank fails, TimeoutError after ``timeout`` seconds; either way no
        rank survives."""
        try:
            deadline = time.monotonic() + timeout
            while True:
                codes = [p.exitcode for p in self.procs]
                if any(c not in (None, 0) for c in codes):
                    raise RuntimeError(self._failed())
                if all(c == 0 for c in codes):
                    break
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{self.world} ranks still running after {timeout} s "
                                       f"(exit codes {codes})")
                time.sleep(0.05)
            out = []
            for r in range(self.world):
                with open(os.path.join(self.tmp, f"rank{r}.pkl"), "rb") as f:
                    out.append(pickle.load(f))
            return out
        finally:
            self.close()

    def close(self) -> None:
        started = [p for p in self.procs if p.pid is not None]
        for p in started:
            if p.is_alive():
                p.kill()
        for p in started:
            p.join(timeout=10)
        shutil.rmtree(self.tmp, ignore_errors=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def start(fn, world: int, args: tuple = (), *, backend: str = "gloo",
          pg_timeout: float = DEFAULT_PG_TIMEOUT) -> Ranks:
    """Spawn ``world`` ranks running ``fn(comm, *args)``; the caller may
    work meanwhile, then ``join``."""
    return Ranks(fn, world, args, backend, pg_timeout)


def launch(fn, world: int, args: tuple = (), *, backend: str = "gloo", timeout: float = 600.0,
           pg_timeout: float = DEFAULT_PG_TIMEOUT) -> list:
    """Run ``fn(comm, *args)`` on ``world`` spawned ranks; their results in
    rank order (``start`` then ``join``)."""
    return start(fn, world, args, backend=backend, pg_timeout=pg_timeout).join(timeout)


def run_env(fn, args: tuple = (), backend: str | None = None,
            pg_timeout: float = DEFAULT_PG_TIMEOUT):
    """Run ``fn(comm, *args)`` in a process that ``torchrun`` started: the
    group from its environment (RANK, WORLD_SIZE, MASTER_ADDR,
    MASTER_PORT); NCCL when every rank has a card of its own, else gloo."""
    world = int(os.environ["WORLD_SIZE"])
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() and \
            torch.cuda.device_count() >= world else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", os.environ["RANK"])))
    dist.init_process_group(backend, timeout=datetime.timedelta(seconds=pg_timeout))
    try:
        return fn(Comm(), *args)
    finally:
        dist.destroy_process_group()
