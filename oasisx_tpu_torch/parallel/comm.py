"""The collectives of the slab-sharded solver, over ``torch.distributed``.

One process per rank; the JAX package's ``jax.lax`` collectives map so:

=============== ===================================== ==================
``jax.lax``     here                                  used for
=============== ===================================== ==================
``ppermute``    ``Comm.shift`` (one plane to a        halo refresh and
                neighbour, one from the other)        fold
``psum``        ``Comm.sum``                          Krylov dots, norms;
                                                      the replicated
                                                      mode's products
``all_gather``  ``Comm.gather`` (equal slabs)         the gathered MG,
                                                      state reads
``axis_index``  ``Comm.rank``; ``Comm.size``          —
=============== ===================================== ==================

Backends.  NCCL, where each rank has a card of its own (``cuda:{rank}``).
NCCL refuses two ranks on one card, so where ranks share a card, or run on
the CPU, the backend is gloo.  Gloo's ``send``/``recv`` take CPU memory
only: under gloo every CUDA tensor passes through the host (a copy to the
CPU, the collective, a copy back), which also waits for the card.

``Comm.sum`` gathers the ranks' partial values and adds them in rank order
on every rank, so every rank holds the same bits whatever the backend's
reduction order: the Krylov loops take their exit decision on each rank
from these sums, and ranks that disagreed there would deadlock.

Every collective of the group runs under the timeout given to
``init_process_group`` (``parallel/launch.py`` passes one), so a rank that
waits for a partner that never comes fails instead of hanging.

``Comm.stats`` counts each kind of call (``shift``: every halo exchange,
with or without a partner) and the bytes this rank sent, for the per-step
traffic report.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


class Comm:
    """The ranks of one process group, each owning one slab."""

    def __init__(self, group=None):
        self.group = group
        self.rank = dist.get_rank(group)
        self.size = dist.get_world_size(group)
        self.backend = str(dist.get_backend(group))
        self.host = self.backend != "nccl"  # stage CUDA tensors through the host
        self.stats = {"shift": [0, 0], "sum": [0, 0], "gather": [0, 0]}

    def reset_stats(self) -> None:
        for v in self.stats.values():
            v[0] = v[1] = 0

    def _global(self, r: int) -> int:
        return r if self.group is None else dist.get_global_rank(self.group, r)

    def _out(self, t: torch.Tensor) -> torch.Tensor:
        return t.cpu() if self.host else t

    def shift(self, send: torch.Tensor | None, dst: int | None, src: int | None,
              like: torch.Tensor) -> torch.Tensor | None:
        """Send ``send`` to rank ``dst`` and receive a tensor shaped as
        ``like`` from rank ``src`` (either None: no such partner).  Returns
        the received tensor on ``like``'s device, or None."""
        reqs, buf = [], None
        self.stats["shift"][0] += 1
        if dst is not None:
            s = self._out(send.contiguous())
            self.stats["shift"][1] += s.numel() * s.element_size()
            reqs.append(dist.isend(s, self._global(dst), group=self.group))
        if src is not None:
            buf = torch.empty(like.shape, dtype=like.dtype,
                              device="cpu" if self.host else like.device)
            reqs.append(dist.irecv(buf, self._global(src), group=self.group))
        for q in reqs:
            q.wait()
        if buf is None:
            return None
        return buf.to(like.device, non_blocking=False)

    def _gather(self, t: torch.Tensor, kind: str) -> torch.Tensor:
        s = self._out(t.contiguous())
        self.stats[kind][0] += 1
        self.stats[kind][1] += s.numel() * s.element_size()
        parts = [torch.empty_like(s) for _ in range(self.size)]
        dist.all_gather(parts, s, group=self.group)
        return torch.stack(parts).to(t.device)

    def gather(self, t: torch.Tensor) -> torch.Tensor:
        """The ranks' equal-shaped tensors stacked in rank order:
        (size, *t.shape), on ``t``'s device."""
        return t[None] if self.size == 1 else self._gather(t, "gather")

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum over ranks of ``t`` (a few scalars, or under the
        replicated mode a whole dof vector), added in rank order: the same
        bits on every rank."""
        if self.size == 1:
            return t
        g = self._gather(t, "sum")
        out = g[0]
        for k in range(1, self.size):
            out = out + g[k]
        return out

    def barrier(self) -> None:
        if self.size > 1:
            dist.barrier(group=self.group)


def as_comm(device_mesh) -> Comm:
    """The ``Comm`` of a ``device_mesh`` argument: a ``Comm``, a 1-D
    ``torch.distributed.device_mesh.DeviceMesh`` (its one group), or a
    ``ProcessGroup`` (``dist.group.WORLD`` for all ranks)."""
    if isinstance(device_mesh, Comm):
        return device_mesh
    get_group = getattr(device_mesh, "get_group", None)
    if get_group is None and not isinstance(device_mesh, dist.ProcessGroup):
        raise TypeError(f"device_mesh: expected a DeviceMesh, a ProcessGroup or a Comm, got "
                        f"{type(device_mesh).__name__}")
    if not dist.is_initialized():
        raise RuntimeError("a device_mesh needs an initialised torch.distributed process group")
    if get_group is not None:
        if getattr(device_mesh, "ndim", 1) != 1:
            raise ValueError(f"the slab path takes a 1-D device mesh, got {device_mesh.ndim}-D")
        return Comm(get_group())
    return Comm(None if device_mesh is dist.group.WORLD else device_mesh)
