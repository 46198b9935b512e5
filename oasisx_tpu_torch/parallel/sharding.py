"""The cell decompositions of the general path, for one rank: the
graph-halo mode's partition and the replicated mode's cell block.

``shard_problem_halo`` is the counterpart of the function of that name in
``oasisx_tpu/parallel/sharding.py`` (oasisx_tpu sharding.py:208-360).  Every rank runs the same host NumPy:
the partition of the cells into ``ndev`` blocks (``partition``
"multilevel": ``partition.choose_partition``, the cheaper of the multilevel
edge-cut partition and RCB by exact exchange cost; "rcb":
``graph.rcb_partition``), the shard-blocked cell order ``cell_perm`` (block
s holds shard s's cells in ascending order, padded with -1 to ``B`` cells),
and each space's exchange tables (``graph.build_halo_exchange``), so the
local numbering and ``nloc`` are the JAX package's and a rank's vectors
compare slot for slot with the JAX shard's block.

The JAX package pads every shard to ``B`` cells with detJ = 0; a rank here
holds only its own cells, in block order (the JAX shard's leading rows).
The rank's ``DeviceContext`` carries its cells' geometry, its local cell
dofmaps and its exchange rounds, so the engine's gathers refresh and its
scatters fold (``assembly/engine.py``).  The outlet facets are grouped by
the shard of their cell, in their original order, their cells localized to
the block.

``shard_problem`` is the replicated mode (oasisx_tpu sharding.py:94-205,
``options["replicated"]``): rank r holds the contiguous block of
``B = ceil(nc / ndev)`` cells ``[r B, min((r + 1) B, nc))``, the JAX
package's split, with the canonical dofmaps, so its dof vectors stay whole
and every scatter ends in one sum over the ranks (``assembly/engine.py``).
The JAX package pads the last blocks with cells of detJ = 0; ranks here are
processes whose shapes may differ, so a rank holds only its own cells, and
each rank's partial sums group the same cells as the JAX shard's do.  The
outlet facets go to the rank of their cell, in their order, their cells
localized to its block.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from ..assembly import engine as eng
from ..assembly.facets import FacetContext
from .graph import HaloExchange, HaloRounds, build_halo_exchange, halo_rounds, rcb_partition

PARTITIONERS = ("multilevel", "rcb")


@dataclass
class HaloShard:
    """One rank's part of the graph-halo decomposition."""

    rank: int
    ndev: int
    B: int  # cells per shard (the largest shard's count)
    shard_of: np.ndarray  # (nc,) the shard of each cell
    cell_perm: np.ndarray  # (ndev * B,) the shard-blocked cell order, -1 padded
    cells: np.ndarray  # this rank's cells, in block order
    hx_v: HaloExchange  # every shard's tables (host)
    hx_q: HaloExchange
    rounds_v: HaloRounds  # this rank's rounds (device)
    rounds_q: HaloRounds
    ctx: eng.DeviceContext  # this rank's cells, local dof numbering
    partition: dict = field(default_factory=dict)  # name and schedule cost of the choice
    times: dict = field(default_factory=dict)  # set-up seconds by part


def partition_cells(mesh, cd_v: np.ndarray, cd_q: np.ndarray, ndev: int,
                    partitioner: str = "multilevel") -> tuple[np.ndarray, dict]:
    """(the shard of each cell, the choice's name and cost): the JAX
    package's choice for ``partitioner``."""
    if partitioner not in PARTITIONERS:
        raise ValueError(f"unknown partitioner {partitioner!r}: one of {PARTITIONERS}")
    cent = mesh.x[mesh.cells].mean(axis=1)
    if partitioner == "rcb":
        return rcb_partition(np.asarray(cent), ndev), dict(name="rcb")
    from .partition import choose_partition

    info: dict = {}
    shard_of = choose_partition(np.asarray(mesh.cells), np.asarray(cent), ndev,
                                dofmaps=[np.asarray(cd_v), np.asarray(cd_q)], info=info)
    return shard_of, info


def shard_blocks(shard_of: np.ndarray, ndev: int) -> tuple[int, np.ndarray]:
    """(B, cell_perm): cells a shard, and the shard-blocked cell order."""
    nc = shard_of.shape[0]
    B = -(-nc // ndev)
    cell_perm = np.full(B * ndev, -1, dtype=np.int64)
    for s in range(ndev):
        cs = np.where(shard_of == s)[0]
        cell_perm[s * B:s * B + len(cs)] = cs
    return B, cell_perm


def shard_problem_halo(comm, mesh, el_v, cd_v: np.ndarray, el_q, cd_q: np.ndarray, dtype,
                       device, partitioner: str = "multilevel") -> HaloShard:
    """This rank's cells, exchange tables and element context (``comm``:
    ``parallel.comm.Comm``, one rank of ``comm.size`` shards)."""
    ndev, k = comm.size, comm.rank
    t0 = time.perf_counter()
    shard_of, choice = partition_cells(mesh, cd_v, cd_q, ndev, partitioner)
    t1 = time.perf_counter()
    B, cell_perm = shard_blocks(shard_of, ndev)
    hx_v = build_halo_exchange(np.asarray(cd_v), shard_of, ndev, cell_perm, B)
    hx_q = build_halo_exchange(np.asarray(cd_q), shard_of, ndev, cell_perm, B)
    t2 = time.perf_counter()
    block = cell_perm[k * B:(k + 1) * B]
    cells = block[block >= 0]
    rows = slice(k * B, k * B + len(cells))
    ctx, _ = eng.build_device_context(
        mesh, el_v, hx_v.cell_dofs_local[rows], hx_v.nloc, el_q, hx_q.cell_dofs_local[rows],
        hx_q.nloc, dtype, device, cells=cells)
    rv, rq = halo_rounds(hx_v, k, dtype, device), halo_rounds(hx_q, k, dtype, device)
    ctx.halo_v, ctx.halo_q, ctx.comm = rv, rq, comm
    t3 = time.perf_counter()
    return HaloShard(
        rank=k, ndev=ndev, B=B, shard_of=shard_of, cell_perm=cell_perm, cells=cells,
        hx_v=hx_v, hx_q=hx_q, rounds_v=rv, rounds_q=rq, ctx=ctx, partition=choice,
        times=dict(partition_s=t1 - t0, exchange_s=t2 - t1, context_s=t3 - t2))


@dataclass
class ReplicatedShard:
    """One rank's cell block of the replicated mode."""

    rank: int
    ndev: int
    B: int  # cells a block (the last blocks may hold fewer)
    shard_of: np.ndarray  # (nc,) the block of each cell
    cells: np.ndarray  # this rank's cells, ascending
    ctx: eng.DeviceContext  # this rank's cells, canonical dof numbering


def shard_problem(comm, mesh, el_v, cd_v: np.ndarray, nv: int, el_q, cd_q: np.ndarray, nq: int,
                  dtype, device) -> ReplicatedShard:
    """This rank's block of cells and its element context (``comm``:
    ``parallel.comm.Comm``), whose scatters sum over the ranks."""
    ndev, k = comm.size, comm.rank
    nc = len(mesh.cells)
    B = -(-nc // ndev)
    shard_of = np.arange(nc) // B
    cells = np.arange(k * B, min((k + 1) * B, nc))
    ctx, _ = eng.build_device_context(mesh, el_v, np.asarray(cd_v)[cells], nv, el_q,
                                      np.asarray(cd_q)[cells], nq, dtype, device, cells=cells)
    ctx.comm = comm
    return ReplicatedShard(rank=k, ndev=ndev, B=B, shard_of=shard_of, cells=cells, ctx=ctx)


def local_facets(fctx: FacetContext, sh: HaloShard | ReplicatedShard) -> FacetContext:
    """The facets of ``fctx`` whose cell is on this rank, in their order,
    the cells as positions in the rank's block, the touched dofs in its
    V numbering (local under graph-halo, canonical when replicated)."""
    cells = fctx.cells.cpu().numpy()
    sel = np.flatnonzero(sh.shard_of[cells] == sh.rank)
    pos = np.full(sh.shard_of.shape[0], -1, dtype=np.int64)
    pos[sh.cells] = np.arange(len(sh.cells))
    cl = pos[cells[sel]]
    fcd = sh.ctx.cd_v.cpu().numpy()[cl]
    dofs, inv = np.unique(fcd.reshape(-1), return_inverse=True)
    tmap = eng.build_transpose_map(inv.reshape(fcd.shape), len(dofs))
    dev = fctx.scale.device
    i = lambda a: torch.as_tensor(np.asarray(a, np.int64), device=dev)
    s = i(sel)
    return FacetContext(
        cells=i(cl), local=fctx.local[s], scale=fctx.scale[s], normal=fctx.normal[s],
        qw=fctx.qw, dphi_v=fctx.dphi_v, phi_q=fctx.phi_q, dofs_v=i(dofs), pos_v=i(tmap),
        nfacets=int(len(sel)))
