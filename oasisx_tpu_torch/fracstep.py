"""IPCS fractional-step Navier-Stokes solver (Adams-Bashforth convection,
Crank-Nicolson diffusion) on PyTorch, on one device or sharded over the
ranks of a ``torch.distributed`` group.

Counterpart of ``oasisx_tpu/fracstep.py``'s ``FractionalStep_AB_CN``.  The
solver picks one of two paths the way the JAX package does:

The structured path (a mesh from the structured generators, no outlet,
``options["structured"]`` not False): every operator application and every
solve of the step goes through one of the eight kernels of
``assembly/kernels.py``, ``la/fused.py`` and ``la/pressure_mg.py`` or
``la/pressure_cg.py`` (their plain versions on a CPU device):

  U       = the cube-local values of uab         cube_gather
  b_first = (2/dt) M u1 - A_W u1               matvec_const, matvec_win
  A_W     = (1/dt) M + (nu/2) K + 1/2 C(uab)   per-cube weights W, one matmul
  inner loop (k < max_iter and diff > max_error):
      rhs   = b_first + B ps;  rhs[bc] = g     mixed
      solve A_W u = rhs: x0[bc] = g,           bicgstab (r0 by matvec_win
        r0 = zmask rhs - zmask A_W x0, Jacobi    with its zmask)
      b2    = -(1/dt) div u                    divergence
      solve Ap dp = b2 (nullspace)             pressure_mg, or pressure_cg
      ps    = p + dp, or rotational:           (r0 = xi nu dt b2, K7's
        solve Mq ps = Mq (p + dp) - xi nu        output reused; |rhs| by
        (div u, q) from x0 = p + dp            matvec_const) cg_mass
  velocity update: solve M u_new = M u - dt G dp   cg_mass (r0 by mixed,
                                                   matvec_const)
    or, lumped: u_new = u - dt (Gw dp) / diag(M)   mixed on Gw_c
  rotate u2 <- u1 <- u_new;  p <- ps

The pressure solve is chosen as the JAX package's kernel path chooses it:
the MG-PCG (``pressure_mg``) when the pressure grid coarsens (even cell
counts) and ``options["pallas_pressure_pc"]`` is "mg" (the default); else
CG preconditioned by a degree-``options["pallas_cheb_degree"]`` (default 4)
Chebyshev acceleration of Jacobi, its bounds estimated at set-up
(``pressure_cg``), or by Jacobi alone at degree 0.  A pressure ``pc_type``
of "jacobi" or "none" selects Jacobi-CG, as on the JAX package's XLA path.

The general path (any other mesh, e.g. with ``mesh.structured = None``, or
a ``PressureBC`` outlet): element stacks assembled on the device
(``assembly/engine.py``); every solve and every stand-alone product with an
assembled operator goes through the ELL kernels of ``la/ell.py``:

  A_rhs   = -1/2 C(uab) + (1/dt) M - (nu/2) K  element stacks
  b_first = A_rhs u1 + outlet surface terms    element matvec
  A_lhs   = -A_rhs + (2/dt) M
  inner loop:
      rhs   = b_first + assemble(ps v.dx(i))
      solve A_lhs u = rhs (ELL values of A_lhs  ell_bicgstab (r0 by ell_matvec)
        assembled once per solve)
      b2    = -(1/dt) assemble(div u q); b2[outlet] = 0
      solve Ap dp = b2: outlet mask, or        ell_pcg_amg (r0 by ell_matvec)
        nullspace + zero mean
      ps    = p + dp, or rotational:           ell_cg on Mq (|rhs| by
        solve Mq ps = Mq (p + dp)                ell_matvec)
        - xi nu assemble(div u q), unmasked
  velocity update: M u_new = M u - dt G dp     ell_cg (b3, r0 by ell_matvec)
    or, lumped: u_new = u - dt (Gw dp) / diag(M), the element gather-scatter

The rotational pressure update (``rotational=True``, xi = 1/2) runs inside
the inner loop, so a further inner iteration's right-hand side sees it; its
CG takes the ``scalar`` family's tolerances, with Jacobi whatever that
family's ``pc_type``.  A ``body_force`` (a constant or a callable ``f(x)``
per component) is assembled once at set-up into b0, which is added to
b_first; without one b_first is as above.

The general path's other options, off its default configuration: a
pressure ``pc_type`` jacobi / none (Jacobi-CG) or any other non-AMG type
(Chebyshev(``cheb_degree``, default 6)-Jacobi CG), and a tentative
``ksp_type`` cg or gmres (one component at a time): Krylov loops around
K14's products (K18's in the band layout), each the JAX package's
``lax.while_loop`` as a device while loop (``la/device_loop.py``).  On the
structured path a tentative ``ksp_type`` cg is batched CG on K3's product
with identity bc rows, its loop the same; gmres runs batched BiCGStab
there, as on the JAX package's kernel path.

With ``options={"ell_layout": "band"}`` the velocity operators (A_lhs and
M) take the band-ELL layout (``assembly/band.py``, RCM order inside a
solve only): the tentative solve runs band_bicgstab (r0 by band_matvec)
and the velocity update band_cg (b3, r0 by band_matvec).  The pressure
solve stays ell_pcg_amg on the flat ELL Ap: the JAX package's band engine
ran an XLA AMG-PCG there only because its TPU could not lower the fused
V-cycle's gathers, and the AMG and the PCG are the same math.

The split-phase API runs one phase of a step per call, through the step's
own helpers, reading and writing the solver's Functions on its device (the
JAX package's split methods, oasisx_tpu fracstep.py:3499-3733):
``assemble_first`` (uab into ``_uab``, b_first into ``_b_first``, the
tentative operator kept), ``velocity_tentative_assemble`` (``_rhs1``),
``velocity_tentative_solve`` (from x0 = u, where ``run`` starts from
2 u1 - u2; returns the diff and a reason a component), ``pressure_assemble``
(``_b2``), ``pressure_solve`` (``_dp``, ``_ps``) and ``velocity_update``
(``_u``, with no warm start from a previous correction); the caller rotates
u2 <- u1 <- u and p <- ps.  ``tentative_matrix_dense`` exports the kept
operator of component 0 with its BC rows.  A split phase writes the
Functions, so the next ``run`` rebuilds its state from them.  Under a
``device_mesh`` every phase is a collective on every sharded mode: it reads
the canonical Functions into the rank's layout, runs the mode's own phase
and writes its result back canonical (a gather); the dense export applies
the mode's own tentative operator to identity columns and gathers them.

With a ``device_mesh`` the solver runs on every rank of the group, in one
of three modes, chosen as the JAX package chooses (oasisx_tpu
fracstep.py:183-304):

The slab path (the JAX package's "slab-halo" mode, taken first whatever
``options["replicated"]`` says): the cube grid cut into slabs of cube
planes along its leading axis, a slab a rank (``parallel/slab.py``); every
operator application is halo refresh -> the kernel on the slab's own
structured map -> halo fold (``parallel/comm.py`` over
``torch.distributed``): W by K8 and ``build_w``, b_first by K5 and K3, the
tentative solve batched BiCGStab (CG for a ``ksp_type`` cg) on K3 with
identity bc rows and x0 as given, the divergence by K7, the pressure CG on
K5/K12 preconditioned by the JAX package's XLA MG (``la/multigrid.py``) on
the gathered grid (Chebyshev or Jacobi for other pressure ``pc_type``s),
the velocity update batched CG on K5 with K6's gradient.  The Krylov loops
run on the host with their reductions summed over the ranks; the lumped
update falls back to the mass CG.

Where the slab path is not taken (an unstructured mesh, a PressureBC, the
rotational update, ``options["slab"]`` or ``structured`` False, a
structured mesh without a dof lattice or uniform cube geometry, or a
leading cube count the ranks do not divide), ``options["replicated"]``
selects the replicated mode and otherwise the graph-halo path runs.

The graph-halo path: the general element path on one cell block a rank
(``parallel/sharding.py`` ``shard_problem_halo``), dof vectors in the
rank's ``[owned | halo | sentinel]`` layout.  The engine's gathers refresh
the halo and its scatters fold it; every operator product is halo refresh
-> K14 on the rank's local ELL operator (K18 on its band tables under
``ell_layout`` "band", in both spaces as the JAX halo band engine) -> halo
fold (``_halo_apply``), its values assembled from the element stack once a
solve.  The two owned-dof paths share the tentative, pressure and
velocity-update solves (``_*_sharded``), each on its path's product.  The
tentative solves batched BiCGStab or CG on the batch-d product with
identity bc rows and x0 as given (GMRES a component at a time), the
pressure CG on Ap (outlet rows masked) preconditioned by the distributed
AMG (the fine level per rank, the restriction summed over the ranks, the
coarse levels on every rank), the AMG on the gathered residual where level
0 does not coarsen or with ``amg_distributed`` False, Chebyshev-Jacobi or
Jacobi; the velocity update batched CG on M, the rotational update CG on
Mq.  The Krylov loops run on the host, their reductions summed over the
ranks.

The replicated mode (``parallel/sharding.py`` ``shard_problem``; the JAX
package's debug path): a contiguous block of cells a rank, dof vectors
canonical and whole on every rank.  Every operator is the engine's element
product followed by one sum of the whole vector over the ranks (the
tentative A_lhs, M, Ap, Mq, the gradient, the divergence, the outlet
surface terms), as the JAX package runs XLA there: no kernel of this
package runs on this path.  The solves are the JAX package's XLA loops, a
component at a time, with their dots local on the whole vectors (the same
bits on every rank): BiCGStab, CG or GMRES for the tentative velocity with
identity bc rows and x0 as given, Jacobi-PCG for the pressure (the JAX
package's observable preconditioner there: ROADMAP known difference l)
with the outlet rows masked or the nullspace projected, Jacobi-CG on M for
the velocity update and on Mq for the rotational update.

On the owned-dof paths ``get_state`` / ``set_state`` use the ranks'
layouts stacked in rank order (the JAX package's internal layout), and the
Functions hold the canonical state on every rank; under the replicated
mode the state is canonical.

State (u, u1, u2, p, dp, duc) stays on the device between calls, in the
parity-split grid layout (structured) or the canonical dof order
(general); after each call it is written into the solver's Functions.  On
the card each default solve is one kernel with its loop on the device; the
option solves' Krylov loops and the inner ``max_iter`` loop are device
while loops (``la/device_loop.py``), which outside a captured step loop in
Python and read their condition once a trip, as the plain versions do.
``last_stats["host_syncs"]`` counts those reads per step; ``run`` adds
one read of the stats per call.

On one device (``config_report()["run"]`` "graph": every single-device
configuration) ``run`` is the JAX package's device program (its ``jit``
of a ``lax.scan``, oasisx_tpu fracstep.py:3332-3446): one step on static
buffers (``step_graph.py``), captured on the card as a CUDA graph and
replayed once a step, its while loops conditional nodes in the graph, the
per-step boundary values, time, stats and callback outputs in device
tables indexed by a device step counter.  The sharded modes, whose sums go
through the host, run the per-step loop ("eager: <reason>").
"""

from __future__ import annotations

import logging
import time
import weakref

import numpy as np
import torch

from .assembly import cubes as cub
from .assembly import engine as eng
from .assembly import kernels as kn
from .assembly.facets import pressure_surface_vecs
from .forms.expr import padded_coordinates, quadrature_points
from .assembly.geometry import compute_cell_geometry
from .assembly.reference_tensors import build_reference_tensors
from .assembly.structured import build_structured_map, num_padded
from .bcs import DirichletBC, PressureBC, bc_mask_and_values
from .config import real_dtype, resolve_device
from .elements.element import make_element
from .assembly.band import BandAssembly, band_values, build_band_assembly
from .la import band, device_loop as dl, ell, fused, krylov
from .la.amg import AlgebraicMG, amg_kernel_data, amg_widths, coo_from_elems
from .la.krylov import _effective_rtol
from .la.pressure_cg import PressureCG
from .la.pressure_mg import PressureMGCG
from .la.solver import KSPSolver
from .meshes.mesh import Mesh
from .parallel.graph import build_ell_assembly, ell_values, halo_fold, halo_refresh
from .parallel.sharding import local_facets, shard_problem, shard_problem_halo
from .spaces.functionspace import Function, FunctionSpace
from .step_graph import StepGraph, table_rows

__all__ = ["FractionalStep_AB_CN"]

logger = logging.getLogger("oasisx_tpu_torch")

STATE_KEYS = ("u", "u1", "u2", "p", "dp", "duc")
AMG_PC_TYPES = ("amg", "gamg", "hypre", "ml", "mg")
# tentative_matrix_dense: the largest component it exports (demo/assembly_bcs.py
# exports the dense matrix below 20,000 dofs), and the identity columns a
# product of the structured path's operator takes
DENSE_MAX_DOFS = 20000
DENSE_BATCH = 64


def _reasons(converged: torch.Tensor) -> np.ndarray:
    """PETSc-style converged reasons on the host: 2 converged, -3 not."""
    return np.where(converged.cpu().numpy(), 2, -3).astype(np.int32)


def _rel_res(rnorm: torch.Tensor, bnorm: torch.Tensor) -> torch.Tensor:
    """Relative exit residual ||b - A x|| / ||b||."""
    return rnorm / torch.clamp(bnorm, min=1e-30)


def _inv(diag: torch.Tensor) -> torch.Tensor:
    """Jacobi inverse diagonal, 1 where the diagonal is 0."""
    return torch.where(diag != 0, 1.0 / torch.where(diag != 0, diag, torch.ones_like(diag)),
                       torch.ones_like(diag))


def _lumped_inv(m_diag: torch.Tensor) -> torch.Tensor:
    """The lumped update's 1 / diag(M): 0 where the diagonal is not
    positive, so the grid's padding points stay 0."""
    pos = m_diag > 0
    return torch.where(pos, 1.0 / torch.where(pos, m_diag, torch.ones_like(m_diag)),
                       torch.zeros_like(m_diag))


def _stack(outs: list, device):
    """Stack a callback's per-step outputs (tensors, numbers, or dicts /
    tuples / lists of them) along a new leading step axis."""
    first = outs[0]
    if isinstance(first, dict):
        return {k: _stack([o[k] for o in outs], device) for k in first}
    if isinstance(first, (tuple, list)):
        return type(first)(_stack(list(c), device) for c in zip(*outs))
    return torch.stack([torch.as_tensor(o, device=device) for o in outs])


def _host(tree):
    if isinstance(tree, dict):
        return {k: _host(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_host(v) for v in tree)
    return tree.detach().cpu().numpy()


class FractionalStep_AB_CN:
    """Fractional-step solver with AB2-linearized convection and CN diffusion.

    Args mirror the JAX package's, in its order: ``mesh``, ``u_element`` /
    ``p_element`` as ("Lagrange", degree) tuples or FiniteElements,
    per-component velocity Dirichlet BCs, pressure outlet ``PressureBC``s,
    ``rotational`` (the rotational pressure update, xi = 1/2), per-family
    ``solver_options`` keyed ``tentative`` / ``pressure`` / ``scalar``
    (``la/solver.py``'s PETSc names; a ``scalar`` ``pc_type`` "lumped", or
    ``lumped: True``, selects the lumped velocity update on both paths),
    ``jit_options`` (the port compiles nothing at run time: its keys are
    logged as ignored), ``body_force`` (per component a number, a Constant
    or a callable ``f(x)`` of the (3, nc, nq) zero-padded quadrature points,
    evaluated on the host at set-up), ``options`` (``low_memory_version``:
    direct vector assembly of the mixed terms, default True, or
    preassembled mixed matrices;
    ``ell_layout``: "ell", default, or "band" for the velocity operators
    of the general path; ``structured``: False sends a structured mesh to
    the general path; ``pallas_pressure_pc`` and ``pallas_cheb_degree``:
    the structured path's pressure solve, above; ``slab``: False keeps a
    sharded structured mesh off the slab path; ``replicated``: the
    replicated mode where the slab path is not taken; ``partitioner`` and
    ``amg_distributed``: the graph-halo path's), ``dtype``, ``device_mesh``
    (None: one device; else the sharded modes of the module docstring over
    the ranks of a ``torch.distributed`` group: a 1-D ``DeviceMesh``, a
    ``ProcessGroup`` or a ``parallel.comm.Comm``, each rank calling the
    constructor and every entry point, the split phases and the dense
    export included, together) and the ``device`` every tensor of this rank
    lives on (default: the card; there is no fallback to the CPU; a rank's
    own ``cuda:{rank}`` under NCCL, the one card or the CPU under gloo).  A
    structured mesh without an outlet takes the cube path, where
    ``low_memory_version`` has no counterpart.
    """

    def __init__(
        self,
        mesh: Mesh,
        u_element,
        p_element,
        bcs_u: list[list[DirichletBC]],
        bcs_p: list[PressureBC] | tuple = (),
        rotational: bool = False,
        solver_options: dict | None = None,
        jit_options: dict | None = None,
        body_force=None,
        options: dict | None = None,
        dtype=None,
        device_mesh=None,
        device=None,
    ):
        if jit_options:
            logger.info("jit_options keys %s ignored: the port compiles its kernels ahead of "
                        "the run, nothing at run time", sorted(jit_options))
        self._rotational = bool(rotational)
        self._xi = 0.5 if self._rotational else None
        self._device = resolve_device(device)
        self._dtype = real_dtype(dtype)
        options = dict(options or {})
        layout = options.get("ell_layout", "ell")
        if layout not in ("ell", "band"):
            raise ValueError(f"unknown ell_layout {layout!r}")
        self._layout = layout
        self._low_memory = bool(options.get("low_memory_version", True))
        self._mesh = mesh
        d = mesh.dim
        el_u = make_element(u_element, mesh.cell_type)
        el_p = make_element(p_element, mesh.cell_type)

        # --- function spaces ------------------------------------------------
        self._V = FunctionSpace(mesh, el_u, shape=(d,))
        self._Q = FunctionSpace(mesh, el_p)
        self._Vi = [self._V.sub(i).collapse() for i in range(d)]
        Vi0 = self._Vi[0][0]
        fn = lambda V, name: Function(V, name, dtype=self._dtype, device=self._device)
        self._u = [fn(Vi0, f"u{i}") for i in range(d)]
        self._u1 = [fn(Vi0, f"u_{i}1") for i in range(d)]
        self._u2 = [fn(Vi0, f"u_{i}2") for i in range(d)]
        self._p = fn(self._Q, "p")
        self._dp = fn(self._Q, "dp")
        self._b0 = [fn(Vi0, f"b0_{i}") for i in range(d)]
        # the split-phase API's Functions (the JAX solver's names)
        self._uab = [fn(Vi0, f"u_{i}ab") for i in range(d)]
        self._rhs1 = [fn(Vi0, f"rhs1_{i}") for i in range(d)]
        self._b_first = [fn(Vi0, f"b_first_{i}") for i in range(d)]
        self._ps = fn(self._Q, "ps")
        self._b2 = fn(self._Q, "b2")
        self._sol_u = fn(self._V, "u")
        self._cmaps = [torch.as_tensor(cmap, dtype=torch.long, device=self._device)
                       for _, cmap in self._Vi]

        # --- boundary conditions ---------------------------------------------
        self._bcs_u = bcs_u
        for bc_i, (Vi, _) in zip(self._bcs_u, self._Vi):
            for bc in bc_i:
                bc.create_bc(Vi)
        self._bcs_p = list(bcs_p)
        for bcp in self._bcs_p:
            bcp.create_bcs(Vi0, self._Q, dtype=self._dtype, device=self._device)
        # the outlets' facet tables (under graph-halo: this rank's facets)
        self._fctxs = [bcp.facet_context for bcp in self._bcs_p]

        # --- solvers ---------------------------------------------------------
        solver_options = solver_options or {}
        self._solver_u = KSPSolver(
            solver_options.get("tentative"), prefix="tentative_velocity", symmetric=False
        )
        self._solver_p = KSPSolver(
            solver_options.get("pressure"), prefix="pressure_correction", symmetric=True
        )
        self._solver_c = KSPSolver(
            solver_options.get("scalar"), prefix="velocity_update", symmetric=True
        )
        # the lumped velocity update's table: the Q basis's reference
        # gradients at the V reference nodes (ndv, d, ndq); under a device_mesh
        # the update is the mass CG (as in the JAX package)
        self._lumped = self._solver_c.lumped and device_mesh is None
        if self._solver_c.lumped and not self._lumped:
            logger.info("the lumped velocity update is not available under sharding; using the "
                        "%s mass solve", self._solver_c.method)
        gtab = el_p.tabulate(el_u.nodes)[1] if self._lumped else None

        # --- the structured grid layout, when the mesh has one ------------------
        self._refs = build_reference_tensors(el_u, el_p)
        self._cu = None
        self._comm = self._slab = self._halo = self._rep = self._shard_idx = None
        if device_mesh is not None:
            from .parallel.comm import as_comm

            comm = as_comm(device_mesh)
            # the slab path first, whatever "replicated" says (oasisx_tpu
            # fracstep.py:186-223, 268)
            if not self._setup_slab(comm, el_u, el_p, options):
                if options.get("replicated", False):
                    self._setup_replicated(comm, el_u, el_p)
                else:
                    self._setup_halo(comm, el_u, el_p, options)
        elif not self._bcs_p and mesh.structured is not None and options.get("structured", True):
            rv = build_structured_map(mesh, el_u, Vi0.dofmap)
            rq = build_structured_map(mesh, el_p, self._Q.dofmap)
            if rv is not None and rq is not None:
                (self._sm_v, gf_v, _), (self._sm_q, gf_q, valid_q) = rv, rq
                self._cu = cub.build_cube_ops(
                    mesh, self._refs, self._sm_v, self._sm_q, dtype=self._dtype,
                    device=self._device, gtab=gtab,
                )
        self._structured = self._cu is not None
        if self._structured and self._slab is None:  # _setup_slab sets the slab's layout
            self._npad_v = num_padded(self._sm_v)
            self._npad_q = num_padded(self._sm_q)
            self._gf_v = torch.as_tensor(gf_v, dtype=torch.long, device=self._device)
            self._gf_q = torch.as_tensor(gf_q, dtype=torch.long, device=self._device)
            self._q_null = torch.as_tensor(valid_q, dtype=self._dtype, device=self._device)
        elif not self._structured:
            self._gf_v = self._gf_q = None
            if self._comm is None:
                self._ctx, _ = eng.build_device_context(
                    mesh, el_u, Vi0.dofmap.cell_dofs, Vi0.num_dofs, el_p,
                    self._Q.dofmap.cell_dofs, self._Q.num_dofs, self._dtype, self._device,
                )
            if self._lumped:
                self._gtab = torch.as_tensor(gtab, device=self._device).to(self._dtype)
        b0 = self._body_force(body_force, el_u, el_p)
        self._b0_dev = None if b0 is None else self._pv(b0)
        if self._structured and self._solver_u.method == "gmres":
            logger.info("the structured path's tentative solves run batched BiCGStab "
                        "(requested %s)", self._solver_u.method)

        if self._slab is not None:
            self._preassemble_slab(solver_options.get("pressure") or {})
        elif self._structured:
            self._preassemble(options)
        else:
            self._preassemble_general(solver_options.get("pressure") or {})
        self._state: dict | None = None
        self._state_versions = None
        self._bc_cache = None
        # assemble_first's tentative operator, (A, uq, dt, nu), and the dt of
        # the last pressure_assemble: the split phases' hand-off
        self._split = None
        self._split_dt = None
        # run: its StepGraph, and whether it runs the per-step loop where the
        # graph would run (set by the comparisons of the two: tests,
        # chip_smoke's graph leg)
        self._force_eager = False
        self._graph = None
        self.last_stats: dict = {}
        logger.info("active paths: %s", self.config_report())

    # ------------------------------------------------------------------
    # setup
    # ------------------------------------------------------------------
    def _bc_mask_tensor(self) -> torch.Tensor:
        nv = self._Vi[0][0].num_dofs
        masks = np.stack([bc_mask_and_values(bc_i, nv)[0] for bc_i in self._bcs_u])
        return self._pv(torch.as_tensor(masks, device=self._device))

    def _body_force(self, body_force, el_u, el_p) -> torch.Tensor | None:
        """b0_i = assemble(f_i v dx) in the canonical dof order, (d,
        ndofs_v), or None without a body force (oasisx_tpu fracstep.py:
        1967-2027): a constant component by ``constant_load_vec``, a
        callable one evaluated on the host at the (3, nc, nq) padded points
        of the engine's own rule (the rule ``source_load_vec_v`` contracts
        against) and assembled by it.  Written into ``self._b0``.  The
        structured path keeps no element context: one is built here for
        the set-up only."""
        if body_force is None:
            return None
        Vi0 = self._Vi[0][0]
        ctx = self._ctx if not self._structured else eng.build_device_context(
            self._mesh, el_u, Vi0.dofmap.cell_dofs, Vi0.num_dofs, el_p,
            self._Q.dofmap.cell_dofs, self._Q.num_dofs, self._dtype, self._device)[0]
        du, dq = el_u.degree, el_p.degree
        qdeg = max(3 * du - 1, du + dq, 2 * dq, 2)
        on = lambda a: torch.as_tensor(np.asarray(a, np.float64), device=self._device).to(
            self._dtype)
        xq, b0 = None, []
        for fi in body_force:
            fi = getattr(fi, "value", fi)
            if callable(fi):
                if xq is None:
                    xq = padded_coordinates(quadrature_points(self._mesh, qdeg)[2])
                vals = np.asarray(fi(xq))
                if self._comm is not None:  # this rank's cells, in block order
                    vals = vals[(self._halo or self._rep).cells]
                b0.append(eng.source_load_vec_v(ctx, on(vals)))
            else:
                b0.append(eng.constant_load_vec(ctx, float(fi)))
        b0 = torch.stack(b0)
        if self._halo is not None:
            b0 = self._uv(b0)
        for f, b in zip(self._b0, b0):
            f.x.array.copy_(b)
        return b0

    def _preassemble(self, options: dict) -> None:
        """Structured path: constant diagonals, integration weights, BC
        masks, convection weight tensor and the pressure solve."""
        cu, dev, dt = self._cu, self._device, self._dtype
        mesh = self._mesh
        d = mesh.dim
        self._M_diag = cub.diag_cube(cu.M_c, self._sm_v)
        self._K_diag = cub.diag_cube(cu.K_c, self._sm_v)
        self._Ap_diag = cub.diag_cube(cu.Ap_c, self._sm_q)
        geo = compute_cell_geometry(mesh.x, mesh.cells, d)
        self._vol = float(np.sum(geo.detJ) * np.sum(self._refs.qweights))
        # integration weights for the volume-weighted pressure mean:
        # w = Mq 1 so that integral(p) = <w, p>
        self._intw = cub.matvec_cube(self._q_null, cu.Mq_c, self._sm_q)
        self._T = torch.as_tensor(kn.conv_weight_tensor(cu), dtype=dt, device=dev)

        self._bc_masks = self._bc_mask_tensor()
        # 0 on Dirichlet rows: the tentative operator's output is zeroed there
        self._zmask = (~self._bc_masks).to(dt)
        self._M_invd = torch.where(self._M_diag != 0, 1.0 / self._M_diag, 1.0)
        self._lumped_inv = _lumped_inv(self._M_diag) if self._lumped else None
        # the rotational update's Jacobi: 1 on the padding, where diag(Mq) is 0
        self._Mq_invd = _inv(cub.diag_cube(cu.Mq_c, self._sm_q)) if self._rotational else None

        # the pressure solve, chosen as the JAX package's kernel path chooses
        # it (oasisx_tpu/fracstep.py:741-767): the MG-PCG where the grid
        # coarsens and pallas_pressure_pc is "mg", else K1's non-MG mode of
        # degree pallas_cheb_degree with bounds estimated here (set-up reads
        # only).  A pressure pc_type of jacobi or none selects Jacobi-CG, the
        # method the JAX package's XLA path runs for it.
        diag = self._Ap_diag.detach().cpu().double().numpy()
        invd = np.where(diag != 0, 1.0 / np.where(diag != 0, diag, 1.0), 1.0)
        s = self._solver_p
        rtol = _effective_rtol(s.rtol, dt)
        jacobi = str(s.options.get("pc_type", "")).lower() in ("jacobi", "none")
        mg = None
        if options.get("pallas_pressure_pc", "mg") == "mg" and not jacobi:
            mg = kn.build_pressure_mg_data(self._sm_q, cu.Ap_c.detach().cpu().double().numpy())
        self._p_cheb = None
        if mg is not None:
            self._pcg = PressureMGCG(self._sm_q, cu.Ap_c, invd, mg, rtol=rtol, maxiter=s.maxiter)
            return
        deg = 0 if jacobi else int(options.get("pallas_cheb_degree", 4))
        lmin = lmax = 0.0
        if deg > 0:
            mv = lambda x: kn.matvec_const(x, cu.Ap_c, self._sm_q)
            invd_t = torch.as_tensor(invd, device=dev).to(dt)
            est = krylov.estimate_lmax(mv, invd_t)
            lmin, lmax = krylov.validated_cheb_bounds(mv, invd_t, est, deg)
            self._p_cheb = dict(degree=deg, lmin=lmin, lmax=lmax, lmax_estimate=est)
        self._pcg = PressureCG(self._sm_q, cu.Ap_c, invd, rtol, s.maxiter, deg, lmin, lmax)

    def _preassemble_general(self, popts: dict) -> None:
        """General path: constant element stacks and diagonals, BC masks,
        the outlet mask, the mixed matrices (``low_memory_version=False``),
        the ELL tables and the constant operators M and Ap in ELL form, and
        the pressure preconditioner: the AMG with its kernel tables, or
        Jacobi's diagonal and, for Chebyshev, its bounds."""
        ctx, dev, dt = self._ctx, self._device, self._dtype
        c = eng.setup_constants(ctx)
        self._M_elems, self._K_elems, self._Ap_elems = c["M"], c["K"], c["Ap"]
        self._M_invd = _inv(c["M_diag"])
        self._lumped_inv = _lumped_inv(c["M_diag"]) if self._lumped else None
        self._vol = float(c["vol"])
        self._bc_masks = self._bc_mask_tensor()
        self._zmask = (~self._bc_masks).to(dt)
        nq = self._Q.num_dofs
        pmask = np.zeros(nq, dtype=bool)
        for bcp in self._bcs_p:
            pmask[bcp.dofs] = True
        self._pbc_mask = self._pq(torch.as_tensor(pmask, device=dev)) if self._bcs_p else None
        if not self._low_memory:
            pg = eng.pressure_gradient_mats(ctx)  # (d, nc, ndv, ndq)
            self._p_vdxi = pg
            self._divu = pg.transpose(2, 3)
            self._grad_p = eng.grad_p_mats(ctx)
        # the rotational update's Jacobi (no outlet rows); the pressure's
        # Jacobi diagonal, 1 on the outlet rows (unused under the AMG)
        self._Mq_invd = _inv(eng.diagonal_q(ctx, c["Mq"])) if self._rotational else None
        ap_diag = c["Ap_diag"]
        if self._pbc_mask is not None:
            ap_diag = torch.where(self._pbc_mask, torch.ones_like(ap_diag), ap_diag)
        self._Ap_diag = ap_diag
        self._amg = self._p_cheb = self._mg_M = None
        if self._rep is not None:
            # the replicated mode: element products summed over the ranks, no
            # ELL table; Jacobi-PCG for the pressure (ROADMAP known difference l)
            self._Mq_elems = c["Mq"]
            return

        # the constant operators' values, assembled once here: the JAX
        # package assembles them again in every solve, to the same values.
        # The tables of the rank's local operators under graph-halo (nloc
        # rows, the local cell dofmaps)
        cd_v, nv = ctx.cd_v.cpu().numpy(), ctx.ndofs_v
        cd_q, nq_loc = ctx.cd_q.cpu().numpy(), ctx.ndofs_q
        self._ell_v = self._band_v = self._ell_q = None
        if self._layout == "band":
            self._asm_v = self._band_v = build_band_assembly(cd_v, nv, dev)
            self._M_invd_b = band.to_band(self._M_invd, self._band_v, fill=1.0)
        else:
            self._asm_v = self._ell_v = build_ell_assembly(cd_v, nv, dev)
        # the pressure space: band tables too under graph-halo in the band
        # layout (every product K18, as the JAX halo band engine); the
        # single-device band layout keeps K14 / K17 on the flat Ap (ROADMAP
        # known difference h)
        if self._layout == "band" and self._halo is not None:
            self._asm_q = build_band_assembly(cd_q, nq_loc, dev)
        else:
            self._asm_q = self._ell_q = build_ell_assembly(cd_q, nq_loc, dev)
        self._M_vals = self._op_values(self._M_elems, "v")[0]
        self._Ap_vals = self._op_values(self._Ap_elems, "q")[0]
        # the rotational update's Mq
        self._Mq_vals = self._op_values(c["Mq"], "q")[0] if self._rotational else None
        pc = str(popts.get("pc_type", "amg")).lower()
        if pc in AMG_PC_TYPES:
            t0 = time.perf_counter()
            self._amg = self._build_amg(popts, pmask)
            if self._halo is not None:
                self._mg_M = self._make_amg_halo_M(bool(popts.get("amg_distributed", True)))
                self._halo.times["amg_s"] = time.perf_counter() - t0
                return
            self._amg_data = amg_kernel_data(self._amg)
            self._amg_widths = amg_widths(self._amg)
            return
        # Jacobi-CG (pc_type jacobi or none) or Chebyshev-Jacobi CG, as the
        # JAX package's _build_cheb for the general path: the bounds (lmax /
        # 30, lmax) with lmax the validated power-iteration estimate (set-up
        # reads only)
        if pc in ("jacobi", "none"):
            return
        deg = int(popts.get("cheb_degree", 6))
        mv, invd = self._pressure_matvec(), _inv(ap_diag)
        if self._halo is not None:  # on the whole operator, as the JAX package
            mv, invd = self._global_pressure_operator(pmask)
        est = krylov.estimate_lmax(mv, invd)
        lmax = krylov.validated_cheb_bounds(mv, invd, est, deg)[1]
        self._p_cheb = dict(degree=deg, lmin=lmax / 30.0, lmax=lmax, lmax_estimate=est)
        logger.info("pressure Chebyshev(%d)-Jacobi preconditioner (lmax %.3g)", deg, lmax)

    # ------------------------------------------------------------------
    # the slab path (oasisx_tpu fracstep.py:183-230, 976-1042, 1765-1787)
    # ------------------------------------------------------------------
    def _setup_slab(self, comm, el_u, el_p, options: dict) -> bool:
        """Structured maps of the whole grid on every rank, cut into slabs
        of cube planes (``parallel/slab.py``), this rank's slab tables, the
        cube operators on the global grid (for the set-up constants) and on
        the slab's own map (for the step).  False, with nothing set, where
        the JAX package sends the case to graph-halo (oasisx_tpu
        fracstep.py:187-223, 268): no structured mesh, ``structured`` or
        ``slab`` False, a PressureBC, the rotational update, no dof lattice,
        slabs that do not divide, or no uniform cube geometry."""
        from dataclasses import replace as dc_replace

        from .parallel.slab import build_slab, local_part

        mesh, Vi0 = self._mesh, self._Vi[0][0]
        if (mesh.structured is None or self._bcs_p or self._rotational
                or not options.get("structured", True) or not options.get("slab", True)):
            return False
        rv = build_structured_map(mesh, el_u, Vi0.dofmap)
        rq = build_structured_map(mesh, el_p, self._Q.dofmap)
        if rv is None or rq is None:
            return False
        (sv, gf_v, _), (sq, gf_q, valid_q) = rv, rq
        try:
            info = build_slab(sv, gf_v, sq, gf_q, comm.size)
        except ValueError as e:
            logger.info("slab sharding unavailable (%s); graph-halo path", e)
            return False
        cu = cub.build_cube_ops(mesh, self._refs, sv, sq, dtype=self._dtype, device=self._device)
        if cu is None:
            return False
        self._comm, self._slab = comm, info
        self._cu_grid, self._sm_v_grid, self._sm_q_grid = cu, sv, sq
        self._valid_q_grid = valid_q
        self._sm_v, self._sm_q = info.sm_v_loc, info.sm_q_loc
        self._cu = dc_replace(cu, sm_v=info.sm_v_loc, sm_q=info.sm_q_loc)
        self._npad_v, self._npad_q = info.npad_v_loc, info.npad_q_loc
        k, on = comm.rank, lambda a: torch.as_tensor(a, dtype=torch.long, device=self._device)
        # per space, the global slab-flat position of each canonical dof
        # ("all"), and this rank's part of it and of the grid's ("perm",
        # "g2s": (entries, local positions))
        self._shard_idx = {}
        for space, perm, g2s, n in (("v", info.perm_v, info.grid_to_slab_v, info.npad_v_loc),
                                    ("q", info.perm_q, info.grid_to_slab_q, info.npad_q_loc)):
            self._shard_idx[space] = dict(
                all=on(perm), n=n, perm=tuple(map(on, local_part(perm, n, k))),
                g2s=tuple(map(on, local_part(g2s, n, k))))
        nq = info.npad_q_loc
        self._q_null = torch.as_tensor(info.valid_q[k * nq:(k + 1) * nq], dtype=self._dtype,
                                       device=self._device)
        self._gf_v = self._gf_q = None
        logger.info("slab sharding: rank %d of %d, %d cube planes a rank, backend %s", k,
                    comm.size, info.planes_per_dev["v"], comm.backend)
        return True

    def _setup_halo(self, comm, el_u, el_p, options: dict) -> None:
        """The graph-halo decomposition (oasisx_tpu fracstep.py:276-304):
        this rank's cells, both spaces' exchange tables, its element
        context in the local layout, its outlet facets; the local
        positions of the canonical dofs it owns."""
        from .parallel.slab import local_part

        Vi0 = self._Vi[0][0]
        sh = shard_problem_halo(comm, self._mesh, el_u, Vi0.dofmap.cell_dofs, el_p,
                                self._Q.dofmap.cell_dofs, self._dtype, self._device,
                                partitioner=options.get("partitioner", "multilevel"))
        self._comm, self._halo, self._ctx = comm, sh, sh.ctx
        self._fctxs = [local_facets(bcp.facet_context, sh) for bcp in self._bcs_p]
        on = lambda a: torch.as_tensor(a, dtype=torch.long, device=self._device)
        self._shard_idx = {}
        for space, hx in (("v", sh.hx_v), ("q", sh.hx_q)):
            self._shard_idx[space] = dict(all=on(hx.perm), n=hx.nloc,
                                          perm=tuple(map(on, local_part(hx.perm, hx.nloc,
                                                                        sh.rank))))
        self._npad_v, self._npad_q = sh.hx_v.nloc, sh.hx_q.nloc
        self._q_null = sh.rounds_q.ownmask
        logger.info("graph-halo sharding: rank %d of %d, %d cells, nloc_v=%d (halo %d), "
                    "nloc_q=%d, partition %s, backend %s", sh.rank, sh.ndev, len(sh.cells),
                    sh.hx_v.nloc, sh.hx_v.nloc - sh.hx_v.owned_pad - 1, sh.hx_q.nloc,
                    sh.partition.get("name"), comm.backend)

    def _setup_replicated(self, comm, el_u, el_p) -> None:
        """The replicated mode (oasisx_tpu fracstep.py:268-275): this rank's
        block of cells with the canonical dofmaps (``shard_problem``), its
        outlet facets."""
        Vi0 = self._Vi[0][0]
        sh = shard_problem(comm, self._mesh, el_u, Vi0.dofmap.cell_dofs, Vi0.num_dofs, el_p,
                           self._Q.dofmap.cell_dofs, self._Q.num_dofs, self._dtype, self._device)
        self._comm, self._rep, self._ctx = comm, sh, sh.ctx
        self._fctxs = [local_facets(bcp.facet_context, sh) for bcp in self._bcs_p]
        logger.info("replicated sharding: rank %d of %d, %d of %d cells, backend %s", sh.rank,
                    sh.ndev, len(sh.cells), len(sh.shard_of), comm.backend)

    def _shard_part(self, arr: torch.Tensor, space: str, table: str = "perm") -> torch.Tensor:
        """This rank's part of ``arr`` in its local layout, halo and padding
        slots zero: a vector in the canonical dof order (``table`` "perm")
        or, on the slab path, a constant in the single-device grid layout
        ("g2s")."""
        ix = self._shard_idx[space]
        sel, loc = ix[table]
        out = torch.zeros(arr.shape[:-1] + (ix["n"],), dtype=arr.dtype, device=arr.device)
        out[..., loc] = arr[..., sel]
        return out

    def _preassemble_slab(self, popts: dict) -> None:
        """The slab path's constants, computed on the whole grid and moved
        into this rank's slab (oasisx_tpu fracstep.py:1908-1935): diag(M),
        diag(K), diag(Ap), the integration weights Mq 1, the convection
        weight tensor, the bc masks; and the pressure preconditioner
        (fracstep.py:592-647, 1789-1830): the XLA MG's V-cycle on the
        gathered grid for a pressure ``pc_type`` of an MG kind (the
        default) on a grid that coarsens, Jacobi for jacobi / none, else
        Chebyshev(``cheb_degree``, default 6)-Jacobi with bounds from the
        whole grid's operator."""
        from .la.multigrid import StructuredPoissonMG

        g, smv, smq = self._cu_grid, self._sm_v_grid, self._sm_q_grid
        dev, dt = self._device, self._dtype
        self._M_diag = self._shard_part(cub.diag_cube(g.M_c, smv), "v", "g2s")
        self._K_diag = self._shard_part(cub.diag_cube(g.K_c, smv), "v", "g2s")
        ap_diag_g = cub.diag_cube(g.Ap_c, smq)
        self._Ap_diag = self._shard_part(ap_diag_g, "q", "g2s")
        geo = compute_cell_geometry(self._mesh.x, self._mesh.cells, self._mesh.dim)
        self._vol = float(np.sum(geo.detJ) * np.sum(self._refs.qweights))
        valid_g = torch.as_tensor(self._valid_q_grid, dtype=dt, device=dev)
        self._intw = self._shard_part(cub.matvec_cube(valid_g, g.Mq_c, smq), "q", "g2s")
        self._T = torch.as_tensor(kn.conv_weight_tensor(self._cu), dtype=dt, device=dev)
        self._bc_masks = self._bc_mask_tensor()
        self._mg = self._p_cheb = self._mg_M = self._pbc_mask = None
        self._M_invd = _inv(self._M_diag)
        pc = str(popts.get("pc_type", "mg")).lower()
        structured_ok = self._Q.element.degree == 1 and min(self._mesh.structured.shape) >= 4
        if structured_ok and pc in AMG_PC_TYPES:
            try:
                self._mg = StructuredPoissonMG(self._mesh, dtype=dt, device=dev)
                self._mg_M = self._make_mg_slab_M()
                logger.info("pressure MG under slab sharding (gathered V-cycle): %d levels",
                            self._mg.num_levels)
            except ValueError as e:
                logger.info("pressure MG disabled: %s", e)
        if self._mg is not None or pc in ("jacobi", "none"):
            return
        deg = int(popts.get("cheb_degree", 6))
        mv = lambda x: cub.matvec_cube(x, g.Ap_c, smq)
        invd = _inv(ap_diag_g)
        est = krylov.estimate_lmax(mv, invd)
        lmin, lmax = krylov.validated_cheb_bounds(mv, invd, est, deg)
        self._p_cheb = dict(degree=deg, lmin=lmin, lmax=lmax, lmax_estimate=est)
        logger.info("pressure Chebyshev(%d)-Jacobi preconditioner (lmax %.3g)", deg, lmax)

    def _make_mg_slab_M(self):
        """The MG preconditioner on the slab (oasisx_tpu fracstep.py:
        1765-1787): gather the ranks' slabs of the residual, one V-cycle on
        the whole grid, this rank's slab of it back (halo slots zero); as a
        function of the product, as ``_make_amg_halo_M``'s, which it does
        not read."""
        info, comm, mg = self._slab, self._comm, self._mg
        g2s = np.asarray(info.grid_to_slab_q)
        npad_grid = g2s.shape[0]
        inv = np.full(info.ndev * info.npad_q_loc, npad_grid, np.int64)
        inv[g2s] = np.arange(npad_grid)
        k, n = comm.rank, info.npad_q_loc
        on = lambda a: torch.as_tensor(a, dtype=torch.long, device=self._device)
        g2s_t, inv_row = on(g2s), on(inv[k * n:(k + 1) * n])

        def M(r_loc):
            z = mg.vcycle(comm.gather(r_loc).reshape(-1)[g2s_t])
            return torch.cat([z, z.new_zeros(1)])[inv_row]

        return lambda mv: M

    def _slab_op(self, kernel, x, space_in: str, space_out: str):
        from .parallel.slab import slab_apply

        sm = {"v": self._sm_v, "q": self._sm_q}
        return slab_apply(kernel, x, sm[space_in], sm[space_out], self._comm)

    def _gnorm(self, v: torch.Tensor) -> torch.Tensor:
        """The row norms of slab vectors, over all ranks."""
        return torch.sqrt(self._comm.sum(torch.sum(v * v, dim=-1)))

    def _assemble_first_slab(self, u1, u2, dt, nu):
        """(oasisx_tpu fracstep.py:2159-2190) W per shard from the cube
        values of the refreshed uab (K8, then ``build_w``), and b_first =
        fold((2/dt) M u1 - A_W u1) on the refreshed u1 (K5, K3)."""
        from .parallel.slab import halo_fold, halo_refresh

        cu, sm, comm, d = self._cu, self._sm_v, self._comm, u1.shape[0]
        nl = cu.M_c.shape[0]
        U = kn.cube_gather(halo_refresh(1.5 * u1 - 0.5 * u2, sm, comm), sm)
        uq = cu.Phi @ U
        A0 = (1.0 / dt) * cu.M_c + (0.5 * nu) * cu.K_c
        W = kn.build_w(self._T, A0, U.reshape(d * nl, -1))
        u1f = halo_refresh(u1, sm, comm)
        bf = (2.0 / dt) * kn.matvec_const(u1f, cu.M_c, sm) - kn.matvec_win(W, u1f, sm)
        b_first = halo_fold(bf, sm, comm)
        if self._b0_dev is not None:
            b_first = b_first + self._b0_dev
        return W, uq, b_first

    # ------------------------------------------------------------------
    # the solves of both sharded paths, on the path's product ``op``: K3 /
    # K5 on the slab, K14 / K18 between the halo refresh and fold under
    # graph-halo; every reduction summed over the ranks
    # ------------------------------------------------------------------
    def _tentative_solve_sharded(self, op, diag, rhs1, bc_vals, u, x0):
        """(oasisx_tpu fracstep.py:2442-2458, 2489-2540) batched BiCGStab
        (CG for a ``ksp_type`` cg) in the XLA formulation: the batch-d
        product ``op`` with identity bc rows, x0 as given, Jacobi with 1 on
        the bc rows; GMRES (graph-halo only) a component at a time."""
        masks, s = self._bc_masks, self._solver_u
        rhs = torch.where(masks, bc_vals, rhs1)
        dfull = torch.where(masks, torch.ones_like(bc_vals), diag[None])
        kw = dict(rtol=s.rtol, atol=s.atol, maxiter=s.maxiter, comm=self._comm)
        method = self._tentative_method()
        if method == "gmres":
            out = []
            for i in range(rhs.shape[0]):
                A_i = lambda x, m=masks[i]: eng.apply_bc_rows(m, op(x), x)
                out.append(krylov.gmres(A_i, rhs[i], x0=x0[i],
                                        M=krylov.jacobi_preconditioner(dfull[i]),
                                        restart=s.gmres_restart, **kw))
            res = krylov.KrylovResult(*(torch.stack(t) for t in list(zip(*out))[:4]),
                                      sum(r.syncs for r in out))
        else:
            mv = lambda x: eng.apply_bc_rows(masks, op(x), x)
            solve = krylov.cg_batched if method == "cg" else krylov.bicgstab_batched
            res = solve(mv, rhs, x0=x0, M=krylov.jacobi_preconditioner(dfull), **kw)
        diff = torch.sum(self._gnorm(res.x - u))
        return res, diff, _rel_res(res.resnorm, self._gnorm(rhs))

    def _pressure_solve_sharded(self, b2, dp0):
        """(oasisx_tpu fracstep.py:2571-2610, 2620-2735) CG on the sharded
        product of Ap (``_pressure_matvec``), preconditioned by the path's
        multigrid (the gathered MG on the slab, the AMG under graph-halo),
        Chebyshev-Jacobi or Jacobi.  With an outlet dp0 as it is; else the
        nullspace (the owned-slot mask) projected out with summed dots and
        the volume-weighted mean removed."""
        s, comm, mv = self._solver_p, self._comm, self._pressure_matvec()
        ch = self._p_cheb
        if self._mg_M is not None:
            M = self._mg_M(mv)
        elif ch is not None:
            M = krylov.chebyshev_preconditioner(mv, _inv(self._Ap_diag), ch["lmin"], ch["lmax"],
                                                ch["degree"])
        else:
            M = krylov.jacobi_preconditioner(self._Ap_diag)
        kw = dict(M=M, rtol=s.rtol, atol=s.atol, maxiter=s.maxiter, comm=comm)
        if self._pbc_mask is not None:
            res = krylov.cg(mv, b2, x0=dp0, **kw)
            return res, res.x, _rel_res(res.resnorm, self._gnorm(b2))
        nv = self._q_null
        d = comm.sum(torch.stack([torch.dot(nv, dp0), torch.dot(nv, nv)]))
        res = krylov.cg(mv, b2, x0=dp0 - (d[0] / d[1]) * nv, project_nullspace=True, nullvec=nv,
                        **kw)
        if self._slab is not None:
            w = comm.sum(torch.dot(self._intw, res.x))
        else:
            w = eng.integrate(self._ctx, eng.eval_q_at_qp(self._ctx, res.x))
        return res, res.x - (w / self._vol) * nv, _rel_res(res.resnorm, self._gnorm(b2))

    def _velocity_update_sharded(self, op, u, g, dt, duc):
        """(oasisx_tpu fracstep.py:2786-2806, 2943-2953) batched Jacobi-CG
        on the sharded product ``op`` of M from x0 = u + duc, b3 = M u - dt
        G dp (``g`` = G dp)."""
        sc = self._solver_c
        b3 = op(u) - dt * g
        res = krylov.cg_batched(op, b3, x0=u + duc, M=lambda r: self._M_invd * r,
                                rtol=sc.rtol, atol=sc.atol, maxiter=sc.maxiter, comm=self._comm)
        return res, _rel_res(res.resnorm, self._gnorm(b3))

    # ------------------------------------------------------------------
    # the graph-halo path (oasisx_tpu fracstep.py:1044-1234, 1640-1763,
    # 2459-2540, 2620-2765, 2943-2953)
    # ------------------------------------------------------------------
    def _halo_apply(self, vals, asm, x, space: str):
        """refresh -> K14 on the rank's local ELL operator (K18 on a band
        one) -> fold: a global operator application in the local layout."""
        hr = self._halo.rounds_v if space == "v" else self._halo.rounds_q
        x = halo_refresh(x, hr, self._comm)
        if isinstance(asm, BandAssembly):
            y = band.from_band(band.band_matvec(vals, *asm.tables, band.to_band(x, asm)), asm)
        else:
            y = ell.ell_matvec(vals, asm.cols, asm.widths, x)
        return halo_fold(y, hr, self._comm)

    def _op_values(self, elems, space: str):
        """(values, tables) of an element stack of ``space`` ("v" or "q")
        on the general path's operator (the rank's local one under
        graph-halo): ELL, or band under ``ell_layout`` "band" (under
        graph-halo in both spaces, as the JAX halo band engine, oasisx_tpu
        fracstep.py:1106-1145)."""
        asm = self._asm_v if space == "v" else self._asm_q
        if isinstance(asm, BandAssembly):
            return band_values(elems, asm), asm
        return ell_values(elems, asm), asm

    def _global_pressure_operator(self, pmask: np.ndarray):
        """(K14's product of the whole pressure Laplacian with identity
        outlet rows and columns, its Jacobi inverse diagonal, 1 on the
        outlet rows): the single-device operator, on which the graph-halo
        path estimates the Chebyshev bounds at set-up (oasisx_tpu
        fracstep.py:1826-1850)."""
        Vi0, Q = self._Vi[0][0], self._Q
        ctx, _ = eng.build_device_context(
            self._mesh, Vi0.element, Vi0.dofmap.cell_dofs, Vi0.num_dofs, Q.element,
            Q.dofmap.cell_dofs, Q.num_dofs, self._dtype, self._device)
        Ap = eng.stiffness_q_elems(ctx)
        diag = eng.diagonal_q(ctx, Ap)
        asm = build_ell_assembly(self._Q.dofmap.cell_dofs, self._Q.num_dofs, self._device)
        op = (ell_values(Ap, asm), asm.cols, asm.widths)
        if not self._bcs_p:
            return (lambda x: ell.ell_matvec(*op, x)), _inv(diag)
        m = torch.as_tensor(pmask, device=self._device)
        return (lambda x: torch.where(m, x, ell.ell_matvec(*op, torch.where(m, 0.0, x))),
                _inv(torch.where(m, torch.ones_like(diag), diag)))

    def _make_amg_halo_M(self, distributed: bool):
        """The AMG preconditioner under graph-halo: the distributed apply
        where level 0 coarsens (shard-pure aggregates) and
        ``amg_distributed`` is not False, else the V-cycle on the gathered
        residual (oasisx_tpu fracstep.py:1605-1663)."""
        from .la.amg import amg_dist_tables

        amg, sh, comm = self._amg, self._halo, self._comm
        k, n, nloc = sh.rank, self._Q.num_dofs, sh.hx_q.nloc
        on = lambda a: torch.as_tensor(a, device=self._device)
        own = sh.rounds_q.ownmask
        if distributed and amg.dist is not None:
            self._amg_kind = "amg-pcg-distributed"
            t = {key: on(v[k]) for key, v in amg_dist_tables(amg, sh.hx_q).items()}
            for key in ("Rvals", "Pvals", "sm0"):
                t[key] = t[key].to(self._dtype)
            n_own = float(sh.hx_q.ownmask.sum())
            return lambda mv: self._amg_dist_apply(t, own, n_own, mv)
        self._amg_kind = "amg-pcg"
        perm = on(sh.hx_q.perm)
        inv = np.full(sh.ndev * nloc, n, np.int64)
        inv[sh.hx_q.perm] = np.arange(n)
        inv_row = on(inv[k * nloc:(k + 1) * nloc])

        def M(r):
            z = amg.vcycle(comm.gather(r).reshape(-1)[perm])
            return torch.cat([z, z.new_zeros(1)])[inv_row] * own

        return lambda mv: M

    def _amg_dist_apply(self, t: dict, own, n_own: float, matvec):
        """The distributed V(pre, post) apply (oasisx_tpu fracstep.py:
        1729-1763): fine-level smoothing and residual through the halo'd
        ``matvec``, the rank's partial restriction summed over the ranks in
        one (nagg,) sum, the coarse levels on every rank, the local
        prolongation; the nullspace projected out with summed dots."""
        amg, comm = self._amg, self._comm
        sm0 = t["sm0"]
        proj = amg.nullvec is not None

        def M(r):
            if proj:
                r = r - (comm.sum(torch.dot(own, r)) / n_own) * own
            z = sm0 * r
            for _ in range(amg.pre - 1):
                z = z + sm0 * (r - matvec(z))
            res = r - matvec(z)
            rc = comm.sum(torch.sum(t["Rvals"] * res[t["Rcols"]], dim=-1))
            zc = amg.cycle_coarse(rc)
            z = z + torch.sum(t["Pvals"] * zc[t["Pcols"]], dim=-1)
            for _ in range(amg.post):
                z = z + sm0 * (r - matvec(z))
            if proj:
                z = z - (comm.sum(torch.dot(own, z)) / n_own) * own
            return z

        return M

    def _rotational_update_sharded(self, p, dp, u, nu):
        """(oasisx_tpu fracstep.py:2740-2765) CG on Mq from x0 = p + dp, rhs =
        Mq (p + dp) - xi nu (div u, q), Jacobi on diag(Mq), the ``scalar``
        family's tolerances; results batched as one row.  Mq halo'd with its
        dots summed over the ranks under graph-halo, the element product
        summed with local dots under the replicated mode."""
        sc, ctx = self._solver_c, self._ctx
        if self._rep is not None:
            comm, mv = None, lambda x: eng.matvec_q(ctx, self._Mq_elems, x)
        else:
            comm, mv = self._comm, lambda x: self._halo_apply(self._Mq_vals, self._asm_q, x, "q")
        x0 = p + dp
        rhs = mv(x0) - (self._xi * nu) * eng.source_load_vec_q(ctx, eng.div_v_at_qp(ctx, u))
        res = krylov.cg(mv, rhs, x0=x0, M=lambda r: self._Mq_invd * r, rtol=sc.rtol,
                        atol=sc.atol, maxiter=sc.maxiter, comm=comm)
        res = res._replace(iters=res.iters[None], resnorm=res.resnorm[None],
                           converged=res.converged[None])
        rnorm = torch.linalg.vector_norm(rhs) if comm is None else self._gnorm(rhs)
        return res, res.x, _rel_res(res.resnorm, rnorm[None])

    def halo_traffic_report(self) -> dict | None:
        """The halo exchange's traffic (oasisx_tpu fracstep.py:445-503):
        per space, ``bytes_per_exchange`` is what one refresh (or one fold)
        moves over all rank boundaries as the JAX package counts it (each
        round's messages padded to its longest), ``owned_bytes`` the owned
        state, so ``ratio`` is the share communicated per operator
        application.  Graph-halo also gives ``rounds`` and
        ``sent_bytes_per_exchange``, the messages' real entries, which is
        what the port sends.  None off the sharded paths."""
        fb = torch.finfo(self._dtype).bits // 8
        if self._halo is not None:
            def hspace(hx):
                per_ex = sum(len(pairs) * pack.shape[1] for pairs, pack, _ in hx.sched) * fb
                sent = sum(int(np.sum(pack != hx.nloc - 1)) for _, pack, _ in hx.sched) * fb
                owned = int(hx.ownmask.sum()) * fb
                return dict(bytes_per_exchange=per_ex, owned_bytes=owned, rounds=len(hx.sched),
                            ratio=per_ex / max(owned, 1), sent_bytes_per_exchange=sent)

            return dict(mode="graph-halo", ndev=self._halo.ndev, v=hspace(self._halo.hx_v),
                        q=hspace(self._halo.hx_q))
        if self._slab is None:
            return None
        info, d = self._slab, self._mesh.dim

        def space(sm_loc, valid):
            pshape = sm_loc[0]
            plane = int(np.prod(pshape)) // int(pshape[d])
            per_ex = (info.ndev - 1) * plane * fb
            owned = int(np.asarray(valid).sum()) * fb
            return dict(bytes_per_exchange=per_ex, owned_bytes=owned,
                        ratio=per_ex / max(owned, 1))

        return dict(mode="slab-halo", ndev=info.ndev, v=space(info.sm_v_loc, info.valid_v),
                    q=space(info.sm_q_loc, info.valid_q))

    def _pressure_matvec(self):
        """The pressure operator of the general and sharded paths: K14
        (halo'd under graph-halo, K18 there in the band layout; K5 on the
        slab; the element product summed under the replicated mode), with
        identity rows and columns on the outlet dofs where there is an
        outlet."""
        if self._rep is not None:
            mv = lambda x: eng.matvec_q(self._ctx, self._Ap_elems, x)
        elif self._slab is not None:
            Ap_c, sm = self._cu.Ap_c, self._sm_q
            mv = lambda x: self._slab_op(lambda v: kn.matvec_const(v, Ap_c, sm), x, "q", "q")
        elif self._halo is not None:
            mv = lambda x: self._halo_apply(self._Ap_vals, self._asm_q, x, "q")
        else:
            op = (self._Ap_vals, self._ell_q.cols, self._ell_q.widths)
            mv = lambda x: ell.ell_matvec(*op, x)
        if self._pbc_mask is None:
            return mv
        m = self._pbc_mask
        return lambda x: torch.where(m, x, mv(torch.where(m, 0.0, x)))

    def _build_amg(self, popts: dict, pmask: np.ndarray) -> AlgebraicMG:
        """Smoothed-aggregation AMG for the pressure Poisson (the JAX
        package's ``_build_amg`` on one device).  Its set-up reads the
        pressure Laplacian's element stack computed on the host in float64,
        not the solver's stack: a run on the card and one on the CPU then
        build the same hierarchy, and in float32 the singular coarse
        operator keeps exact zero row sums.  Built from float32-rounded
        elements (as the JAX package does), its pseudo-inverse inverts the
        rounding noise in the constant mode (entries near 1e6 against 14)
        and the vessel's float32 pressure solves at N=12 took 370-440
        iterations instead of 11-12."""
        n = self._Q.num_dofs
        geo = compute_cell_geometry(self._mesh.x, self._mesh.cells, self._mesh.dim)
        elems = np.einsum("c,cab,abij->cij", geo.detJ, geo.G, self._refs.stiffness_q)
        rows, cols, vals = coo_from_elems(self._Q.dofmap.cell_dofs, elems, n)
        if self._bcs_p:
            # identity rows and columns on the outlet dofs, as the operator's
            # mask wrap (bc_symmetric_matvec) has them
            keep = ~(pmask[rows] | pmask[cols])
            drows = np.flatnonzero(pmask).astype(np.int64)
            rows = np.concatenate([rows[keep], drows])
            cols = np.concatenate([cols[keep], drows])
            vals = np.concatenate([vals[keep], np.ones(drows.size)])
        amg = AlgebraicMG(
            rows, cols, vals, n, dtype=self._dtype, device=self._device,
            theta=float(popts.get("amg_theta", 0.25)),
            coarse_max=int(popts.get("amg_coarse_max", 400)),
            # V(2,2): on deformed simplex meshes V(1,1) took 3-4x more PCG
            # iterations (the JAX package's measurement)
            pre=int(popts.get("amg_pre", 2)),
            post=int(popts.get("amg_post", 2)),
            nullvec=None if self._bcs_p else np.ones(n),
            # under graph-halo: level-0 aggregates within one rank's owned dofs
            dof_shard=None if self._halo is None else self._halo.hx_q.perm // self._npad_q,
        )
        logger.info("pressure AMG: %d levels, coarse n=%d", amg.num_levels, amg.coarse_n)
        return amg

    def config_report(self) -> dict:
        """The paths this solver instance uses."""
        common = dict(
            sharding="single-device",
            structured_fastpath=self._structured,
            velocity_update="lumped" if self._lumped else self._solver_c.method,
            pressure_update="rotational" if self._rotational else "standard",
            body_force=self._b0_dev is not None,
            tentative_method=self._tentative_method(),
            kernels=list(kn.KERNELS),
            run=self._run_mode(),
            device=str(self._device),
            dtype=str(self._dtype).replace("torch.", ""),
        )
        # the mass solve's kernel does not run under the lumped update; the
        # rotational update's solve is K4 (structured) or K16 (general)
        if self._halo is not None:
            return self._config_halo(common)
        if self._rep is not None:
            sh = self._rep
            return dict(common, sharding="replicated", ndev=sh.ndev, rank=sh.rank,
                        backend=self._comm.backend, cells=len(sh.cells), path_kernels=[],
                        pressure_pc="jacobi-pcg", pressure_mg_levels=0,
                        low_memory=self._low_memory, outlet=bool(self._bcs_p))
        unused = {"cg_mass", "ell_cg", "band_cg"} if self._lumped else set()
        if self._rotational:
            unused -= {"cg_mass", "ell_cg"}
        if self._tentative_method() != "bcgs":  # Krylov loops on the products
            unused |= {"bicgstab", "ell_bicgstab", "band_bicgstab"}
        if self._slab is not None:
            info, mg, ch = self._slab, self._mg, self._p_cheb
            out = dict(common, sharding="slab-halo", ndev=info.ndev, rank=self._comm.rank,
                       backend=self._comm.backend, planes_per_rank=info.planes_per_dev["v"],
                       path_kernels=list(kn.SLAB_KERNELS),
                       pressure_pc="mg-pcg" if mg else "cheb-pcg" if ch else "jacobi-pcg",
                       pressure_mg_levels=mg.num_levels if mg else 0)
            return out if ch is None else dict(out, pressure_cheb=dict(ch))
        if self._structured:
            mg = isinstance(self._pcg, PressureMGCG)
            unused.add("pressure_cg" if mg else "pressure_mg")
            out = dict(common, path_kernels=[k for k in kn.STRUCTURED_KERNELS if k not in unused])
            if mg:
                return dict(out, pressure_pc="mg-pcg", pressure_mg_levels=len(self._pcg.levels))
            if self._p_cheb is None:
                return dict(out, pressure_pc="jacobi-pcg", pressure_mg_levels=0)
            return dict(out, pressure_pc="cheb-pcg", pressure_mg_levels=0,
                        pressure_cheb=dict(self._p_cheb))
        eq = self._ell_q
        if self._layout == "band":
            bv = self._band_v
            velocity = {"S_v": bv.S, "P_v": bv.P, "R_v": bv.R, "n_v": bv.n, "nnz_v": bv.nnz,
                        "shifts_v": [min(bv.shifts), max(bv.shifts)]}
        else:
            ev = self._ell_v
            velocity = {"K_v": ev.K, "n_v": ev.n, "nnz_v": ev.nnz}
        if self._amg is not None:
            pressure = dict(pressure_pc="amg-pcg-fused", pressure_mg_levels=self._amg.num_levels)
        elif self._p_cheb is None:
            pressure = dict(pressure_pc="jacobi-pcg", pressure_mg_levels=0)
        else:
            pressure = dict(pressure_pc="cheb-pcg", pressure_mg_levels=0,
                            pressure_cheb=dict(self._p_cheb))
        if self._amg is None:
            unused.add("ell_pcg_amg")
        kernels = kn.BAND_KERNELS if self._layout == "band" else kn.ELL_KERNELS
        if self._layout == "band" and self._rotational:
            kernels = kernels + ("ell_cg",)
        return dict(
            common,
            **pressure,
            path_kernels=[k for k in kernels if k not in unused],
            low_memory=self._low_memory,
            outlet=bool(self._bcs_p),
            ell_layout=self._layout,
            ell=dict(velocity, K_q=eq.K, n_q=eq.n, nnz_q=eq.nnz),
        )

    def _config_halo(self, common: dict) -> dict:
        sh, tables = self._halo, {}
        for sp, asm in (("v", self._asm_v), ("q", self._asm_q)):
            keys = ("S", "P", "R") if isinstance(asm, BandAssembly) else ("K",)
            tables.update({f"{k}_{sp}": getattr(asm, k) for k in keys + ("n", "nnz")})
        if self._amg is not None:
            pressure = dict(pressure_pc=self._amg_kind, pressure_mg_levels=self._amg.num_levels)
        elif self._p_cheb is None:
            pressure = dict(pressure_pc="jacobi-pcg", pressure_mg_levels=0)
        else:
            pressure = dict(pressure_pc="cheb-pcg", pressure_mg_levels=0,
                            pressure_cheb=dict(self._p_cheb))
        kernels = kn.HALO_BAND_KERNELS if self._layout == "band" else kn.HALO_KERNELS
        return dict(common, **pressure, sharding="graph-halo", ndev=sh.ndev, rank=sh.rank,
                    backend=self._comm.backend, partitioner=dict(sh.partition),
                    cells=len(sh.cells), path_kernels=list(kernels), low_memory=self._low_memory,
                    outlet=bool(self._bcs_p), ell_layout=self._layout, ell=tables)

    def _tentative_method(self) -> str:
        """The tentative solves' method: the ``ksp_type``'s, except GMRES on
        the structured path, which runs BiCGStab there (as the JAX package's
        kernel path does)."""
        m = self._solver_u.method
        return "bcgs" if self._structured and m == "gmres" else m

    # --- canonical <-> internal dof order -----------------------------------
    def _pv(self, arr: torch.Tensor) -> torch.Tensor:
        """Canonical V dof order -> the internal layout (the padded grid on
        the structured path, padding zero; this rank's slab or local block on
        the owned-dof paths, halo and padding zero; a copy on the general
        path and under the replicated mode)."""
        if self._shard_idx is not None:
            return self._shard_part(arr, "v")
        if self._gf_v is None:
            return arr.clone()
        out = torch.zeros(arr.shape[:-1] + (self._npad_v,), dtype=arr.dtype, device=arr.device)
        out[..., self._gf_v] = arr
        return out

    def _pq(self, arr: torch.Tensor) -> torch.Tensor:
        if self._shard_idx is not None:
            return self._shard_part(arr, "q")
        if self._gf_q is None:
            return arr.clone()
        out = torch.zeros(arr.shape[:-1] + (self._npad_q,), dtype=arr.dtype, device=arr.device)
        out[..., self._gf_q] = arr
        return out

    def _uv(self, arr: torch.Tensor) -> torch.Tensor:
        """Internal layout -> canonical V dof order (on the owned-dof paths
        every rank's part gathered first: a collective)."""
        if self._shard_idx is not None:
            return self._gathered(arr)[..., self._shard_idx["v"]["all"]]
        return arr if self._gf_v is None else arr[..., self._gf_v]

    def _uq(self, arr: torch.Tensor) -> torch.Tensor:
        if self._shard_idx is not None:
            return self._gathered(arr)[..., self._shard_idx["q"]["all"]]
        return arr if self._gf_q is None else arr[..., self._gf_q]

    def _gathered(self, arr: torch.Tensor) -> torch.Tensor:
        """The ranks' parts of ``arr`` stacked in rank order (the JAX
        package's internal layout on its sharded paths)."""
        g = self._comm.gather(arr)  # (ndev, ..., n)
        return g.movedim(0, -2).reshape(arr.shape[:-1] + (-1,))

    # ------------------------------------------------------------------
    # step phases (tensors on the solver's device, internal layout)
    # ------------------------------------------------------------------
    def _assemble_first(self, u1, u2, dt, nu, h_qvals=()):
        """Returns (the tentative operator, the Q-point convecting velocity
        or None, b_first).  Structured: the per-cube weights W of A_W and
        b_first = (2/dt) M u1 - A_W u1.  General: the element stack A_lhs
        and b_first = A_rhs u1 plus the outlet surface terms.  With a body
        force, b0 is added on either path (before the surface terms)."""
        if self._slab is not None:
            return self._assemble_first_slab(u1, u2, dt, nu)
        if not self._structured:
            ctx = self._ctx
            C = eng.convection_elems(ctx, 1.5 * u1 - 0.5 * u2)
            A_rhs = -0.5 * C + (1.0 / dt) * self._M_elems - (0.5 * nu) * self._K_elems
            b_first = eng.matvec_v(ctx, A_rhs, u1)
            if self._b0_dev is not None:
                b_first = b_first + self._b0_dev
            for fctx, hq in zip(self._fctxs, h_qvals):
                b_first = b_first + pressure_surface_vecs(ctx, fctx, hq)
            return -A_rhs + (2.0 / dt) * self._M_elems, None, b_first
        cu, d = self._cu, u1.shape[0]
        nl = cu.M_c.shape[0]
        uab = 1.5 * u1 - 0.5 * u2
        U = kn.cube_gather(uab, self._sm_v)  # (d, nl, ncube)
        uq = cu.Phi @ U  # (d, Q, ncube)
        A0 = (1.0 / dt) * cu.M_c + (0.5 * nu) * cu.K_c
        W = kn.build_w(self._T, A0, U.reshape(d * nl, -1))
        b_first = (
            (2.0 / dt) * kn.matvec_const(u1, cu.M_c, self._sm_v)
            - kn.matvec_win(W, u1, self._sm_v)
        )
        if self._b0_dev is not None:
            b_first = b_first + self._b0_dev
        return W, uq, b_first

    def _tentative_diag(self, A, uq, dt, nu):
        if not self._structured:
            return eng.diagonal_v(self._ctx, A)
        if self._slab is not None:
            from .parallel.slab import conv_diag_slab

            conv = conv_diag_slab(self._cu, uq, self._sm_v, self._comm)
        else:
            conv = cub.conv_diag(self._cu, uq)
        return (1.0 / dt) * self._M_diag + (0.5 * nu) * self._K_diag + 0.5 * conv

    def _pressure_gradient(self, ps):
        """The tentative right-hand side's pressure term, (d, n)."""
        if self._slab is not None:
            B_c, sv, sq = self._cu.B_c, self._sm_v, self._sm_q
            return self._slab_op(lambda p: kn.mixed(p, B_c, sv, sq), ps, "q", "v")
        if self._structured:
            return kn.mixed(ps, self._cu.B_c, self._sm_v, self._sm_q)
        if self._low_memory:
            return eng.pressure_gradient_vecs(self._ctx, ps)
        return eng.matvec_vq(self._ctx, self._p_vdxi, ps)

    def _tentative_solve(self, A, diag, rhs1, bc_vals, u, x0):
        """Batched BiCGStab with zero-masked bc rows (the kernel path's
        formulation, oasisx_tpu fracstep.py:2390-2410, 2465-2488): x0's bc
        rows preset to the bc values, r0 = zmask (rhs - A x0), tolerance from
        the full rhs norm, Jacobi from the full diagonal.  On the general
        path a ``ksp_type`` cg or gmres solves each component in turn
        (``_tentative_components``), and on the structured path a ``ksp_type``
        cg runs batched CG there; the replicated mode solves a component at a
        time.  Returns (KrylovResult, diff against u, relative exit
        residual)."""
        if self._slab is not None or self._halo is not None:
            return self._tentative_solve_sharded(self._tentative_product(A), diag, rhs1, bc_vals,
                                                 u, x0)
        if self._rep is not None or self._tentative_method() != "bcgs":
            return self._tentative_components(A, diag, rhs1, bc_vals, u, x0)
        masks, zmask = self._bc_masks, self._zmask
        rhs = torch.where(masks, bc_vals, rhs1)
        x0 = torch.where(masks, bc_vals, x0)
        bnorm = torch.linalg.vector_norm(rhs, dim=-1)
        invd = _inv(diag)
        s = self._solver_u
        rtol = _effective_rtol(s.rtol, self._dtype)
        if self._structured:
            # zmask {0, 1}: the same bits as zmask (rhs - A_W x0)
            sm_v = self._sm_v
            r0 = zmask * rhs - kn.matvec_win(A, x0, sm_v, zmask=zmask)
            res = fused.bicgstab(A, r0, x0, zmask, invd, bnorm, sm_v, rtol, s.maxiter, s.atol)
        elif self._layout == "band":
            bv = self._band_v
            vals, b = band_values(A, bv), lambda t: band.to_band(t, bv)
            x0b, zmb = b(x0), b(zmask)
            r0 = zmb * (b(rhs) - band.band_matvec(vals, *bv.tables, x0b))
            res = band.band_bicgstab(vals, *bv.tables, r0, x0b, zmb,
                                     band.to_band(invd, bv, fill=1.0), bnorm, rtol, s.maxiter,
                                     s.atol)
            res = res._replace(x=band.from_band(res.x, bv))
        else:
            ev = self._ell_v
            vals = ell_values(A, ev)
            r0 = zmask * (rhs - ell.ell_matvec(vals, ev.cols, ev.widths, x0))
            res = ell.ell_bicgstab(vals, ev.cols, ev.widths, r0, x0, zmask, invd, bnorm, rtol,
                                   s.maxiter, s.atol)
        diff = torch.sum(torch.linalg.vector_norm(res.x - u, dim=-1))
        return res, diff, _rel_res(res.resnorm, bnorm)

    def _tentative_product(self, A):
        """The tentative operator's product on the internal layout, without
        its bc rows, from ``_assemble_first``'s A: K3 on W (between the halo
        refresh and fold on the slab); K14 on A_lhs's ELL values, K18 on its
        band values in the band layout (between the halo refresh and fold
        under graph-halo); the element product summed under the replicated
        mode."""
        if self._rep is not None:
            return lambda x: eng.matvec_v(self._ctx, A, x)
        if self._structured:
            sm = self._sm_v
            if self._slab is None:
                return lambda x: kn.matvec_win(A, x, sm)
            return lambda x: self._slab_op(lambda v: kn.matvec_win(A, v, sm), x, "v", "v")
        vals, asm = self._op_values(A, "v")
        if self._halo is not None:
            return lambda x: self._halo_apply(vals, asm, x, "v")
        if isinstance(asm, BandAssembly):
            return lambda x: band.from_band(band.band_matvec(vals, *asm.tables,
                                                             band.to_band(x, asm)), asm)
        return lambda x: ell.ell_matvec(vals, asm.cols, asm.widths, x)

    def _tentative_components(self, A, diag, rhs1, bc_vals, u, x0):
        """The tentative solves by CG, GMRES(restart) or (replicated)
        BiCGStab in the JAX package's XLA formulation (oasisx_tpu
        fracstep.py:2512-2540): identity bc rows after the product, the rhs
        with the bc values on them, x0 as given (its bc rows not preset),
        Jacobi with 1 on the bc rows.  Structured (CG only): every component
        at once by ``krylov.cg_batched`` on K3's product at batch d, as the
        JAX kernel path runs it (fracstep.py:2442-2453, its product
        ``_tentative_matvec`` :2312-2316).  General: a component at a time,
        the product K14 at batch 1 on A_lhs's ELL values, or K18's in the
        band layout, both assembled once a solve; replicated: the element
        product summed over the ranks, the dots local.  The Krylov loops run
        as device while loops (in Python outside a capture: a read a trip)."""
        s, masks = self._solver_u, self._bc_masks
        dfull = torch.where(masks, torch.ones_like(bc_vals), diag[None])
        rhs = torch.where(masks, bc_vals, rhs1)
        mv = self._tentative_product(A)
        if self._structured:
            res = krylov.cg_batched(lambda x: eng.apply_bc_rows(masks, mv(x), x), rhs, x0=x0,
                                    M=krylov.jacobi_preconditioner(dfull),
                                    rtol=s.rtol, atol=s.atol, maxiter=s.maxiter)
            diff = torch.sum(torch.linalg.vector_norm(res.x - u, dim=-1))
            return res, diff, _rel_res(res.resnorm, torch.linalg.vector_norm(rhs, dim=-1))
        out = []
        for i in range(rhs.shape[0]):
            A_i = lambda x, m=masks[i]: eng.apply_bc_rows(m, mv(x), x)
            kw = dict(x0=x0[i], M=krylov.jacobi_preconditioner(dfull[i]), rtol=s.rtol,
                      atol=s.atol, maxiter=s.maxiter)
            if s.method == "gmres":
                out.append(krylov.gmres(A_i, rhs[i], restart=s.gmres_restart, **kw))
            else:
                out.append((krylov.cg if s.method == "cg" else krylov.bicgstab)(A_i, rhs[i], **kw))
        res = krylov.KrylovResult(*(torch.stack(t) for t in list(zip(*out))[:4]),
                                  sum(r.syncs for r in out))
        diff = torch.sum(torch.linalg.vector_norm(res.x - u, dim=-1))
        return res, diff, _rel_res(res.resnorm, torch.linalg.vector_norm(rhs, dim=-1))

    def _divergence(self, u, dt):
        """b2 = -(1/dt) assemble(div u q), 0 on the outlet dofs."""
        if self._slab is not None:
            B_c, sv, sq = self._cu.B_c, self._sm_v, self._sm_q
            return (-1.0 / dt) * self._slab_op(lambda v: kn.divergence(v, B_c, sv, sq), u,
                                               "v", "q")
        if self._structured:
            return (-1.0 / dt) * kn.divergence(u, self._cu.B_c, self._sm_v, self._sm_q)
        ctx = self._ctx
        if self._low_memory:
            b2 = eng.divergence_vec(ctx, u)
        else:
            b2 = torch.zeros(ctx.ndofs_q, dtype=u.dtype, device=u.device)
            for i in range(self._mesh.dim):
                b2 = b2 + eng.matvec_qv(ctx, self._divu[i], u[i])
        b2 = (-1.0 / dt) * b2
        if self._pbc_mask is not None:
            b2 = torch.where(self._pbc_mask, torch.zeros_like(b2), b2)
        return b2

    def _pressure_solve(self, b2, dp0):
        """Returns (KrylovResult, dp, relative exit residual).  Structured:
        projected warm start, the pressure PCG, volume-weighted zero mean.
        General: AMG-PCG (K17), or Jacobi- or Chebyshev-Jacobi CG on K14's
        products, its loop a device while loop; with the outlet mask (dp0 as it
        is), or with the nullspace (warm start demeaned, volume-weighted zero
        mean after)."""
        if self._slab is not None or self._halo is not None:
            return self._pressure_solve_sharded(b2, dp0)
        if self._structured:
            nv = self._q_null
            x0 = dp0 - (torch.dot(nv, dp0) / torch.dot(nv, nv)) * nv
            res = self._pcg.solve(b2, x0)
            dp = res.x - (torch.dot(self._intw, res.x) / self._vol) * nv
            return res, dp, _rel_res(res.resnorm, torch.linalg.vector_norm(b2))
        s = self._solver_p
        if self._amg is None:
            return self._pressure_solve_cg(b2, dp0)
        rtol = _effective_rtol(s.rtol, self._dtype)
        op = (self._Ap_vals, self._ell_q.cols, self._ell_q.widths)
        if self._pbc_mask is not None:
            res = ell.ell_pcg_amg(self._amg_data, *op, b2, dp0, rtol, s.maxiter, s.atol,
                                  mask=self._pbc_mask.to(b2.dtype), amg_widths=self._amg_widths)
            dp = res.x
        else:
            res = ell.ell_pcg_amg(self._amg_data, *op, b2, dp0 - torch.mean(dp0), rtol,
                                  s.maxiter, s.atol, amg_widths=self._amg_widths)
            ctx = self._ctx
            dp = res.x - eng.integrate(ctx, eng.eval_q_at_qp(ctx, res.x)) / self._vol
        return res, dp, _rel_res(res.resnorm, torch.linalg.vector_norm(b2))

    def _pressure_solve_cg(self, b2, dp0):
        """The general path's non-AMG pressure solve (the JAX package's
        XLA loop, oasisx_tpu fracstep.py:2660-2720): CG preconditioned by
        Jacobi or by Chebyshev-Jacobi of the set-up's degree and bounds,
        read here at each solve."""
        s, mv = self._solver_p, self._pressure_matvec()
        ch = self._p_cheb
        M = krylov.jacobi_preconditioner(self._Ap_diag) if ch is None else \
            krylov.chebyshev_preconditioner(mv, _inv(self._Ap_diag), ch["lmin"], ch["lmax"],
                                            ch["degree"])
        kw = dict(M=M, rtol=s.rtol, atol=s.atol, maxiter=s.maxiter)
        if self._pbc_mask is not None:
            res = krylov.cg(mv, b2, x0=dp0, **kw)
            dp = res.x
        else:
            res = krylov.cg(mv, b2, x0=dp0 - torch.mean(dp0), project_nullspace=True, **kw)
            ctx = self._ctx
            dp = res.x - eng.integrate(ctx, eng.eval_q_at_qp(ctx, res.x)) / self._vol
        return res, dp, _rel_res(res.resnorm, torch.linalg.vector_norm(b2))

    def _rotational_update(self, p, dp, u, b2, dt, nu):
        """ps = Proj_Q(p + dp - xi nu div u) (oasisx_tpu fracstep.py:
        2740-2764): Mq ps = Mq (p + dp) - xi nu (div u, q) by Jacobi-PCG from
        x0 = p + dp, so r0 = -xi nu (div u, q) exactly and the Mq product
        serves only |rhs|; the ``scalar`` family's rtol (float32-clamped),
        atol and maxiter, Jacobi on diag(Mq) whatever its pc_type.
        Structured: (div u, q) = -dt b2, K7's output reused (this path has
        no outlet rows, and a second K7 launch would add to steps that wait
        on the host), |rhs| from K5 at batch 1 on Mq_c, the solve K4 at
        batch 1; ps 0 on the padding.  General: (div u, q) assembled from
        div u at the quadrature points, as the JAX package does (not the
        outlet-masked b2; the outlet rows are not masked here either), the
        product K14 and the solve K16 at batch 1 on Mq's ELL values.
        Returns (KrylovResult, ps, relative exit residual)."""
        if self._halo is not None or self._rep is not None:
            return self._rotational_update_sharded(p, dp, u, nu)
        sc = self._solver_c
        rtol = _effective_rtol(sc.rtol, self._dtype)
        x0 = (p + dp)[None]
        if self._structured:
            cu, sm_q = self._cu, self._sm_q
            r0 = ((self._xi * nu * dt) * b2)[None]
            bnorm = torch.linalg.vector_norm(kn.matvec_const(x0, cu.Mq_c, sm_q) + r0, dim=-1)
            res = fused.cg_mass(cu.Mq_c, r0, x0, self._Mq_invd, bnorm, sm_q, rtol, sc.maxiter,
                                sc.atol)
            ps = res.x[0] * self._q_null
        else:
            ctx, eq = self._ctx, self._ell_q
            op = (self._Mq_vals, eq.cols, eq.widths)
            r0 = ((-self._xi * nu) * eng.source_load_vec_q(ctx, eng.div_v_at_qp(ctx, u)))[None]
            bnorm = torch.linalg.vector_norm(ell.ell_matvec(*op, x0) + r0, dim=-1)
            res = ell.ell_cg(*op, r0, x0, self._Mq_invd, bnorm, rtol, sc.maxiter, sc.atol)
            ps = res.x[0]
        return res, ps, _rel_res(res.resnorm, bnorm)

    def _velocity_update(self, u, dp, dt, duc):
        """Mass solves M u_new = M u - dt G dp, warm-started from u + duc
        with r0 = -dt G dp - M duc; or the lumped update."""
        if self._lumped:
            return self._lumped_update(u, dp, dt)
        if self._slab is not None:
            cu, sv, sq = self._cu, self._sm_v, self._sm_q
            g = self._slab_op(lambda p: kn.mixed(p, cu.G_c, sv, sq), dp, "q", "v")
            op = lambda x: self._slab_op(lambda v: kn.matvec_const(v, cu.M_c, sv), x, "v", "v")
            return self._velocity_update_sharded(op, u, g, dt, duc)
        sc = self._solver_c
        rtol = _effective_rtol(sc.rtol, self._dtype)
        if self._structured:
            cu, sm_v = self._cu, self._sm_v
            mv = lambda x: kn.matvec_const(x, cu.M_c, sm_v)
            g = kn.mixed(dp, cu.G_c, sm_v, self._sm_q)
        else:
            ctx = self._ctx
            if self._low_memory:
                g = eng.grad_p_vecs(ctx, dp)
            else:
                g = eng.matvec_vq(ctx, self._grad_p, dp)
            if self._halo is not None:
                op = lambda x: self._halo_apply(self._M_vals, self._asm_v, x, "v")
                return self._velocity_update_sharded(op, u, g, dt, duc)
            if self._rep is not None:
                return self._velocity_update_components(u, g, dt, duc)
            if self._layout == "band":
                return self._velocity_update_band(u, g, dt, duc, rtol)
            ev = self._ell_v
            mv = lambda x: ell.ell_matvec(self._M_vals, ev.cols, ev.widths, x)
        b3 = mv(u) - dt * g
        r0 = -dt * g - mv(duc)
        bnorm = torch.linalg.vector_norm(b3, dim=-1)
        if self._structured:
            res = fused.cg_mass(self._cu.M_c, r0, u + duc, self._M_invd, bnorm, self._sm_v,
                                rtol, sc.maxiter, sc.atol)
        else:
            ev = self._ell_v
            res = ell.ell_cg(self._M_vals, ev.cols, ev.widths, r0, u + duc, self._M_invd, bnorm,
                             rtol, sc.maxiter, sc.atol)
        return res, _rel_res(res.resnorm, bnorm)

    def _velocity_update_components(self, u, g, dt, duc):
        """The replicated mode's mass solves (oasisx_tpu fracstep.py:
        2954-2965): Jacobi-CG a component at a time on the element product of
        M summed over the ranks, its dots local, from x0 = u + duc, b3 = M u
        - dt G dp (``g`` = G dp)."""
        sc = self._solver_c
        mv = lambda x: eng.matvec_v(self._ctx, self._M_elems, x)
        b3 = torch.stack([mv(u[i]) - dt * g[i] for i in range(u.shape[0])])
        out = [krylov.cg(mv, b3[i], x0=u[i] + duc[i], M=lambda r: self._M_invd * r, rtol=sc.rtol,
                         atol=sc.atol, maxiter=sc.maxiter) for i in range(u.shape[0])]
        res = krylov.KrylovResult(*(torch.stack(t) for t in list(zip(*out))[:4]),
                                  sum(r.syncs for r in out))
        return res, _rel_res(res.resnorm, torch.linalg.vector_norm(b3, dim=-1))

    def _lumped_update(self, u, dp, dt):
        """The lumped (weighted-gradient) update, u - dt num / diag(M), as
        the JAX package's (oasisx_tpu fracstep.py:2812-2835): num is the
        diag(M)-weighted sum of the cells' gradients of dp at each velocity
        node, K6 on the cube matrix Gw_c (structured) or the element
        gather-scatter (general).  No solve: 0 iterations, converged, exit
        residual 0."""
        if self._structured:
            num = kn.mixed(dp, self._cu.Gw_c, self._sm_v, self._sm_q)
        else:
            num = eng.weighted_nodal_grad_p(self._ctx, dp, self._gtab)
        d = u.shape[0]
        res = krylov.KrylovResult(
            u - dt * num * self._lumped_inv, torch.zeros(d, dtype=torch.int32, device=u.device),
            torch.zeros(d, dtype=u.dtype, device=u.device),
            torch.ones(d, dtype=torch.bool, device=u.device), 0)
        return res, res.resnorm

    def _velocity_update_band(self, u, g, dt, duc, rtol):
        """The general path's mass solves in band form, as the JAX band
        engine's ``mass_solve``: b3, r0 and the norms on the RCM-permuted
        vectors, the result back in the canonical order."""
        sc, bv = self._solver_c, self._band_v
        mv = lambda x: band.band_matvec(self._M_vals, *bv.tables, x)
        ub, gb, ducb = (band.to_band(t, bv) for t in (u, g, duc))
        b3 = mv(ub) - dt * gb
        r0 = -dt * gb - mv(ducb)
        bnorm = torch.linalg.vector_norm(b3, dim=-1)
        res = band.band_cg(self._M_vals, *bv.tables, r0, ub + ducb, self._M_invd_b,
                           bnorm, rtol, sc.maxiter, sc.atol)
        return res._replace(x=band.from_band(res.x, bv)), _rel_res(res.resnorm, bnorm)

    def _step(self, state, dt, nu, bc_vals, h_qvals, max_error, max_iter):
        """One time step; returns (new state, per-step stats on the device,
        host syncs made).  The inner iterations after the first run as the
        JAX package's ``lax.while_loop`` (oasisx_tpu fracstep.py:2969-3018):
        a device while loop while it < max_iter and diff > max_error, its
        carry (u, ps, dp, diff, it and the u/p stats); with ``max_iter`` 1
        there is no loop."""
        u1, u2, p = state["u1"], state["u2"], state["p"]
        A, uq, b_first = self._assemble_first(u1, u2, dt, nu, h_qvals)
        diag = self._tentative_diag(A, uq, dt, nu)
        syncs = [0]

        def inner(u, ps, dp, x0):
            """One inner iteration from (u, ps, dp): (u, ps, dp, diff, stats)."""
            rhs1 = b_first + self._pressure_gradient(ps)
            ures, diff, u_res = self._tentative_solve(A, diag, rhs1, bc_vals, u, x0)
            u = ures.x
            b2 = self._divergence(u, dt)
            pres, dp, p_res = self._pressure_solve(b2, dp)
            stats = dict(u_iters=ures.iters, u_converged=ures.converged, u_res=u_res,
                         p_iters=pres.iters, p_converged=pres.converged, p_res=p_res)
            syncs[0] += ures.syncs + pres.syncs
            if self._rotational:
                rres, ps, r_res = self._rotational_update(p, dp, u, b2, dt, nu)
                syncs[0] += rres.syncs
                stats.update(rot_iters=rres.iters[0], rot_converged=rres.converged[0],
                             rot_res=r_res[0])
            else:
                ps = p + dp
            return u, ps, dp, diff, stats

        # first inner iteration: AB2-extrapolated guess
        u, ps, dp, diff, st = inner(state["u"], p, state["dp"], 2.0 * u1 - u2)
        # filled on the device: a copy from the host would synchronise
        it = torch.full((), 1, dtype=torch.int32, device=u.device)
        if max_iter > 1:
            keys = tuple(st)

            def cond(u, ps, dp, diff, it, *_):
                return (it < max_iter) & (diff > max_error)

            def body(u, ps, dp, diff, it, *_):
                u, ps, dp, diff, s = inner(u, ps, dp, u)
                return (u, ps, dp, diff, it + 1) + tuple(s[k] for k in keys)

            out, n = dl.while_loop(cond, body, (u, ps, dp, diff, it) + tuple(st[k] for k in keys))
            syncs[0] += n
            (u, ps, dp, diff, it), st = out[:5], dict(zip(keys, out[5:]))
        cres, c_res = self._velocity_update(u, dp, dt, state["duc"])
        syncs[0] += cres.syncs
        new_state = dict(u=cres.x, u1=cres.x, u2=u1, p=ps, dp=dp, duc=cres.x - u)
        stats = dict(
            u_iters=st["u_iters"], u_converged=st["u_converged"], u_res=st["u_res"],
            p_iters=st["p_iters"], p_converged=st["p_converged"], p_res=st["p_res"],
            c_iters=cres.iters, c_converged=cres.converged, c_res=c_res,
            inner_iters=it, diff=diff,
        )
        if self._rotational:
            stats.update({k: st[k] for k in ("rot_iters", "rot_converged", "rot_res")})
        return new_state, stats, syncs[0]

    # ------------------------------------------------------------------
    # state
    # ------------------------------------------------------------------
    @property
    def u(self) -> Function:
        """The tentative velocity as a vector Function on the solver's
        device (its components written in)."""
        for ui, cmap in zip(self._u, self._cmaps):
            self._sol_u.x.array[cmap] = ui.x.array
        return self._sol_u

    def _functions(self) -> list[Function]:
        return [*self._u, *self._u1, *self._u2, self._p, self._dp]

    def _versions(self) -> list[int]:
        return [f.x.array._version for f in self._functions()]

    def _state_from_functions(self) -> dict:
        """The device state; rebuilt from the Functions (with a zero warm
        start correction) whenever one of them was written since the last
        call."""
        if self._state is not None and self._versions() == self._state_versions:
            return self._state
        f = lambda fs: self._pv(torch.stack([g.x.array for g in fs]))
        u = f(self._u)
        return dict(
            u=u, u1=f(self._u1), u2=f(self._u2),
            p=self._pq(self._p.x.array), dp=self._pq(self._dp.x.array),
            duc=torch.zeros_like(u),
        )

    def _set_device_state(self, state: dict) -> None:
        self._state = state
        for fs, key in ((self._u, "u"), (self._u1, "u1"), (self._u2, "u2")):
            canon = self._uv(state[key])
            for f, c in zip(fs, canon):
                f.x.array.copy_(c)
        p, dp = self._uq(state["p"]), self._uq(state["dp"])
        self._p.x.array.copy_(p)
        self._ps.x.array.copy_(p)
        self._dp.x.array.copy_(dp)
        self._state_versions = self._versions()

    def set_state(self, state: dict) -> None:
        """Load the solver state from NumPy arrays in the internal layout
        (the grid on the structured path, the canonical dof order on the
        general path and under the replicated mode; on the slab path the
        whole state in the global slab-flat layout, on the graph-halo path
        the stacked local layouts, as ``get_state`` returns it and as the JAX
        package holds it, on every rank, which keeps its own part), keyed as
        the JAX solver's ``_state_from_functions``: u, u1, u2, p, dp, duc."""
        t = lambda a: torch.as_tensor(np.array(a), device=self._device).to(self._dtype)
        st = {k: t(state[k]) for k in STATE_KEYS}
        if self._shard_idx is not None:
            k = self._comm.rank
            for key, arr in st.items():
                n = self._npad_q if key in ("p", "dp") else self._npad_v
                st[key] = arr[..., k * n:(k + 1) * n].contiguous()
        self._set_device_state(st)

    def get_state(self) -> dict:
        """The solver state as NumPy arrays in the internal layout (on the
        owned-dof paths the ranks' parts gathered: a collective)."""
        st = self._state_from_functions()
        if self._shard_idx is not None:
            st = {k: self._gathered(st[k]) for k in STATE_KEYS}
        return {k: st[k].detach().cpu().numpy() for k in STATE_KEYS}

    def _bc_values(self) -> torch.Tensor:
        key = tuple(bc._version for bc_i in self._bcs_u for bc in bc_i)
        if self._bc_cache is None or self._bc_cache[0] != key:
            nv = self._Vi[0][0].num_dofs
            out = np.stack([bc_mask_and_values(bc_i, nv)[1] for bc_i in self._bcs_u])
            vals = torch.as_tensor(out, dtype=self._dtype, device=self._device)
            self._bc_cache = (key, self._pv(vals))
        return self._bc_cache[1]

    def _h_qvals(self) -> list[torch.Tensor]:
        """Each outlet's value at its facet quadrature points (under
        graph-halo: this rank's facets, from the value in the local
        layout)."""
        return [bcp.value_at_facet_qp(self._ctx, f, self._pq)
                for bcp, f in zip(self._bcs_p, self._fctxs)]

    # ------------------------------------------------------------------
    # entry points
    # ------------------------------------------------------------------
    def bc_value_table(self, times, update=None) -> torch.Tensor:
        """Per-step Dirichlet values for ``run(bc_vals_seq=...)``: for each
        t in ``times``, ``update(t)`` (the caller's hook that advances its
        Constants) and every BC re-evaluated; (len(times), d, ndofs) in the
        canonical dof order, on the solver's device."""
        rows = []
        for t in times:
            if update is not None:
                update(float(t))
            for bc_i in self._bcs_u:
                for bc in bc_i:
                    bc.update_bc()
            nv = self._Vi[0][0].num_dofs
            rows.append(np.stack([bc_mask_and_values(bc_i, nv)[1] for bc_i in self._bcs_u]))
        return torch.as_tensor(np.stack(rows), dtype=self._dtype, device=self._device)

    def h_value_table(self, times, update=None) -> list[torch.Tensor]:
        """Per-step outlet values for ``run(h_qvals_seq=...)``: one tensor
        (len(times), nf, nq) per PressureBC, at its facet quadrature
        points."""
        rows = [[] for _ in self._bcs_p]
        for t in times:
            if update is not None:
                update(float(t))
            for bcp in self._bcs_p:
                bcp.update_bc()
            for i, h in enumerate(self._h_qvals()):
                rows[i].append(h)
        return [torch.stack(r) for r in rows]

    def _run_mode(self) -> str:
        """How ``run`` advances its steps: "graph" (one step captured as a
        CUDA graph and replayed, the static-buffer body uncaptured on the
        CPU) on one device, else "eager: <reason>" (the per-step loop)."""
        if self._comm is not None:
            mode = "slab-halo" if self._slab is not None else \
                "graph-halo" if self._halo is not None else "replicated"
            return f"eager: the {mode} mode's Krylov loops read the host every iteration"
        if self._force_eager:
            return "eager: forced, for a comparison with the graph"
        return "graph"

    def _run_tables(self, num_steps: int, bc_vals_seq, h_qvals_seq):
        """The call's boundary values on the device in the internal layout:
        the frozen (d, n) vector or the (num_steps, d, n) table, and each
        outlet's (nf, nq) values or (num_steps, nf, nq) table."""
        on = lambda a: torch.as_tensor(a, dtype=self._dtype, device=self._device)
        if bc_vals_seq is None:
            bc = self._bc_values()
        else:
            bc = self._pv(on(bc_vals_seq))
            nv = self._Vi[0][0].num_dofs
            if tuple(bc.shape[:2]) != (num_steps, self._mesh.dim) or \
                    tuple(bc_vals_seq.shape)[-1] != nv:
                raise ValueError(f"bc_vals_seq: expected ({num_steps}, {self._mesh.dim}, {nv}), "
                                 f"got {tuple(bc_vals_seq.shape)}")
        if h_qvals_seq is None:
            return bc, self._h_qvals()
        h = [on(a) for a in h_qvals_seq]
        if len(h) != len(self._bcs_p) or any(a.shape[0] != num_steps for a in h):
            raise ValueError(f"h_qvals_seq: expected {len(self._bcs_p)} tables of "
                             f"{num_steps} steps")
        return bc, h

    def run(self, num_steps: int, dt: float, nu: float, max_error: float = 1e-12,
            max_iter: int = 1, bc_vals_seq=None, h_qvals_seq=None, step_callback=None,
            t0: float = 0.0) -> dict:
        """Advance ``num_steps`` steps; returns per-step stats as NumPy
        arrays with a leading step axis.

        Without ``bc_vals_seq`` / ``h_qvals_seq`` the boundary values are
        frozen over the call.  ``bc_vals_seq`` (num_steps, d, ndofs), from
        ``bc_value_table``, gives each step its Dirichlet values, and
        ``h_qvals_seq``, from ``h_value_table``, each outlet's; both go to
        the device and the internal layout once a call.
        ``step_callback(state, t)`` sees the device state (internal layout)
        and the time at the end of each step, a 0-d tensor of the solver's
        dtype (t0 + dt + ... + dt); its outputs, a tensor or a dict / tuple
        of tensors, are stacked over the steps on the device into
        ``last_stats["callback"]``, read with the stats once a call.

        Where ``config_report()["run"]`` is "graph" (a single-device
        solver), the step runs on static buffers (``step_graph.StepGraph``):
        on the card one step is captured as a CUDA graph, its while loops
        conditional nodes, the first time the call's key (dt, nu,
        max_error, max_iter, the tables' presence and row shapes, the
        callback's identity, the Chebyshev bounds) is met, or a call is
        longer than its tables' rows, and replayed ``num_steps`` times; a
        new key replaces the graph.  A callback there must be torch on the device (a host read
        fails the capture, naming it); a failed capture raises.  Elsewhere
        the steps run in a loop on the host."""
        if num_steps < 1 or max_iter < 1:
            raise ValueError("num_steps and max_iter must be at least 1")
        state = self._state_from_functions()
        bc, h = self._run_tables(num_steps, bc_vals_seq, h_qvals_seq)
        seq_bc, seq_h = bc_vals_seq is not None, h_qvals_seq is not None
        if self._run_mode() == "graph":
            # the Chebyshev bounds are constants of the captured step
            key = (dt, nu, max_error, max_iter, seq_bc and tuple(bc.shape[1:]),
                   seq_h and tuple(tuple(a.shape[1:]) for a in h),
                   None if step_callback is None else id(step_callback),
                   None if self._p_cheb is None else tuple(sorted(self._p_cheb.items())))
            g = self._graph
            if g is None or g.key != key or g.rows < num_steps:
                # one graph is kept: the old one's buffers and pool go first
                self._graph = g = None
                # the graph reaches the solver through a weak reference: a
                # solver dropped with its graph frees the graph's memory at
                # once, not at the cyclic collector's next pass
                solver = weakref.ref(self)
                step = lambda st, b, hq: solver()._step(st, dt, nu, b, hq, max_error, max_iter)
                g = StepGraph(key, step, state, bc, h, seq_bc, seq_h, table_rows(num_steps), dt,
                              step_callback)
            g.load(state, bc, h, t0)
            if self._device.type == "cuda" and g.graph is None:
                g.capture(t0)
            syncs = g.run(num_steps)
            self._graph = g
            self._set_device_state(dict(g.state))
            self.last_stats, outs = g.read(num_steps)
        else:
            steps, syncs, outs = [], [], []
            t = torch.full((), t0, dtype=self._dtype, device=self._device)
            for k in range(num_steps):
                state, stats, n = self._step(state, dt, nu, bc[k] if seq_bc else bc,
                                             [a[k] for a in h] if seq_h else h, max_error,
                                             max_iter)
                t = t + dt
                if step_callback is not None:
                    outs.append(step_callback(state, t))
                steps.append(stats)
                syncs.append(n)
            self._set_device_state(state)
            self.last_stats = {
                k: torch.stack([s[k] for s in steps]).cpu().numpy() for k in steps[0]
            }
            outs = _host(_stack(outs, self._device)) if step_callback is not None else None
        self.last_stats["host_syncs"] = np.asarray(syncs)
        if step_callback is not None:
            self.last_stats["callback"] = outs
        return self.last_stats

    def solve(self, dt: float, nu: float, max_error: float = 1e-12, max_iter: int = 10) -> float:
        """Propagate one time step (re-evaluating time-dependent BCs first)."""
        for bc_i in self._bcs_u:
            for bc in bc_i:
                bc.update_bc()
        for bcp in self._bcs_p:
            bcp.update_bc()
        stats = self.run(1, dt, nu, max_error=max_error, max_iter=max_iter)
        self.last_stats = {k: v[0] for k, v in stats.items()}
        if not (
            self.last_stats["u_converged"].all()
            and self.last_stats["p_converged"]
            and self.last_stats["c_converged"].all()
            and self.last_stats.get("rot_converged", True)
        ):
            logger.warning("solver did not converge: %s", self.last_stats)
        return float(self.last_stats["diff"])

    # ------------------------------------------------------------------
    # split-phase API (oasisx_tpu fracstep.py:3452-3733): one phase of a
    # step per call, through the step's own helpers; each reads the
    # solver's canonical Functions into the internal layout (a rank's part
    # under a device_mesh) and writes its result back canonical (gathered
    # over the ranks: every phase is a collective there)
    # ------------------------------------------------------------------
    def _read_v(self, fs: list[Function]) -> torch.Tensor:
        return self._pv(torch.stack([f.x.array for f in fs]))

    def _write_v(self, fs: list[Function], arr: torch.Tensor) -> None:
        arr = self._uv(arr)
        for f, a in zip(fs, arr):
            f.x.array.copy_(a)

    def assemble_first(self, dt: float, nu: float) -> None:
        """uab = 1.5 u1 - 0.5 u2, the outlet values updated, b_first into
        ``_b_first``; keeps the step's tentative operator (W structured, the
        element stack A_lhs general) for the solve and the dense export."""
        for ab, f1, f2 in zip(self._uab, self._u1, self._u2):
            ab.x.array.copy_(1.5 * f1.x.array - 0.5 * f2.x.array)
        for bcp in self._bcs_p:
            bcp.update_bc()
        A, uq, b_first = self._assemble_first(self._read_v(self._u1), self._read_v(self._u2),
                                              dt, nu, self._h_qvals())
        self._split = (A, uq, dt, nu)
        self._write_v(self._b_first, b_first)

    def velocity_tentative_assemble(self) -> None:
        """rhs1 = b_first + (ps, dv/dx_i) into ``_rhs1``."""
        rhs1 = self._read_v(self._b_first) + self._pressure_gradient(self._pq(self._ps.x.array))
        self._write_v(self._rhs1, rhs1)

    def velocity_tentative_solve(self) -> tuple[float, np.ndarray]:
        """The tentative solves from x0 = u (the JAX split phase's guess;
        ``run`` starts from 2 u1 - u2), the BC values written into
        ``_rhs1`` first.  Returns (diff, reasons): 2 converged, -3 not, a
        component each."""
        if self._split is None:
            raise RuntimeError("call assemble_first first")
        A, uq, dt, nu = self._split
        bc_vals = self._bc_values()
        rhs1 = torch.where(self._bc_masks, bc_vals, self._read_v(self._rhs1))
        self._write_v(self._rhs1, rhs1)
        u = self._read_v(self._u)
        res, diff, _ = self._tentative_solve(A, self._tentative_diag(A, uq, dt, nu), rhs1,
                                             bc_vals, u, u)
        self._write_v(self._u, res.x)
        return float(diff), _reasons(res.converged)

    def pressure_assemble(self, dt: float) -> None:
        """b2 = -(1/dt) (div u, q), 0 on the outlet dofs, into ``_b2``."""
        self._split_dt = dt
        self._b2.x.array.copy_(self._uq(self._divergence(self._read_v(self._u), dt)))

    def pressure_solve(self, nu: float | None = None) -> int:
        """dp from b2, warm-started from ``_dp``; ps = p + dp, or the
        rotational update with ``nu`` (None: 0).  Writes ``_dp`` and
        ``_ps``; returns 2 converged, -3 not.  The structured rotational
        update takes (div u, q) as -dt b2 with the dt of the last
        ``pressure_assemble``."""
        b2, p = self._pq(self._b2.x.array), self._pq(self._p.x.array)
        res, dp, _ = self._pressure_solve(b2, self._pq(self._dp.x.array))
        if self._rotational:
            if self._structured and self._split_dt is None:
                raise RuntimeError("call pressure_assemble first")
            _, ps, _ = self._rotational_update(p, dp, self._read_v(self._u), b2,
                                               self._split_dt, 0.0 if nu is None else nu)
        else:
            ps = p + dp
        self._dp.x.array.copy_(self._uq(dp))
        self._ps.x.array.copy_(self._uq(ps))
        return int(_reasons(res.converged))

    def velocity_update(self, dt: float) -> np.ndarray:
        """The velocity update of u with ``_dp``, from x0 = u (no previous
        correction, as the JAX split phase); writes ``_u``, returns the
        reasons a component."""
        u = self._read_v(self._u)
        res, _ = self._velocity_update(u, self._pq(self._dp.x.array), dt, torch.zeros_like(u))
        self._write_v(self._u, res.x)
        return _reasons(res.converged)

    def tentative_matrix_dense(self) -> np.ndarray:
        """The dense tentative operator of component 0 as ``assemble_first``
        left it, BC rows zeroed with a unit diagonal, float64 on the host.
        General path on one device: the element stack summed.  Structured
        path and every sharded mode: the mode's own product of the step's
        operator (``_tentative_product``: K3 on W, per slab on the slab
        path; K14 or K18 per rank under graph-halo; the element product
        summed when replicated; the plain versions on the CPU) applied to
        the identity columns, ``DENSE_BATCH`` a call (under graph-halo the
        solve's batch d), and gathered.  Refused above ``DENSE_MAX_DOFS``
        dofs a component."""
        if self._split is None:
            raise RuntimeError("call assemble_first first")
        n = self._Vi[0][0].num_dofs
        if n > DENSE_MAX_DOFS:
            raise ValueError(f"{n} dofs a component: the dense export stops at {DENSE_MAX_DOFS}")
        A_op = self._split[0]
        if self._structured or self._comm is not None:
            mv, dev = self._tentative_product(A_op), self._device
            step = self._mesh.dim if self._halo is not None else DENSE_BATCH
            cols = []
            for j0 in range(0, n, step):
                j = torch.arange(j0, min(j0 + step, n), device=dev)
                X = torch.zeros((len(j), n), dtype=self._dtype, device=dev)
                X[torch.arange(len(j), device=dev), j] = 1.0
                cols.append(self._uv(mv(self._pv(X))).cpu())
            A = torch.cat(cols).T.contiguous().double().numpy()  # column j: A e_j
        else:
            cd = self._ctx.cd_v.cpu().numpy()
            A = eng.elems_to_dense(A_op.detach().cpu().double().numpy(), cd, cd, n, n)
        bc = np.flatnonzero(bc_mask_and_values(self._bcs_u[0], n)[0])
        A[bc, :] = 0.0
        A[bc, bc] = 1.0
        return A
