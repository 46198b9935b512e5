"""IPCS fractional-step Navier-Stokes solver (Adams-Bashforth convection,
Crank-Nicolson diffusion) on PyTorch: the structured single-device path.

Counterpart of ``oasisx_tpu/fracstep.py``'s ``FractionalStep_AB_CN`` on a
mesh from the structured generators, with velocity Dirichlet data and no
outlet (so the pressure Poisson is singular).  Every operator application
and every solve of the step goes through one of the eight kernels of
``assembly/kernels.py``, ``la/fused.py`` and ``la/pressure_mg.py`` (their
plain versions on a CPU device):

  U       = the cube-local values of uab         cube_gather
  b_first = (2/dt) M u1 - A_W u1               matvec_const, matvec_win
  A_W     = (1/dt) M + (nu/2) K + 1/2 C(uab)   per-cube weights W, one matmul
  inner loop (k < max_iter and diff > max_error):
      rhs   = b_first + B ps;  rhs[bc] = g     mixed
      solve A_W u = rhs: x0[bc] = g,           bicgstab (r0 by matvec_win)
        r0 = zmask (rhs - A_W x0), Jacobi
      b2    = -(1/dt) div u                    divergence
      solve Ap dp = b2 (nullspace)             pressure_mg
      ps    = p + dp
  velocity update: solve M u_new = M u - dt G dp   cg_mass (r0 by mixed,
                                                   matvec_const)
  rotate u2 <- u1 <- u_new;  p <- ps

State (u, u1, u2, p, dp, duc) stays on the device between calls, in the
parity-split grid layout; after each call it is written into the solver's
Functions.  On the card each solve is one kernel with its loop on the
device, so a step reads nothing on the host (with ``max_iter > 1`` the
inner-loop test reads ``diff``); the plain versions loop on the host and
read one device scalar per iteration.  ``last_stats["host_syncs"]`` counts
those reads per step; ``run`` adds one read of the stats per call.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from .assembly import cubes as cub
from .assembly import kernels as kn
from .assembly.geometry import compute_cell_geometry
from .assembly.reference_tensors import build_reference_tensors
from .assembly.structured import build_structured_map, num_padded
from .bcs import DirichletBC, bc_mask_and_values
from .config import real_dtype, resolve_device
from .elements.element import make_element
from .la import fused
from .la.krylov import _effective_rtol
from .la.pressure_mg import PressureMGCG
from .la.solver import KSPSolver
from .meshes.mesh import Mesh
from .spaces.functionspace import Function, FunctionSpace

__all__ = ["FractionalStep_AB_CN"]

logger = logging.getLogger("oasisx_tpu_torch")

STATE_KEYS = ("u", "u1", "u2", "p", "dp", "duc")


def _rel_res(rnorm: torch.Tensor, bnorm: torch.Tensor) -> torch.Tensor:
    """Relative exit residual ||b - A x|| / ||b||."""
    return rnorm / torch.clamp(bnorm, min=1e-30)


class FractionalStep_AB_CN:
    """Fractional-step solver with AB2-linearized convection and CN diffusion.

    Args mirror the JAX package: ``mesh`` (from the structured generators),
    ``u_element`` / ``p_element`` as ("Lagrange", degree) tuples or
    FiniteElements, per-component velocity Dirichlet BCs, pressure outlet
    BCs (must be empty: not ported yet), per-family ``solver_options``
    keyed ``tentative`` / ``pressure`` / ``scalar``, ``dtype`` and the
    ``device`` every tensor lives on (required).  The structured path has
    one assembly strategy, so the JAX solver's ``low_memory_version``
    option has no counterpart here.
    """

    def __init__(
        self,
        mesh: Mesh,
        u_element,
        p_element,
        bcs_u: list[list[DirichletBC]],
        bcs_p: list | tuple = (),
        solver_options: dict | None = None,
        dtype=None,
        device=None,
    ):
        if bcs_p:
            raise NotImplementedError("PressureBC (outlet) is not ported yet")
        self._device = resolve_device(device)
        self._dtype = real_dtype(dtype)
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

        # --- boundary conditions ---------------------------------------------
        self._bcs_u = bcs_u
        for bc_i, (Vi, _) in zip(self._bcs_u, self._Vi):
            for bc in bc_i:
                bc.create_bc(Vi)

        # --- structured grid layout and cube operators ------------------------
        rv = build_structured_map(mesh, el_u, Vi0.dofmap)
        rq = build_structured_map(mesh, el_p, self._Q.dofmap)
        if rv is None or rq is None:
            raise ValueError("only meshes from the structured generators are supported")
        (self._sm_v, gf_v, _), (self._sm_q, gf_q, valid_q) = rv, rq
        self._refs = build_reference_tensors(el_u, el_p)
        self._cu = cub.build_cube_ops(
            mesh, self._refs, self._sm_v, self._sm_q, dtype=self._dtype, device=self._device
        )
        if self._cu is None:
            raise ValueError("mesh cells of one shape must share their geometry")
        self._npad_v = num_padded(self._sm_v)
        self._npad_q = num_padded(self._sm_q)
        self._gf_v = torch.as_tensor(gf_v, dtype=torch.long, device=self._device)
        self._gf_q = torch.as_tensor(gf_q, dtype=torch.long, device=self._device)
        self._q_null = torch.as_tensor(valid_q, dtype=self._dtype, device=self._device)

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
        if self._solver_u.method != "bcgs":
            logger.info("the tentative solves run batched BiCGStab (requested %s)",
                        self._solver_u.method)

        self._preassemble()
        self._state: dict | None = None
        self._state_versions = None
        self._bc_cache = None
        self.last_stats: dict = {}
        logger.info("active paths: %s", self.config_report())

    # ------------------------------------------------------------------
    # setup
    # ------------------------------------------------------------------
    def _preassemble(self) -> None:
        """Constant diagonals, integration weights, BC masks, convection
        weight tensor and the pressure preconditioner."""
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

        nv = self._Vi[0][0].num_dofs
        masks = np.stack([bc_mask_and_values(bc_i, nv)[0] for bc_i in self._bcs_u])
        self._bc_masks = self._pv(torch.as_tensor(masks, device=dev))
        # 0 on Dirichlet rows: the tentative operator's output is zeroed there
        self._zmask = (~self._bc_masks).to(dt)
        self._M_invd = torch.where(self._M_diag != 0, 1.0 / self._M_diag, 1.0)

        Ap64 = cu.Ap_c.detach().cpu().double().numpy()
        mg = kn.build_pressure_mg_data(self._sm_q, Ap64)
        if mg is None:
            raise ValueError(
                f"the pressure grid {self._sm_q[1]} does not coarsen "
                "(the MG-preconditioned pressure solve needs even cell counts)"
            )
        diag = self._Ap_diag.detach().cpu().double().numpy()
        invd = np.where(diag != 0, 1.0 / np.where(diag != 0, diag, 1.0), 1.0)
        s = self._solver_p
        self._pcg = PressureMGCG(
            self._sm_q, cu.Ap_c, invd, mg,
            rtol=_effective_rtol(s.rtol, dt), maxiter=s.maxiter,
        )

    def config_report(self) -> dict:
        """The paths this solver instance uses."""
        return {
            "sharding": "single-device",
            "structured_fastpath": True,
            "velocity_update": self._solver_c.method,
            "pressure_pc": "mg-pcg",
            "pressure_mg_levels": len(self._pcg.levels),
            "tentative_method": "bcgs",
            "kernels": list(kn.KERNELS),
            "device": str(self._device),
            "dtype": str(self._dtype).replace("torch.", ""),
        }

    # --- canonical <-> grid dof order ---------------------------------------
    def _pv(self, arr: torch.Tensor) -> torch.Tensor:
        """Canonical V dof order -> padded grid layout (padding zero)."""
        out = torch.zeros(arr.shape[:-1] + (self._npad_v,), dtype=arr.dtype, device=arr.device)
        out[..., self._gf_v] = arr
        return out

    def _pq(self, arr: torch.Tensor) -> torch.Tensor:
        out = torch.zeros(arr.shape[:-1] + (self._npad_q,), dtype=arr.dtype, device=arr.device)
        out[..., self._gf_q] = arr
        return out

    # ------------------------------------------------------------------
    # step phases (tensors on the solver's device, grid layout)
    # ------------------------------------------------------------------
    def _assemble_first(self, u1, u2, dt, nu):
        """The per-cube weights W of A_W, the convecting velocity at the
        quadrature points uq, and b_first = (2/dt) M u1 - A_W u1 (there is
        no body force on this path)."""
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
        return W, uq, b_first

    def _tentative_diag(self, uq, dt, nu):
        return (
            (1.0 / dt) * self._M_diag
            + (0.5 * nu) * self._K_diag
            + 0.5 * cub.conv_diag(self._cu, uq)
        )

    def _tentative_solve(self, W, diag, rhs1, bc_vals, u, x0):
        """Batched BiCGStab on A_W with zero-masked bc rows (the kernel
        path's formulation, oasisx_tpu fracstep.py:2390-2410): x0's bc rows
        preset to the bc values, r0 = zmask (rhs - A_W x0), tolerance from
        the full rhs norm, Jacobi from the full diagonal.  Returns
        (KrylovResult, diff against u, relative exit residual)."""
        masks, zmask, sm_v = self._bc_masks, self._zmask, self._sm_v
        rhs = torch.where(masks, bc_vals, rhs1)
        x0 = torch.where(masks, bc_vals, x0)
        r0 = zmask * (rhs - kn.matvec_win(W, x0, sm_v))
        bnorm = torch.linalg.vector_norm(rhs, dim=-1)
        invd = torch.where(diag != 0, 1.0 / diag, 1.0)
        s = self._solver_u
        res = fused.bicgstab(W, r0, x0, zmask, invd, bnorm, sm_v,
                             _effective_rtol(s.rtol, self._dtype), s.maxiter, s.atol)
        diff = torch.sum(torch.linalg.vector_norm(res.x - u, dim=-1))
        return res, diff, _rel_res(res.resnorm, bnorm)

    def _pressure_solve(self, b2, dp0):
        """Projected warm start, MG-PCG, volume-weighted zero mean; returns
        (KrylovResult, dp, relative exit residual)."""
        nv = self._q_null
        x0 = dp0 - (torch.dot(nv, dp0) / torch.dot(nv, nv)) * nv
        res = self._pcg.solve(b2, x0)
        dp = res.x - (torch.dot(self._intw, res.x) / self._vol) * nv
        return res, dp, _rel_res(res.resnorm, torch.linalg.vector_norm(b2))

    def _velocity_update(self, u, dp, dt, duc):
        """Mass solves M u_new = M u - dt G dp, warm-started from u + duc
        with r0 = -dt G dp - M duc."""
        cu, sm_v = self._cu, self._sm_v
        mv = lambda x: kn.matvec_const(x, cu.M_c, sm_v)
        g = kn.mixed(dp, cu.G_c, sm_v, self._sm_q)
        b3 = mv(u) - dt * g
        r0 = -dt * g - mv(duc)
        bnorm = torch.linalg.vector_norm(b3, dim=-1)
        sc = self._solver_c
        res = fused.cg_mass(cu.M_c, r0, u + duc, self._M_invd, bnorm, sm_v,
                            _effective_rtol(sc.rtol, self._dtype), sc.maxiter, sc.atol)
        return res, _rel_res(res.resnorm, bnorm)

    def _step(self, state, dt, nu, bc_vals, max_error, max_iter):
        """One time step; returns (new state, per-step stats on the device,
        host syncs made)."""
        u, u1, u2, p = state["u"], state["u1"], state["u2"], state["p"]
        W, uq, b_first = self._assemble_first(u1, u2, dt, nu)
        diag = self._tentative_diag(uq, dt, nu)
        ps, dp, it, syncs = p, state["dp"], 0, 0
        while it < max_iter:
            if it > 0:
                syncs += 1
                if not bool(diff > max_error):
                    break
            rhs1 = b_first + kn.mixed(ps, self._cu.B_c, self._sm_v, self._sm_q)
            # first inner iteration: AB2-extrapolated guess
            x0 = 2.0 * u1 - u2 if it == 0 else u
            ures, diff, u_res = self._tentative_solve(W, diag, rhs1, bc_vals, u, x0)
            u = ures.x
            b2 = (-1.0 / dt) * kn.divergence(u, self._cu.B_c, self._sm_v, self._sm_q)
            pres, dp, p_res = self._pressure_solve(b2, dp)
            ps = p + dp
            syncs += ures.syncs + pres.syncs
            it += 1
        cres, c_res = self._velocity_update(u, dp, dt, state["duc"])
        syncs += cres.syncs
        new_state = dict(u=cres.x, u1=cres.x, u2=u1, p=ps, dp=dp, duc=cres.x - u)
        stats = dict(
            u_iters=ures.iters, u_converged=ures.converged, u_res=u_res,
            p_iters=pres.iters, p_converged=pres.converged, p_res=p_res,
            c_iters=cres.iters, c_converged=cres.converged, c_res=c_res,
            # filled on the device: a copy from the host would synchronise
            inner_iters=torch.full((), it, dtype=torch.int32, device=u.device), diff=diff,
        )
        return new_state, stats, syncs

    # ------------------------------------------------------------------
    # state
    # ------------------------------------------------------------------
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
        for i in range(self._mesh.dim):
            self._u[i].x.array.copy_(state["u"][i][self._gf_v])
            self._u1[i].x.array.copy_(state["u1"][i][self._gf_v])
            self._u2[i].x.array.copy_(state["u2"][i][self._gf_v])
        self._p.x.array.copy_(state["p"][self._gf_q])
        self._dp.x.array.copy_(state["dp"][self._gf_q])
        self._state_versions = self._versions()

    def set_state(self, state: dict) -> None:
        """Load the solver state from NumPy arrays in the grid layout, keyed
        as the JAX solver's ``_state_from_functions``: u, u1, u2, p, dp, duc."""
        t = lambda a: torch.as_tensor(np.array(a), device=self._device).to(self._dtype)
        self._set_device_state({k: t(state[k]) for k in STATE_KEYS})

    def get_state(self) -> dict:
        """The solver state as NumPy arrays in the grid layout."""
        st = self._state_from_functions()
        return {k: st[k].detach().cpu().numpy() for k in STATE_KEYS}

    def _bc_values(self) -> torch.Tensor:
        key = tuple(bc._version for bc_i in self._bcs_u for bc in bc_i)
        if self._bc_cache is None or self._bc_cache[0] != key:
            nv = self._Vi[0][0].num_dofs
            out = np.stack([bc_mask_and_values(bc_i, nv)[1] for bc_i in self._bcs_u])
            vals = torch.as_tensor(out, dtype=self._dtype, device=self._device)
            self._bc_cache = (key, self._pv(vals))
        return self._bc_cache[1]

    # ------------------------------------------------------------------
    # entry points
    # ------------------------------------------------------------------
    def run(self, num_steps: int, dt: float, nu: float, max_error: float = 1e-12,
            max_iter: int = 1) -> dict:
        """Advance ``num_steps`` steps with frozen boundary values; returns
        per-step stats as NumPy arrays with a leading step axis."""
        if num_steps < 1 or max_iter < 1:
            raise ValueError("num_steps and max_iter must be at least 1")
        state = self._state_from_functions()
        bc_vals = self._bc_values()
        steps, syncs = [], []
        for _ in range(num_steps):
            state, stats, n = self._step(state, dt, nu, bc_vals, max_error, max_iter)
            steps.append(stats)
            syncs.append(n)
        self._set_device_state(state)
        self.last_stats = {
            k: torch.stack([s[k] for s in steps]).cpu().numpy() for k in steps[0]
        }
        self.last_stats["host_syncs"] = np.asarray(syncs)
        return self.last_stats

    def solve(self, dt: float, nu: float, max_error: float = 1e-12, max_iter: int = 10) -> float:
        """Propagate one time step (re-evaluating time-dependent BCs first)."""
        for bc_i in self._bcs_u:
            for bc in bc_i:
                bc.update_bc()
        stats = self.run(1, dt, nu, max_error=max_error, max_iter=max_iter)
        self.last_stats = {k: v[0] for k, v in stats.items()}
        if not (
            self.last_stats["u_converged"].all()
            and self.last_stats["p_converged"]
            and self.last_stats["c_converged"].all()
        ):
            logger.warning("solver did not converge: %s", self.last_stats)
        return float(self.last_stats["diff"])
