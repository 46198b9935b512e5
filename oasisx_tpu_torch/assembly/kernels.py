"""The slice's hand-written cube kernels, their plain versions, their
host-side tables, and the launch counters of every kernel of the port.

Six wrappers here, each in front of one entry point of ``csrc/cube_ops.cu``:

============== ======================================== =========================
wrapper        computes                                 replaces (pallas_ops.py)
============== ======================================== =========================
matvec_const   y_b = sum_c P_c^T C P_c x_b, batch B     make_matvec_pf, make_matvec
matvec_win     y_b = zmask_b sum_c P_c^T W_c P_c        make_matvec_win,
               (premul_b x_b); the multipliers          make_matvec_hbm_chan,
               optional                                 make_tent_matvec_hbm
mixed          r_g = C_g p, g < d                       make_mixed_pf
divergence     b2 = sum_g B_g^T u_g                     make_divergence_pf
cube_gather    U_b = (P_c x_b)_c, (B, nl, ncubes)       make_gather(_chunked)
cube_scatter   y_b = sum_c P_c^T U_b[:, c]              make_scatter(_chunked)
============== ======================================== =========================

``cube_scatter`` is on no path of the solver, but its kernel is: on the
card ``matvec_win`` is a cube-owned product in two launches, a thread a cube
into a stage (min(B, 4), nl, ncubes), then K13's scatter of the stage with
the zmask at its store.  The whole-solve kernels of
``csrc/krylov_ops.cu`` have their wrappers in ``la/fused.py`` (``cg_mass``,
``bicgstab``), ``la/pressure_mg.py`` (``pressure_mg``) and
``la/pressure_cg.py`` (``pressure_cg``, K1's non-MG modes), the ELL kernels
of the unstructured path (``csrc/ell_ops.cu``) theirs in ``la/ell.py`` and,
for the band-ELL layout, ``la/band.py``; all count here too.

A CPU tensor goes to the plain version (built from the ``cubes.py`` ops); a
CUDA tensor goes to the kernel, and anything else raises.  ``launches``
counts kernel launches per wrapper and ``plain_calls`` counts the plain
versions, so a run can show which path it took.  A replay of a captured
CUDA graph calls no wrapper: ``RecordedCounts`` records what a capture
launched and adds it once per replay (``step_graph.py``).

``matvec_const`` on the P2 cube (K5) and K4's product run the block-tiled
product of ``csrc/cube_device.cuh``, whose tile (base points a block owns
per axis) the entry points choose there (``tile_choose``), and so do
``mixed`` (K6) and ``divergence`` (K7) on the P2/P1 pair (``tile_mixed``;
any other pair point by point); ``matvec_const_staged_plain``,
``mixed_staged_plain`` and ``divergence_staged_plain`` are their orders of
sums as tensor code, for the tests (``matvec_win_staged_plain`` is K3's and
K2's).

Also here: ``conv_weight_tensor`` and ``build_w`` (the per-cube weights of
the tentative operator, one matmul), and ``build_pressure_mg_data`` (the
pressure V-cycle's host tables), both copied from the JAX package.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import cubes as cub
from .structured import StructuredMap

# the kernels each path of the solver launches: the structured cube path
# (with one of the two pressure solves: pressure_mg on a grid that coarsens,
# pressure_cg otherwise) and the unstructured ELL path
STRUCTURED_KERNELS = (
    "matvec_const", "matvec_win", "mixed", "divergence", "cube_gather",
    "cg_mass", "bicgstab", "pressure_mg", "pressure_cg",
)
# the slab-sharded structured path: the cube kernels per shard (its Krylov
# loops run on the host, the pressure MG's level products through K12)
SLAB_KERNELS = ("matvec_const", "matvec_win", "mixed", "divergence", "cube_gather")
ELL_KERNELS = ("ell_matvec", "ell_bicgstab", "ell_cg", "ell_pcg_amg")
# the general path with ell_layout="band": the velocity operators in band
# form, the pressure solve (and its r0 product) on the flat ELL Ap
BAND_KERNELS = ("band_matvec", "band_bicgstab", "band_cg", "ell_matvec", "ell_pcg_amg")
# the graph-halo sharded general path: every product K14 on the rank's local
# ELL operator between the halo refresh and fold (its Krylov loops run on the
# host); under ell_layout="band" every product K18 on band tables
HALO_KERNELS = ("ell_matvec",)
HALO_BAND_KERNELS = ("band_matvec",)
KERNELS = (STRUCTURED_KERNELS + ("cube_scatter",) + ELL_KERNELS
           + ("band_matvec", "band_bicgstab", "band_cg"))
# counted too: K17's V-cycle launched alone (tests and checks; not on a path),
# and the condition setter of a device while loop (la/device_loop.py), which
# launches only while a graph is captured and replaces no TPU kernel
_COUNTED = KERNELS + ("ell_vcycle", "graph_loop")
launches = dict.fromkeys(_COUNTED, 0)
# components of one launch of the cube kernels (kMaxBatch, csrc/cube_device.cuh):
# the leading size of matvec_win's stage, which each launch reuses
STAGE_BATCH = 4
plain_calls = dict.fromkeys(_COUNTED, 0)


def reset_counts() -> None:
    for k in _COUNTED:
        launches[k] = 0
        plain_calls[k] = 0


class RecordedCounts:
    """The launches and plain calls made inside a ``with`` block (the
    capture of a CUDA graph, the body of a device while loop captured in
    it, or a warm-up), taken out of the counters when the block ends;
    ``replayed(n)`` adds them back n times, once per replay of what the
    block recorded: a replay runs its kernels without calling a wrapper, so
    the counters see it only here.  A block nested in another is taken out
    of the outer one's count too: a while body's launches run once a trip,
    not once a replay, so ``replayed(n, loops)`` adds each body's (a
    ``RecordedCounts``) as many times as its trip counter ran it."""

    def __enter__(self) -> "RecordedCounts":
        self._start = (dict(launches), dict(plain_calls))
        self.launches = self.plain_calls = None
        return self

    def __exit__(self, *exc) -> None:
        (l0, p0), self.launches, self.plain_calls = self._start, {}, {}
        for k in _COUNTED:
            self.launches[k], self.plain_calls[k] = launches[k] - l0[k], plain_calls[k] - p0[k]
            launches[k], plain_calls[k] = l0[k], p0[k]

    def replayed(self, n: int, loops=()) -> None:
        """n replays; ``loops``: (a while body's counts, its trips in them)."""
        for k in _COUNTED:
            launches[k] += n * self.launches[k]
            plain_calls[k] += n * self.plain_calls[k]
        for body, trips in loops:
            body.replayed(trips)


# ---------------------------------------------------------------------------
# host tables
# ---------------------------------------------------------------------------


def conv_weight_tensor(cu) -> np.ndarray:
    """T[(g,m),(i,j)] with C_cube(u)[i,j] = sum_{g,m} u27[g,m] T[(g,m),(i,j)]:
    the cube-level convection matrix is linear in the convecting velocity's
    cube-local values. Host-side, tiny ((d*nl) x (nl*nl))."""
    PhiW = cu.PhiW.detach().cpu().double().numpy()  # (Q, nl)
    Phi = cu.Phi.detach().cpu().double().numpy()  # (Q, nl)
    Dg = cu.Dg.detach().cpu().double().numpy()  # (Q, d, nl)
    T = np.einsum("qi,qm,qgj->gmij", PhiW, Phi, Dg)
    d, nl = Dg.shape[1], Dg.shape[2]
    return T.reshape(d * nl, nl * nl)


def build_w(T: torch.Tensor, A0: torch.Tensor, U: torch.Tensor) -> torch.Tensor:
    """Per-cube tentative-operator weights in the compact layout:
    W = A0.reshape(-1, 1) + 0.5 * T^T U, shape (nl*nl, ncubes), row
    ``to*nl + ti``.  ``U`` is the convecting velocity gathered to cubes,
    (d*nl, ncubes).  The math of ``build_w_win_from_u`` without the TPU's
    seam/pad window; a plain matmul, as the JAX package leaves it to XLA."""
    return torch.addmm(A0.reshape(-1, 1), T.T, U, alpha=0.5)


def build_pressure_mg_data(
    sm_q: StructuredMap,
    Ap_c: np.ndarray,
    coarsest: int = 3,
    nsmooth: int = 2,
    omega: float = 0.8,
    coarse_degree: int = 14,
) -> dict | None:
    """Host-side tables of the pressure V-cycle preconditioner: level
    hierarchy, per-level Jacobi diagonals, 1-D transfer matrices, and exact
    coarsest-level Chebyshev eigenvalue bounds.

    The P1 pressure grid on a structured generator mesh coarsens by cell
    halving; the coarse cube matrix is exactly ``Ap_c * 2**(l*(d-2))``.
    Transfers are axis-separable linear interpolation P (restriction
    P^T).  The coarsest level is solved by a degree-``coarse_degree``
    Chebyshev-Jacobi iteration with bounds from a dense eigvalsh.

    Returns None when the grid does not coarsen (odd cells / too coarse /
    degree != 1).  Copied from ``oasisx_tpu/assembly/pallas_ops.py``.
    """
    _, cells, deg, _, _ = sm_q
    d = len(cells)
    if deg != 1 or d not in (2, 3):
        return None
    res = [tuple(int(c) for c in cells)]
    while all(c % 2 == 0 and c // 2 >= coarsest for c in res[-1]):
        res.append(tuple(c // 2 for c in res[-1]))
    if len(res) < 2:
        return None
    Ap = np.asarray(Ap_c, np.float64)
    levels = []
    for li, cl in enumerate(res):
        scale = 2.0 ** (li * (d - 2))
        grid = tuple(c + 1 for c in cl)
        D = np.zeros(grid)
        for t in range(2**d):
            base = np.unravel_index(t, (2,) * d)
            slc = tuple(slice(int(b), int(b) + c) for b, c in zip(base, cl))
            D[slc] += Ap[t, t] * scale
        invd = (1.0 / np.where(D != 0, D, 1.0)).astype(np.float32)
        levels.append(dict(cells=cl, grid=grid, scale=scale, invd=invd))

    def interp1d(nf: int, nc: int) -> np.ndarray:
        P = np.zeros((nf, nc), np.float32)
        for i in range(nf):
            if i % 2 == 0:
                P[i, i // 2] = 1.0
            else:
                P[i, (i - 1) // 2] = 0.5
                P[i, (i + 1) // 2] = 0.5
        return P

    # per transition: (A^T, A, B, B^T) — A interpolates grid axis d-2, B axis
    # d-1; a 3D leading axis uses the same 1.0/0.5 weights written out
    transfers = []
    for li in range(len(levels) - 1):
        gf, gc = levels[li]["grid"], levels[li + 1]["grid"]
        A = interp1d(gf[d - 2], gc[d - 2])
        B = interp1d(gf[d - 1], gc[d - 1])
        transfers.append((np.ascontiguousarray(A.T), A, B, np.ascontiguousarray(B.T)))

    # exact Chebyshev bounds for the coarsest operator D^{-1}A (singular
    # Neumann: lmin = smallest NONZERO eigenvalue)
    Lc = levels[-1]
    grid_c, cl = Lc["grid"], Lc["cells"]
    n = int(np.prod(grid_c))
    idx = np.arange(n).reshape(grid_c)
    A_dense = np.zeros((n, n))
    for tO in range(2**d):
        bO = np.unravel_index(tO, (2,) * d)
        rows = idx[tuple(slice(int(b), int(b) + c) for b, c in zip(bO, cl))].ravel()
        for tI in range(2**d):
            bI = np.unravel_index(tI, (2,) * d)
            cols = idx[tuple(slice(int(b), int(b) + c) for b, c in zip(bI, cl))].ravel()
            np.add.at(A_dense, (rows, cols), Ap[tO, tI] * Lc["scale"])
    dsqrt = 1.0 / np.sqrt(np.diag(A_dense))
    w = np.linalg.eigvalsh(A_dense * dsqrt[:, None] * dsqrt[None, :])
    lmax = float(w[-1]) * 1.02
    nonzero = w[w > 1e-8 * max(w[-1], 1.0)]
    lmin = float(nonzero[0]) * 0.95 if len(nonzero) else lmax / 30.0
    return dict(
        levels=levels,
        transfers=transfers,
        coarse=(lmin, lmax, int(coarse_degree)),
        nsmooth=int(nsmooth),
        omega=float(omega),
    )


# ---------------------------------------------------------------------------
# plain versions (the CPU path, and the reference the card is held to)
# ---------------------------------------------------------------------------


def matvec_const_plain(x: torch.Tensor, C: torch.Tensor, sm: StructuredMap) -> torch.Tensor:
    plain_calls["matvec_const"] += 1
    return cub.matvec_cube(x, C, sm)


def matvec_const_staged_plain(x: torch.Tensor, C: torch.Tensor, sm: StructuredMap) -> torch.Tensor:
    """``matvec_const_plain`` summed in the order of K5's and K4's tiled
    product (``csrc/cube_device.cuh`` ``tile_product``): ``matvec_win_staged_plain``
    with the one cube matrix C (nl, nl) for every cube.  For the tests."""
    xb = x.reshape(-1, int(np.prod(sm[0])))
    return _staged_sum(C[:, :, None], cub.cube_gather(xb, sm), sm).reshape(x.shape)


def stencil_table(C: torch.Tensor, d: int) -> torch.Tensor:
    """The P1 cube matrix C (2^d, 2^d) as 3^d classes of 3^d stencil
    coefficients, as ``csrc/cube_device.cuh`` ``stencil_stage`` builds them:
    S[cls, e] sums C[delta, delta + e] over the cubes b - delta that hold a
    point of class cls (per axis: b = 0 delta 0 only, b = n delta 1 only,
    else both) and both ends of the offset, in float64 over delta in
    C-order, rounded once to C's dtype; cls and e with the last axis's digit
    fastest (e's digits are the offsets plus 1)."""
    Cd = C.detach().to("cpu", torch.float64).numpy()
    S = np.zeros((3 ** d, 3 ** d))
    for cls, e in np.ndindex(3 ** d, 3 ** d):
        cd = np.array(np.unravel_index(cls, (3,) * d))
        ed = np.array(np.unravel_index(e, (3,) * d)) - 1
        for dl in range(2 ** d):
            delta = np.array(np.unravel_index(dl, (2,) * d))
            ti = delta + ed
            if (np.all((ti >= 0) & (ti <= 1)) and not np.any((cd == 0) & (delta == 1))
                    and not np.any((cd == 2) & (delta == 0))):
                S[cls, e] += Cd[dl, np.ravel_multi_index(tuple(ti), (2,) * d)]
    return torch.as_tensor(S).to(C.device, C.dtype)


def matvec_stencil_plain(x: torch.Tensor, C: torch.Tensor, sm: StructuredMap) -> torch.Tensor:
    """``matvec_const_plain`` on the P1 cube summed as K1's non-MG modes
    and K4's P1 route sum it (``csrc/cube_device.cuh`` ``stencil_apply``):
    each point adds its 3^d neighbours times its class's coefficients
    (``stencil_table``) in the offsets' C-order, 0 beyond the grid.  x
    (B, npad) or (npad,).  For the tests."""
    d = len(sm[1])
    if int(sm[2]) != 1:
        raise ValueError(f"the stencil is the P1 cube's, not degree {sm[2]}'s")
    g = tuple(int(n) + 1 for n in sm[1])
    xb = x.reshape(-1, *g)
    S = stencil_table(C, d)
    xp = torch.nn.functional.pad(xb, (1, 1) * d)
    cls = torch.zeros(g, dtype=torch.long, device=x.device)
    for k in range(d):
        i = torch.arange(g[k], device=x.device)
        ck = torch.where(i == 0, 0, torch.where(i == g[k] - 1, 2, 1))
        cls = 3 * cls + ck.reshape([g[k] if j == k else 1 for j in range(d)])
    y = torch.zeros_like(xb)
    for e, ed in enumerate(np.ndindex((3,) * d)):
        y = y + S[cls, e] * xp[(slice(None),) + tuple(slice(o, o + g[k]) for k, o in enumerate(ed))]
    return y.reshape(x.shape)


def _staged_sum(Wt: torch.Tensor, U: torch.Tensor, sm: StructuredMap) -> torch.Tensor:
    """Per cube, each output slot sums its input slots in slot order (Wt
    (..., nl_out, nl_in, ncubes or 1) against U (B, nl_in, ncubes), the
    leading axes broadcast); then each point of ``sm``'s grid sums its cubes'
    values in ``cube_visit``'s order, which is ``cubes.cube_scatter``'s."""
    Y = 0.0
    for ti in range(U.shape[-2]):
        Y = Y + Wt[..., ti, :] * U[..., ti : ti + 1, :]
    return cub.cube_scatter(Y, sm)


def matvec_win_plain(W: torch.Tensor, x: torch.Tensor, sm: StructuredMap, premul=None,
                     zmask=None) -> torch.Tensor:
    plain_calls["matvec_win"] += 1
    nl = cub.num_slots(sm)
    U = cub.cube_gather(x if premul is None else premul * x, sm)  # (B, nl, nc)
    Y = torch.einsum("tic,bic->btc", W.reshape(nl, nl, -1), U)
    y = cub.cube_scatter(Y, sm)
    return y if zmask is None else zmask * y


def matvec_win_staged_plain(W: torch.Tensor, x: torch.Tensor, sm: StructuredMap, premul=None,
                            zmask=None) -> torch.Tensor:
    """``matvec_win_plain`` summed in the order of K3's product and K2's
    in-solve one (``csrc/cube_device.cuh`` ``win_cube``): per cube, each
    output slot sums its nl input slots in slot order into a staged (B, nl,
    ncubes) value; then each point sums the staged values of its cubes in
    ``cube_visit``'s order, which is ``cubes.cube_scatter``'s.  Their product
    as tensor code, for the tests."""
    nl = cub.num_slots(sm)
    U = cub.cube_gather(x if premul is None else premul * x, sm)  # (B, nl, nc)
    y = _staged_sum(W.reshape(nl, nl, -1), U, sm)
    return y if zmask is None else zmask * y


def mixed_plain(p: torch.Tensor, C_all: torch.Tensor, sm_v, sm_q) -> torch.Tensor:
    plain_calls["mixed"] += 1
    return cub.mixed_all(p, C_all, sm_v, sm_q)


def divergence_plain(u: torch.Tensor, B_all: torch.Tensor, sm_v, sm_q) -> torch.Tensor:
    plain_calls["divergence"] += 1
    return cub.divergence_cube(u, B_all, sm_v, sm_q)


def mixed_staged_plain(p: torch.Tensor, C_all: torch.Tensor, sm_v, sm_q) -> torch.Tensor:
    """``mixed_plain`` summed in the order of K6's tiled product
    (``csrc/cube_device.cuh`` ``tile_mixed``): per cube, each output slot of
    each component g sums the cube's nl_q inputs in slot order against C_g's
    row; then each velocity point sums its cubes' staged values in
    ``cube_visit``'s order.  For the tests."""
    U = cub.cube_gather(p[None], sm_q)  # (1, nl_q, nc)
    return _staged_sum(C_all[..., None], U, sm_v)


def divergence_staged_plain(u: torch.Tensor, B_all: torch.Tensor, sm_v, sm_q) -> torch.Tensor:
    """``divergence_plain`` summed in the order of K7's tiled product
    (``csrc/cube_device.cuh`` ``tile_mixed``): per cube, each output slot
    sums the components g in order and, in each, the cube's nl_v input slots
    in slot order against B_g's column; then each pressure point sums its
    cubes' staged values in ``cube_visit``'s order.  For the tests."""
    d, nl_v, nl_q = B_all.shape
    U = cub.cube_gather(u, sm_v).reshape(1, d * nl_v, -1)  # slots (g, ti), g first
    Wt = B_all.permute(2, 0, 1).reshape(nl_q, d * nl_v, 1)
    return _staged_sum(Wt, U, sm_q)[0]


def cube_gather_plain(x: torch.Tensor, sm: StructuredMap) -> torch.Tensor:
    plain_calls["cube_gather"] += 1
    return cub.cube_gather(x, sm)


def cube_scatter_plain(U: torch.Tensor, sm: StructuredMap) -> torch.Tensor:
    plain_calls["cube_scatter"] += 1
    return cub.cube_scatter(U, sm)


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------


def _route(*tensors: torch.Tensor) -> bool:
    """True for the kernel (all on one CUDA device), False for the plain
    version (all on the CPU); raises otherwise."""
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"tensors on several devices: {sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type == "cpu":
        return False
    if dev.type == "cuda":
        return True
    raise ValueError(f"no kernel for device {dev}")


def _check(t: torch.Tensor, name: str, dtype: torch.dtype, shape: tuple) -> None:
    if t.dtype != dtype or t.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype} (float32 or float64)")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def _dims(sm: StructuredMap) -> tuple[int, int, int, int]:
    cells = tuple(int(c) for c in sm[1])
    if len(cells) not in (2, 3):
        raise ValueError(f"only 2D and 3D grids, got cells {cells}")
    return (len(cells),) + cells + (0,) * (3 - len(cells))


def _stream(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def coop_capacity(device: torch.device) -> int:
    """The most blocks of 256 threads the card holds at once: the size of
    the reduction-slot buffer a cooperative (whole-solve) kernel needs."""
    props = torch.cuda.get_device_properties(device)
    per_sm = getattr(props, "max_threads_per_multi_processor", 2048) // 256
    return per_sm * props.multi_processor_count


def _call(name: str, *args) -> None:
    from .._build import library

    err = getattr(library(), "oasisx_" + name)(*args)
    if err != 0:
        raise RuntimeError(f"kernel {name} failed to launch: CUDA error {err}")
    launches[name] += 1


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def matvec_const(x: torch.Tensor, C: torch.Tensor, sm: StructuredMap) -> torch.Tensor:
    """y = A x with constant cube matrix C (nl, nl); x (B, npad) or (npad,).
    On the card the P2 cube (K5) takes the block-tiled product, any other
    degree (K12) the point-by-point one."""
    if not _route(x, C):
        return matvec_const_plain(x, C, sm)
    npad = int(np.prod(sm[0]))
    nl = cub.num_slots(sm)
    xb = x.reshape(-1, npad) if x.dim() == 1 else x
    _check(xb, "x", x.dtype, (xb.shape[0], npad))
    _check(C, "C", x.dtype, (nl, nl))
    y = torch.empty_like(xb)
    with torch.cuda.device(x.device):
        _call("matvec_const", _ptr(xb), _ptr(C), _ptr(y), int(x.dtype == torch.float64),
              *_dims(sm), int(sm[2]), int(xb.shape[0]), _stream(x))
    return y.reshape(x.shape)


def matvec_win(W: torch.Tensor, x: torch.Tensor, sm: StructuredMap, premul=None,
               zmask=None, stage=None) -> torch.Tensor:
    """y_b = zmask_b * A_W (premul_b * x_b) with per-cube weights W
    (nl*nl, ncubes); x (B, npad), premul and zmask (B, npad) or None (1).
    On the card the product is cube-owned (``csrc/cube_ops.cu``): ``stage``
    is its work buffer, (min(B, 4), nl, ncubes) of x's dtype, allocated here
    when None; the CPU path ignores it."""
    extra = [t for t in (premul, zmask) if t is not None]
    if not _route(W, x, *extra):
        return matvec_win_plain(W, x, sm, premul, zmask)
    with torch.cuda.device(x.device):
        if stage is None:
            stage = torch.empty((min(x.shape[0], STAGE_BATCH), cub.num_slots(sm),
                                 int(np.prod(sm[1]))), dtype=x.dtype, device=x.device)
        return _matvec_win_kernel(W, x, sm, premul, zmask, stage)


def _check_stage(stage, B: int, nl: int, nc: int, dtype: torch.dtype) -> None:
    """A cube-owned product's work buffer (K3's, K2's): a contiguous (B,
    nl, ncubes) tensor of the product's dtype, where the per-cube outputs go
    before they are summed into the points."""
    if not isinstance(stage, torch.Tensor):
        raise ValueError(f"stage: expected a ({B}, {nl}, {nc}) tensor, got {stage!r}")
    _check(stage, "stage", dtype, (B, nl, nc))


def _matvec_win_kernel(W, x, sm, premul, zmask, stage) -> torch.Tensor:
    npad = int(np.prod(sm[0]))
    nl = cub.num_slots(sm)
    nc = int(np.prod(sm[1]))
    _check(x, "x", x.dtype, (x.shape[0], npad))
    _check(W, "W", x.dtype, (nl * nl, nc))
    for name, t in (("premul", premul), ("zmask", zmask)):
        if t is not None:
            _check(t, name, x.dtype, tuple(x.shape))
    _check_stage(stage, min(x.shape[0], STAGE_BATCH), nl, nc, x.dtype)
    opt = lambda t: ctypes.c_void_p(0) if t is None else _ptr(t)
    y = torch.empty_like(x)
    _call("matvec_win", _ptr(x), _ptr(W), opt(premul), opt(zmask), _ptr(y), _ptr(stage),
          stage.numel(), int(x.dtype == torch.float64), *_dims(sm), int(sm[2]), int(x.shape[0]),
          _stream(x))
    return y


def mixed(p: torch.Tensor, C_all: torch.Tensor, sm_v, sm_q) -> torch.Tensor:
    """r_g = C_all[g] p for every component g: (npad_q,) -> (d, npad_v).  On
    the card the P2/P1 pair with d components takes the block-tiled product,
    any other pair the point-by-point one (chosen in ``csrc/cube_ops.cu``)."""
    if not _route(p, C_all):
        return mixed_plain(p, C_all, sm_v, sm_q)
    if tuple(sm_v[1]) != tuple(sm_q[1]):
        raise ValueError("velocity and pressure grids must share their cells")
    npad_v, npad_q = int(np.prod(sm_v[0])), int(np.prod(sm_q[0]))
    ncomp = C_all.shape[0]
    _check(p, "p", p.dtype, (npad_q,))
    _check(C_all, "C_all", p.dtype, (ncomp, cub.num_slots(sm_v), cub.num_slots(sm_q)))
    r = torch.empty((ncomp, npad_v), dtype=p.dtype, device=p.device)
    with torch.cuda.device(p.device):
        _call("mixed", _ptr(p), _ptr(C_all), _ptr(r), int(p.dtype == torch.float64),
              *_dims(sm_v), int(sm_v[2]), int(sm_q[2]), int(ncomp), _stream(p))
    return r


def divergence(u: torch.Tensor, B_all: torch.Tensor, sm_v, sm_q) -> torch.Tensor:
    """b2 = sum_g B_all[g]^T u[g]: (d, npad_v) -> (npad_q,).  Routes as
    ``mixed``'s."""
    if not _route(u, B_all):
        return divergence_plain(u, B_all, sm_v, sm_q)
    if tuple(sm_v[1]) != tuple(sm_q[1]):
        raise ValueError("velocity and pressure grids must share their cells")
    npad_v, npad_q = int(np.prod(sm_v[0])), int(np.prod(sm_q[0]))
    ncomp = u.shape[0]
    _check(u, "u", u.dtype, (ncomp, npad_v))
    _check(B_all, "B_all", u.dtype, (ncomp, cub.num_slots(sm_v), cub.num_slots(sm_q)))
    b2 = torch.empty(npad_q, dtype=u.dtype, device=u.device)
    with torch.cuda.device(u.device):
        _call("divergence", _ptr(u), _ptr(B_all), _ptr(b2), int(u.dtype == torch.float64),
              *_dims(sm_v), int(sm_v[2]), int(sm_q[2]), int(ncomp), _stream(u))
    return b2


def cube_gather(x: torch.Tensor, sm: StructuredMap) -> torch.Tensor:
    """Cube-local values of grid vectors: (B, npad) -> (B, nl, ncubes)."""
    if not _route(x):
        return cube_gather_plain(x, sm)
    npad = int(np.prod(sm[0]))
    _check(x, "x", x.dtype, (x.shape[0], npad))
    u = torch.empty((x.shape[0], cub.num_slots(sm), int(np.prod(sm[1]))),
                    dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        _call("cube_gather", _ptr(x), _ptr(u), int(x.dtype == torch.float64), *_dims(sm),
              int(sm[2]), int(x.shape[0]), _stream(x))
    return u


def cube_scatter(U: torch.Tensor, sm: StructuredMap) -> torch.Tensor:
    """Assembled grid vectors of cube-local values: (B, nl, ncubes) -> (B, npad)."""
    if not _route(U):
        return cube_scatter_plain(U, sm)
    B = U.shape[0]
    _check(U, "U", U.dtype, (B, cub.num_slots(sm), int(np.prod(sm[1]))))
    y = torch.empty((B, int(np.prod(sm[0]))), dtype=U.dtype, device=U.device)
    with torch.cuda.device(U.device):
        _call("cube_scatter", _ptr(U), _ptr(y), int(U.dtype == torch.float64), *_dims(sm),
              int(sm[2]), int(B), _stream(U))
    return y
