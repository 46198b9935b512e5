#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

1. Card: requires torch.cuda; prints the device and nvidia-smi's name and
   power limit.
2. Build: compiles the CUDA kernels of oasisx_tpu_torch/csrc (first use),
   and emits the PTX of cube_ops.cu, krylov_ops.cu and ell_ops.cu (nvcc
   -ptx): the count of 64-bit integer divisions and remainders (div/rem on
   .s64/.u64) in each is printed, and phase 2 fails unless cube_ops.cu and
   krylov_ops.cu have none.  K1 MG's plan (oasisx_pressure_mg_plan) for
   N=36, N=64, a 256x256 rectangle and the MG_BOXES, MG_GRID_BOXES and
   MG_CUBES grids, both types:
   printed, and held against la/pressure_mg.py's mirror of its teams and
   barriers.
3. Kernels: at the bench shapes (3D Taylor-Green, N=36, P2/P1) each
   kernel against its plain PyTorch version, in float64 and float32, both
   timed with CUDA events.  The cube operators (K5, K3 at batch 3 and 1,
   with its premul and zmask multipliers and with the zmask alone, K6 on
   B_c, G_c and the lumped update's weighted-gradient matrix Gw_c, K7)
   and the cube scatter
   (K13) on random data, max relative error 1e-12 (f64) and 1e-5 (f32),
   padded outputs exactly 0, a repeat call bit-identical; the cube gather
   (K8) on the Taylor-Green initial uab (P2, its 27 slots unrolled) and on
   a random P1 pressure vector (8 slots, the loop of any other count),
   equal.  The same cases on two structured grids whose axes differ and
   whose planes are no multiple of a block, a 3D box of 20x27x33 cells and
   a 2D rectangle of 41x57 cells: an axis mixed up in the kernels'
   decomposition of the grid shows there, where a cube would hide it.
   K8's two loops (27 slots unrolled, and the run-time loop) on one input,
   the TGV uab, equal and timed (again at N=64 in phase 3c).  K3 on every
   cube degree (1-3 in 3D; 1, 2, 3 and 7 in 2D) at batch 1-5, with and
   without its multipliers, on grids that take each of its routes; each K3
   line names the route of its launches (point by point, or cube-owned
   with the inputs in registers or in shared memory), and each timed K3
   case the bytes of its product and the rate.  K6 and K7 on the degree
   pairs P2/P1 (block-tiled), P1/P1 and P3/P2 (point by point) in 3D and
   2D, on grids below and above one tile, with random matrices, in float64
   and float32: against the plain version and against the staged plain
   version (the tiled kernels' order of sums), at phase 3's tolerances,
   padding zero, a repeat bit-identical; each line names its route, and
   each K6 and K7 line of the cube kernel cases its route, its tile, shared
   memory and blocks an SM, the bytes of a product and the rate.
   K5 also at batch 1 on the pressure mass Mq_c (the rotational update's
   |rhs|, point by point on the P1 cube).
   The whole solves on the main path's systems: the mass CG (K4) on M_c
   with a random rhs at batch 3 and 1, and at batch 1 on Mq_c (the
   rotational update's solve), the MG pressure CG (K1) on Ap_c with a demeaned
   random rhs and its 3-level MG, the BiCGStab (K2) on the W of the
   Taylor-Green initial state with the mesh's bc rows, at batch 3 and at
   batch 1 (also on the two unequal grids, and at N=64 in 3c); on the two
   unequal grids, which do not coarsen, also K1's non-MG modes, K4 on the
   pressure grid's P1 cube (a P1 mass at batch d, Mq_c at batch 1) and K4
   on a P3 cube of the same cells at batch 2 (a tensor-product P3 mass: the
   point-by-point route, box_solve_cases); K1 MG also on the MG_BOXES
   grids and the MG_CUBES cube (mg_route_cases: 2D, every level below the
   finest on block 0, no level on block 0); x to 1e-10
   relative with equal iteration counts in f64 (rtol 1e-8), to 10 rtol
   with iterations within 1 per row in f32 (rtol 1e-5), and a second
   kernel call bit-identical to the first.  The plain solves loop on the
   host with their operators on the cube kernels' plain versions.  Printed
   for K1 (and in 3c at N=64): its levels; for K2: the bytes of one product (W, the staged per-cube outputs, the
   vectors) and the rate its products moved them at; for K5 (M_c at batch
   d): its tile, shared memory a block, blocks an SM, the bytes a product
   moves and their rate; for K4: its grid barriers an iteration; for each
   timed K1 (non-MG) and K4 case: its route, tile, shared memory a block,
   Chebyshev steps a segment (K1), grid barriers an iteration (from the C
   entry points oasisx_pressure_cg_plan / oasisx_cg_mass_route) and the
   microseconds an iteration; for each K1 MG case its plan (from
   oasisx_pressure_mg_plan, held against la/pressure_mg.py's mirror, as
   phase 2 does for the main path's grids): the fine level's route and
   tile, the levels run by the whole grid, by the sub-group of blocks and
   by block 0 alone, and the barriers of each an iteration.
   `--solves-only` runs only these whole-solve cases, K1 MG at N=64 (the
   N=36 cube matrix scaled by the cell width) and on the MG_GRID_BOXES
   rectangle (every level on the whole grid), the N=36 main path 4, 3e's
   and 4f (with --tree, on the
   other checkout's package: the two trees' K1 and K4 in one call in a few
   minutes a leg, and phase 4's and 4f's steps compared).
4. Main path: the 3D Taylor-Green IPCS solver at N=36 (1,167,051 velocity
   dofs) in float32 on the card, bench settings (dt 2e-3, nu 1/1600, rtol
   1e-5, max_iter 1): 5 warm-up steps, then 25 timed steps with every
   launch counter reset before them.  Velocity finite, every solve
   converged, every kernel launched, no plain version called, no host
   read inside a step (host_syncs 0).  ``run``'s mode is "graph" (on every
   single-device default path): the warm-up captures one step as a CUDA
   graph and the timed steps replay it.  Then the graph leg (``graph_leg``,
   also after 4f, 4d and 4b): from one saved state, 3 windows of 25 steps
   through the per-step loop (``solver._force_eager``) and 25 through
   the graph, in turns: iterations equal at every step, the final state
   bit for bit the loop's (within GRAPH_F32_BOUND where two loop windows
   already differ), launches a step equal, one replay a step, the replays
   under ``torch.cuda.set_sync_debug_mode("error")``; both steps/s, their
   ratio and a profile of 10 graph steps (the device's busy share).
4t. The device while loops (la/device_loop.py: conditional WHILE nodes,
   their condition set by csrc/graph_loop.cu): three loops nested outside
   a solver against the same loops in Python (bit-identical, trips
   printed), a loop of 1,000 trips timed a trip on the device against
   the Python loop a trip (printed), and the condition setter alone, its
   device time a launch from torch.profiler over one replay of that loop
   against one host read of the condition (its kernel line, "replaces"
   null: no Pallas kernel); then graph legs of phase 4's solver at
   max_iter 3, and at max_iter 3 with a max_error that ends some inner loops after 2 (the
   larger of step 1's and the median of 5 steps' diff after 2 from the
   leg's state, so step 1 ends there): every graph_leg check, the inner
   iterations equal at every step.
4u. The vessel at N=36 with the tentative ksp_type gmres (a restart loop
   and its Arnoldi steps, nested device loops, a component at a time on
   K14) and the pressure pc_type jacobi (CG on K14): a graph leg of 3 x 10
   steps a mode.
4v. The N=36 box with the tentative ksp_type cg (batched CG on K3): a
   graph leg of 3 x 10 steps a mode.
5. GPU against CPU: N=6 in float64, 3 steps from the same state on cuda
   and on cpu; u and p agree to 1e-10 relative with equal iteration counts.
3e. K1's non-MG modes at N=35 (bench.py's problem at a grid of odd cell
   count, which does not coarsen: 1,073,733 velocity dofs, 46,656 pressure
   dofs): the Chebyshev(4)-Jacobi mode with the bounds the solver
   estimated at set-up, and the Jacobi mode, against their plain versions
   on a demeaned random rhs, in float64 and float32 (phase 3's solve
   tolerances, a repeat bit-identical, f32 timed, the bound from this
   run's iterations); and phase 3's cube kernel cases at the N=35 shapes.
4f. The N=35 main path in float32 at bench settings: 5 warm-up and 25
   timed steps, phase 4's checks with pressure_cg in place of
   pressure_mg, the pressure method "cheb-pcg", the estimated lmax and its
   validated value.
5d. GPU against CPU in float64, 3 steps: N=5 (Chebyshev mode) and N=6 with
   the pressure pc_type "jacobi" (Jacobi mode).
4g. The N=36 main path with the lumped velocity update (a scalar pc_type
   "lumped"): 5 warm-up and 25 timed steps, phase 4's checks without K4
   (cg_mass), c iterations 0 every step, every u and p exit residual at
   most rtol, and a step's launches: K5 once, K6 twice (B_c and Gw_c), K4
   never.
4i. The N=36 main path with the rotational pressure update
   (``rotational=True``): 5 warm-up and 25 timed steps, phase 4's checks,
   every rotational solve converged with its exit residual at most rtol,
   and a step's launches phase 4's and K5 and K4 once more (K7's output is
   reused for (div u, q)).

Prints the kernels' JSON line (per kernel: "ms", "plain_ms" and
"max_abs_err" of one call at its first case's shape, named in "case", and
every case under "cases"), the nvidia-smi line, and last
{"ok": true, "device": {...}}.  Exits non-zero, with no result line, on
any failure or when there is no card.

3b. ELL kernels: on the vessel-deformed Taylor-Green mesh at N=36 (the
   general path: 389,017 dofs per velocity component, 50,653 pressure
   dofs) K14-K17 against their plain versions, in float64 and float32,
   both timed with CUDA events: K14 on the tentative operator of the
   initial state (batch 3 and batch 1) and on Ap, max relative error 1e-12
   (f64) and 1e-5 (f32); K15 on the tentative system with the mesh's bc
   rows, K16 on M with a random rhs, K17 on Ap with the nullspace and on
   the res=30 DFG cylinder's Ap with its outlet mask, and K17's V-cycle
   alone: x to 1e-10 relative with equal iterations in f64 (rtol 1e-8), to
   10 rtol with iterations within 10% (at least 1) per row in f32 (rtol
   1e-5); every repeat call bit-identical.  K14 is also timed against one
   torch.sparse CSR product of the same operator (the library yardstick).
   Printed per ELL operator: the bytes a float32 K14 product reads of its
   32-row slices' widths, and the share of them that are entries, against
   all K slots; K14's records carry those bytes ("read_bytes"), while the
   bound counts the real nonzeros.  Printed for K17 on the vessel and the
   cylinder: each AMG level's rows, each table's K (and whether K17 reads
   it a warp a row) and width-bounded bytes, and its grid barriers an
   iteration.  K16 also at batch 1 on the vessel's pressure mass Mq (the
   rotational update's solve) and at batch 2 on the mass of a Projector
   of grad(p) into vector P1 on the res=30 cylinder.
4b. The vessel path at N=36 in float32 (dt 2e-3, nu 1/1600, rtol 1e-5,
   max_iter 1, CG velocity update, low_memory_version False): 5 warm-up
   and 25 timed steps, the same checks as phase 4 on the ELL kernels, and
   the device memory before and at its peak in the steps.
4c. The res=30 DFG cylinder with its outlet PressureBC in float32: 5
   steps, every solve converged, the ELL kernels launched.
4c''. A step callback that reads the host (``float(t)``) on the N=6 box:
   ``run``'s capture fails with an error naming it; the next run captures.
5b. GPU against CPU in float64, 3 steps: the vessel at N=6 and the
   cylinder at res=10; equal iterations, u and p to 1e-10 relative.

3c. The structured kernels at the N=64 shapes (6,440,067 velocity dofs,
   the JAX package's size tier: K9, K10, K11 and the per-slot-row W stream
   fold into K2, K3 and K4, and K13 is its scatter): the phase 3 cases and
   tolerances, the float64 cases on the float32 solver's operators cast,
   and K1 on its 5 levels.
4d. The N=64 main path in float32 (bench.py's BENCH_N=64 settings): 5
   warm-up and 25 timed steps, phase 4's checks, K1 on 5 levels, peak
   device memory and set-up time; the TPU-era iterations of
   BENCH_N64_r05.json printed as the reference only.
3d. The band-ELL kernels (K18) at the vessel's N=36 shapes against their
   plain versions in float64 and float32: the product at batch 3 on the
   tentative operator and at batch 1 on Ap, BiCGStab on the tentative
   system and CG on M, at phase 3b's tolerances; beside each case the
   same work by K14/K15/K16 on the flat ELL form and one torch.sparse CSR
   product.  The band operators are pair tables: only the (tile, slot)
   pairs of the JAX package's (S, R, 128) layout that hold an entry are
   stored and read.  Printed per operator: S, R, P, pairs a tile, the
   share of the stored lanes that hold a value, and the bytes a float32
   product reads in the pair layout, in the (S, R, 128) layout, in flat
   ELL and in the real nonzeros.
4e. The vessel path with ell_layout="band", run after 4b with the flat-ELL
   solvers freed, so that each path's device memory is its own: phase 4b's
   run and checks on the band kernels, the iterations within 10% of phase
   4b's; the band solver's own device memory (before the steps, less what
   stays once it is freed).
5c. GPU against CPU in float64 with the band layout: the vessel at N=6.
4h. The vessel at N=36 with the lumped update, BENCH_unstructured_r05.json's
   configuration (AMG-PCG pressure, low_memory_version False): 5 warm-up
   and 25 timed steps, phase 4b's checks without K16 (ell_cg), 4g's lumped
   checks, the per-component u and p iteration means beside that
   capture's TPU-era means (the like-for-like comparison), steps/s and
   device memory.
4j. The vessel at N=36 with the rotational update and a constant body
   force: phase 4b's run and checks, the rotational solves' checks of 4i,
   and a step's launches 4b's and K14 and K16 once more.
4c'. The res=30 cylinder with the DFG 2D-3 inflow U(t) = 1.5 sin(pi t/8) in
   float32: 25 steps of ``run`` with the inflow from ``bc_value_table`` and
   a ``step_callback`` of the kinetic energy and the force on the cylinder
   (-surface_traction, kept on the device: no host read a step), against
   25 ``solve`` calls that re-evaluate the inflow each step (equal to f32
   rounding); the energy after the last step, and Cd and Cl of every step
   (demo/cylinder.py's normalisation) printed.
5e. GPU against CPU in float64, 3 steps each, phase 5's checks and the
   host reads a step printed: the lumped update on both paths, the general
   path's pressure pc_type jacobi and cheb (the cpu solver's bounds handed
   to the cuda one), its tentative ksp_type cg and gmres, and the band
   layout with gmres, on the vessel at N=6 and a 6x6 rectangle sent to the
   general path; each case's run mode "graph" (the option solves' Krylov
   loops are device while loops: no host read a step on cuda).
5f. GPU against CPU in float64, 3 steps each, phase 5's checks (the
   rotational solves' iterations too): the rotational update and a callable
   body force on the N=6 box and the N=6 vessel; then on the res=10
   cylinder's state after 3 steps the Projector of grad(p) with a
   Dirichlet BC (one K16 launch on the card), a LumpedProject, the force
   on the cylinder and assemble_scalar, to 1e-10 relative.
4k. The split-phase API at N=36 in float32 at bench settings: two solvers
   take the same 5 warm-up steps of ``run``; then A takes 10 steps of
   ``run(1, max_iter=1)`` and B 10 split steps (ps = p, the six methods,
   u2 <- u1 <- u, p <- ps).  Every reason 2, each split step's launches
   equal to A's step's (K8, K5, K3, K6, K2, K7, K1 and K4 among them), no
   plain version, and B's u and p within a bound of A's after every step
   (u: 200 rtol (k+1) after step k; p: 1e4 rtol: a sanity bound on two
   paths that start their solves from other guesses; 5g holds the split
   phases at N=36 to 1e-10), each step's differences printed.  Two times
   of each phase a step: the wall between CUDA events around it (the
   host's enqueue and its reads of the reasons included; the median of the
   10 steps), and the device time of its kernels and copies alone, from a
   torch.profiler window around each phase of 3 more split steps (the
   median).
4l. ``oasisx_tpu_torch.demo.vessel`` on demo/meshes/patient_vessel.msh
   (1,813 nodes; inlet 1, wall 2, outlet 3) in float32, 5 steps: finite
   velocities, every solve converged, K14-K17 launched (the general path
   with its outlet mask), no plain version.
4m. ``python -m oasisx_tpu_torch -dt 0.05 -T 0.2 -nu 0.1 --output ...
   --checkpoint ...`` in a subprocess on the card: exit 0, the .pvd, .vtu
   and .npz files, the checkpoint loaded into a new solver equal to the
   file.  The Taylor-Green demo with the reference CI's arguments (-N 8 -N
   16 -N 32 -dt 0.005): in float64 rate_u > 1.7 and rate_p > 1.5, in
   float32 the rates printed.
5g. GPU against CPU in float64: the split sequence for 3 steps on the N=6
   box (standard and rotational) and the res=10 cylinder with its outlet
   (rotational), and for 1 step on the N=36 box (phase 4's width, from its
   initial state): every solve's iterations and reasons equal; _b_first,
   _rhs1, _b2, u, p, dp and ps to 1e-10 relative.  tentative_matrix_dense
   (K3 on identity columns on cuda, its plain version on cpu; the element
   stack on the cylinder) to 1e-12.  A Checkpoint from the cuda solver
   loaded into cuda and cpu solvers that take 2 more steps (phase 5's
   checks), and the cpu solver's loaded back into cuda bit for bit.
5h. GPU against CPU in float64: the structured path's tentative ksp_type
   cg (batched CG on K3's product with identity bc rows, the loop on the
   host) on the N=6 box, 3 steps, phase 5's checks, the u iterations and
   host reads a step printed; config_report says "cg" without K2, and on
   the card K3 launched and K2 not.
4p. ``oasisx_tpu_torch.demo.assembly_strategies`` at the JAX demo's
   defaults (3D, -n 12, degrees 1-4) in float32: "action" and "matvec"
   agree at every degree (asserted by the demo), both timed a degree.
4o. The steady DFG 2D-1 (``demo.cylinder --res 30 --refine-levels 2 --Um
   0.3 -nu 1e-3 -T 2.5``, dt 2e-3: 1250 steps) in float32: Cd at T within
   0.5% of FIDELITY.md's 5.608, its place against the band 5.5779-5.5979
   printed; K14-K17 launched, no plain version.
4n. ``oasisx_tpu_torch.demo.fidelity_tgv``: Taylor-Green Re=1600 on the
   symmetry sub-box at N=32 (823,875 velocity dofs), dt 0.01 to T=10 (1000
   steps), in float32 and in float64: each against the repository's
   float64 curve fidelity_tgv_N32_f64.npz at FIDELITY.md's float32 bar,
   max |dE| at most 2e-4 and the 9-point smoothed peak dissipation within
   0.5%; steps/s, iterations and the worst exit residuals printed; every
   structured kernel launched, no plain version.

4q. The slab path (a ``device_mesh``: slabs of cube planes, a slab a
   rank of a torch.distributed group, spawned by
   ``oasisx_tpu_torch.parallel.launch``) on bench.py's problem at N=36 in
   float32, rtol 1e-5, 2 warm-up and 10 timed steps (SHARD_STEPS): at world 1 (the slab
   code with no neighbours) and over 2 ranks on the one card (gloo, planes
   and sums through the host), and over NCCL at every card where there
   are 2 or more.  Each rank's K3, K5, K6 and K7 per shard against their
   plain versions on random slab vectors (1e-5 relative, halo and padding
   0); every solve converged; each rank's launches of K3, K5, K6, K7 and
   K8 in the timed steps all > 0 and equal across ranks, no plain call;
   every rank's iterations equal.  Printed: steps/s, iterations a step,
   the exchanges, sums and gathers a step, halo_traffic_report's bytes
   per exchange, one sum's and one halo refresh's host time, and the
   card's busy share over 3 more profiled steps.  The state after 12 steps
   against world 1's (5e-4 u, 5e-3 p: the f32 engines' bound), and world
   1's against the single-device path's (relative L2 0.03 u, 0.05 p at
   N=36, 0.05 u, 0.25 p at N=64: about twice the readings; the two paths'
   MGs and tentative x0s differ, each solve to rtol 1e-5).
   ``--slab-only [--slab-n N --slab-world W]`` builds the kernels and runs
   this phase alone (W: world 1 and W ranks; N 36 or 64).
   The world-1 and world-2 gloo groups start at once: their spawns,
   set-ups and warm-ups overlap, and each takes the card alone, one group
   after the other, from its timed steps to its profile (a lock shared by
   the groups), so that no reading is taken while the other group runs.
   ``--slab-gap N [N ...]`` builds the kernels and measures, at each N,
   world 1 against the single-device path in f32 at rtol 1e-5 and f64 at
   rtol 1e-5 and 1e-8, each state's distance from the single-device f64
   rtol 1e-8 one (checks nothing).
5i. GPU against CPU on the slab path: world 2 (gloo), N=6, float64, 3
   steps (the two devices' groups at once): every iteration count equal,
   u and p to 1e-12 relative.
4r. The graph-halo path (``parallel/ranks.py`` ``run_halo``): the vessel
   at N=36 (bench.py's unstructured configuration, float32, rtol 1e-5),
   2 + 10 steps at world 1, at world 2 on the one card (gloo) and over NCCL
   on every card where there are two or more.  Every rank's per-shard K14
   at batch 3 on A_lhs and M and at batch 1 on Ap against its plain version
   between the halo refresh and fold: before the fold on every slot and
   the sentinel exactly 0, after it 1e-5 relative with the halo and
   sentinel slots 0; every solve converged, K14 launched on every rank with
   the same count and no plain call; the state gaps of world 2 against
   world 1 and of world 1 against phase 4b.  In the world-2 group also the
   band layout on the vessel at N=18 (K18 in both spaces, 1 + 3 steps)
   with the same checks.  The gloo groups start at once, as 4q's (each
   run alone on the card from its kernel timings to its profile), and
   each ends with phase 4s's run.  ``--halo-only [--halo-world W]``
   builds the kernels and runs 4r, 4r', 4s and 5j alone.
4r'. In 4r's world-2 group: the DFG cylinder at res=30 with its
   PressureBC(0) outlet and the rotational update, 2 + 6 steps.
5j. GPU against CPU on the graph-halo path: world 2 (gloo), float64, rtol
   1e-12, 3 steps, on the res=10 cylinder (outlet, rotational) and the
   vessel at N=6: every iteration count equal, u and p to 1e-12 relative;
   the card's run against the single-device general path to 1e-8.
4k'. One step of the split-phase API under a device_mesh at N=36 at the
   end of 4q's and 4r's gloo groups (world 1 and 2), after their 2 + 10
   steps of ``run``: bench.py's box on the slab path and its vessel under
   graph-halo, float32, rtol 1e-5.  Every reason 2, each phase's launches
   on every rank the path's (SPLIT_MESH_KERNELS: K8, K5, K3, K6, K7 on the
   slab; K14 under graph-halo), no plain call; the world-2 step's u and ps
   against world 1's (SPLIT_MESH_BOUND); each phase's wall printed.
4s. At the end of each of 4r's groups (one spawn for both phases), the
   replicated mode (``options={"replicated": True}``: a block of
   cells a rank, whole dof vectors, every operator the element product
   and one sum over the ranks, Jacobi-PCG for the pressure, no kernel of
   the package on its path) on the vessel at N=36 (float32, rtol 1e-5), 1
   warm-up and 3 timed steps, at world 1, at world 2 on the one card
   (gloo) and over NCCL on every card where there are two or more.  Every
   solve converged, every rank's iterations and state bits rank 0's, no
   kernel and no plain version; printed: steps/s, iterations a step, the
   sums a step and bytes summed, one sum of a whole velocity component's
   and of one value's host ms, the busy share over 1 profiled step (world
   2 and above).  Each
   world's state against world 1's after the 4 steps (REP_WORLD_BOUND);
   world 1, taken on to 12 steps, against 4r's world-1 graph-halo state
   after its 2 + 10 (REP_HALO_BOUND).
5k. GPU against CPU on every sharded mode: world 2 (gloo), float64, rtol
   1e-12.  The replicated mode 3 steps on the vessel at N=6 and the res=10
   cylinder: every iteration count equal, u and p to 1e-10, every rank's
   state bits rank 0's.  One split step on the slab path (box N=6),
   graph-halo (vessel N=6) and the replicated mode (vessel N=6, cylinder
   res=10): reasons and iterations equal, u and ps to 1e-10, on the card
   each phase's kernels and the dense export's (K3 per slab, K14 per rank)
   launched and no plain version; ``tentative_matrix_dense`` after it
   equal to the cpu export and to the single-device export on the card to
   1e-12.  ``--shard-only`` builds the kernels and runs 4q and 4r (with
   4r' and 4s; without the single-device references), 4k' and 5k.

Every kernel's entry in the JSON line also has "bound_ms" (the least time
the H100 could take for the same work: the bytes of the inputs read once
and the outputs written once over 3.35 TB/s, or the operations over 67
TFLOP/s in float32, whichever is larger, with "bound_by" naming which; for
a solve, the operations of the iterations this run's data took, and an
operator larger than the 50 MB L2 (K2's W, the A_lhs and M of K15, K16
and K18) read once a product, the products from the iterations; each such
operator is printed) and
"library_ms" (one PyTorch call computing the same function: a
torch.sparse CSR product of the assembled operator for the cube operators
(K3's zmask and premul folded in as row and column scaling of the batch's
block-diagonal operator), K14 and K18, one indexing call for K8, one
index_add_ for K13; null for the
solves).  A band case also has "ell_ms": the same product or solve by
K14/K15/K16 on the flat ELL form.

The phases run in the order 3, 4, 4t, 4u, 4v, 4g, 4i, 4k, 5, 3e, 4f, 5d,
3c, 4d, then the vessel phases 3b, 4b, 3d, 4e, 4h, 4j, then 4c, 4c', 5b,
5c, 5e, 5f, 4l, 4m, 5g, 5h, 4p, 4o, 4n, 4q, 4r (with 4r' and 4s), 4k', then
5i, 5j and 5k, whose cuda and cpu rank groups all start at once.
Kernel, plain and library times are device times of back-to-back calls
(``time_ms``).

--tree DIR runs the chip_smoke.py of another checkout DIR (a parent
commit unpacked with ``git archive``) on its own package and kernel build,
with this file's ``time_ms``: two trees' times from one timer.  Each main
path's per-step u / p / c iterations and a hash of its final state go to
build/chip_smoke_steps_tree.json (under --tree) or _this.json (this
checkout); a --tree run that finds _this.json fails unless the iterations
of every step of phases 4, 4g, 4i, 4f, 4d, 4b, 4e, 4h, 4j and 4c equal
those of this checkout's run, and prints whether the final states are
bit-identical;
it compares the phases both trees ran and names those the other tree did
not run.  Run parent, change, change, parent in one call, after removing
both files: the last parent run compares.
--band-setup N only times the host set-up of the band layout of the
vessel's P2 dofmap at N (``build_band_assembly`` on the CPU) and prints
the process's peak resident memory before and after it; with --tree, the
other checkout's.

--profile N adds a torch.profiler window of N more steps after phases 4,
4g, 4i, 4f, 4d, 4b, 4e, 4h and 4j: device time by kernel, the device's busy
share of the window, and Chrome traces under build/chip_smoke_trace*.json.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

TPU_ERA_ITERS = {"u": 0.88, "p": 5.0, "c": 2.2266666666666666}  # BENCH_r05.json
TPU_ERA_ITERS_VESSEL = {"u": 1.33, "p": 14.44}  # BENCH_unstructured_r05.json
TPU_ERA_ITERS_N64 = {"u": 1.12, "p": 5.0, "c": 3.506666666666667}  # BENCH_N64_r05.json
PO = "oasisx_tpu/assembly/pallas_ops.py"
# each kernel's TPU functions, the folded size-tier variants included
REPLACES = {
    "matvec_const": f"{PO}:2019; {PO}:94",  # make_matvec_pf (K5), make_matvec (K12)
    # make_matvec_win (K3), make_matvec_hbm_chan (K10), make_tent_matvec_hbm (+pad_weights :799)
    "matvec_win": f"{PO}:1949; {PO}:1409; {PO}:717",
    "mixed": f"{PO}:1862",  # make_mixed_pf (K6)
    "divergence": f"{PO}:1906",  # make_divergence_pf (K7)
    "cube_gather": f"{PO}:524; {PO}:569",  # make_gather, make_gather_chunked (K8)
    "cube_scatter": f"{PO}:583; {PO}:629",  # make_scatter, make_scatter_chunked (K13)
    "cg_mass": f"{PO}:1770; {PO}:810",  # make_cg_iter_pf (K4), make_cg_step (K11)
    # make_bicgstab_iter (K2), make_bicgstab_hbm_kernels (K9) with bicgstab_hbm_from_r0 :1706
    "bicgstab": f"{PO}:1058; {PO}:1463",
    "pressure_mg": f"{PO}:128",  # make_pressure_cg (K1) with build_pressure_mg_data :404
    "pressure_cg": f"{PO}:128",  # make_pressure_cg (K1) with mg=None
    "ell_matvec": f"{PO}:646; {PO}:682",  # make_ell_matvec, make_ell_matvec_batched (K14)
    "ell_bicgstab": f"{PO}:2083",  # make_ell_bicgstab_iter (K15)
    "ell_cg": f"{PO}:2194",  # make_ell_cg_iter (K16)
    "ell_pcg_amg": f"{PO}:2413; {PO}:2385",  # make_ell_pcg_amg_iter, make_ell_vcycle (K17)
    "band_matvec": f"{PO}:2588",  # make_band_matvec_batched (K18)
    "band_bicgstab": f"{PO}:2613",  # make_band_bicgstab_iter (K18)
    "band_cg": f"{PO}:2683",  # make_band_cg_iter (K18)
}
CSRC = "oasisx_tpu_torch/csrc/"
SOURCE = {name: CSRC + "cube_ops.cu" for name in REPLACES}
SOURCE.update(dict.fromkeys(("cg_mass", "bicgstab", "pressure_mg", "pressure_cg"),
                            CSRC + "krylov_ops.cu"))
SOURCE.update(dict.fromkeys(("ell_matvec", "ell_bicgstab", "ell_cg", "ell_pcg_amg", "band_matvec",
                             "band_bicgstab", "band_cg"), CSRC + "ell_ops.cu"))
SOLVE_RTOL = {"float64": 1e-8, "float32": 1e-5}
DT, NU = 2e-3, 1.0 / 1600.0
N, WARMUP, STEPS = 36, 5, 25  # bench.py's size; steps timed after the warm-up
# phases 4q's and 4r's warm-up and timed steps (5 + 25 before the graph legs
# came; these host-bound sharded phases were cut to keep the full run's margin)
SHARD_STEPS = (2, 10)
GRAPH_WINDOWS = 3  # a graph leg's windows of STEPS steps a mode (eager, graph, in turns)
# a graph leg's bound (relative to the eager state's largest entry) where two
# eager windows from one state already differ: the f32 state's rounding
GRAPH_F32_BOUND = {"u": 1e-5, "p": 1e-3}
N_ODD = 35  # bench.py's problem at a grid that does not coarsen: K1's Chebyshev mode
N64 = 64  # bench.py's BENCH_N=64 tier (BENCH_N64_r05.json), the same settings
BOXES = ((20, 27, 33), (41, 57))  # structured grids whose axes differ (phase 3)
# grids whose axes differ that coarsen: 3, 5 and 2 MG levels; 66x98's
# coarsest (1,700 points) is over block 0's 1,024, so no level runs there
MG_BOXES = ((16, 24, 32), (48, 64), (66, 98))
# a cube whose coarsest is over block 0's: N=44 (3 levels, 12^3 = 1,728 on
# the sub-group)
MG_CUBES = (44,)
# --solves-only: a rectangle whose coarsest (64x129 = 8,256 points) is over
# the sub-group's 8,192, so every level runs on the whole grid (its
# Chebyshev steps too); its coarse bounds' dense eigvalsh takes ~10 s of
# host time, which the full run does not spend
MG_GRID_BOXES = ((126, 256),)
CYL_RES, CYL_STEPS, CYL_DT, CYL_NU = 30, 5, 2e-3, 1e-3  # demo/cylinder.py's settings
CYL_CENTER, CYL_D = (0.2, 0.2), 0.1  # the DFG cylinder (demo/cylinder.py)
DFG3_UM = 1.5  # the DFG 2D-3 inflow's peak: U(t) = 1.5 sin(pi t / 8), mean 1 at its peak
HBM_BYTES_S, F32_FLOP_S = 3.35e12, 67e12  # H100 SXM: HBM3, float32 outside the tensor cores
L2_BYTES = 50e6  # H100 SXM L2: a solve's operator above it is read from HBM once a product
SPIN_CYCLES_S = 2.0e9  # about the H100's SM clock: spin-kernel cycles a second


class SmokeError(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeError(msg)


def bound(nbytes: float, flops: float) -> dict:
    """The least time the H100 could take: bytes over its memory rate or
    operations over its float32 rate, whichever is larger."""
    tb, tf = nbytes / HBM_BYTES_S, flops / F32_FLOP_S
    return {"bound_ms": 1e3 * max(tb, tf), "bound_by": "bytes" if tb >= tf else "operations"}


def operator_bytes(label: str, nbytes: float, products: int) -> float:
    """An operator's bytes in a solve's bound: read once where it fits in
    the L2, once a product (``products``, from the solve's iterations) where
    it does not; the latter is printed."""
    if nbytes <= L2_BYTES:
        return nbytes
    print(f"    bound: {label}, {nbytes / 1e6:.1f} MB > the {L2_BYTES / 1e6:.0f} MB L2, counted "
          f"once a product: {products} products")
    return nbytes * products


# ---------------------------------------------------------------------------
# problems
# ---------------------------------------------------------------------------

def deform_vessel(mesh):
    """Vessel-style deformation of a box mesh (taper, bulge, curved
    centerline), as bench.py's unstructured mode makes it; marks the mesh
    unstructured.  ``parallel.ranks.deform_vessel`` for the ranks; this
    copy imports no package, so that ``--band-setup N --tree DIR`` loads
    only the other checkout's."""
    import numpy as np

    x = mesh.x.copy()
    lo, hi = x[:, 0].min(), x[:, 0].max()
    s = (x[:, 0] - lo) / (hi - lo)
    r = (1.0 - 0.25 * s) * (1.0 + 0.55 * np.exp(-(((s - 0.55) / 0.12) ** 2)))
    x[:, 1] = 0.45 * np.sin(np.pi * s) + 1.0 * r * x[:, 1]
    x[:, 2] = 0.3 * np.sin(np.pi * s * 0.9) + 0.8 * r * x[:, 2]
    mesh.x[:] = x
    mesh.structured = None
    return mesh


def tgv_solver(N, dtype, device, rtol: float, vessel: bool = False, layout: str = "ell",
               pressure: dict | None = None, scalar: dict | None = None,
               tentative: dict | None = None, options: dict | None = None,
               rotational: bool = False, body_force=None):
    """The bench problem (bench.py build_solver) on the port: the box of N
    cells an axis (or of the cells of a tuple N: a 3D box, or a 2D rectangle
    with the 2D Taylor-Green field), or with ``vessel`` the deformed box on
    the general path with bench.py's low_memory_version=False and the
    velocity operators in ``layout`` ("ell" or "band"); ``pressure``,
    ``scalar`` and ``tentative`` add to those solver options (``scalar``
    {"pc_type": "lumped"}: the lumped velocity update), ``options`` to the
    solver's options; ``rotational`` and ``body_force`` go to the solver."""
    import numpy as np

    from oasisx_tpu_torch import DirichletBC, FractionalStep_AB_CN, LocatorMethod
    from oasisx_tpu_torch.meshes import create_box, create_rectangle, meshtags

    cells = (N, N, N) if isinstance(N, int) else tuple(N)
    if len(cells) == 3:
        fs = (
            lambda x: np.sin(np.pi * x[0]) * np.cos(np.pi * x[1]) * np.cos(np.pi * x[2]),
            lambda x: -np.cos(np.pi * x[0]) * np.sin(np.pi * x[1]) * np.cos(np.pi * x[2]),
            lambda x: np.zeros_like(x[0]),
        )
        mesh = create_box((-1.0, -1.0, -1.0), (1.0, 1.0, 1.0), cells)
    else:
        fs = (lambda x: -np.cos(np.pi * x[0]) * np.sin(np.pi * x[1]),
              lambda x: np.sin(np.pi * x[0]) * np.cos(np.pi * x[1]))
        mesh = create_rectangle((-1.0, -1.0), (1.0, 1.0), cells)
    if vessel:
        deform_vessel(mesh)
    facets = mesh.exterior_facet_indices()
    tags = meshtags(mesh, mesh.dim - 1, facets, np.full_like(facets, 1))
    bcs_u = [[DirichletBC(f, LocatorMethod.TOPOLOGICAL, (tags, 1))] for f in fs]
    opts = {"ksp_rtol": rtol, "ksp_max_it": 2000}
    solver = FractionalStep_AB_CN(
        mesh, ("Lagrange", 2), ("Lagrange", 1), bcs_u=bcs_u, bcs_p=[],
        solver_options={"tentative": dict(opts, **(tentative or {})),
                        "pressure": dict(opts, **(pressure or {})),
                        "scalar": dict(opts, **(scalar or {}))},
        options=dict({"low_memory_version": False, "ell_layout": layout} if vessel else {},
                     **(options or {})),
        rotational=rotational, body_force=body_force, dtype=dtype, device=device,
    )
    for f, u1, u2 in zip(fs, solver._u1, solver._u2):
        u1.interpolate(f)
        u2.interpolate(f)
    return solver


def cylinder_facets(mesh):
    """demo/cylinder.py's cylinder facets: the exterior facets within 0.9 D
    of the cylinder's centre."""
    import numpy as np

    ext = mesh.exterior_facet_indices()
    mid = mesh.x[mesh.topology.facets[ext]].mean(axis=1)
    return ext[np.linalg.norm(mid - np.asarray(CYL_CENTER), axis=1) < 0.9 * CYL_D]


def cylinder_solver(res: int, dtype, device, rtol: float, um=lambda: 0.3,
                    rotational: bool = False):
    """The DFG cylinder channel with a parabolic inflow, no-slip walls and
    cylinder, and a PressureBC(0) outlet (``parallel.ranks.cylinder_solver``,
    tests/test_ell_wiring.py's set-up); the inflow's peak ``um()`` (default
    0.3, as demo/cylinder.py), read each time the boundary values are
    evaluated; ``rotational`` goes to the solver."""
    from oasisx_tpu_torch.parallel.ranks import cylinder_solver as build

    return build(res, dtype, device, rtol, um=um, rotational=rotational)


def _sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def time_ms(fn, device, reps: int = 20, warmup: int = 3) -> float:
    """Mean time per call: CUDA events on the card, the host clock on CPU.

    On the card the device time of back-to-back calls: a spin kernel
    (``torch.cuda._sleep``) holds the stream while the host enqueues the
    calls, sized from the host time of one call (at most 50 ms), so a call
    shorter than its own Python and launch overhead is not timed as that
    overhead.  Where the spin ended before the host had enqueued every call
    (the device may then have waited for the host between calls), the
    reading is taken once more behind a spin four times as long, and a
    reading that this lowers by more than 10% is printed with the first.  A
    call that waits on the device inside (a plain solve's host loop) is
    timed with its waits."""
    import torch

    for _ in range(warmup):
        fn()
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        host_s = time.perf_counter() - t
        spin_s = min(1.5 * reps * host_s + 1e-4, 0.05)
        first = None
        while True:
            torch.cuda.synchronize()
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(int(SPIN_CYCLES_S * spin_s))
            t0.record()
            for _ in range(reps):
                fn()
            caught_up = t0.query()  # the spin has ended: the device may have waited
            t1.record()
            torch.cuda.synchronize()
            ms = t0.elapsed_time(t1) / reps
            if first is not None:
                if ms < 0.9 * first:
                    print(f"    [timer] {first:.4f} ms a call behind a {spin_s / 4 * 1e3:.2f} ms "
                          f"spin that ended before the host had enqueued {reps} calls; "
                          f"{ms:.4f} ms behind a {spin_s * 1e3:.2f} ms spin")
                return ms
            if not caught_up or spin_s >= 0.05:
                return ms
            first, spin_s = ms, 4 * spin_s
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t) * 1e3 / reps


# ---------------------------------------------------------------------------
# library yardsticks: one torch.sparse product of the assembled operator
# ---------------------------------------------------------------------------


def _csr(rows, cols, vals, shape):
    import torch

    coo = torch.sparse_coo_tensor(torch.stack([rows, cols]), vals, shape).coalesce()
    return coo.to_sparse_csr()


def cube_index(sm, device):
    """(nl, ncubes) grid index of every cube slot (the cube gather of an
    index vector)."""
    import numpy as np
    import torch

    from oasisx_tpu_torch.assembly import cubes as cub

    ar = torch.arange(int(np.prod(sm[0])), dtype=torch.float64, device=device)
    return cub.cube_gather(ar, sm).round().long()


def cube_csr(idx_out, idx_in, vals, n_out, n_in, row_off=0, col_off=0):
    """CSR of sum_c P_c^T V_c P_c with per-cube values vals (nl_out, nl_in,
    ncubes) (or (nl_out, nl_in), one matrix for every cube)."""
    nlo, nc = idx_out.shape
    nli = idx_in.shape[0]
    rows = (idx_out[:, None, :] + row_off).expand(nlo, nli, nc)
    cols = (idx_in[None, :, :] + col_off).expand(nlo, nli, nc)
    v = vals if vals.dim() == 3 else vals[:, :, None].expand(nlo, nli, nc)
    return rows.reshape(-1), cols.reshape(-1), v.reshape(-1), (n_out, n_in)


def ell_csr(vals, cols):
    """CSR of an ELL operator (K, n) from its stored non-zero slots."""
    import torch

    V, C = vals.T, cols.T.long()
    m = V != 0
    crow = torch.zeros(V.shape[0] + 1, dtype=torch.long, device=V.device)
    crow[1:] = torch.cumsum(m.sum(dim=1), 0)
    return torch.sparse_csr_tensor(crow, C[m], V[m], (V.shape[0], V.shape[0]))


def width_slots(widths, n: int) -> float:
    """Slots a width-bounded product of an ELL table of n rows reads: each
    row its 32-row slice's width."""
    import numpy as np

    from oasisx_tpu_torch.parallel.graph import ELL_SLICE

    w = widths.cpu().numpy().astype(np.int64)
    rows = np.full(w.shape, ELL_SLICE, dtype=np.int64)
    rows[-1] = n - ELL_SLICE * (len(w) - 1)
    return float((w * rows).sum())


def ell_read(asm, isz: int) -> tuple[float, float]:
    """(bytes, fill) of one K14 product's operator read: each row reads its
    32-row slice's width of values and columns (and the slice's width), and
    the share of the slots read that hold an entry."""
    slots = width_slots(asm.widths, asm.n)
    return (isz + 4) * slots + 4 * len(asm.widths), asm.nnz / slots


def amg_report(label: str, solver, isz: int = 4) -> None:
    """K17's AMG levels: rows, each table's K (marked where K17 reads it a
    warp a row, from the kernel's own kWarpRowK) and the bytes a float32
    product reads of its slices' widths against all K slots; and its grid
    barriers an iteration."""
    from oasisx_tpu_torch._build import library
    from oasisx_tpu_torch.la import ell

    meta = solver._amg_data[0]
    warp_k = library().oasisx_ell_warp_row_k()
    for i, m in enumerate(meta["levels"]):
        parts = []
        for j, (key, K, rows) in enumerate((("A", m["K_A"], m["n"]), ("P", m["K_P"], m["n"]),
                                            ("R", m["K_R"], m["nc"]))):
            w = solver._amg_widths[3 * i + j]
            read = (isz + 4) * width_slots(w, rows) + 4 * len(w)
            warp = " (a warp a row)" if K >= warp_k else ""
            parts.append(f"{key} K {K}{warp}: {read / 1e6:.3f} MB of "
                         f"{(isz + 4) * K * rows / 1e6:.3f}")
        print(f"  K17 {label} level {i}: {m['n']} rows; " + "; ".join(parts) + " MB")
    cn = meta["coarse_n"]
    print(f"  K17 {label} level {len(meta['levels'])}: {cn} rows, dense "
          f"{isz * cn * cn / 1e6:.3f} MB; grid barriers an iteration (pre {meta['pre']}, post "
          f"{meta['post']}): {ell.amg_barriers(meta)}")


# ---------------------------------------------------------------------------
# phase 3: the structured path's kernels
# ---------------------------------------------------------------------------


def weighted_gradient_cube(solver, device):
    """The lumped update's cube matrix Gw_c (d, nl_v, nl_q) at the solver's
    grid, in float64: the solver's own under the lumped update, else built
    from its mesh (``cubes.build_cube_ops`` with the Q basis's gradients at
    the V nodes)."""
    import torch

    from oasisx_tpu_torch.assembly import cubes as cub

    if solver._cu.Gw_c is not None:
        return solver._cu.Gw_c.to(device, torch.float64)
    gtab = solver._Q.element.tabulate(solver._Vi[0][0].element.nodes)[1]
    return cub.build_cube_ops(solver._mesh, solver._refs, solver._sm_v, solver._sm_q,
                              dtype=torch.float64, device=device, gtab=gtab).Gw_c


def kernel_cases(solver, dtype, device, seed: int = 0, library: bool = False, gw=None):
    """(kernel, label, kernel call, plain call, padded-output mask, (bytes,
    operations), library call or None) at the solver's shapes, on random
    inputs made from ``seed``, the solver's operators cast to ``dtype``;
    ``gw`` the lumped update's Gw_c (built here when not given)."""
    import numpy as np
    import torch

    from oasisx_tpu_torch.assembly import cubes as cub
    from oasisx_tpu_torch.assembly import kernels as kn

    cu, sm_v, sm_q = solver._cu, solver._sm_v, solver._sm_q
    d = solver._mesh.dim
    g = torch.Generator().manual_seed(seed)
    rnd = lambda *shape: torch.randn(*shape, generator=g, dtype=torch.float64).to(device, dtype)
    valid_v = (solver._pv(torch.ones(solver._gf_v.shape[0], device=device)) != 0)
    valid_q = (solver._pq(torch.ones(solver._gf_q.shape[0], device=device)) != 0)
    c = lambda t: t.to(device, dtype).contiguous()
    xv = rnd(d, solver._npad_v) * valid_v
    xq = rnd(solver._npad_q) * valid_q
    nl, nlq = cub.num_slots(sm_v), cub.num_slots(sm_q)
    nc, ncq = int(np.prod(sm_v[1])), int(np.prod(sm_q[1]))
    nv, nq = solver._npad_v, solver._npad_q
    W = rnd(nl * nl, nc)
    M_c, Ap_c, B_c, G_c, Mq_c = c(cu.M_c), c(cu.Ap_c), c(cu.B_c), c(cu.G_c), c(cu.Mq_c)
    Gw_c = c(weighted_gradient_cube(solver, device) if gw is None else gw)
    st = solver._state_from_functions()
    uab = c(1.5 * st["u1"] - 0.5 * st["u2"])
    all_valid = torch.ones(d, nl, nc, dtype=torch.bool, device=device)
    isz = torch.empty((), dtype=dtype).element_size()
    pm = rnd(d, nv) * valid_v
    zm = solver._zmask.to(dtype)
    U = rnd(d, nl, nc)
    lib = dict.fromkeys(("gather", "gather_q", "M", "Ap", "Mq", "W", "W1", "Wz", "Wpz", "B", "G",
                         "Gw", "div", "scatter"))
    if library:
        iv, iq = cube_index(sm_v, device), cube_index(sm_q, device)
        xt = xv.T.contiguous()
        A_M = _csr(*cube_csr(iv, iv, M_c, nv, nv))
        A_Ap = _csr(*cube_csr(iq, iq, Ap_c, nq, nq))
        A_Mq = _csr(*cube_csr(iq, iq, Mq_c, nq, nq))
        A_W = _csr(*cube_csr(iv, iv, W.reshape(nl, nl, nc), nv, nv))
        stack = lambda parts, shape: _csr(*(torch.cat(t) for t in zip(*[q[:3] for q in parts])),
                                          shape)
        mixed = lambda C: stack([cube_csr(iv, iq, C[k], nv, nq, row_off=k * nv)
                                 for k in range(d)], (d * nv, nq))
        A_B, A_G, A_Gw = mixed(B_c), mixed(G_c), mixed(Gw_c)
        A_div = stack([cube_csr(iq, iv, B_c[k].T, nq, nv, col_off=k * nv) for k in range(d)],
                      (nq, d * nv))
        # K3 with its multipliers: the block-diagonal operator of the batch,
        # zmask folded in as row scaling and premul as column scaling
        r0, c0, w0, _ = cube_csr(iv, iv, W.reshape(nl, nl, nc), nv, nv)
        folded = lambda zm_, pm_: _csr(
            torch.cat([r0 + k * nv for k in range(d)]), torch.cat([c0 + k * nv for k in range(d)]),
            torch.cat([w0 * zm_[k][r0] * (1.0 if pm_ is None else pm_[k][c0]) for k in range(d)]),
            (d * nv, d * nv))
        A_Wz, A_Wpz = folded(zm, None), folded(zm, pm)
        uflat = xv.reshape(-1)
        ivf, Uf = iv.reshape(-1), U.reshape(d, -1)
        x1 = xv[0].contiguous()
        lib = dict(gather=lambda: uab[:, iv], gather_q=lambda: xq[None][:, iq],
                   M=lambda: A_M @ xt, Ap=lambda: A_Ap @ xq, Mq=lambda: A_Mq @ xq,
                   W=lambda: A_W @ xt, W1=lambda: A_W @ x1, Wz=lambda: A_Wz @ uflat,
                   Wpz=lambda: A_Wpz @ uflat, B=lambda: A_B @ xq,
                   G=lambda: A_G @ xq, Gw=lambda: A_Gw @ xq,
                   div=lambda: A_div @ uflat,
                   scatter=lambda: torch.zeros_like(xv).index_add_(1, ivf, Uf))
    mv = lambda nlo, nli, B: 2.0 * nlo * nli * nc * B  # cube matvec operations
    return [
        ("cube_gather", "TGV uab",
         lambda: kn.cube_gather(uab, sm_v), lambda: kn.cube_gather_plain(uab, sm_v), all_valid,
         (isz * d * (nv + nl * nc), 0.0), lib["gather"]),
        ("cube_gather", "P1 p",
         lambda: kn.cube_gather(xq[None], sm_q), lambda: kn.cube_gather_plain(xq[None], sm_q),
         torch.ones(1, nlq, ncq, dtype=torch.bool, device=device),
         (isz * (nq + nlq * ncq), 0.0), lib["gather_q"]),
        ("matvec_const", "M_c batch 3",
         lambda: kn.matvec_const(xv, M_c, sm_v), lambda: kn.matvec_const_plain(xv, M_c, sm_v),
         valid_v, (isz * 2 * d * nv, mv(nl, nl, d)), lib["M"]),
        ("matvec_const", "Ap_c batch 1",
         lambda: kn.matvec_const(xq[None], Ap_c, sm_q),
         lambda: kn.matvec_const_plain(xq[None], Ap_c, sm_q), valid_q,
         (isz * 2 * nq, mv(nlq, nlq, 1)), lib["Ap"]),
        ("matvec_const", "Mq_c batch 1",  # the rotational update's |rhs| (fracstep)
         lambda: kn.matvec_const(xq[None], Mq_c, sm_q),
         lambda: kn.matvec_const_plain(xq[None], Mq_c, sm_q), valid_q,
         (isz * 2 * nq, mv(nlq, nlq, 1)), lib["Mq"]),
        ("matvec_win", "W batch 3",
         lambda: kn.matvec_win(W, xv, sm_v), lambda: kn.matvec_win_plain(W, xv, sm_v), valid_v,
         (isz * (nl * nl * nc + 2 * d * nv), mv(nl, nl, d)), lib["W"]),
        ("matvec_win", "W premul zmask",
         lambda: kn.matvec_win(W, xv, sm_v, premul=pm, zmask=zm),
         lambda: kn.matvec_win_plain(W, xv, sm_v, premul=pm, zmask=zm), valid_v,
         (isz * (nl * nl * nc + 4 * d * nv), mv(nl, nl, d) + 2.0 * d * nv), lib["Wpz"]),
        ("matvec_win", "W batch 1",
         lambda: kn.matvec_win(W, xv[:1], sm_v), lambda: kn.matvec_win_plain(W, xv[:1], sm_v),
         valid_v, (isz * (nl * nl * nc + 2 * nv), mv(nl, nl, 1)), lib["W1"]),
        ("matvec_win", "W zmask batch 3",  # the tentative solve's r0 (fracstep)
         lambda: kn.matvec_win(W, xv, sm_v, zmask=zm),
         lambda: kn.matvec_win_plain(W, xv, sm_v, zmask=zm), valid_v,
         (isz * (nl * nl * nc + 3 * d * nv), mv(nl, nl, d) + 1.0 * d * nv), lib["Wz"]),
        ("mixed", "B_c",
         lambda: kn.mixed(xq, B_c, sm_v, sm_q), lambda: kn.mixed_plain(xq, B_c, sm_v, sm_q),
         valid_v, (isz * (nq + d * nv), mv(nl, nlq, d)), lib["B"]),
        ("mixed", "G_c",
         lambda: kn.mixed(xq, G_c, sm_v, sm_q), lambda: kn.mixed_plain(xq, G_c, sm_v, sm_q),
         valid_v, (isz * (nq + d * nv), mv(nl, nlq, d)), lib["G"]),
        ("mixed", "Gw_c",  # the lumped update's weighted nodal gradient (fracstep)
         lambda: kn.mixed(xq, Gw_c, sm_v, sm_q), lambda: kn.mixed_plain(xq, Gw_c, sm_v, sm_q),
         valid_v, (isz * (nq + d * nv), mv(nl, nlq, d)), lib["Gw"]),
        ("divergence", "B_c",
         lambda: kn.divergence(xv, B_c, sm_v, sm_q),
         lambda: kn.divergence_plain(xv, B_c, sm_v, sm_q), valid_q,
         (isz * (d * nv + nq), mv(nl, nlq, d)), lib["div"]),
        ("cube_scatter", "U batch 3",
         lambda: kn.cube_scatter(U, sm_v), lambda: kn.cube_scatter_plain(U, sm_v), valid_v,
         (isz * d * (nl * nc + nv), float(d * nl * nc)), lib["scatter"]),
    ]


def _timed(name, label, kfn, pfn, device, err, work, lib, reps=20, preps=20, extra=None):
    """One f32 case's record: kernel and plain times (plain, kernel, kernel,
    plain), the bound and the library call's time."""
    p1 = time_ms(pfn, device, reps=preps, warmup=1 if preps < 20 else 3)
    k1 = time_ms(kfn, device, reps=reps)
    k2 = time_ms(kfn, device, reps=reps)
    p2 = time_ms(pfn, device, reps=preps, warmup=1 if preps < 20 else 3)
    lib_ms = None if lib is None else min(time_ms(lib, device), time_ms(lib, device))
    rec = {"case": label, "max_abs_err": err, "ms": min(k1, k2), "plain_ms": min(p1, p2),
           **bound(*work), "library_ms": lib_ms, **(extra or {})}
    others = "".join(f", {k} {v:.4f}" for k, v in (extra or {}).items() if k.endswith("_ms"))
    print(f"    {label}: kernel {k1:.4f} / {k2:.4f} ms, plain {p1:.4f} / {p2:.4f} ms, "
          f"bound {rec['bound_ms']:.4f} ms ({rec['bound_by']}), library "
          f"{'-' if lib_ms is None else f'{lib_ms:.4f} ms'}{others}")
    return rec


def compare_kernels(solver, device, tag: str = "") -> dict:
    """Phases 3 and 3c: every cube kernel against its plain version in f64
    and f32 (the solver's operators cast), a repeat call bit-identical.

    Returns, per kernel, a list of its cases in float32, each with its own
    max abs error, its time per call (kernel, plain version and library
    call) and its bound at that one shape; ``tag`` ends each case's label."""
    import torch

    tols = {torch.float64: 1e-12, torch.float32: 1e-5}
    out: dict = {}
    gw = weighted_gradient_cube(solver, device)
    for dtype, tol in tols.items():
        timed = dtype == torch.float32 and torch.device(device).type == "cuda"
        for name, label, kfn, pfn, valid, work, lib in kernel_cases(
                solver, dtype, device, library=timed, gw=gw):
            label += tag
            yk = kfn()
            yk2 = kfn()
            yp = pfn()
            _sync(device)
            scale = float(yp.abs().max())
            err = float((yk - yp).abs().max())
            rel = err / max(scale, 1e-300)
            pad_zero = bool((yk[..., ~valid] == 0).all())
            same = bool(torch.equal(yk, yk2))
            dt = str(dtype).replace("torch.", "")
            route = ""
            if name == "matvec_win" and torch.device(device).type == "cuda":
                batch, pm, _ = win_case(label, solver)
                route = ", route " + win_route(solver._sm_v, batch, pm, dtype)["name"]
            if name in ("mixed", "divergence") and torch.device(device).type == "cuda":
                route = ", route " + mixed_route(solver._sm_v, solver._sm_q,
                                                 name == "divergence", dtype)["name"]
            print(f"  {name:13s} {label:20s} {dt}: max abs err {err:.3e}, rel {rel:.3e}"
                  f" (tol {tol:g}), padding zero: {pad_zero}, repeat bit-identical: {same}{route}")
            check(rel <= tol, f"{name} ({label}, {dt}) disagrees: rel err {rel:.3e}")
            check(pad_zero, f"{name} ({label}, {dt}) wrote non-zero padding")
            check(same, f"{name} ({label}, {dt}): a second kernel call differs from the first")
            if dtype != torch.float32:
                continue
            out.setdefault(name, []).append(_timed(name, label, kfn, pfn, device, err, work, lib))
            if label.startswith("M_c") and torch.device(device).type == "cuda":
                k5_report(solver, dtype, out[name][-1])
            if name == "matvec_win" and torch.device(device).type == "cuda":
                win_report(solver, dtype, out[name][-1], label)
            if name in ("mixed", "divergence") and label.startswith(("B_c", "Gw_c")) and \
                    torch.device(device).type == "cuda":
                mixed_report(solver, dtype, out[name][-1], name == "divergence")
    return out


def gather_loops(solver, tag: str = "") -> None:
    """K8's two instantiations on one input, the solver's TGV uab (27 slots
    a cube in 3D P2): the unrolled slot loop of the main path and the
    run-time loop that every other slot count takes; equal outputs, device
    times of both (unrolled, loop, loop, unrolled)."""
    import torch

    from oasisx_tpu_torch import _build
    from oasisx_tpu_torch.assembly import kernels as kn

    st = solver._state_from_functions()
    uab = (1.5 * st["u1"] - 0.5 * st["u2"]).contiguous()
    sm = solver._sm_v
    u = torch.empty_like(kn.cube_gather(uab, sm))
    lib = _build.library()

    def loop():
        err = lib.oasisx_cube_gather_loop(kn._ptr(uab), kn._ptr(u), int(uab.dtype == torch.float64),
                                          *kn._dims(sm), int(sm[2]), int(uab.shape[0]),
                                          kn._stream(uab))
        check(err == 0, f"K8's run-time loop failed to launch: CUDA error {err}")
        return u

    check(torch.equal(loop(), kn.cube_gather(uab, sm)), f"K8's two loops differ{tag}")
    unrolled = lambda: kn.cube_gather(uab, sm)
    t = [time_ms(unrolled, "cuda"), time_ms(loop, "cuda"), time_ms(loop, "cuda"),
         time_ms(unrolled, "cuda")]
    print(f"  cube_gather   TGV uab{tag}: {u.shape[1]} slots unrolled {t[0]:.4f} / {t[3]:.4f} ms, "
          f"run-time loop {t[1]:.4f} / {t[2]:.4f} ms, outputs equal")


def solve_cases(solver, device, seed: int = 1, dtype=None):
    """(kernel, label, kernel solve, plain solve, work(result) -> (bytes,
    operations)) on the structured path's systems of ``solver``, in its
    dtype or in ``dtype`` with its operators cast, each solve returning a
    KrylovResult."""
    import numpy as np
    import torch

    from oasisx_tpu_torch import _build
    from oasisx_tpu_torch.assembly import cubes as cub
    from oasisx_tpu_torch.assembly import kernels as kn
    from oasisx_tpu_torch.la import fused

    dtype = dtype or solver._dtype
    rtol = SOLVE_RTOL[str(dtype).replace("torch.", "")]
    c = lambda t: t.to(dtype)
    cu, sm_v, sm_q = solver._cu, solver._sm_v, solver._sm_q
    M_c, Ap_c = c(cu.M_c), c(cu.Ap_c)
    d, maxiter = solver._mesh.dim, 2000
    g = torch.Generator().manual_seed(seed)
    rnd = lambda *shape: torch.randn(*shape, generator=g, dtype=torch.float64).to(device, dtype)
    valid_v = (solver._pv(torch.ones(solver._gf_v.shape[0], device=device)) != 0)
    isz = torch.empty((), dtype=dtype).element_size()
    nv, nq = solver._npad_v, solver._npad_q
    nl, nlq = cub.num_slots(sm_v), cub.num_slots(sm_q)
    nc = int(np.prod(sm_v[1]))

    # K4: M x = b, x0 = 0 (so r0 = b)
    b = rnd(d, nv) * valid_v
    x0 = torch.zeros_like(b)
    bn = torch.linalg.vector_norm(b, dim=-1)
    mass = lambda v: kn.matvec_const_plain(v, M_c, sm_v)
    M_invd = c(solver._M_invd)
    b1, x01, bn1 = b[1:2], x0[1:2], bn[1:2]
    p1 = p1_mass_cases(solver, dtype, device, rnd, rtol, maxiter)

    # K1: Ap x = b - mean(b), x0 = 0, the solver's MG hierarchy
    mg = mg_case(sm_q, cu.Ap_c, solver._Ap_diag, dtype, device, rnd, rtol, maxiter)

    rows = lambda res: float(res.iters.sum())
    if torch.device(device).type == "cuda" and has_routes():
        print(f"  cg_mass       grid barriers an iteration: "
              f"{_build.library().oasisx_cg_mass_barriers(2)} on the P2 cube, "
              f"{_build.library().oasisx_cg_mass_barriers(1)} on the P1 cube (the product's pAp, "
              "the update's rz and |r|^2)")

    def mass_work(B):
        return lambda res: (mass_bytes(isz, B, nv, int(res.iters.max())),
                            rows(res) * (2.0 * nl * nl * nc + 10 * nv))

    route = lambda sm, B: mass_route_extra(device, len(sm[1]), int(sm[2]), B, dtype)
    return rtol, [
        ("cg_mass", "M_c, random rhs",
         lambda: fused.cg_mass(M_c, b, x0, M_invd, bn, sm_v, rtol, maxiter),
         lambda: fused.cg_from_r0(mass, b, x0, M_invd, bn, rtol, maxiter), mass_work(d),
         *route(sm_v, d)),
        ("cg_mass", "M_c batch 1",
         lambda: fused.cg_mass(M_c, b1, x01, M_invd, bn1, sm_v, rtol, maxiter),
         lambda: fused.cg_from_r0(mass, b1, x01, M_invd, bn1, rtol, maxiter), mass_work(1),
         *route(sm_v, 1)),
        *p1,
        mg,
    ] + bicgstab_cases(solver, dtype)[1]


def mg_levels(cells) -> int:
    """The levels of ``kernels.build_pressure_mg_data`` on a grid of
    ``cells``: halved while every axis is even and its half at least 3."""
    cells, L = list(cells), 1
    while all(c % 2 == 0 and c // 2 >= 3 for c in cells):
        cells, L = [c // 2 for c in cells], L + 1
    return L


# set by run_tree: the package loaded is another checkout's, whose kernels
# may not report K1 MG's plan (mg_case then records none)
OTHER_TREE = False


MG_ROUTES = ("stencil tile (P1), the coarsest levels on block 0",
             "stencil tile (P1), no level on block 0")


def mg_plan(cells, dtype, nsmooth: int = 2, degree: int = 14) -> dict:
    """K1 MG's plan on this card for the MG levels of a grid of ``cells``
    (``oasisx_pressure_mg_plan``): the fine level's route, its tile (3D
    form), shared memory a block, the levels of each team (the whole grid,
    the sub-group of blocks, block 0) and the barriers of each an
    iteration; held against the plain mirror (``la/pressure_mg.py``
    ``mg_teams``, ``barriers``), which is given the plan's block level: it
    does not model the step that moves block 0 to a coarser level (or to
    none) where shared memory is short, but checks that the plan's is no
    finer than its own and the rest from there."""
    import numpy as np
    import torch

    from oasisx_tpu_torch import _build
    from oasisx_tpu_torch.assembly import kernels as kn
    from oasisx_tpu_torch.la import pressure_mg as pm

    cells = tuple(int(c) for c in cells)
    L = mg_levels(cells)
    out = torch.zeros(11, dtype=torch.int32)
    err = _build.library().oasisx_pressure_mg_plan(
        int(dtype == torch.float64), len(cells), *cells, *(0,) * (3 - len(cells)), L, nsmooth,
        degree, kn._ptr(out))
    check(err == 0, f"no K1 MG plan for {cells} {dtype}: CUDA error {err}")
    o = out.tolist()
    sizes = [int(np.prod([c // 2 ** l + 1 for c in cells])) for l in range(L)]
    teams, bars = tuple(o[5:8]), tuple(o[8:11])
    want = pm.mg_teams(sizes, block_from=teams[1])
    want_bars = pm.barriers(L, want[0], want[1], nsmooth, degree)
    check(teams == want and bars == want_bars and o[0] == (0 if teams[1] < L else 1),
          f"K1 MG's plan for {cells} {dtype}: route {o[0]} teams {teams} barriers {bars}, its "
          f"plain mirror {want} {want_bars}")
    lsub, lblk = teams[0], teams[1]
    moved = lblk != pm.mg_teams(sizes)[1]
    return {"route": MG_ROUTES[o[0]] + (" (shared memory moved block 0 coarser)" if moved else ""),
            "tile": tuple(o[1:4]), "smem": o[4], "sizes": sizes,
            "levels": {"grid": list(range(lsub)), "sub-group": list(range(lsub, lblk)),
                       "block": list(range(lblk, L))},
            "sub_blocks": teams[2],
            "barriers": f"{bars[0]} grid, {bars[1]} sub-group, {bars[2]} block"}


MG_PLAN_GRIDS = ((36, 36, 36), (64, 64, 64), (256, 256), *MG_BOXES, *MG_GRID_BOXES,
                 *((n,) * 3 for n in MG_CUBES))


def check_mg_plans() -> None:
    """Phase 2: K1 MG's plan on this card for the grids of MG_PLAN_GRIDS in
    both types, each against its plain mirror (mg_plan)."""
    import torch

    for cells in MG_PLAN_GRIDS:
        for dtype in (torch.float32, torch.float64):
            r = mg_plan(cells, dtype)
            print(f"[2] K1 MG plan {'x'.join(map(str, cells))} {str(dtype)[6:]}: levels of "
                  f"{r['sizes']} points; route {r['route']}, tile {r['tile']}, {r['smem']} bytes "
                  f"of shared memory a block; levels by team {r['levels']} (the sub-group "
                  f"{r['sub_blocks']} blocks); barriers an iteration {r['barriers']}; its "
                  "mirror agrees")


_MG_DATA: dict = {}  # mg_case's last MG hierarchy (its coarse bounds take a dense eigvalsh)


def mg_case(sm_q, Ap_c, Ap_diag, dtype, device, rnd, rtol: float, maxiter: int, label: str = ""):
    """solve_cases' K1 MG case on the pressure grid ``sm_q`` with cube
    matrix ``Ap_c`` and diagonal ``Ap_diag``, in ``dtype``: Ap x = b -
    mean(b) from a random ``rnd`` rhs, x0 = 0, the grid's MG hierarchy; on
    the card with its plan (mg_plan) as the case's extra record."""
    import numpy as np
    import torch

    from oasisx_tpu_torch.assembly import cubes as cub
    from oasisx_tpu_torch.assembly import kernels as kn
    from oasisx_tpu_torch.la.pressure_mg import PressureMGCG

    Ap64 = Ap_c.detach().cpu().double().numpy()
    diag = Ap_diag.detach().cpu().double().numpy()
    invd = np.where(diag != 0, 1.0 / np.where(diag != 0, diag, 1.0), 1.0)
    key = (tuple(sm_q[1]), Ap64.tobytes())  # one hierarchy for both types
    if key not in _MG_DATA:
        _MG_DATA.clear()
        _MG_DATA[key] = kn.build_pressure_mg_data(sm_q, Ap64)
    pcg = PressureMGCG(sm_q, Ap_c.to(dtype), invd, _MG_DATA[key], rtol, maxiter)
    nq, nlq = int(np.prod(sm_q[0])), cub.num_slots(sm_q)
    isz = torch.empty((), dtype=dtype).element_size()
    L = len(pcg.levels)
    print(f"  pressure_mg   {L} levels of {[int(np.prod(lv['grid'])) for lv in pcg.levels]} points "
          f"({dtype}){label}")
    bq = rnd(nq)
    bq = bq - bq.mean()
    xq = torch.zeros_like(bq)

    def mg_work(res):
        # operator applications: the fine Ap per iteration, and per V-cycle
        # 2 nsmooth on each level above the coarsest and degree-1 there; a
        # product's operations: the P1 stencil's 3^d fmas a point of its
        # level, fewer than the cube form's (2^d)^2 a cube
        k = int(res.iters)
        lv = [2.0 * 3 ** len(sm_q[1]) * int(np.prod(L["grid"])) for L in pcg.levels]
        vflops = sum(2 * pcg.nsmooth * f for f in lv[:-1]) + (pcg.coarse[2] - 1) * lv[-1]
        return isz * (3 * nq + pcg.invd_all.numel()), (k + 1) * vflops + k * lv[0]

    plan = (({"plan": mg_plan(sm_q[1], dtype, pcg.nsmooth, pcg.coarse[2])},)
            if torch.device(device).type == "cuda" and not OTHER_TREE else ())
    return ("pressure_mg", f"Ap_c, {L} levels", lambda: pcg.solve(bq, xq),
            lambda: pcg.solve_plain(bq, xq, matvec=kn.matvec_const_plain), mg_work, *plan)


def mg_box_cases(pair, device, seed: int = 10):
    """K1 MG's case on the pressure grid of ``pair`` = (solver, dtype): the
    MG_BOXES and MG_GRID_BOXES grids, whose axes differ."""
    import torch

    solver, dtype = pair
    rtol = SOLVE_RTOL[str(dtype).replace("torch.", "")]
    g = torch.Generator().manual_seed(seed)
    rnd = lambda *shape: torch.randn(*shape, generator=g, dtype=torch.float64).to(device, dtype)
    return rtol, [mg_case(solver._sm_q, solver._cu.Ap_c, solver._Ap_diag, dtype, device, rnd, rtol,
                          2000)]


def mg_cube_cases(pair, device, n: int = N64, seed: int = 11):
    """K1 MG's case on an n^3 grid without its solver's set-up: ``pair`` =
    (the N=36 solver, dtype), whose pressure cube matrix, scaled by the cell
    width (36 / n: the P1 Laplacian's cube matrix is h^(d-2) times the unit
    cube's), is n's; the n^3 P1 grid and its MG levels (N=64: 5, N=44:
    3)."""
    import torch

    from oasisx_tpu_torch.assembly import cubes as cub

    solver, dtype = pair
    rtol = SOLVE_RTOL[str(dtype).replace("torch.", "")]
    sm = sweep_map((n,) * 3, 1, device)[0]
    Ap = solver._cu.Ap_c.double() * (N / n)
    g = torch.Generator().manual_seed(seed)
    rnd = lambda *shape: torch.randn(*shape, generator=g, dtype=torch.float64).to(device, dtype)
    return rtol, [mg_case(sm, Ap, cub.diag_cube(Ap, sm), dtype, device, rnd, rtol, 2000)]


def mg_route_cases(solver, device, boxes=MG_BOXES) -> dict:
    """Phase 3's K1 MG cases beside the main path's: the grids of ``boxes``
    (MG_BOXES: axes that differ, 2D, every level below the finest on block
    0, no level on block 0; --solves-only adds MG_GRID_BOXES: every level
    on the whole grid) and the MG_CUBES grids (no level on block 0, the
    coarsest on the sub-group), each in float64 and float32 against the
    plain version; ``solver`` is the N=36 float32 solver.  Returns per
    kernel its f32 cases."""
    import torch

    out: dict = {}
    for cells in boxes:
        box = tgv_solver(cells, torch.float32, device, rtol=1e-5)
        tag = " " + "x".join(map(str, cells))
        print(f"[3] K1 MG against its plain version ({len(cells)}D, {tag[1:]} cells)")
        for name, recs in compare_solves(
                {"float64": (box, torch.float64), "float32": (box, torch.float32)}, device,
                cases_fn=mg_box_cases, suffix=tag).items():
            out[name] = out.get(name, []) + recs
        del box
    for n in MG_CUBES:
        print(f"[3] K1 MG against its plain version (N={n}: N={N}'s cube matrix scaled by the "
              "cell width)")
        for name, recs in compare_solves(
                {"float64": (solver, torch.float64), "float32": (solver, torch.float32)}, device,
                cases_fn=lambda pr, dev, n=n: mg_cube_cases(pr, dev, n), suffix=f" N={n}").items():
            out[name] = out.get(name, []) + recs
    return out


def p1_mass_cases(solver, dtype, device, rnd, rtol: float, maxiter: int) -> list:
    """solve_cases' K4 cases on the pressure grid's P1 cube, in ``dtype``
    with ``rnd`` drawing the right-hand sides: a P1 mass at batch d and the
    pressure mass Mq_c at batch 1 (the rotational update's solve)."""
    import numpy as np
    import torch

    from oasisx_tpu_torch.assembly import cubes as cub
    from oasisx_tpu_torch.assembly import kernels as kn
    from oasisx_tpu_torch.la import fused

    c = lambda t: t.to(dtype)
    cu, sm_q, d, nq = solver._cu, solver._sm_q, solver._mesh.dim, solver._npad_q
    nlq = cub.num_slots(sm_q)
    isz = torch.empty((), dtype=dtype).element_size()
    # K4 on the P1 cube (the stencil tile) on the pressure grid: the SPD cube
    # matrix of a tensor-product (Q1) mass, a unit cube
    m1 = torch.tensor([[2.0, 1.0], [1.0, 2.0]], dtype=torch.float64) / 6
    M1 = m1
    for _ in range(d - 1):
        M1 = torch.kron(M1, m1)
    M1 = M1.to(device, dtype)
    ncq = int(np.prod(sm_q[1]))
    diag1 = cub.cube_scatter(torch.diag(M1)[None, :, None].expand(1, nlq, ncq).contiguous(),
                             sm_q)[0]
    M1_invd = torch.where(diag1 != 0, 1.0 / diag1, torch.ones_like(diag1))
    bp = rnd(d, nq)
    x0p = torch.zeros_like(bp)
    bnp = torch.linalg.vector_norm(bp, dim=-1)
    mass1 = lambda v: kn.matvec_const_plain(v, M1, sm_q)
    # K4 at batch 1 on the pressure mass Mq_c: the rotational update's solve
    # (fracstep), Jacobi 1 on the padding
    Mq_c = c(cu.Mq_c)
    dq = cub.diag_cube(Mq_c, sm_q)
    Mq_invd = torch.where(dq != 0, 1.0 / dq, torch.ones_like(dq))
    valid_q = (solver._pq(torch.ones(solver._gf_q.shape[0], device=device)) != 0)
    bmq = rnd(1, nq) * valid_q
    x0mq = torch.zeros_like(bmq)
    bnmq = torch.linalg.vector_norm(bmq, dim=-1)
    massq = lambda v: kn.matvec_const_plain(v, Mq_c, sm_q)

    rows = lambda res: float(res.iters.sum())
    route = lambda B: mass_route_extra(device, d, 1, B, dtype)
    return [
        ("cg_mass", "P1 mass",
         lambda: fused.cg_mass(M1, bp, x0p, M1_invd, bnp, sm_q, rtol, maxiter),
         lambda: fused.cg_from_r0(mass1, bp, x0p, M1_invd, bnp, rtol, maxiter),
         lambda res: (mass_bytes(isz, d, nq, int(res.iters.max())),
                      rows(res) * (2.0 * 3 ** d * nq + 10 * nq)), *route(d)),
        ("cg_mass", "Mq_c batch 1",
         lambda: fused.cg_mass(Mq_c, bmq, x0mq, Mq_invd, bnmq, sm_q, rtol, maxiter),
         lambda: fused.cg_from_r0(massq, bmq, x0mq, Mq_invd, bnmq, rtol, maxiter),
         lambda res: (mass_bytes(isz, 1, nq, int(res.iters.max())),
                      rows(res) * (2.0 * 3 ** d * nq + 10 * nq)), *route(1)),
    ]


# the 1D mass matrix of cubic Lagrange on [0, 1], nodes 0, 1/3, 2/3, 1: K4's
# P3 case takes its tensor product as the cube matrix
P3_MASS_1D = ((128.0, 99.0, -36.0, 19.0), (99.0, 648.0, -81.0, -36.0),
              (-36.0, -81.0, 648.0, 99.0), (19.0, -36.0, 99.0, 128.0))


def box_solve_cases(pair, device, seed: int = 9):
    """Phase 3's whole solves on an unequal grid of ``pair`` = (solver,
    dtype), which does not coarsen: K2's cases (bicgstab_cases), K1's
    non-MG modes (pcg_solve_cases), K4 on the pressure grid's P1 cube
    (p1_mass_cases) and K4 on a P3 cube of the same cells at batch 2 (the
    tensor product of P3_MASS_1D: the point-by-point route)."""
    import numpy as np
    import torch

    from oasisx_tpu_torch.assembly import cubes as cub
    from oasisx_tpu_torch.assembly import kernels as kn
    from oasisx_tpu_torch.la import fused

    solver, dtype = pair
    rtol, cases = bicgstab_cases(solver, dtype)
    maxiter = 2000
    g = torch.Generator().manual_seed(seed)
    rnd = lambda *shape: torch.randn(*shape, generator=g, dtype=torch.float64).to(device, dtype)
    cases = cases + pcg_solve_cases(pair, device)[1] + p1_mass_cases(solver, dtype, device, rnd,
                                                                      rtol, maxiter)
    cells = tuple(int(c) for c in solver._sm_q[1])
    sm3, valid3 = sweep_map(cells, 3, device)
    m3 = torch.tensor(P3_MASS_1D, dtype=torch.float64) / 1680
    C3 = m3
    for _ in range(len(cells) - 1):
        C3 = torch.kron(C3, m3)
    C3 = C3.to(device, dtype)
    d3 = cub.diag_cube(C3, sm3)
    invd3 = torch.where(d3 != 0, 1.0 / d3, torch.ones_like(d3))
    n3 = int(np.prod(sm3[0]))
    b3 = rnd(2, n3) * valid3
    x03 = torch.zeros_like(b3)
    bn3 = torch.linalg.vector_norm(b3, dim=-1)
    isz = torch.empty((), dtype=dtype).element_size()
    nl3, nc3 = cub.num_slots(sm3), int(np.prod(sm3[1]))
    mass3 = lambda v: kn.matvec_const_plain(v, C3, sm3)
    return rtol, cases + [
        ("cg_mass", "P3 mass batch 2",
         lambda: fused.cg_mass(C3, b3, x03, invd3, bn3, sm3, rtol, maxiter),
         lambda: fused.cg_from_r0(mass3, b3, x03, invd3, bn3, rtol, maxiter),
         lambda res: (mass_bytes(isz, 2, n3, int(res.iters.max())),
                      float(res.iters.sum()) * (2.0 * nl3 * nl3 * nc3 + 10 * n3)),
         *mass_route_extra(device, len(cells), 3, 2, dtype)),
    ]


def mass_bytes(isz: int, B: int, nv: int, iters: int) -> float:
    """Bytes of K4's bound: r0 and x0 read, x written and invd read once;
    where the state that Jacobi-PCG needs (x, r, p, Ap: 4 vectors of B
    rows, and invd; not the second p buffer of K4's design) does not fit in
    the L2, also each iteration's two passes from memory: the product reads
    r, p and invd and writes p and Ap, the update reads x, p, r, Ap and
    invd and writes x and r (10 B + 2 vectors)."""
    once = isz * (3 * B * nv + nv)
    state = isz * (4 * B * nv + nv)
    if state <= L2_BYTES:
        return once
    it = isz * (10 * B + 2) * nv
    print(f"    bound: K4's state {state / 1e6:.1f} MB > the {L2_BYTES / 1e6:.0f} MB L2, counted "
          f"{it / 1e6:.1f} MB an iteration: {iters} iterations")
    return once + iters * it


MASS_ROUTES = ("point by point", "block-tiled (P2)", "stencil tile (P1)")


def has_routes() -> bool:
    """Whether the loaded kernels report K4's route and K1's plan (under
    --tree a parent's build may not)."""
    from oasisx_tpu_torch import _build

    return hasattr(_build.library(), "oasisx_cg_mass_route")


def mass_route(d: int, deg: int, batch: int, dtype) -> dict:
    """K4's route for ``batch`` rows of a ``d``-D grid of degree ``deg``, as
    ``oasisx_cg_mass`` chooses it on this card (``oasisx_cg_mass_route``):
    the route, its tile (3D form), shared memory a block and grid barriers
    an iteration."""
    import torch

    from oasisx_tpu_torch import _build
    from oasisx_tpu_torch.assembly import kernels as kn

    out = torch.zeros(6, dtype=torch.int32)
    err = _build.library().oasisx_cg_mass_route(int(dtype == torch.float64), d, deg, batch,
                                                kn._ptr(out))
    check(err == 0, f"no K4 route for {d}D degree {deg} batch {batch} {dtype}: CUDA error {err}")
    o = out.tolist()
    return {"route": MASS_ROUTES[o[0]], "tile": tuple(o[1:4]), "smem": o[4], "barriers": o[5]}


def pcg_plan(d: int, degree: int, dtype) -> dict:
    """K1's non-MG plan at Chebyshev degree ``degree`` (0: Jacobi) on a
    ``d``-D grid, as ``oasisx_pressure_cg`` chooses it on this card
    (``oasisx_pressure_cg_plan``): its tile (3D form), shared memory a
    block, Chebyshev steps a segment and grid barriers an iteration, the
    last equal to ``oasisx_pressure_cg_barriers``."""
    import torch

    from oasisx_tpu_torch import _build
    from oasisx_tpu_torch.assembly import kernels as kn

    lib, f64 = _build.library(), int(dtype == torch.float64)
    out = torch.zeros(6, dtype=torch.int32)
    err = lib.oasisx_pressure_cg_plan(f64, d, degree, kn._ptr(out))
    check(err == 0, f"no K1 plan for {d}D degree {degree} {dtype}: CUDA error {err}")
    o = out.tolist()
    check(lib.oasisx_pressure_cg_barriers(f64, d, degree) == o[5],
          f"K1's barriers {lib.oasisx_pressure_cg_barriers(f64, d, degree)}, its plan's {o[5]}")
    return {"route": "stencil tile (P1)", "tile": tuple(o[:3]), "smem": o[3], "steps": o[4],
            "barriers": o[5]}


def mass_route_extra(device, d: int, deg: int, batch: int, dtype) -> tuple:
    """A K4 case's extra record on the card (its route, as "plan"), none
    elsewhere."""
    import torch

    if torch.device(device).type != "cuda" or not has_routes():
        return ()
    return ({"plan": mass_route(d, deg, batch, dtype)},)


def const_tile(d: int, batch: int, dtype) -> list:
    """K5's and K4's tile on this card for ``batch`` components of a
    ``d``-D P2 grid, as the kernels choose it (``oasisx_const_tile``): [t0,
    t1, t2 (3D form), K5's shared memory a block, K5's blocks an SM, K4's
    shared memory a block]."""
    import torch

    from oasisx_tpu_torch import _build
    from oasisx_tpu_torch.assembly import kernels as kn

    out = torch.zeros(6, dtype=torch.int32)
    err = _build.library().oasisx_const_tile(int(dtype == torch.float64), d, batch, kn._ptr(out))
    check(err == 0, f"no tile for {d}D batch {batch} {dtype}: CUDA error {err}")
    return out.tolist()


def check_tiles() -> None:
    """Phase 2: the tile the kernels choose for every grid dimension, type
    and batch 1-4 lets K5 run two blocks an SM of this card."""
    import torch

    for d in (3, 2):
        for dtype in (torch.float32, torch.float64):
            tiles = {b: const_tile(d, b, dtype) for b in range(1, 5)}
            print(f"[2] tiles {d}D {str(dtype).replace('torch.', '')}, batch: (t0, t1, t2), "
                  f"bytes a block of K5 / K4, K5's blocks an SM: " + "; ".join(
                      f"{b}: {tuple(t[:3])} {t[3]} / {t[5]} B {t[4]}" for b, t in tiles.items()))
            for b, t in tiles.items():
                check(t[4] >= 2, f"K5 runs {t[4]} blocks an SM at {d}D batch {b} {dtype}")


def k5_report(solver, dtype, rec: dict) -> None:
    """K5's tile at the solver's batch-d product: the tile, its shared
    memory, the blocks an SM the card runs, the bytes a product moves (x
    read and y written once, C) and the rate of ``rec``'s time."""
    import torch

    d = solver._mesh.dim
    isz = torch.empty((), dtype=dtype).element_size()
    t = const_tile(d, d, dtype)
    moved = isz * (2 * d * solver._npad_v + 3 ** (2 * d))
    print(f"    K5 tile {tuple(t[:3])} (3D form), {t[3]} bytes of shared memory a block, {t[4]} "
          f"blocks an SM; a product moves {moved / 1e6:.2f} MB: "
          f"{moved / rec['ms'] / 1e9:.3f} TB/s")


WIN_ROUTES = ("point by point", "cube-owned, inputs in registers",
              "cube-owned, inputs in shared memory")


def win_route(sm, batch: int, premul: bool, dtype) -> dict:
    """K3's route for one launch of ``batch`` (1-4) components on ``sm``'s
    grid, as ``oasisx_matvec_win`` chooses it (``oasisx_win_route``): its
    name, and phase A's threads a block, shared memory a block and blocks an
    SM."""
    import torch

    from oasisx_tpu_torch import _build
    from oasisx_tpu_torch.assembly import kernels as kn

    out = torch.zeros(4, dtype=torch.int32)
    err = _build.library().oasisx_win_route(int(dtype == torch.float64), *kn._dims(sm),
                                            int(sm[2]), batch, int(premul), kn._ptr(out))
    check(err == 0, f"no K3 route for batch {batch} {dtype}: CUDA error {err}")
    r, threads, smem, blocks = out.tolist()
    return {"name": WIN_ROUTES[r], "threads": threads, "smem": smem, "blocks": blocks}


def win_case(label: str, solver) -> tuple[int, bool, bool]:
    """(batch, premul, zmask) of one of kernel_cases' matvec_win cases."""
    return (1 if "batch 1" in label else solver._mesh.dim, "premul" in label, "zmask" in label)


def win_report(solver, dtype, rec: dict, label: str) -> None:
    """K3's route at ``label``'s case, the bytes of its cube-owned product
    (W streamed once, the stage written by phase A and read by phase B, the
    inputs (and premul) read and the outputs written (and zmask read) once)
    and the rate of ``rec``'s time."""
    import numpy as np
    import torch

    from oasisx_tpu_torch.assembly import cubes as cub

    batch, pm, zm = win_case(label, solver)
    r = win_route(solver._sm_v, batch, pm, dtype)
    isz = torch.empty((), dtype=dtype).element_size()
    nl, nc = cub.num_slots(solver._sm_v), int(np.prod(solver._sm_v[1]))
    parts = {"W": isz * nl * nl * nc, "stage": 2.0 * isz * batch * nl * nc,
             "vectors": isz * batch * solver._npad_v * (2 + pm + zm)}
    moved = sum(parts.values())
    print(f"    route {r['name']} ({r['threads']} threads a block, {r['smem']} bytes of shared "
          f"memory, {r['blocks']} blocks an SM); bytes a product: W {parts['W'] / 1e6:.1f} MB, "
          f"stage {parts['stage'] / 1e6:.1f} MB, vectors {parts['vectors'] / 1e6:.1f} MB; "
          f"{moved / 1e6:.1f} MB in {rec['ms']:.4f} ms: {moved / rec['ms'] / 1e9:.3f} TB/s")


MIXED_ROUTES = ("point by point", "block-tiled")


def mixed_route(sm_v, sm_q, div: bool, dtype) -> dict:
    """K6's (``div`` false) or K7's route for the d components of ``sm_v``'s
    and ``sm_q``'s grids, as ``oasisx_mixed`` / ``oasisx_divergence`` choose
    it (``oasisx_mixed_route``): its name, and on the tiled route the tile
    (3D form), shared memory a block and blocks an SM."""
    import torch

    from oasisx_tpu_torch import _build
    from oasisx_tpu_torch.assembly import kernels as kn

    out = torch.zeros(6, dtype=torch.int32)
    err = _build.library().oasisx_mixed_route(int(dtype == torch.float64), int(div),
                                              *kn._dims(sm_v), int(sm_v[2]), int(sm_q[2]),
                                              len(sm_v[1]), kn._ptr(out))
    check(err == 0, f"no {'K7' if div else 'K6'} route for {dtype}: CUDA error {err}")
    r, t0, t1, t2, smem, blocks = out.tolist()
    return {"name": MIXED_ROUTES[r], "tile": (t0, t1, t2), "smem": smem, "blocks": blocks}


def mixed_report(solver, dtype, rec: dict, div: bool) -> None:
    """K6's (``div`` false) or K7's tile at the solver's shapes: the tile, its
    shared memory, the blocks an SM the card runs, the bytes a product moves
    (the P1 vector and the d P2 components once, C_all) and the rate of
    ``rec``'s time."""
    import torch

    from oasisx_tpu_torch.assembly import cubes as cub

    r = mixed_route(solver._sm_v, solver._sm_q, div, dtype)
    d = solver._mesh.dim
    isz = torch.empty((), dtype=dtype).element_size()
    nl, nlq = cub.num_slots(solver._sm_v), cub.num_slots(solver._sm_q)
    moved = isz * (d * solver._npad_v + solver._npad_q + d * nl * nlq)
    print(f"    {'K7' if div else 'K6'} route {r['name']}, tile {r['tile']} (3D form), {r['smem']} "
          f"bytes of shared memory a block, {r['blocks']} blocks an SM; a product moves "
          f"{moved / 1e6:.2f} MB: {moved / rec['ms'] / 1e9:.3f} TB/s")


def sweep_map(cells, deg: int, device):
    """The structured map of Lagrange degree ``deg`` on a box (3D) or a
    rectangle (2D) of ``cells``, and the mask of its grid points that are
    not padding, on ``device``: the grids of the K3 and K6/K7 sweeps."""
    import numpy as np
    import torch

    from oasisx_tpu_torch.assembly import cubes as cub
    from oasisx_tpu_torch.assembly.structured import build_structured_map
    from oasisx_tpu_torch.elements.element import make_element
    from oasisx_tpu_torch.meshes import create_box, create_rectangle
    from oasisx_tpu_torch.spaces.functionspace import FunctionSpace

    d = len(cells)
    mesh = (create_box((-1.0,) * 3, (1.0,) * 3, cells) if d == 3
            else create_rectangle((-1.0,) * 2, (1.0,) * 2, cells))
    el = make_element(("Lagrange", deg), mesh.cell_type)
    sm = build_structured_map(mesh, el, FunctionSpace(mesh, el).dofmap)[0]
    ones = torch.ones((1, cub.num_slots(sm), int(np.prod(sm[1]))), dtype=torch.float64)
    return sm, (cub.cube_scatter(ones, sm)[0] != 0).to(device)


# (cells, (velocity degree, pressure degree) pairs) of K6's and K7's sweep:
# the P2/P1 pair takes the tiled route on every grid (the two small ones
# below one tile on some axis), the other pairs the point-by-point one
MIXED_PAIRS = ((2, 1), (1, 1), (3, 2))
MIXED_SWEEP = (((5, 6, 7), MIXED_PAIRS), ((9, 11), MIXED_PAIRS), ((26, 26, 26), MIXED_PAIRS),
               ((130, 131), MIXED_PAIRS))


def mixed_sweep_cases(device, grids=MIXED_SWEEP, seed: int = 8):
    """(kernel, label, maps (sm_v, sm_q), dtype, kernel call, plain call,
    staged-plain call, padded-output mask) of K6 and K7 on every degree pair
    of ``grids``, in float64 and float32, on random vectors and random
    matrices C_all (d, nl_v, nl_q) made from ``seed``."""
    import numpy as np
    import torch

    from oasisx_tpu_torch.assembly import cubes as cub
    from oasisx_tpu_torch.assembly import kernels as kn

    rng = np.random.default_rng(seed)
    cases = []
    for cells, pairs in grids:
        d = len(cells)
        for dv, dq in pairs:
            (sm_v, valid_v), (sm_q, valid_q) = (sweep_map(cells, dv, device),
                                                sweep_map(cells, dq, device))
            label = f"{d}D P{dv}/P{dq} {'x'.join(map(str, cells))}"
            for dtype in (torch.float64, torch.float32):
                t = lambda *shape: torch.as_tensor(rng.standard_normal(shape)).to(device, dtype)
                C = t(d, cub.num_slots(sm_v), cub.num_slots(sm_q))
                p = t(valid_q.numel()) * valid_q
                u = t(d, valid_v.numel()) * valid_v
                m = (sm_v, sm_q)
                cases.append(("mixed", label, m, dtype,
                              lambda C=C, p=p, m=m: kn.mixed(p, C, *m),
                              lambda C=C, p=p, m=m: kn.mixed_plain(p, C, *m),
                              lambda C=C, p=p, m=m: kn.mixed_staged_plain(p, C, *m), valid_v))
                cases.append(("divergence", label, m, dtype,
                              lambda C=C, u=u, m=m: kn.divergence(u, C, *m),
                              lambda C=C, u=u, m=m: kn.divergence_plain(u, C, *m),
                              lambda C=C, u=u, m=m: kn.divergence_staged_plain(u, C, *m),
                              valid_q))
    return cases


def check_mixed_sweep(device, grids=MIXED_SWEEP) -> None:
    """Phase 3: every case of mixed_sweep_cases against its plain version and
    its staged plain version (f64 to 1e-12, f32 to 1e-5 of the output's
    largest value), padding zero, a repeat bit-identical; a line for each
    kernel, grid, pair and type, with its errors and, on the card, its route
    (and tile)."""
    import torch

    tols = {torch.float64: 1e-12, torch.float32: 1e-5}
    for name, label, maps, dtype, kfn, pfn, sfn, valid in mixed_sweep_cases(device, grids):
        yk, yk2, yp, ys = kfn(), kfn(), pfn(), sfn()
        _sync(device)
        scale = max(float(yp.abs().max()), 1e-300)
        rel = float((yk - yp).abs().max()) / scale
        rs = float((yk - ys).abs().max()) / scale
        dt = str(dtype).replace("torch.", "")
        what = f"{name} ({label}, {dt})"
        check(rel <= tols[dtype], f"{what} disagrees: rel err {rel:.3e}")
        check(rs <= tols[dtype], f"{what} disagrees with its staged order: rel err {rs:.3e}")
        check(bool((yk[..., ~valid] == 0).all()), f"{what} wrote non-zero padding")
        check(torch.equal(yk, yk2), f"{what}: a second kernel call differs from the first")
        route = ""
        if torch.device(device).type == "cuda":
            r = mixed_route(*maps, name == "divergence", dtype)
            route = f"; route {r['name']}" + (f", tile {r['tile']}, {r['blocks']} blocks an SM"
                                              if r["name"] != MIXED_ROUTES[0] else "")
        print(f"  {name:13s} {label:18s} {dt}: rel err {rel:.3e}, against the staged order "
              f"{rs:.3e} (tol {tols[dtype]:g}), padding zero, repeat bit-identical{route}")


# (cells, degrees) of K3's sweep: the small grids have fewer cubes than one
# block of phase A an SM and go point by point on the card, the large ones
# (17,576 and 17,030 cubes) cube-owned
WIN_SWEEP = (((5, 6, 7), (1, 2, 3)), ((9, 11), (1, 2, 3, 7)), ((26, 26, 26), (1, 2, 3)),
             ((130, 131), (1, 2, 3, 7)))


def win_sweep_cases(device, grids=WIN_SWEEP, seed: int = 7):
    """(label, map, dtype, batch, premul, kernel call, plain call, padded-
    output mask) of K3 on every cube it takes: degrees 1-3 in 3D and 1, 2, 3
    and 7 (64 slots) in 2D, on ``grids``, at batch 1-5 (5 in two launches)
    without multipliers and with both, in float64 and float32, on random
    inputs made from ``seed``.  The label names the grid and degree."""
    import numpy as np
    import torch

    from oasisx_tpu_torch.assembly import cubes as cub
    from oasisx_tpu_torch.assembly import kernels as kn

    rng = np.random.default_rng(seed)
    cases = []
    for cells, degrees in grids:
        d = len(cells)
        for deg in degrees:
            sm, valid = sweep_map(cells, deg, device)
            nl, nc, npad = cub.num_slots(sm), int(np.prod(sm[1])), int(np.prod(sm[0]))
            label = f"{d}D P{deg} {'x'.join(map(str, cells))}"
            for dtype in (torch.float64, torch.float32):
                t = lambda *shape: torch.as_tensor(rng.standard_normal(shape)).to(device, dtype)
                W = t(nl * nl, nc)
                for batch in (1, 2, 3, 4, 5):
                    x = t(batch, npad) * valid
                    mults = {"premul": t(batch, npad), "zmask": torch.as_tensor(
                        rng.random((batch, npad)) > 0.2).to(device, dtype)}
                    for a in ({}, mults):
                        cases.append((label, sm, dtype, batch, bool(a),
                                      lambda W=W, x=x, sm=sm, a=a: kn.matvec_win(W, x, sm, **a),
                                      lambda W=W, x=x, sm=sm, a=a: kn.matvec_win_plain(W, x, sm,
                                                                                       **a),
                                      valid))
    return cases


def check_win_sweep(device, grids=WIN_SWEEP) -> None:
    """Phase 3: every case of win_sweep_cases against its plain version (f64
    to 1e-12, f32 to 1e-5 of the output's largest value), padding zero, a
    repeat bit-identical; a line for each grid, degree and type, with the
    largest error of its cases and, on the card, the batches that took each
    route (a launch of at most 4 components each; "p": with premul)."""
    import torch

    tols = {torch.float64: 1e-12, torch.float32: 1e-5}
    rows: dict = {}
    for label, sm, dtype, batch, pm, kfn, pfn, valid in win_sweep_cases(device, grids):
        yk, yk2, yp = kfn(), kfn(), pfn()
        _sync(device)
        rel = float((yk - yp).abs().max()) / max(float(yp.abs().max()), 1e-300)
        dt = str(dtype).replace("torch.", "")
        what = f"matvec_win ({label} batch {batch}{' premul zmask' if pm else ''}, {dt})"
        check(rel <= tols[dtype], f"{what} disagrees: rel err {rel:.3e}")
        check(bool((yk[:, ~valid] == 0).all()), f"{what} wrote non-zero padding")
        check(torch.equal(yk, yk2), f"{what}: a second kernel call differs from the first")
        row = rows.setdefault((label, dt), {"rel": 0.0, "routes": {}})
        row["rel"] = max(row["rel"], rel)
        if torch.device(device).type == "cuda":
            route = " + ".join(win_route(sm, min(4, batch - b0), pm, dtype)["name"]
                               for b0 in range(0, batch, 4))
            row["routes"].setdefault(route, []).append(f"{batch}{'p' if pm else ''}")
    for (label, dt), row in rows.items():
        routes = "; ".join(f"{r}: {' '.join(b)}" for r, b in row["routes"].items())
        print(f"  matvec_win    {label:15s} {dt}: batch 1-5, with and without premul and zmask,"
              f" max rel err {row['rel']:.3e} (tol {tols[getattr(torch, dt)]:g}), padding zero,"
              f" repeats bit-identical{'; routes (p: premul) ' + routes if routes else ''}")


def k2_product_bytes(solver, dtype, batch: int) -> dict:
    """Bytes of one K2 product (the two phases of csrc/krylov_ops.cu): W
    streamed once, the staged per-cube outputs written and read once, and
    the input vectors y read and the output vectors written once."""
    import numpy as np
    import torch

    from oasisx_tpu_torch.assembly import cubes as cub

    isz = torch.empty((), dtype=dtype).element_size()
    nl, nc = cub.num_slots(solver._sm_v), int(np.prod(solver._sm_v[1]))
    return dict(W=isz * nl * nl * nc, staging=2.0 * isz * batch * nl * nc,
                vectors=2.0 * isz * batch * solver._npad_v)


def bicgstab_cases(solver, dtype):
    """(rtol, cases) of K2: the first tentative solve from the Taylor-Green
    initial state with the mesh's bc rows, at the batch of the velocity's
    components and at batch 1 (its first component), in ``dtype`` with the
    solver's operators cast.  The bound counts W once a product where it
    exceeds the L2; each case prints its bytes a product and the rate its
    products achieved."""
    import numpy as np
    import torch

    from oasisx_tpu_torch.assembly import cubes as cub
    from oasisx_tpu_torch.assembly import kernels as kn
    from oasisx_tpu_torch.la import fused

    rtol = SOLVE_RTOL[str(dtype).replace("torch.", "")]
    c = lambda t: t.to(dtype)
    sm_v, maxiter = solver._sm_v, 2000
    isz = torch.empty((), dtype=dtype).element_size()
    nv = solver._npad_v
    nl, nc = cub.num_slots(sm_v), int(np.prod(sm_v[1]))
    st = solver._state_from_functions()
    u1, u2 = st["u1"], st["u2"]
    W, uq, b_first = solver._assemble_first(u1, u2, DT, NU)
    tdiag = c(solver._tentative_diag(W, uq, DT, NU))
    W, b_first, u1, u2 = c(W), c(b_first), c(u1), c(u2)
    bc, masks, zmask = c(solver._bc_values()), solver._bc_masks, c(solver._zmask)
    rhs = torch.where(masks, bc, b_first)
    tx0 = torch.where(masks, bc, 2.0 * u1 - u2)
    r0 = zmask * rhs - kn.matvec_win(W, tx0, sm_v, zmask=zmask)
    tbn = torch.linalg.vector_norm(rhs, dim=-1)
    tinvd = torch.where(tdiag != 0, 1.0 / tdiag, 1.0)
    win = lambda v: kn.matvec_win_plain(W, v, sm_v)
    one = lambda t: t[:1].contiguous()

    def case(B, args, label):
        def work(res):
            products = 2 * int(res.iters.max())
            per = k2_product_bytes(solver, dtype, B)
            w_bytes = operator_bytes(f"K2 W ({label})", per["W"], products)
            return (w_bytes + isz * (4 * B * nv + nv),
                    float(res.iters.sum()) * (4.0 * nl * nl * nc + 20 * nv))

        return ("bicgstab", label, lambda: fused.bicgstab(W, *args, sm_v, rtol, maxiter),
                lambda: fused.bicgstab_from_r0(win, *args, rtol, maxiter), work,
                {"product_bytes": k2_product_bytes(solver, dtype, B)})

    full = (r0, tx0, zmask, tinvd, tbn)
    B = r0.shape[0]
    return rtol, [case(B, full, "TGV first step"),
                  case(1, (one(r0), one(tx0), one(zmask), tinvd, one(tbn)),
                       "TGV first step batch 1")]


def pcg_solve_cases(pair, device, seed: int = 6):
    """Phase 3e: K1's non-MG modes, Jacobi and Chebyshev-Jacobi of the
    solver's degree with the bounds it estimated at set-up, on the pressure
    Ap of ``pair`` = (solver, dtype), its operators cast to dtype: a random
    demeaned rhs, x0 = 0.  (kernel, label, kernel solve, plain solve,
    work(result) -> (bytes, operations)): every fine product (one an
    iteration, degree - 1 a Chebyshev application, one for r0) and ~12
    vector operations a point an iteration."""
    import torch

    from oasisx_tpu_torch.assembly import kernels as kn
    from oasisx_tpu_torch.la.pressure_cg import PressureCG

    solver, dtype = pair
    rtol = SOLVE_RTOL[str(dtype).replace("torch.", "")]
    sm_q, maxiter = solver._sm_q, 2000
    Ap_c = solver._cu.Ap_c.to(dtype)
    cheb = solver.config_report()["pressure_cheb"]
    invd = solver._pcg.invd
    g = torch.Generator().manual_seed(seed)
    nq = solver._npad_q
    bq = torch.randn(nq, generator=g, dtype=torch.float64).to(device, dtype)
    bq = bq - bq.mean()
    xq = torch.zeros_like(bq)
    isz = torch.empty((), dtype=dtype).element_size()
    # a product's operations: the P1 stencil's 3^d fmas a point, fewer than
    # the cube form's (2^d)^2 a cube
    prod = 2.0 * 3 ** len(sm_q[1]) * nq

    def case(deg, lmin, lmax, label):
        pcg = PressureCG(sm_q, Ap_c, invd, rtol, maxiter, deg, lmin, lmax)

        def work(res):
            k = int(res.iters)
            products = 1 + k + (k + 1) * max(deg - 1, 0)
            return isz * 4 * nq, products * prod + 12.0 * k * nq

        plan = (({"plan": pcg_plan(len(sm_q[1]), deg, dtype)},)
                if torch.device(device).type == "cuda" and has_routes() else ())
        return ("pressure_cg", label, lambda: pcg.solve(bq, xq),
                lambda: pcg.solve_plain(bq, xq, matvec=kn.matvec_const_plain), work, *plan)

    return rtol, [
        case(cheb["degree"], cheb["lmin"], cheb["lmax"], f"Ap_c, Chebyshev({cheb['degree']})"),
        case(0, 0.0, 0.0, "Ap_c, Jacobi"),
    ]


def _f32_iters_ok(ik, ip) -> bool:
    import numpy as np

    return bool(np.all(np.abs(ik - ip) <= np.maximum(1, np.ceil(0.1 * ip))))


def compare_solves(solvers: dict, device, cases_fn=None, suffix: str = "") -> dict:
    """Each solve kernel against its plain host-loop version, per dtype:
    f64 x to 1e-10 relative with equal iterations, f32 x to 10 rtol with
    iterations within 10% (at least 1); a repeat call bit-identical; f32
    cases timed.  ``suffix`` ends each case's label.  Returns per kernel
    its f32 cases."""
    import numpy as np
    import torch

    out: dict = {}
    for tag, solver in solvers.items():
        rtol, cases = (cases_fn or solve_cases)(solver, device)
        for name, label, kfn, pfn, work, *extra in cases:
            label += suffix
            rk, rk2, rp = kfn(), kfn(), pfn()
            _sync(device)
            err = float((rk.x - rp.x).abs().max())
            rel = err / max(float(rp.x.abs().max()), 1e-300)
            ik = np.atleast_1d(rk.iters.cpu().numpy())
            ip = np.atleast_1d(rp.iters.cpu().numpy())
            same = bool(torch.equal(rk.x, rk2.x) and torch.equal(rk.iters, rk2.iters))
            tol = 1e-10 if tag == "float64" else 10 * rtol
            print(f"  {name:13s} {label:22s} {tag}: x rel err {rel:.3e} (tol {tol:g}), iterations"
                  f" kernel {ik.tolist()} plain {ip.tolist()}, repeat bit-identical: {same}")
            check(bool(rk.converged.all()) and bool(rp.converged.all()),
                  f"{name} ({label}, {tag}) did not converge")
            check(rel <= tol, f"{name} ({label}, {tag}) disagrees: rel err {rel:.3e}")
            if tag == "float64":
                check(np.array_equal(ik, ip), f"{name} (f64) iterations differ: {ik} {ip}")
            else:
                check(_f32_iters_ok(ik, ip), f"{name} (f32) iterations differ: {ik} {ip}")
            check(same, f"{name} ({label}, {tag}): a second kernel call differs from the first")
            if tag != "float32" or torch.device(device).type != "cuda":
                continue
            more = {"iters": ik.tolist()}
            for key, fn in (extra[0] if extra else {}).items():  # the same solve, flat ELL
                more[key] = (min(time_ms(fn, device, reps=10), time_ms(fn, device, reps=10))
                             if callable(fn) else fn)
            rec = _timed(name, label, kfn, pfn, device, err, work(rk), None, reps=10, preps=3,
                         extra=more)
            if "plan" in more:  # K1, K4: route, tile, barriers, time an iteration
                r, its = more["plan"], int(ik.max())
                steps = f", {r['steps']} Chebyshev steps a segment" if "steps" in r else ""
                bars = r["barriers"] if isinstance(r["barriers"], str) else f"{r['barriers']} grid"
                print(f"    route {r['route']}, tile {r['tile']}, {r['smem']} bytes of shared "
                      f"memory a block{steps}, {bars} barriers an iteration; "
                      f"{1000 * rec['ms'] / max(its, 1):.2f} us an iteration ({its} iterations)")
            if "product_bytes" in more:  # K2: its products' bytes and rate
                pb, products = more["product_bytes"], 2 * int(ik.max())
                moved = products * sum(pb.values())
                print(f"    bytes a product: W {pb['W'] / 1e6:.1f} MB, staging "
                      f"{pb['staging'] / 1e6:.1f} MB, vectors {pb['vectors'] / 1e6:.1f} MB; "
                      f"{products} products, {moved / 1e6:.1f} MB in {rec['ms']:.4f} ms: "
                      f"{moved / rec['ms'] / 1e9:.3f} TB/s")
            out.setdefault(name, []).append(rec)
    return out


# ---------------------------------------------------------------------------
# phase 3b: the general path's ELL kernels
# ---------------------------------------------------------------------------


def _amg_work(amg, isz, iters=None):
    """(bytes, operations) of K17 (or of one V-cycle, iters None): every
    table's stored non-zeros read once, b, x0 and x; per V-cycle
    (pre + post) A products, R and P on each level and the dense coarse
    product; per iteration one fine product and one V-cycle (plus z0)."""
    meta, arrays = amg
    nnz = lambda t: float((t != 0).sum())
    lv = [dict(zip(("Av", "Ac", "sm", "Pv", "Pc", "Rv", "Rc"), arrays[7 * i: 7 * i + 7]))
          for i in range(len(meta["levels"]))]
    cn = meta["coarse_n"]
    vflops = 2.0 * cn * cn + sum(
        2 * (meta["pre"] + meta["post"]) * nnz(L["Av"]) + 2 * nnz(L["Rv"]) + 2 * nnz(L["Pv"])
        for L in lv)
    table = sum((isz + 4) * (nnz(L["Av"]) + nnz(L["Rv"]) + nnz(L["Pv"])) + isz * L["sm"].numel()
                for L in lv) + isz * cn * cn
    n0 = meta["levels"][0]["n"] if lv else cn
    if iters is None:
        return table + 2 * isz * n0, vflops
    return table + 3 * isz * n0, (iters + 1) * vflops + iters * 2.0 * nnz(lv[0]["Av"] if lv
                                                                           else arrays[-1])


def ell_kernel_cases(vsolver, device, seed: int = 2):
    """Phase 3b, products: (kernel, label, kernel call, plain call, (bytes,
    operations), library call) for K14 on the vessel's tentative operator of
    the initial state (batch 3 and 1) and on Ap, and K17's V-cycle alone."""
    import torch

    from oasisx_tpu_torch.la import ell
    from oasisx_tpu_torch.parallel.graph import ell_values

    dtype = vsolver._dtype
    g = torch.Generator().manual_seed(seed)
    rnd = lambda *shape: torch.randn(*shape, generator=g, dtype=torch.float64).to(device, dtype)
    st = vsolver._state_from_functions()
    A, _, _ = vsolver._assemble_first(st["u1"], st["u2"], DT, NU)
    ev, eq = vsolver._ell_v, vsolver._ell_q
    vals = ell_values(A, ev)
    Apv = vsolver._Ap_vals
    x3, xq = rnd(3, ev.n), rnd(eq.n)
    x1 = x3[0].contiguous()
    isz = torch.empty((), dtype=dtype).element_size()
    timed = dtype == torch.float32 and torch.device(device).type == "cuda"
    lib = dict.fromkeys(("A", "Ap"))
    if timed:
        A_csr, Ap_csr = ell_csr(vals, ev.cols), ell_csr(Apv, eq.cols)
        x3t = x3.T.contiguous()
        lib = dict(A3=lambda: A_csr @ x3t, A1=lambda: A_csr @ x1, Ap=lambda: Ap_csr @ xq)
    # the bound reads the real nonzeros; "read_bytes": what K14 reads of the
    # operator, its slices' widths of values and columns
    work = lambda nnz, n, nb: ((isz + 4) * nnz + isz * 2 * nb * n, 2.0 * nnz * nb)
    read = lambda e: {"read_bytes": ell_read(e, isz)[0]}
    amg, amg_w = vsolver._amg_data, vsolver._amg_widths
    r = rnd(eq.n)
    return [
        ("ell_matvec", "A_lhs batch 3",
         lambda: ell.ell_matvec(vals, ev.cols, ev.widths, x3),
         lambda: ell.ell_matvec_plain(vals, ev.cols, x3), work(ev.nnz, ev.n, 3), lib.get("A3"),
         read(ev)),
        ("ell_matvec", "A_lhs batch 1",
         lambda: ell.ell_matvec(vals, ev.cols, ev.widths, x1),
         lambda: ell.ell_matvec_plain(vals, ev.cols, x1), work(ev.nnz, ev.n, 1), lib.get("A1"),
         read(ev)),
        ("ell_matvec", "Ap batch 1",
         lambda: ell.ell_matvec(Apv, eq.cols, eq.widths, xq),
         lambda: ell.ell_matvec_plain(Apv, eq.cols, xq), work(eq.nnz, eq.n, 1), lib.get("Ap"),
         read(eq)),
        ("ell_pcg_amg", f"V-cycle alone, {len(amg[0]['levels']) + 1} levels",
         lambda: ell.ell_vcycle(amg, r, amg_w), lambda: ell.ell_vcycle_plain(amg, r),
         _amg_work(amg, isz), None),
    ]


def compare_ell_kernels(vsolvers: dict, device, cases_fn=None) -> dict:
    """Phases 3b and 3d, products: in f64 (1e-12) and f32 (1e-5), max
    relative error against the plain version, a repeat bit-identical; f32
    timed (with any other timings a case names, and its other numbers).  The V-cycle's records go
    under "cases" of K17 only."""
    import torch

    out: dict = {}
    for tag, vs in vsolvers.items():
        tol = 1e-12 if tag == "float64" else 1e-5
        for name, label, kfn, pfn, work, lib, *extra in (cases_fn or ell_kernel_cases)(vs, device):
            yk, yk2, yp = kfn(), kfn(), pfn()
            _sync(device)
            err = float((yk - yp).abs().max())
            rel = err / max(float(yp.abs().max()), 1e-300)
            same = bool(torch.equal(yk, yk2))
            print(f"  {name:13s} {label:22s} {tag}: max abs err {err:.3e}, rel {rel:.3e} "
                  f"(tol {tol:g}), repeat bit-identical: {same}")
            check(rel <= tol, f"{name} ({label}, {tag}) disagrees: rel err {rel:.3e}")
            check(same, f"{name} ({label}, {tag}): a second kernel call differs from the first")
            if tag == "float32" and torch.device(device).type == "cuda":
                more = {key: min(time_ms(fn, device), time_ms(fn, device)) if callable(fn) else fn
                        for key, fn in (extra[0] if extra else {}).items()}
                out.setdefault(name, []).append(
                    _timed(name, label, kfn, pfn, device, err, work, lib, reps=20, preps=5,
                           extra=more))
    return out


def ell_solve_cases(pair, device, seed: int = 3):
    """Phase 3b, solves on the vessel's systems, the cylinder's outlet Ap
    and the mass of a Projector on the cylinder: (kernel, label, kernel
    solve, plain solve, work(result))."""
    import torch

    from oasisx_tpu_torch import Projector
    from oasisx_tpu_torch.assembly import engine as eng
    from oasisx_tpu_torch.forms.expr import grad
    from oasisx_tpu_torch.la import ell
    from oasisx_tpu_torch.parallel.graph import ell_values
    from oasisx_tpu_torch.spaces import FunctionSpace

    vs, cs = pair
    dtype = vs._dtype
    rtol = SOLVE_RTOL[str(dtype).replace("torch.", "")]
    maxiter = 2000
    g = torch.Generator().manual_seed(seed)
    rnd = lambda *shape: torch.randn(*shape, generator=g, dtype=torch.float64).to(device, dtype)
    isz = torch.empty((), dtype=dtype).element_size()
    ev, eq = vs._ell_v, vs._ell_q
    n = ev.n

    # K15: the first tentative solve from the Taylor-Green initial state
    st = vs._state_from_functions()
    u1, u2 = st["u1"], st["u2"]
    A, _, b_first = vs._assemble_first(u1, u2, DT, NU)
    vals = ell_values(A, ev)
    diag = vs._tentative_diag(A, None, DT, NU)
    bc, masks, zmask = vs._bc_values(), vs._bc_masks, vs._zmask
    rhs = torch.where(masks, bc, b_first + vs._pressure_gradient(st["p"]))
    tx0 = torch.where(masks, bc, 2.0 * u1 - u2)
    r0 = zmask * (rhs - ell.ell_matvec_plain(vals, ev.cols, tx0))
    tbn = torch.linalg.vector_norm(rhs, dim=-1)
    tinvd = torch.where(diag != 0, 1.0 / diag, 1.0)
    op = (vals, ev.cols, ev.widths)

    # K16: M x = b, x0 = 0
    b = rnd(3, n)
    x0 = torch.zeros_like(b)
    bn = torch.linalg.vector_norm(b, dim=-1)
    # K16 at batch 1 on Mq, the rotational update's solve (fracstep), and at
    # batch 2 on the Projector's mass of grad(p) into vector P1 on the cylinder
    Mq = eng.mass_q_elems(vs._ctx)
    Mq_vals = ell_values(Mq, eq)
    dmq = eng.diagonal_q(vs._ctx, Mq)
    Mq_invd = torch.where(dmq != 0, 1.0 / dmq, torch.ones_like(dmq))
    bmq = rnd(1, eq.n)
    x0mq = torch.zeros_like(bmq)
    bnmq = torch.linalg.vector_norm(bmq, dim=-1)
    proj = Projector(grad(cs._p), FunctionSpace(cs._mesh, ("Lagrange", 1), shape=(2,)),
                     dtype=dtype, device=device)
    pe = proj._ell
    bpj = rnd(2, pe.n)
    x0pj = torch.zeros_like(bpj)
    bnpj = torch.linalg.vector_norm(bpj, dim=-1)

    # K17: Ap with the nullspace (random demeaned b), and the cylinder's
    # outlet-masked Ap (b 0 on the outlet rows)
    bq = rnd(eq.n)
    bq = bq - bq.mean()
    zq = torch.zeros_like(bq)
    cmask = cs._pbc_mask.to(dtype)
    bc_q = rnd(cs._ell_q.n) * (1.0 - cmask)
    zc = torch.zeros_like(bc_q)
    rows = lambda res: float(res.iters.sum())
    nnz_bytes = lambda e: (isz + 4) * e.nnz
    pcg = lambda s, bb, xx, mask: (
        lambda: ell.ell_pcg_amg(s._amg_data, s._Ap_vals, s._ell_q.cols, s._ell_q.widths, bb, xx,
                                rtol, maxiter, mask=mask, amg_widths=s._amg_widths),
        lambda: ell.ell_pcg_amg_plain(s._amg_data, s._Ap_vals, s._ell_q.cols, bb, xx, rtol,
                                      maxiter, mask=mask),
        lambda res: _amg_work(s._amg_data, isz, int(res.iters)))
    return rtol, [
        ("ell_bicgstab", "TGV first step, bc rows",
         lambda: ell.ell_bicgstab(*op, r0, tx0, zmask, tinvd, tbn, rtol, maxiter),
         lambda: ell.ell_bicgstab_plain(vals, ev.cols, r0, tx0, zmask, tinvd, tbn, rtol, maxiter),
         lambda res: (operator_bytes("K15 A_lhs", nnz_bytes(ev), 2 * int(res.iters.max()))
                      + isz * (4 * 3 * n + n), rows(res) * (4.0 * ev.nnz + 20 * n))),
        ("ell_cg", "M, random rhs",
         lambda: ell.ell_cg(vs._M_vals, ev.cols, ev.widths, b, x0, vs._M_invd, bn, rtol,
                            maxiter),
         lambda: ell.ell_cg_plain(vs._M_vals, ev.cols, b, x0, vs._M_invd, bn, rtol, maxiter),
         lambda res: (operator_bytes("K16 M", nnz_bytes(ev), int(res.iters.max()))
                      + isz * (3 * 3 * n + n), rows(res) * (2.0 * ev.nnz + 10 * n))),
        ("ell_cg", "Mq batch 1",
         lambda: ell.ell_cg(Mq_vals, eq.cols, eq.widths, bmq, x0mq, Mq_invd, bnmq, rtol, maxiter),
         lambda: ell.ell_cg_plain(Mq_vals, eq.cols, bmq, x0mq, Mq_invd, bnmq, rtol, maxiter),
         lambda res: (nnz_bytes(eq) + isz * (3 * eq.n + eq.n),
                      rows(res) * (2.0 * eq.nnz + 10 * eq.n))),
        ("ell_cg", f"cylinder res={CYL_RES} Projector batch 2",
         lambda: ell.ell_cg(proj._vals, pe.cols, pe.widths, bpj, x0pj, proj._invd, bnpj, rtol,
                            maxiter),
         lambda: ell.ell_cg_plain(proj._vals, pe.cols, bpj, x0pj, proj._invd, bnpj, rtol,
                                  maxiter),
         lambda res: (nnz_bytes(pe) + isz * (3 * 2 * pe.n + pe.n),
                      rows(res) * (2.0 * pe.nnz + 10 * pe.n))),
        ("ell_pcg_amg", f"Ap nullspace, {len(vs._amg_data[0]['levels']) + 1} levels",
         *pcg(vs, bq, zq, None)),
        ("ell_pcg_amg", f"cylinder res={CYL_RES} Ap, outlet mask", *pcg(cs, bc_q, zc, cmask)),
    ]


# ---------------------------------------------------------------------------
# phase 3d: the band-ELL kernels (K18) on the vessel's operators
# ---------------------------------------------------------------------------


def band_layouts(bv, ev, isz: int) -> dict:
    """One operator in its layouts: S, R, P and pairs a tile; the share of
    the stored lanes that hold a value and the bytes a product reads (the
    stored values, lanes or columns, and the pair tables) in the pair
    layout, in the JAX package's (S, R, 128) layout, in flat ELL, and in the
    real nonzeros."""
    slots, lanes = bv.S * bv.R * 128, bv.P * 128
    return dict(S=bv.S, R=bv.R, P=bv.P, pairs_per_tile=bv.P / bv.R, pair_fill=bv.nnz / lanes,
                pair_bytes=(isz + 1) * lanes + 4 * (bv.R + 1 + bv.P),
                slab_fill=bv.nnz / slots, slab_bytes=(isz + 4) * slots,
                K=ev.K, ell_fill=ev.nnz / (ev.K * ev.n), ell_bytes=(isz + 4) * ev.K * ev.n,
                nnz_bytes=(isz + 4) * ev.nnz)


def band_kernel_cases(pair, device, seed: int = 4):
    """Phase 3d, products: (kernel, label, kernel call, plain call, (bytes,
    operations), library call, {"ell_ms": the same product by K14}) for K18
    at batch 3 on the tentative operator of the initial state and at batch
    1 on Ap.  ``pair`` is (the band-layout solver, whose tables are used;
    the flat-ELL solver whose elements and dtype are used; its initial
    state, or None to read it from that solver) and the Ap band tables."""
    import torch

    from oasisx_tpu_torch.assembly.band import band_values
    from oasisx_tpu_torch.la import band, ell
    from oasisx_tpu_torch.parallel.graph import ell_values

    (bs, es, st), bq = pair
    dtype = es._dtype
    g = torch.Generator().manual_seed(seed)
    rnd = lambda *shape: torch.randn(*shape, generator=g, dtype=torch.float64).to(device, dtype)
    st = st or es._state_from_functions()
    A, _, _ = es._assemble_first(st["u1"], st["u2"], DT, NU)
    bv, ev, eq = bs._band_v, es._ell_v, es._ell_q
    vals, avals = band_values(A, bv), band_values(es._Ap_elems, bq)
    evals = ell_values(A, ev)
    x3, xq = rnd(3, ev.n), rnd(eq.n)
    x3b, xqb = band.to_band(x3, bv), band.to_band(xq, bq)
    isz = torch.empty((), dtype=dtype).element_size()
    work = lambda nnz, n, nb: ((isz + 4) * nnz + isz * 2 * nb * n, 2.0 * nnz * nb)
    timed = dtype == torch.float32 and torch.device(device).type == "cuda"
    lib = dict.fromkeys(("A3", "Ap"))
    if timed:
        A_csr, Ap_csr = ell_csr(evals, ev.cols), ell_csr(es._Ap_vals, eq.cols)
        x3t = x3.T.contiguous()
        lib = dict(A3=lambda: A_csr @ x3t, Ap=lambda: Ap_csr @ xq)
    return [
        ("band_matvec", "A_lhs batch 3",
         lambda: band.band_matvec(vals, *bv.tables, x3b),
         lambda: band.band_matvec_plain(vals, *bv.tables, x3b),
         work(ev.nnz, ev.n, 3), lib["A3"],
         {"ell_ms": lambda: ell.ell_matvec(evals, ev.cols, ev.widths, x3)}),
        ("band_matvec", "Ap batch 1",
         lambda: band.band_matvec(avals, *bq.tables, xqb),
         lambda: band.band_matvec_plain(avals, *bq.tables, xqb),
         work(eq.nnz, eq.n, 1), lib["Ap"],
         {"ell_ms": lambda: ell.ell_matvec(es._Ap_vals, eq.cols, eq.widths, xq)}),
    ]


def band_solve_cases(pair, device, seed: int = 5):
    """Phase 3d, solves: K18's BiCGStab on the vessel's first tentative
    system with its bc rows and K18's CG on M with a random rhs, in band
    form; each with the same solve by K15 / K16 on the flat ELL form.
    ``pair`` as band_kernel_cases's first item."""
    import torch

    from oasisx_tpu_torch.assembly.band import band_values
    from oasisx_tpu_torch.la import band, ell
    from oasisx_tpu_torch.parallel.graph import ell_values

    bs, es, st = pair
    dtype = es._dtype
    rtol = SOLVE_RTOL[str(dtype).replace("torch.", "")]
    maxiter = 2000
    g = torch.Generator().manual_seed(seed)
    rnd = lambda *shape: torch.randn(*shape, generator=g, dtype=torch.float64).to(device, dtype)
    isz = torch.empty((), dtype=dtype).element_size()
    bv, ev = bs._band_v, es._ell_v
    n = ev.n
    tb = lambda t, fill=0.0: band.to_band(t, bv, fill)

    st = st or es._state_from_functions()
    u1, u2 = st["u1"], st["u2"]
    A, _, b_first = es._assemble_first(u1, u2, DT, NU)
    vals, evals = band_values(A, bv), ell_values(A, ev)
    diag = es._tentative_diag(A, None, DT, NU)
    bc, masks, zmask = es._bc_values(), es._bc_masks, es._zmask
    rhs = torch.where(masks, bc, b_first + es._pressure_gradient(st["p"]))
    tx0 = torch.where(masks, bc, 2.0 * u1 - u2)
    tinvd = torch.where(diag != 0, 1.0 / diag, 1.0)
    tbn = torch.linalg.vector_norm(rhs, dim=-1)
    er0 = zmask * (rhs - ell.ell_matvec_plain(evals, ev.cols, tx0))
    zb, xb, ivb = tb(zmask), tb(tx0), tb(tinvd, 1.0)
    r0 = zb * (tb(rhs) - band.band_matvec_plain(vals, *bv.tables, xb))

    Mb = band_values(es._M_elems, bv)
    b = rnd(3, n)
    bb, x0b, Mivb = tb(b), torch.zeros((3, bv.R * 128), dtype=dtype, device=device), \
        tb(es._M_invd, 1.0)
    bn = torch.linalg.vector_norm(b, dim=-1)
    rows = lambda res: float(res.iters.sum())
    nnz_bytes = (isz + 4) * ev.nnz
    args = (vals, *bv.tables)
    margs = (Mb, *bv.tables)
    return rtol, [
        ("band_bicgstab", "TGV first step, bc rows",
         lambda: band.band_bicgstab(*args, r0, xb, zb, ivb, tbn, rtol, maxiter),
         lambda: band.band_bicgstab_plain(*args, r0, xb, zb, ivb, tbn, rtol, maxiter),
         lambda res: (operator_bytes("K18 A_lhs", nnz_bytes, 2 * int(res.iters.max()))
                      + isz * (4 * 3 * n + n), rows(res) * (4.0 * ev.nnz + 20 * n)),
         {"ell_ms": lambda: ell.ell_bicgstab(evals, ev.cols, ev.widths, er0, tx0, zmask, tinvd,
                                             tbn, rtol, maxiter)}),
        ("band_cg", "M, random rhs",
         lambda: band.band_cg(*margs, bb, x0b, Mivb, bn, rtol, maxiter),
         lambda: band.band_cg_plain(*margs, bb, x0b, Mivb, bn, rtol, maxiter),
         lambda res: (operator_bytes("K18 M", nnz_bytes, int(res.iters.max()))
                      + isz * (3 * 3 * n + n), rows(res) * (2.0 * ev.nnz + 10 * n)),
         {"ell_ms": lambda: ell.ell_cg(es._M_vals, ev.cols, ev.widths, b, torch.zeros_like(b),
                                       es._M_invd, bn, rtol, maxiter)}),
    ]


# ---------------------------------------------------------------------------
# phases 4, 4b, 4c, 4d, 4e, 5, 5b, 5c
# ---------------------------------------------------------------------------


def drive_main_path(solver, warmup: int, steps: int, device, kernels, dt=DT, nu=NU) -> dict:
    """Warm-up steps, reset counters, timed steps; fails unless the run mode
    is "graph" (the warm-up captures the step, the timed steps replay it),
    every kernel of ``kernels`` launched, no plain version ran, every solve
    converged and (on the card) no step read the host."""
    import numpy as np
    import torch

    from oasisx_tpu_torch.assembly import kernels as kn

    mode = solver.config_report().get("run")  # None: --tree's package from before the graph run
    check(mode == "graph" or (OTHER_TREE and mode is None),
          f"run mode {mode!r} on a single-device default path, not graph")
    solver.run(warmup, dt, nu, max_iter=1)
    _sync(device)
    kn.reset_counts()
    t0 = time.perf_counter()
    stats = solver.run(steps, dt, nu, max_iter=1)
    _sync(device)
    wall = time.perf_counter() - t0
    launches = dict(kn.launches)
    plain = dict(kn.plain_calls)
    u = np.stack([f.x.array.detach().cpu().numpy() for f in solver._u])
    check(np.isfinite(u).all(), "velocity is not finite")
    for fam in ("u", "p", "c"):
        check(bool(np.all(stats[f"{fam}_converged"])), f"a {fam} solve did not converge")
    for name in kernels:
        check(launches[name] > 0, f"kernel {name} was not launched on the main path")
    for name, calls in plain.items():
        check(calls == 0, f"plain {name} ran on the main path ({calls} calls)")
    if torch.device(device).type == "cuda":
        check(bool(np.all(stats["host_syncs"] == 0)),
              f"host reads inside the steps: {stats['host_syncs'].tolist()}")
    return dict(stats=stats, wall=wall, launches=launches, plain=plain,
                state_sha=state_sha(solver))


class StepLog:
    """Per main path (phase tag): every timed step's u / p / c iterations
    and a hash of the final velocity and pressure, written to
    build/chip_smoke_steps_<role>.json beside this file; role "this" for
    this checkout's run, "tree" for another checkout's run under --tree.
    Only a --tree run compares: where this checkout's file holds the same
    tag, the iterations must be equal step for step (the state hashes are
    printed, equal or not).  A plain run only writes its file, so no file
    left by an earlier run decides whether it passes."""

    def __init__(self, role: str):
        import os

        d = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
        os.makedirs(d, exist_ok=True)
        self.path = os.path.join(d, f"chip_smoke_steps_{role}.json")
        other = os.path.join(d, "chip_smoke_steps_this.json")
        self.other = {}
        if role == "tree" and os.path.exists(other):
            with open(other) as f:
                self.other = json.load(f)
        self.data: dict = {}
        print(f"[steps] logging to {self.path}; comparing with "
              f"{other if self.other else 'nothing'}")

    def add(self, tag: str, res: dict, state_sha: str | None) -> None:
        import numpy as np

        st = res["stats"]
        rec = {f: np.asarray(st[f"{f}_iters"]).tolist() for f in ("u", "p", "c")}
        rec.update({f"{f}_res": np.asarray(st[f"{f}_res"]).tolist() for f in ("u", "p", "c")})
        rec["state_sha"] = state_sha
        self.data[tag] = rec
        with open(self.path, "w") as f:
            json.dump(self.data, f)
        ref = self.other.get(tag)
        if ref is None:
            return
        same = {f: ref[f] == rec[f] for f in ("u", "p", "c")}
        print(f"    [{tag}] iterations of every step equal to the other tree's: {same}; final "
              f"state bit-identical: {ref.get('state_sha') == state_sha}")
        for f in ("u", "p", "c"):  # each step that differs: both trees' iterations and residuals
            for k, (a, b) in enumerate(zip(ref[f], rec[f])):
                if a != b:
                    print(f"    [{tag}] step {k} {f}: iterations {a} (this checkout) / {b} "
                          f"(the other tree), exit residuals {ref.get(f'{f}_res', [None] * (k + 1))[k]}"
                          f" / {rec[f'{f}_res'][k]}")
        check(all(same.values()), f"[{tag}] iterations differ from the other tree's: {same}")

    def report_skipped(self) -> None:
        """The phases of this checkout's log that the other tree did not run."""
        skipped = [t for t in self.other if t not in self.data]
        print(f"[steps] compared phases {[t for t in self.data if t in self.other]}; not run by "
              f"the other tree, so not compared: {skipped}")



def state_sha(solver) -> str:
    """A hash of the solver's velocity and pressure arrays."""
    import hashlib

    h = hashlib.sha256()
    for f in (*solver._u, solver._p):
        h.update(f.x.array.detach().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def check_lumped(tag: str, res: dict, steps: int, rtol: float, per_step: dict) -> None:
    """A lumped-update path's run: c iterations 0 every step, every u and p
    exit residual at most rtol, and the launches a step of ``per_step``."""
    import numpy as np

    st = res["stats"]
    check(bool(np.all(st["c_iters"] == 0)), f"[{tag}] a lumped update iterated")
    for f in ("u", "p"):
        worst = float(np.max(st[f"{f}_res"]))
        check(worst <= rtol, f"[{tag}] {f} exit residual {worst:.3e} above rtol {rtol:g}")
    got = {k: res["launches"][k] / steps for k in per_step}
    print(f"    [{tag}] launches a step {got} (expected {per_step}); c iterations 0 every step; "
          f"worst exit residuals u {float(np.max(st['u_res'])):.3e} p "
          f"{float(np.max(st['p_res'])):.3e} (rtol {rtol:g})")
    check(got == {k: float(v) for k, v in per_step.items()},
          f"[{tag}] launches a step {got}, not {per_step}")


def check_rotational(tag: str, res: dict, steps: int, rtol: float, base: dict,
                     per_step: dict) -> None:
    """A rotational path's run: every rotational solve converged, its exit
    residual at most rtol, and a step's launches those of the same path
    without the update (``base``, the launches of its run of as many steps)
    and ``per_step`` more; every other kernel's equal."""
    import numpy as np

    st = res["stats"]
    check(bool(np.all(st["rot_converged"])), f"[{tag}] a rotational solve did not converge")
    worst = float(np.max(st["rot_res"]))
    check(worst <= rtol, f"[{tag}] rotational exit residual {worst:.3e} above rtol {rtol:g}")
    names = set(base) | set(res["launches"])
    more = {k: (res["launches"].get(k, 0) - base.get(k, 0)) / steps for k in sorted(names)}
    want = {k: float(per_step.get(k, 0)) for k in more}
    print(f"    [{tag}] rotational solve iterations a step {float(st['rot_iters'].mean()):.3f} "
          f"(max {int(st['rot_iters'].max())}), worst exit residual {worst:.3e} (rtol {rtol:g}); "
          f"launches a step more than without the update: "
          f"{ {k: v for k, v in more.items() if v} } (expected {per_step})")
    check(more == want, f"[{tag}] launches a step {more}, not the base's and {per_step}")


def report_path(tag: str, res: dict, steps: int, ndofs: int, smi: str, tpu_era: dict,
                log: StepLog | None = None) -> None:
    if log is not None:
        log.add(tag, res, res["state_sha"])
    st = res["stats"]
    sps = steps / res["wall"]
    mean = lambda k: float(st[k].sum(axis=-1).mean()) if st[k].ndim > 1 else float(st[k].mean())
    kmax = lambda k: float(st[k].max(axis=-1).mean()) if st[k].ndim > 1 else float(st[k].mean())
    used = {k: v for k, v in res["launches"].items() if v}
    print(f"[{tag}] {steps} steps in {res['wall']:.3f} s = {sps:.4f} steps/s "
          f"({ndofs * sps / 1e6:.3f} MDOF-updates/s) on {smi}")
    era = f"; TPU-era reference (per-component means): {tpu_era}" if tpu_era else ""
    print(f"    per step mean iterations (summed over components): u {mean('u_iters'):.3f} "
          f"p {mean('p_iters'):.3f} c {mean('c_iters'):.3f}{era}")
    print(f"    per-component means: u {float(st['u_iters'].mean()):.3f} "
          f"c {float(st['c_iters'].mean()):.3f}; K4's iterations a step (its rows run "
          f"together until the last converges): {kmax('c_iters'):.3f}")
    print(f"    worst exit residuals: u {float(st['u_res'].max()):.3e} "
          f"p {float(st['p_res'].max()):.3e} c {float(st['c_res'].max()):.3e}")
    print(f"    host syncs per step: {float(st['host_syncs'].mean()):.2f} in the steps "
          f"(+1 stats read per run call); launches {used} "
          f"({sum(used.values()) / steps:.2f} a step); plain calls "
          f"{ {k: v for k, v in res['plain'].items() if v} }")


def profile_steps(solver, steps: int, path: str, top: int = 20, max_iter: int = 1,
                  max_error: float = 1e-12) -> dict:
    """torch.profiler over ``steps`` more main-path steps (at ``max_iter``
    and ``max_error``), its trace written to ``path`` (none where empty);
    returns the device's busy share and its kernels a step."""
    import os

    import torch
    from torch.profiler import ProfilerActivity, profile

    _sync("cuda")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        stats = solver.run(steps, DT, NU, max_iter=max_iter, max_error=max_error)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    from torch.autograd import DeviceType

    # device-side events only: a CPU op's device time repeats its kernels'
    ka = prof.key_averages()
    dev = sorted((e for e in ka if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0),
                 key=lambda e: -e.self_device_time_total)
    busy = sum(e.self_device_time_total for e in dev)
    count = sum(e.count for e in dev)
    print(f"  profile: {steps} steps, wall {wall_us / 1e3:.3f} ms, device busy "
          f"{busy / 1e3:.3f} ms ({100 * busy / wall_us:.1f}%), idle {100 - 100 * busy / wall_us:.1f}%, "
          f"{count / steps:.1f} device kernels a step")
    # a whole solve's kernel time over its iterations needs these steps' own counts
    print("    iterations a step in these steps (the slowest row): " + ", ".join(
        f"{f} {float(stats[f'{f}_iters'].reshape(steps, -1).max(axis=-1).mean()):.2f}"
        for f in ("u", "p", "c")))
    for e in dev[:top]:
        print(f"    {e.self_device_time_total / 1e3:9.3f} ms {e.count:7d} x  {e.key[:90]}")
    if path:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        prof.export_chrome_trace(path)
    return dict(busy=busy / wall_us, kernels=count / steps)


def graph_leg(solver, tag: str, smi: str, steps: int = STEPS, windows: int = GRAPH_WINDOWS,
              dt=DT, nu=NU, max_iter: int = 1, max_error: float = 1e-12,
              loops: bool | None = None) -> dict:
    """The graph leg of a main path: from one saved state, ``windows``
    pairs of ``steps`` steps at ``max_iter`` / ``max_error`` through
    ``run``'s per-step loop (``_force_eager``) and through its CUDA graph,
    in turns.  Fails unless every graph window's iterations (u, p, c and
    the inner ones) equal the eager window's at every step, its final state
    is bit for bit the eager one's (or, where two eager windows already
    differ, within GRAPH_F32_BOUND), its launches a step are equal (the
    device while loops' condition setter, ``graph_loop``, launches in the
    graph only), the host's work a step is one replay, and the replays ran
    under ``torch.cuda.set_sync_debug_mode("error")``.  ``loops``: whether
    the graph holds device while loops (conditional nodes; default: with
    ``max_iter`` > 1): with none, no condition setter ran.  Prints both
    steps/s (the median window), their ratio, the loops and their
    condition setter's launches, and a profile of 10 graph steps."""
    import numpy as np
    import torch

    from oasisx_tpu_torch.assembly import kernels as kn

    loops = max_iter > 1 if loops is None else loops
    run = lambda n: solver.run(n, dt, nu, max_iter=max_iter, max_error=max_error)
    check(solver.config_report()["run"] == "graph",
          f"[{tag}] run mode {solver.config_report()['run']!r}, not graph")
    st0 = {k: v.clone() for k, v in solver._state_from_functions().items()}
    run(1)  # the graph of this key, captured before the windows
    graph = solver._graph
    nloops = len(getattr(graph, "loops", ()))  # a --tree package from before the loops: none
    check((nloops > 0) == loops, f"[{tag}] {nloops} device while loops in the graph, expected "
          f"{'some' if loops else 'none'}")
    res = {"eager": [], "graph": []}
    for _ in range(windows):
        for mode in ("eager", "graph"):
            solver._force_eager = mode == "eager"
            solver._set_device_state({k: v.clone() for k, v in st0.items()})
            replays = graph.replays
            _sync("cuda")
            kn.reset_counts()
            t0 = time.perf_counter()
            if mode == "graph":
                torch.cuda.set_sync_debug_mode("error")
            try:
                stats = run(steps)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            _sync("cuda")
            wall = time.perf_counter() - t0
            check(solver._graph is graph, f"[{tag}] the {mode} window replaced the graph")
            if mode == "graph":
                check(graph.replays - replays == steps,
                      f"[{tag}] {graph.replays - replays} replays for {steps} steps")
            state = {k: v.detach().cpu().numpy() for k, v in solver._state.items()}
            res[mode].append(dict(stats=stats, wall=wall, launches=dict(kn.launches),
                                  sha=state_sha(solver), state=state))
    solver._force_eager = False
    e0 = res["eager"][0]
    reproducible = all(r["sha"] == e0["sha"] for r in res["eager"])
    worst = {"u": 0.0, "p": 0.0}
    setter = lambda r: r["launches"].get("graph_loop", 0)
    others = lambda r: {k: v for k, v in r["launches"].items() if k != "graph_loop"}
    for e, g in zip(res["eager"], res["graph"]):
        for f in ("u_iters", "p_iters", "c_iters", "inner_iters"):
            check(np.array_equal(e["stats"][f], g["stats"][f]),
                  f"[{tag}] {f} of the graph differ from the eager loop's")
        check(others(e) == others(g),
              f"[{tag}] launches: graph {g['launches']}, eager {e['launches']}")
        check(setter(e) == 0 and (setter(g) > 0) == loops,
              f"[{tag}] condition setter launches: graph {setter(g)}, eager {setter(e)}")
        for f, keys in (("u", ("u", "u1", "u2")), ("p", ("p", "dp"))):
            ref = np.concatenate([e["state"][k].ravel() for k in keys])
            got = np.concatenate([g["state"][k].ravel() for k in keys])
            worst[f] = max(worst[f], float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30)))
        if reproducible:
            check(g["sha"] == e["sha"], f"[{tag}] graph state {g['sha']} against eager {e['sha']}")
    if not reproducible:
        check(all(worst[f] <= GRAPH_F32_BOUND[f] for f in worst),
              f"[{tag}] eager runs from one state differ; graph against eager {worst}, bound "
              f"{GRAPH_F32_BOUND}")
    sps = {m: steps / float(np.median([r["wall"] for r in res[m]])) for m in res}
    per_step = {k: v / steps for k, v in others(res["graph"][0]).items() if v}
    inner = np.asarray(res["graph"][0]["stats"]["inner_iters"])
    print(f"[{tag}] graph leg, max_iter {max_iter}, max_error {max_error:.6g}, {windows} x "
          f"{steps} steps a mode from one state on {smi}: eager {sps['eager']:.4f} steps/s, graph "
          f"{sps['graph']:.4f} steps/s (x{sps['graph'] / sps['eager']:.4f}; windows eager "
          f"{[round(steps / r['wall'], 2) for r in res['eager']]}, graph "
          f"{[round(steps / r['wall'], 2) for r in res['graph']]})")
    print(f"    iterations (u, p, c, inner) equal at every step; launches a step equal "
          f"{per_step}; one replay a step under sync debug mode 'error'; eager windows "
          f"bit-reproducible {reproducible}; final state graph against eager: bit-identical "
          f"{all(e['sha'] == g['sha'] for e, g in zip(res['eager'], res['graph']))}, worst rel "
          f"diff u {worst['u']:.3e} p {worst['p']:.3e}")
    print(f"    device while loops in the graph {nloops}; condition setter launches a step "
          f"{setter(res['graph'][0]) / steps:.2f}; inner iterations a step {inner.tolist()}; "
          f"host reads a step in the eager windows "
          f"{float(np.mean(res['eager'][0]['stats']['host_syncs'])):.2f}")
    solver._set_device_state({k: v.clone() for k, v in st0.items()})
    prof = profile_steps(solver, 10, "", top=8, max_iter=max_iter, max_error=max_error)
    return dict(sps=sps, busy=prof["busy"], reproducible=reproducible, inner=inner,
                setter=setter(res["graph"][0]), loops=nloops)


LOOP_STEPS = 10  # the option solves' graph legs (4u, 4v): steps a window


def loop_legs(solver, smi: str) -> dict:
    """Phases 4t, 4u and 4v: graph legs whose step holds device while
    loops (conditional WHILE nodes, la/device_loop.py), each under every
    ``graph_leg`` check.  4t: phase 4's solver (``solver``) at max_iter 3,
    then with a max_error that ends some inner loops after 2 iterations
    (the larger of step 1's and the median of 5 steps' diff after 2, from
    the same state: step 1 ends there).  4u: the vessel at N=36 with the
    tentative ksp_type gmres (the restart loop and its Arnoldi steps, a
    component at a time on K14) and the pressure pc_type jacobi (CG on
    K14).  4v: the N=36 box with the tentative ksp_type cg (batched CG on
    K3).  Returns 4t's condition-setter launches (the kernel line's)."""
    import numpy as np
    import torch

    out = {}
    t0 = time.perf_counter()
    out["4t"] = graph_leg(solver, "4t", smi, max_iter=3)
    st = {k: v.clone() for k, v in solver._state_from_functions().items()}
    d2 = solver.run(5, DT, NU, max_iter=2)["diff"]
    max_error = max(float(d2[0]), float(np.median(d2)))
    solver._set_device_state({k: v.clone() for k, v in st.items()})
    early = graph_leg(solver, "4t", smi, max_iter=3, max_error=max_error)
    check(bool((early["inner"] < 3).any()), f"[4t] max_error {max_error}: no inner loop ended "
          f"early ({early['inner'].tolist()})")
    print(f"[4t] {time.perf_counter() - t0:.1f} s; diffs after 2 inner iterations "
          f"{np.asarray(d2).tolist()}")
    for tag, kw, want in (
            ("4u", dict(vessel=True, tentative={"ksp_type": "gmres"},
                        pressure={"pc_type": "jacobi"}), ("gmres", "jacobi-pcg")),
            ("4v", dict(tentative={"ksp_type": "cg"}), ("cg", "mg-pcg"))):
        t0 = time.perf_counter()
        s = tgv_solver(N, torch.float32, "cuda", rtol=1e-5, **kw)
        rep = s.config_report()
        print(f"[{tag}] setup N={N}: {time.perf_counter() - t0:.1f} s; tentative "
              f"{rep['tentative_method']}, pressure {rep['pressure_pc']}, run {rep['run']}")
        check((rep["tentative_method"], rep["pressure_pc"]) == want, f"[{tag}] {rep}")
        out[tag] = graph_leg(s, tag, smi, steps=LOOP_STEPS, loops=True)
        print(f"[{tag}] {time.perf_counter() - t0:.1f} s")
        del s
        torch.cuda.empty_cache()
    return out


def loop_probe(trips: int = 1000) -> dict:
    """The device while loop alone (la/device_loop.py, its condition setter
    csrc/graph_loop.cu), captured outside a solver: three loops nested,
    the innermost stopping on a norm, against the same loops uncaptured
    (the plain version, a Python loop that reads the condition a trip):
    equal results and trips; then one loop of ``trips`` trips whose body
    adds 1 to a counter: its device time a trip (the body, the trip
    counter, the condition and its setter) against the Python loop's host
    time a trip, printed; and the condition setter alone, its device time
    a launch from torch.profiler over one replay (``trips`` + 1 launches)
    against the plain version's, one host read of the condition.  Returns
    the kernel line's record (``replaces`` None: no Pallas kernel; XLA ran
    the TPU's loops without one)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from oasisx_tpu_torch.assembly import kernels as kn
    from oasisx_tpu_torch.la import device_loop as dl

    dev = torch.device("cuda", torch.cuda.current_device())
    i32 = lambda v: torch.full((), v, dtype=torch.int32, device=dev)

    def nested():
        x = torch.linspace(1.0, 3.0, 256, dtype=torch.float64, device=dev)

        def b1(x, a):
            def b2(x, b):
                (x,), _ = dl.while_loop(lambda x: torch.linalg.vector_norm(x) > 1.0,
                                        lambda x: (0.5 * x + 0.01 * torch.dot(x, x) / 256.0,), (x,))
                return 4.0 * x, b + 1
            (x, b), _ = dl.while_loop(lambda x, b: b < 3, b2, (x, i32(0)))
            return x, a + 1
        (x, a), _ = dl.while_loop(lambda x, a: a < 2, b1, (x, i32(0)))
        return x

    def captured(fn):
        graph, pool = torch.cuda.CUDAGraph(), torch.cuda.graph_pool_handle()
        with kn.RecordedCounts(), dl.capturing(pool, dev) as cap:
            with torch.cuda.graph(graph, pool=pool, capture_error_mode="thread_local"):
                out = fn()
        cap.trips.zero_()
        return graph, out, cap

    ref = nested()  # the Python loops
    graph, got, cap = captured(nested)
    graph.replay()
    torch.cuda.synchronize()
    err = float((got - ref).abs().max())
    nested_trips = [int(t) for _, t in cap.loops]
    print(f"[4t] nested conditional WHILE nodes (3 deep; cuBLAS dots and a norm test in the "
          f"innermost body): against the Python loops max abs err {err:.3e}; trips a loop "
          f"{nested_trips} (outermost first)")
    check(err == 0.0 and nested_trips[:2] == [2, 6] and nested_trips[2] > 6,
          f"[4t] nested loops: err {err}, trips {nested_trips}")
    del graph, got, cap

    count = lambda: dl.while_loop(lambda k: k < trips, lambda k: (k + 1,), (i32(0),))[0][0]
    graph, k, cap = captured(count)
    graph.replay()
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    graph.replay()
    e1.record()
    torch.cuda.synchronize()
    trip_ms = e0.elapsed_time(e1) / trips
    t0 = time.perf_counter()
    kp = count()
    torch.cuda.synchronize()
    trip_plain_ms = (time.perf_counter() - t0) * 1e3 / trips
    check(int(k) == int(kp) == trips, f"[4t] counter loop: {int(k)}, {int(kp)}")
    print(f"    a loop of {trips} trips adding 1 to a counter: {trip_ms * 1e3:.3f} us a trip on "
          f"the device (a graph replay), {trip_plain_ms * 1e3:.3f} us a trip in the Python loop "
          f"(a host read a trip)")
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        graph.replay()
        torch.cuda.synchronize()
    setter = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and "set_cond_kernel" in e.key]
    n = sum(e.count for e in setter)
    check(n == trips + 1, f"[4t] the profile of a replay holds {n} condition setter launches, "
          f"not {trips + 1}")
    ms = sum(e.self_device_time_total for e in setter) / n / 1e3
    flag = k < trips
    t0 = time.perf_counter()
    for _ in range(trips):
        bool(flag)
    plain_ms = (time.perf_counter() - t0) * 1e3 / trips
    print(f"    the condition setter alone (torch.profiler over a replay, {n} launches): "
          f"{ms * 1e3:.3f} us a launch on the device; its plain version, a host read of the "
          f"condition: {plain_ms * 1e3:.3f} us")
    return dict(name="graph_loop", route="cuda", source=CSRC + "graph_loop.cu", replaces=None,
                max_abs_err=err, ms=ms, plain_ms=plain_ms, **bound(1.0, 0.0), library_ms=None)


def gpu_vs_cpu(make, label: str, steps: int = 3, dt=DT, nu=NU, pressure_pc=None,
               run: str = "graph") -> None:
    """The same problem on cuda and on cpu from the same state, float64:
    equal iterations, u and p to 1e-10 relative; with ``pressure_pc``, the
    pressure method both solvers report; ``run``, the run mode both report
    ("graph", or "eager" with its reason).  A Chebyshev pressure solve on the
    general path runs on the cpu solver's bounds on both devices (each
    device's power iteration rounds in its own way); the host reads a step
    are printed for each device."""
    import numpy as np
    import torch

    solvers = {dev: make(torch.float64, dev) for dev in ("cpu", "cuda")}
    cheb = solvers["cpu"].config_report().get("pressure_cheb")
    if cheb is not None and not solvers["cpu"]._structured:
        solvers["cuda"]._p_cheb.update(lmin=cheb["lmin"], lmax=cheb["lmax"])
    runs = {}
    for dev in ("cuda", "cpu"):
        s = solvers[dev]
        pc, mode = s.config_report()["pressure_pc"], s.config_report()["run"]
        check(pressure_pc in (None, pc), f"{label} on {dev}: pressure {pc}, not {pressure_pc}")
        check(mode.split(":")[0] == run, f"{label} on {dev}: run mode {mode!r}, not {run}")
        st = s.run(steps, dt, nu, max_iter=1)
        u = np.stack([f.x.array.detach().cpu().numpy() for f in s._u])
        p = s._p.x.array.detach().cpu().numpy()
        runs[dev] = (u, p, st)
    del solvers
    (ug, pg, sg), (uc, pc, sc) = runs["cuda"], runs["cpu"]
    du = np.abs(ug - uc).max() / np.abs(uc).max()
    dp = np.abs(pg - pc).max() / np.abs(pc).max()
    print(f"  {label} f64 {steps} steps: u rel diff {du:.3e}, p rel diff {dp:.3e}; host reads a "
          f"step cuda {sg['host_syncs'].tolist()}, cpu {sc['host_syncs'].tolist()}; run {mode}")
    for k in ("u_iters", "p_iters", "c_iters", "rot_iters"):
        if k not in sc:
            continue
        print(f"  {k}: cuda {sg[k].tolist()} cpu {sc[k].tolist()}")
        check(np.array_equal(sg[k], sc[k]), f"{label}: {k} differ between cuda and cpu")
    check(du <= 1e-10 and dp <= 1e-10, f"{label}: cuda and cpu disagree (u {du:.3e}, p {dp:.3e})")


def options_gpu_vs_cpu() -> None:
    """Phase 5e: the options off the default configurations, cuda against
    cpu in float64, 3 steps each (gpu_vs_cpu's checks): the lumped update on
    both paths, the general path's Jacobi and Chebyshev pressure solves and
    its CG and GMRES tentative solves, the band layout with GMRES; on the
    vessel at N=6 and on the 2D rectangle of 6x6 cells sent to the general
    path (CG on the tentative system, which is not symmetric, converges on
    the vessel and stalls on the rectangle's second step, in both
    packages)."""
    lumped, gmres = {"pc_type": "lumped"}, {"ksp_type": "gmres"}
    rect = {"structured": False, "low_memory_version": False}
    cases = (
        ("N=6 lumped (structured)", 6, dict(scalar=lumped), "mg-pcg", "graph"),
        ("vessel N=6 lumped", 6, dict(vessel=True, scalar=lumped), "amg-pcg-fused", "graph"),
        ("vessel N=6 pc_type jacobi, ksp_type cg", 6,
         dict(vessel=True, pressure={"pc_type": "jacobi"}, tentative={"ksp_type": "cg"}),
         "jacobi-pcg", "graph"),
        ("vessel N=6 pc_type cheb", 6, dict(vessel=True, pressure={"pc_type": "cheb"}),
         "cheb-pcg", "graph"),
        ("rectangle 6x6 general, ksp_type gmres, pc_type cheb, lumped", (6, 6),
         dict(options=rect, tentative=gmres, pressure={"pc_type": "cheb"}, scalar=lumped),
         "cheb-pcg", "graph"),
        ("vessel N=6 band, ksp_type gmres", 6, dict(vessel=True, layout="band", tentative=gmres),
         "amg-pcg-fused", "graph"),
    )
    for label, n, kw, pc, run in cases:
        gpu_vs_cpu(lambda dt, dev: tgv_solver(n, dt, dev, rtol=1e-8, **kw), label, pressure_pc=pc,
                   run=run)


def rotational_gpu_vs_cpu() -> None:
    """Phase 5f, the solver: the rotational update and a callable body
    force on the structured path (N=6 box) and the general path (N=6
    vessel), cuda against cpu in float64, 3 steps each (gpu_vs_cpu's
    checks, the rotational solves' iterations too)."""
    import numpy as np

    force = (lambda x: np.sin(np.pi * x[0]) * x[1], 0.25, lambda x: 0.5 * x[2] ** 2)
    for label, kw in (("N=6 rotational", dict(rotational=True)),
                      ("vessel N=6 rotational", dict(vessel=True, rotational=True)),
                      ("N=6 callable body force", dict(body_force=force)),
                      ("vessel N=6 callable body force", dict(vessel=True, body_force=force))):
        gpu_vs_cpu(lambda dt, dev: tgv_solver(6, dt, dev, rtol=1e-8, **kw), label)


def forms_gpu_vs_cpu(steps: int = 3) -> None:
    """Phase 5f, the forms: on the res=10 cylinder's state after ``steps``
    steps, the Projector of grad(p) into vector P1 with a Dirichlet BC (its
    CG one K16 launch on the card), the LumpedProject of |u|^2 into P1, the
    force on the cylinder (-surface_traction) and assemble_scalar of |u|^2,
    cuda against cpu in float64: 1e-10 relative, the projections' reasons
    equal."""
    import numpy as np
    import torch

    from oasisx_tpu_torch import DirichletBC, LocatorMethod, LumpedProject, Projector
    from oasisx_tpu_torch.assembly import kernels as kn
    from oasisx_tpu_torch.assembly.facets import build_facet_context, surface_traction
    from oasisx_tpu_torch.forms.expr import as_expr, assemble_scalar, grad, inner
    from oasisx_tpu_torch.spaces import FunctionSpace

    f64, out = torch.float64, {}
    for dev in ("cuda", "cpu"):
        s = cylinder_solver(10, f64, dev, rtol=1e-8)
        s.run(steps, CYL_DT, CYL_NU, max_iter=1)
        mesh = s._mesh
        bc = DirichletBC(0.0, LocatorMethod.GEOMETRICAL, lambda x: np.isclose(x[0], 0.0))
        kn.reset_counts()
        proj = Projector(grad(s._p), FunctionSpace(mesh, ("Lagrange", 1), shape=(2,)), bcs=[bc],
                         petsc_options={"ksp_rtol": 1e-12}, dtype=f64, device=dev)
        reason = proj.solve()
        if dev == "cuda":
            check(kn.launches["ell_cg"] == 1 and kn.launches["ell_matvec"] == 1,
                  f"the Projector's solve launched {dict(kn.launches)}")
        u = as_expr(s.u)
        lumped = LumpedProject(inner(u, u), FunctionSpace(mesh, ("Lagrange", 1)), dtype=f64,
                               device=dev)
        lumped.solve()
        fctx = build_facet_context(mesh, s._V.element, s._Q.element, cylinder_facets(mesh),
                                   s._Vi[0][0].dofmap.cell_dofs, f64, dev)
        st = s._state_from_functions()
        out[dev] = dict(
            reason=reason, projection=proj.x.x.array, lumped=lumped.x.x.array,
            force=-surface_traction(s._ctx, fctx, st["u"], st["p"], CYL_NU),
            energy=assemble_scalar(mesh, inner(u, u), dtype=f64, device=dev))
    g, c = out["cuda"], out["cpu"]
    check(g.pop("reason") == c.pop("reason") == 2, "the Projector did not converge on both")
    for key in g:
        a, b = g[key].cpu().numpy(), c[key].numpy()
        rel = float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))
        print(f"  cylinder res=10 {key}: cuda against cpu rel diff {rel:.3e}"
              + (f", {a.tolist()}" if a.size <= 2 else ""))
        check(rel <= 1e-10, f"{key}: cuda and cpu disagree ({rel:.3e})")


def cylinder_transient(device, smi: str, steps: int = 25, dt=CYL_DT, nu=CYL_NU) -> None:
    """Phase 4c': the cylinder with the DFG 2D-3 inflow, peak U(t) = 1.5
    sin(pi t / 8): ``run`` over ``steps`` steps with the boundary values from
    ``bc_value_table`` and a step_callback of the kinetic energy and the
    force on the cylinder (``-surface_traction``, on the device), against
    ``steps`` ``solve`` calls that re-evaluate the inflow each step;
    float32.  Cd and Cl of every step, demo/cylinder.py's normalisation
    2 F / (Ubar^2 D) with Ubar = 2/3 of the inflow's peak (1 for DFG 2D-3)."""
    import numpy as np
    import torch

    from oasisx_tpu_torch.assembly import engine as eng
    from oasisx_tpu_torch.assembly.facets import build_facet_context, surface_traction

    clock = {"t": 0.0}
    um = lambda: DFG3_UM * np.sin(np.pi * clock["t"] / 8.0)
    a = cylinder_solver(CYL_RES, torch.float32, device, rtol=1e-5, um=um)
    b = cylinder_solver(CYL_RES, torch.float32, device, rtol=1e-5, um=um)
    times = [(k + 1) * dt for k in range(steps)]
    table = a.bc_value_table(times, update=lambda t: clock.update(t=t))
    fctx = build_facet_context(a._mesh, a._V.element, a._Q.element, cylinder_facets(a._mesh),
                               a._Vi[0][0].dofmap.cell_dofs, a._dtype, device)

    def monitor(st, t):
        return dict(ke=0.5 * (st["u"] * eng.matvec_v(a._ctx, a._M_elems, st["u"])).sum(),
                    F=-surface_traction(a._ctx, fctx, st["u"], st["p"], nu))

    _sync(device)
    t0 = time.perf_counter()
    stats = a.run(steps, dt, nu, max_iter=1, bc_vals_seq=table, step_callback=monitor)
    _sync(device)
    wall = time.perf_counter() - t0
    for t in times:
        clock["t"] = t
        b.solve(dt, nu, max_iter=1)
    ua, ub = (np.stack([f.x.array.detach().cpu().numpy() for f in s._u]) for s in (a, b))
    pa, pb = (s._p.x.array.detach().cpu().numpy() for s in (a, b))
    du = np.abs(ua - ub).max() / np.abs(ub).max()
    dp = np.abs(pa - pb).max() / max(np.abs(pb).max(), 1e-30)
    ke, F = stats["callback"]["ke"], stats["callback"]["F"]
    scale = 2.0 / ((2.0 * DFG3_UM / 3.0) ** 2 * CYL_D)
    print(f"[4c'] cylinder res={CYL_RES}, DFG 2D-3 inflow to U({times[-1]:g}) = {um():.6f}: "
          f"{steps} steps from a table in {wall:.3f} s = {steps / wall:.4f} steps/s on {smi}; "
          f"against {steps} solve calls: u rel diff {du:.3e}, p rel diff {dp:.3e}, "
          f"bit-identical {bool(np.array_equal(ua, ub) and np.array_equal(pa, pb))}; host "
          f"reads a step {stats['host_syncs'].tolist()[:3]}...; kinetic energy (callback) "
          f"{float(ke[0]):.6e} after step 1, {float(ke[-1]):.6e} after step {steps}")
    print("    Cd per step: " + " ".join(f"{scale * f:.6e}" for f in F[:, 0]))
    print("    Cl per step: " + " ".join(f"{scale * f:.6e}" for f in F[:, 1]))
    check(ke.shape == (steps,) and np.isfinite(ke).all(), "the kinetic-energy callback")
    check(F.shape == (steps, 2) and np.isfinite(F).all(), "the traction callback")
    check(bool(np.all(stats["host_syncs"] == 0)) or device != "cuda",
          f"[4c'] host reads inside the steps: {stats['host_syncs'].tolist()}")
    check(bool(np.all(stats["u_converged"]) and np.all(stats["p_converged"])),
          "a solve of the transient cylinder did not converge")
    # the same operations in the same order: equal to f32 rounding
    check(du <= 1e-5 and dp <= 1e-5, f"the table run and the per-step loop disagree (u {du:.3e},"
          f" p {dp:.3e})")


def host_read_callback(device) -> None:
    """Phase 4c'': a step callback that reads the host (``float(t)``) fails
    the capture of ``run``'s graph with an error that names it; the
    solver's next run, without it, captures and runs."""
    import torch

    from oasisx_tpu_torch.step_graph import CallbackError

    s = tgv_solver(6, torch.float32, device, rtol=1e-5)

    def reads_the_host(st, t):
        return st["u"].sum() * float(t)

    try:
        s.run(2, DT, NU, max_iter=1, step_callback=reads_the_host)
    except CallbackError as e:
        msg = str(e)
    else:
        msg = ""
    print(f"[4c''] a callback that reads the host: {msg[:160]!r}")
    check("reads_the_host" in msg, "[4c''] a host-reading callback was not refused by name")
    st = s.run(2, DT, NU, max_iter=1)
    check(bool(st["p_converged"].all()) and s._graph is not None,
          "[4c''] the run after the refused callback")


# ---------------------------------------------------------------------------
# the split-phase API, the demos and the CLI
# ---------------------------------------------------------------------------

SPLIT_STEPS = 10  # phase 4k's steps after the warm-up
SPLIT_PROFILED = 3  # phase 4k's split steps with a profiler window around each phase
SPLIT_PHASES = ("assemble_first", "velocity_tentative_assemble", "velocity_tentative_solve",
                "pressure_assemble", "pressure_solve", "velocity_update")
# the kernels of a structured step with the MG pressure solve
STEP_KERNELS = ("cube_gather", "matvec_const", "matvec_win", "mixed", "bicgstab", "divergence",
                "pressure_mg", "cg_mass")
# phase 4k's bound on the split path's distance from run's, relative to run's
# largest entry, after step k (0-based): both solve the same systems to rtol
# from other initial guesses (x0 = u against 2 u1 - u2, no warm start of the
# mass solve), which leaves the velocities O(rtol) apart a step, adding up
# over the steps; the pressure follows the divergence of the tentative
# velocity, which amplifies its difference (CPU float32: 2.8e-3 and 3.7e-2
# after 10 steps at N=16)
SPLIT_U_BOUND = lambda rtol, k: 200.0 * rtol * (k + 1)  # noqa: E731
SPLIT_P_BOUND = lambda rtol, k: 1e4 * rtol  # noqa: E731
CLI_ARGS = ("-dt", "0.05", "-T", "0.2", "-nu", "0.1")  # the CLI smoke of phase 4m: 4 steps
TG_CI_ARGS = ("-N", "8", "-N", "16", "-N", "32", "-dt", "0.005")  # the reference CI's rates
VESSEL_MSH = "demo/meshes/patient_vessel.msh"


def split_step(solver, dt, nu, around=None):
    """One step by the split phases (tests/test_taylor_green.py:145-160):
    ps = p, the six methods, then u2 <- u1 <- u and p <- ps.  Returns (diff,
    every reason: u per component, p, c per component).  With ``around``,
    each phase runs as ``around(phase)`` (a timer: ``_event_timer``,
    ``_kernel_timer``)."""
    run = around or (lambda phase: phase())
    solver._ps.x.array.copy_(solver._p.x.array)
    run(lambda: solver.assemble_first(dt, nu))
    run(solver.velocity_tentative_assemble)
    diff, ru = run(solver.velocity_tentative_solve)
    run(lambda: solver.pressure_assemble(dt))
    rp = run(lambda: solver.pressure_solve(nu))
    rc = run(lambda: solver.velocity_update(dt))
    for u2, u1, u in zip(solver._u2, solver._u1, solver._u):
        u2.x.array.copy_(u1.x.array)
        u1.x.array.copy_(u.x.array)
    solver._p.x.array.copy_(solver._ps.x.array)
    return diff, [*ru.tolist(), rp, *rc.tolist()]


def _event_timer(times: list):
    """``split_step``'s ``around``: the milliseconds between CUDA events
    recorded on the stream before and after each phase, appended to
    ``times``.  The interval holds the host's enqueue of the phase and its
    reads of the results too: a phase starts on an idle device once the
    previous one's reads have returned."""
    import torch

    def around(phase):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        out = phase()
        e1.record()
        times.append((e0, e1))
        return out

    return around


def _kernel_timer(times: list):
    """``split_step``'s ``around``: each phase in a torch.profiler window of
    its own; the device time of the kernels and copies it ran (ms, the sum
    of their durations, no idle time) appended to ``times``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def around(phase):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            out = phase()
            torch.cuda.synchronize()
        times.append(sum(e.self_device_time_total for e in prof.key_averages()
                         if e.device_type == DeviceType.CUDA) / 1e3)
        return out

    return around


def _rel(a, b) -> float:
    """max |a - b| over max |b| (0 where b is 0)."""
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-300))


def split_phase_path(device, smi: str, n=N, warmup: int = WARMUP, steps: int = SPLIT_STEPS,
                     rtol: float = 1e-5, profiled: int = SPLIT_PROFILED) -> None:
    """Phase 4k: two solvers of the bench problem at ``n`` in float32 take the
    same ``warmup`` steps of ``run``; then A takes ``steps`` steps of
    ``run(1, max_iter=1)`` and B as many split steps.  Every reason 2, each
    split step's launches (on the CPU: plain calls) those of A's step and
    every kernel of the step among them, no plain version on the card, and
    B's u and p within SPLIT_U_BOUND / SPLIT_P_BOUND of A's after every
    step.  On the card two times of each phase a step: the wall between
    CUDA events around it (the host's enqueue and its reads included; the
    median over the steps), and the device time of its kernels alone, from
    a torch.profiler window around each phase of ``profiled`` more split
    steps (the median)."""
    import numpy as np
    import torch

    from oasisx_tpu_torch.assembly import kernels as kn

    cuda = torch.device(device).type == "cuda"
    a = tgv_solver(n, torch.float32, device, rtol)
    b = tgv_solver(n, torch.float32, device, rtol)
    for s in (a, b):
        s.run(warmup, DT, NU, max_iter=1)
    counts = kn.launches if cuda else kn.plain_calls
    times, du, dp, iters = [], [], [], []
    log = _iteration_log(b)
    for k in range(steps):
        kn.reset_counts()
        a.run(1, DT, NU, max_iter=1)
        _sync(device)
        step = {name: v for name, v in counts.items() if v}
        kn.reset_counts()
        events = []
        _, reasons = split_step(b, DT, NU, _event_timer(events) if cuda else None)
        _sync(device)
        split = {name: v for name, v in counts.items() if v}
        st = a.last_stats
        iters.append((st["u_iters"][0].tolist(), int(st["p_iters"][0]), st["c_iters"][0].tolist(),
                      [it for _, it in _iterations(log)]))
        check(all(r == 2 for r in reasons), f"[4k] step {k}: reasons {reasons}")
        # on the CPU the plain solves call the plain products an iteration: the same kernels
        same = split == step if cuda else set(split) == set(step)
        check(same, f"[4k] step {k}: the split phases launched {split}, a run step {step}")
        check(all(step.get(name, 0) > 0 for name in STEP_KERNELS),
              f"[4k] step {k}: a kernel of the step is missing from {step}")
        if cuda:
            plain = {name: v for name, v in kn.plain_calls.items() if v}
            check(not plain, f"[4k] step {k}: plain versions ran: {plain}")
            times.append([e0.elapsed_time(e1) for e0, e1 in events])
        ua, ub = (torch.stack([f.x.array for f in s._u]) for s in (a, b))
        du.append(_rel(ub, ua))
        dp.append(_rel(b._p.x.array, a._p.x.array))
        check(du[-1] <= SPLIT_U_BOUND(rtol, k) and dp[-1] <= SPLIT_P_BOUND(rtol, k),
              f"[4k] step {k}: split against run u {du[-1]:.3e} (bound "
              f"{SPLIT_U_BOUND(rtol, k):.1e}), p {dp[-1]:.3e} (bound {SPLIT_P_BOUND(rtol, k):.1e})")
    print(f"[4k] split phases at N={n}, float32, {warmup} warm-up steps of run then {steps} steps "
          f"each way, on {smi}: every reason 2; a split step's launches equal a run step's: "
          f"{split}")
    print("    u rel diff (split against run) per step: " + " ".join(f"{v:.3e}" for v in du)
          + f" (bound {SPLIT_U_BOUND(rtol, 0):.0e} (k+1))")
    print("    p rel diff per step: " + " ".join(f"{v:.3e}" for v in dp)
          + f" (bound {SPLIT_P_BOUND(rtol, 0):.0e})")
    print("    iterations a step, run (u per component, p, c per component) | split (u, p, c): "
          + "; ".join(f"{u} {p} {c} | {sp}" for u, p, c, sp in iters))
    if not cuda:
        return
    med = np.median(np.asarray(times), axis=0)
    print(f"    wall between CUDA events around each phase, host enqueue and reads included, "
          f"median of {steps} (ms): " + ", ".join(f"{p} {t:.4f}" for p, t in zip(SPLIT_PHASES, med))
          + f"; sum {med.sum():.4f}")
    kernel = []
    for _ in range(profiled):
        kernel.append([])
        _, reasons = split_step(b, DT, NU, _kernel_timer(kernel[-1]))
        check(all(r == 2 for r in reasons), f"[4k] profiled split step: reasons {reasons}")
    med = np.median(np.asarray(kernel), axis=0)
    if med.sum() > 0:
        print(f"    device time of each phase's kernels and copies (torch.profiler, a window a "
              f"phase), median of {profiled} more split steps (ms): "
              + ", ".join(f"{p} {t:.4f}" for p, t in zip(SPLIT_PHASES, med))
              + f"; sum {med.sum():.4f}")
    else:
        print("    device time of each phase's kernels: not measured (the profiler recorded no "
              "device time)")


def vessel_demo_path(device, steps: int = 5, dt: float = 0.01) -> None:
    """Phase 4l: ``demo.vessel.main`` on the repo's tagged patient mesh
    (inlet 1, wall 2, outlet 3) in float32 for ``steps`` steps: the general
    path with the outlet.  Finite velocities, every solve converged, every
    ELL kernel of the path launched (on the CPU: its plain version) and, on
    the card, no plain version."""
    import os

    import numpy as np
    import torch

    from oasisx_tpu_torch.assembly import kernels as kn
    from oasisx_tpu_torch.demo import vessel

    cuda = torch.device(device).type == "cuda"
    msh = os.path.join(os.path.dirname(os.path.abspath(__file__)), VESSEL_MSH)
    kn.reset_counts()
    t0 = time.perf_counter()
    out = vessel.main(["--mesh-path", msh, "-dt", str(dt), "-T", str(steps * dt),
                       "--device", str(device)])
    _sync(device)
    wall = time.perf_counter() - t0
    counts = kn.launches if cuda else kn.plain_calls
    used = {k: v for k, v in counts.items() if v}
    print(f"[4l] vessel demo on {VESSEL_MSH} ({out['velocity_dofs']} velocity dofs), {steps} "
          f"steps in {wall:.1f} s with set-up: max |u| per step {out['max_velocity']}, every "
          f"solve converged {out['converged']}; launches {used}")
    check(len(out["max_velocity"]) == steps and np.isfinite(out["max_velocity"]).all(),
          "[4l] the vessel's velocity is not finite")
    check(all(out["converged"]), "[4l] a solve of the vessel demo did not converge")
    for name in kn.ELL_KERNELS:
        check(counts[name] > 0, f"[4l] {name} was not launched")
    if cuda:
        plain = {k: v for k, v in kn.plain_calls.items() if v}
        check(not plain, f"[4l] plain versions ran: {plain}")


def cli_and_demo(device, tg_args=TG_CI_ARGS) -> None:
    """Phase 4m: ``python -m oasisx_tpu_torch`` in a subprocess (on the card
    by default; ``--device`` only off it), its .pvd / .vtu / .npz files, and
    its checkpoint loaded into a new solver of the same problem: the arrays
    of the file.  Then the Taylor-Green demo with the reference CI's
    arguments: in float64 held to the CI bar (rate_u > 1.7, rate_p > 1.5),
    in float32 printed."""
    import os
    import shutil

    import numpy as np
    import torch

    from oasisx_tpu_torch import DirichletBC, FractionalStep_AB_CN, LocatorMethod
    from oasisx_tpu_torch.demo import taylor_green
    from oasisx_tpu_torch.io import Checkpoint
    from oasisx_tpu_torch.meshes import create_unit_square, meshtags

    cuda = torch.device(device).type == "cuda"
    root = os.path.dirname(os.path.abspath(__file__))
    out = os.path.join(root, "build", "chip_smoke_cli")
    shutil.rmtree(out, ignore_errors=True)
    cmd = [sys.executable, "-m", "oasisx_tpu_torch", *CLI_ARGS, "--output",
           os.path.join(out, "run.bp"), "--checkpoint", os.path.join(out, "ck.npz")]
    if not cuda:
        cmd += ["--device", str(device)]
    t0 = time.perf_counter()
    r = subprocess.run(cmd, cwd=root, capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    check(r.returncode == 0, f"[4m] the CLI exited with {r.returncode}: {r.stderr[-2000:]}")
    names = sorted(os.listdir(out))
    print(f"[4m] python -m oasisx_tpu_torch {' '.join(CLI_ARGS)}: exit 0 in {wall:.1f} s, "
          f"wrote {names}")
    for name in ("run.pvd", "run_00000.vtu", "run_00003.vtu", "run_00003.npz", "ck.npz"):
        check(name in names, f"[4m] the CLI did not write {name}")
    mesh = create_unit_square(10, 10)
    facets = mesh.exterior_facet_indices()
    tags = meshtags(mesh, 1, facets, np.full_like(facets, 1))
    bcs = [[DirichletBC(0.0, LocatorMethod.TOPOLOGICAL, (tags, 1))] for _ in range(2)]
    s = FractionalStep_AB_CN(mesh, ("Lagrange", 2), ("Lagrange", 1), bcs, [], device=device)
    t, step = Checkpoint(os.path.join(out, "ck.npz")).load(s)
    data = np.load(os.path.join(out, "ck.npz"))
    fs = {"p": s._p, "dp": s._dp}
    for i in range(2):
        fs.update({f"u{i}": s._u[i], f"u1_{i}": s._u1[i], f"u2_{i}": s._u2[i]})
    same = all(np.array_equal(f.x.array.cpu().numpy(), data[k].astype(np.float32))
               for k, f in fs.items())
    print(f"    checkpoint t={t:g} step {step} loaded into a new solver: arrays equal {same}")
    check(same and step == 4, "[4m] the checkpoint did not load back")
    rates = {}
    for dtype in ("float64", "float32"):
        t0 = time.perf_counter()
        rates[dtype] = taylor_green.main([*tg_args, "--device", str(device), "--dtype", dtype])
        print(f"    Taylor-Green demo {' '.join(tg_args)} in {dtype}: rate_u "
              f"{rates[dtype][0].tolist()}, rate_p {rates[dtype][1].tolist()} "
              f"({time.perf_counter() - t0:.1f} s)")
    ru, rp = rates["float64"]
    check(ru.min() > 1.7 and rp.min() > 1.5,
          f"[4m] float64 rates {ru.tolist()} / {rp.tolist()} below the CI bar 1.7 / 1.5")


def _iteration_log(solver) -> list:
    """Wrap the solver's solves to record each one's iterations, (name,
    iterations tensor) in call order: read them with ``_iterations`` after
    the step (no host read inside it)."""
    log = []
    for name in ("_tentative_solve", "_pressure_solve", "_rotational_update", "_velocity_update"):
        f = getattr(solver, name)

        def wrap(*args, f=f, name=name):
            out = f(*args)
            log.append((name, out[0].iters))
            return out

        setattr(solver, name, wrap)
    return log


def _iterations(log: list) -> list:
    """The iterations of an ``_iteration_log`` on the host, emptying it."""
    out = [(name, it.cpu().numpy().tolist()) for name, it in log]
    log.clear()
    return out


def split_gpu_vs_cpu(steps: int = 3, full_steps: int = 1) -> None:
    """Phase 5g: in float64, cuda against cpu.  The split sequence for
    ``steps`` steps on the N=6 box, standard and rotational, and on the
    res=10 cylinder with its outlet and the rotational update, and for
    ``full_steps`` at the full width (the N=36 box): every solve's
    iterations and every reason equal, ``_b_first``, ``_rhs1``, ``_b2``, u,
    p, dp and ps after each step to 1e-10 relative.  ``tentative_matrix_dense``
    on the N=6 box (K3 on cuda, its plain version on cpu) and the cylinder
    (the element stack) to 1e-12.  A Checkpoint written by the cuda solver
    after 3 steps loads into fresh cuda and cpu solvers, which take 2 more
    steps: phase 5's checks; the cpu solver's checkpoint loads back into a
    cuda one bit for bit."""
    import os

    import numpy as np
    import torch

    from oasisx_tpu_torch.io import Checkpoint

    f64 = torch.float64
    dt_nu = {"box": (DT, NU), "cyl": (CYL_DT, CYL_NU)}
    cases = (("N=6", "box", steps, lambda dev: tgv_solver(6, f64, dev, rtol=1e-8)),
             ("N=6 rotational", "box", steps,
              lambda dev: tgv_solver(6, f64, dev, rtol=1e-8, rotational=True)),
             ("cylinder res=10 rotational", "cyl", steps,
              lambda dev: cylinder_solver(10, f64, dev, rtol=1e-8, rotational=True)),
             # the full width: every split phase at N=36 held as tightly
             (f"N={N}", "box", full_steps, lambda dev: tgv_solver(N, f64, dev, rtol=1e-8)))
    keys = ("_b_first", "_rhs1", "_u", "_b2", "_p", "_dp", "_ps")
    for label, kind, nsteps, make in cases:
        runs = {}
        t0 = time.perf_counter()
        for dev in ("cuda", "cpu"):
            s = make(dev)
            log, vecs, reasons = _iteration_log(s), [], []
            for _ in range(nsteps):
                reasons.append(split_step(s, *dt_nu[kind])[1])
                vecs.append({k: _values(getattr(s, k)) for k in keys})
            runs[dev] = (log, vecs, reasons)
        (lg, vg, rg), (lc, vc, rc) = runs["cuda"], runs["cpu"]
        lg, lc = _iterations(lg), _iterations(lc)
        worst = {k: max(_rel(g[k].cpu(), c[k]) for g, c in zip(vg, vc)) for k in keys}
        print(f"  {label} split phases f64 {nsteps} steps: cuda against cpu rel diff "
              + ", ".join(f"{k} {v:.3e}" for k, v in worst.items())
              + f" ({time.perf_counter() - t0:.1f} s with set-up)")
        print(f"    iterations cuda {lg}")
        check(lg == lc, f"{label}: split-phase iterations differ: cuda {lg}, cpu {lc}")
        check(rg == rc and all(r == 2 for rr in rg for r in rr), f"{label}: reasons {rg} / {rc}")
        check(max(worst.values()) <= 1e-10, f"{label}: cuda and cpu disagree: {worst}")
    for label, make in (("N=6", lambda dev: tgv_solver(6, f64, dev, rtol=1e-8)),
                        ("cylinder res=10", lambda dev: cylinder_solver(10, f64, dev, rtol=1e-8))):
        dense, secs = {}, {}
        for dev in ("cuda", "cpu"):
            s = make(dev)
            s.assemble_first(*((DT, NU) if label == "N=6" else (CYL_DT, CYL_NU)))
            t0 = time.perf_counter()
            dense[dev] = s.tentative_matrix_dense()
            secs[dev] = time.perf_counter() - t0
        rel = float(np.abs(dense["cuda"] - dense["cpu"]).max() / np.abs(dense["cpu"]).max())
        print(f"  {label} tentative_matrix_dense {dense['cpu'].shape}: cuda against cpu rel diff "
              f"{rel:.3e} (host clock with the copy to the host: cuda {secs['cuda']:.3f} s, "
              f"cpu {secs['cpu']:.3f} s)")
        check(rel <= 1e-12, f"{label}: the dense tentative matrices disagree ({rel:.3e})")
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(root, exist_ok=True)
    ck = Checkpoint(os.path.join(root, "chip_smoke_ck.npz"))
    src = tgv_solver(6, f64, "cuda", rtol=1e-8)
    src.run(3, DT, NU, max_iter=1)
    ck.save(src, t=3 * DT, step=3)
    gpu_vs_cpu(lambda dtype, dev: _loaded(tgv_solver(6, dtype, dev, rtol=1e-8), ck),
               "N=6 from the cuda solver's checkpoint", steps=2)
    cpu = _loaded(tgv_solver(6, f64, "cpu", rtol=1e-8), ck)
    cpu.run(2, DT, NU, max_iter=1)
    ck.save(cpu, t=5 * DT, step=5)
    back = _loaded(tgv_solver(6, f64, "cuda", rtol=1e-8), ck)
    same = all(torch.equal(f.x.array.cpu(), g.x.array) for f, g in zip(
        [*back._u, *back._u1, *back._u2, back._p, back._dp],
        [*cpu._u, *cpu._u1, *cpu._u2, cpu._p, cpu._dp]))
    print(f"  the cpu solver's checkpoint loaded into a cuda solver: bit-identical {same}")
    check(same, "a checkpoint from cpu did not load into cuda bit for bit")


def _values(f):
    """A Function's (or a list of component Functions') values, copied."""
    import torch

    return torch.stack([g.x.array for g in f]) if isinstance(f, list) else f.x.array.clone()


def _loaded(solver, ck):
    """``solver`` with the state of the checkpoint ``ck`` loaded."""
    ck.load(solver)
    return solver


# ---------------------------------------------------------------------------
# the fidelity runs, assembly_strategies and the structured tentative CG
# ---------------------------------------------------------------------------

FID_N, FID_DT, FID_T = 32, 0.01, 10.0  # scripts/fidelity_tgv.py's N=32 run: 1000 steps
FID_REF = "fidelity_tgv_N32_f64.npz"  # the JAX package's float64 curve (FIDELITY.md)
FID_MAX_DE, FID_PEAK_REL = 2e-4, 5e-3  # FIDELITY.md's float32 against float64: 1.6e-4, 0.4%
FID_KERNELS = ("cube_gather", "matvec_const", "matvec_win", "mixed", "bicgstab", "divergence",
               "pressure_mg", "cg_mass")
DFG1_ARGS = ("--res", "30", "--refine-levels", "2", "--Um", "0.3", "-nu", "1e-3", "-T", "2.5")
DFG1_CD, DFG1_CD_REL = 5.608, 5e-3  # FIDELITY.md's steady DFG 2D-1 Cd (CPU, float32)
DFG1_BAND = (5.5779, 5.5979)  # the benchmark's interval for Cd
STRATEGY_ARGS = ("--dim", "3", "-n", "12", "--max-degree", "4")  # the JAX demo's defaults


def fidelity_path(device, n=FID_N, T=FID_T) -> None:
    """Phase 4n: ``demo.fidelity_tgv`` (Taylor-Green Re=1600 on the symmetry
    sub-box) at N=32, dt 0.01 to T=10 in float32 and in float64 on
    ``device``, each held against ``FID_REF``: max |dE| at most
    ``FID_MAX_DE`` and the smoothed peak dissipation within
    ``FID_PEAK_REL``; every structured kernel launched and, on the card, no
    plain version.  Prints steps/s, iterations and the worst exit residuals
    of each run."""
    import os

    import torch

    from oasisx_tpu_torch.assembly import kernels as kn
    from oasisx_tpu_torch.demo import fidelity_tgv

    cuda = torch.device(device).type == "cuda"
    root = os.path.dirname(os.path.abspath(__file__))
    ref = os.path.join(root, FID_REF)
    for dtype in ("float32", "float64"):
        kn.reset_counts()
        t0 = time.perf_counter()
        npz = os.path.join(root, "build", f"chip_smoke_fidelity_tgv_N{n}_{dtype}.npz")
        out = fidelity_tgv.main(["-N", str(n), "--dt", str(FID_DT), "--T", str(T), "--device",
                                 str(device), "--dtype", dtype, "--compare", ref, "--out", npz])
        wall = time.perf_counter() - t0
        c = out["compare"]
        counts = kn.launches if cuda else kn.plain_calls
        print(f"[4n] fidelity_tgv N={n} {dtype}, {out['steps']} steps ({out['velocity_dofs']} "
              f"velocity dofs): {out['steps_per_s']:.4f} steps/s, {wall:.1f} s with set-up; "
              f"iterations a step {out['mean_iters']} (largest {out['max_iters']}), worst exit "
              f"residuals {out['worst_exit_res']}")
        print(f"    against {FID_REF}: max |dE| {c['max_abs_dE']:.4e} at t={c['t_max_abs_dE']:.2f} "
              f"(bar {FID_MAX_DE:g}); smoothed peak eps {c['peak_smoothed']:.6f} at "
              f"t={c['t_peak_smoothed']:.2f}, reference {c['ref_peak_smoothed']:.6f} at "
              f"t={c['ref_t_peak_smoothed']:.2f}: {100 * c['peak_rel_diff']:+.4f}% (bar "
              f"{100 * FID_PEAK_REL:g}%); E(0) {out['E0']:.9f}; launches "
              f"{ {k: v for k, v in counts.items() if v} }")
        for name in FID_KERNELS:
            check(counts[name] > 0, f"[4n] {name} was not launched")
        if cuda:
            plain = {k: v for k, v in kn.plain_calls.items() if v}
            check(not plain, f"[4n] plain versions ran: {plain}")
        check(c["max_abs_dE"] <= FID_MAX_DE and abs(c["peak_rel_diff"]) <= FID_PEAK_REL,
              f"[4n] {dtype}: max |dE| {c['max_abs_dE']:.3e}, peak "
              f"{100 * c['peak_rel_diff']:+.3f}% against {FID_REF}")


def dfg1_path(device, args=DFG1_ARGS) -> None:
    """Phase 4o: ``demo.cylinder`` with the steady DFG 2D-1 settings
    (res 30 and 2 refinement levels at the cylinder, Re=20, T=2.5, dt 2e-3:
    1250 steps) in float32: Cd at T within ``DFG1_CD_REL`` of FIDELITY.md's
    5.608 and its place against the benchmark's band printed; the ELL
    kernels launched and, on the card, no plain version."""
    import torch

    from oasisx_tpu_torch.assembly import kernels as kn
    from oasisx_tpu_torch.demo import cylinder

    cuda = torch.device(device).type == "cuda"
    kn.reset_counts()
    t0 = time.perf_counter()
    out = cylinder.main([*args, "--device", str(device)])
    _sync(device)
    wall = time.perf_counter() - t0
    counts = kn.launches if cuda else kn.plain_calls
    cd, (lo, hi) = out["Cd"], DFG1_BAND
    place = "inside" if lo <= cd <= hi else f"{cd - hi:+.4f} above" if cd > hi else \
        f"{cd - lo:+.4f} below"
    rel = (cd - DFG1_CD) / DFG1_CD
    print(f"[4o] DFG 2D-1 ({' '.join(args)}), t={out['t_end']:.3f} in {wall:.1f} s with "
          f"set-up: Cd {cd:.6f} ({100 * rel:+.4f}% against {DFG1_CD}, bar "
          f"{100 * DFG1_CD_REL:g}%; {place} the band {lo}-{hi}), Cl {out['Cl']:.6f}; launches "
          f"{ {k: v for k, v in counts.items() if v} }")
    for name in kn.ELL_KERNELS:
        check(counts[name] > 0, f"[4o] {name} was not launched")
    if cuda:
        plain = {k: v for k, v in kn.plain_calls.items() if v}
        check(not plain, f"[4o] plain versions ran: {plain}")
    check(abs(rel) <= DFG1_CD_REL, f"[4o] Cd {cd:.6f} is not within {DFG1_CD_REL:g} of {DFG1_CD}")


def strategies_path(device, args=STRATEGY_ARGS) -> None:
    """Phase 4p: ``demo.assembly_strategies`` in float32 (the agreement of
    "action" and "matvec" asserted at every degree; the table of both
    strategies' times a degree printed)."""
    from oasisx_tpu_torch.demo import assembly_strategies

    print(f"[4p] assembly_strategies {' '.join(args)} on {device}")
    t0 = time.perf_counter()
    try:
        assembly_strategies.main([*args, "--device", str(device)])
    except AssertionError as e:
        raise SmokeError(f"[4p] {e}") from None
    print(f"[4p] {time.perf_counter() - t0:.1f} s")


def structured_cg_gpu_vs_cpu() -> None:
    """Phase 5h: the structured path's tentative ``ksp_type`` cg (batched CG
    on K3's product with identity bc rows, looped on the host) on the N=6
    box, cuda against cpu in float64 (``gpu_vs_cpu``'s checks, u iterations
    and host reads a step printed); ``config_report`` says "cg" without K2,
    and on the card K3 launched and K2 not."""
    from oasisx_tpu_torch.assembly import kernels as kn

    def make(dtype, dev):
        s = tgv_solver(6, dtype, dev, rtol=1e-8, tentative={"ksp_type": "cg"})
        rep = s.config_report()
        check(rep["tentative_method"] == "cg" and "bicgstab" not in rep["path_kernels"],
              f"[5h] tentative {rep['tentative_method']} with {rep['path_kernels']}")
        return s

    kn.reset_counts()
    gpu_vs_cpu(make, "N=6 ksp_type cg (structured)", pressure_pc="mg-pcg")
    print(f"  launches on the card: matvec_win {kn.launches['matvec_win']}, bicgstab "
          f"{kn.launches['bicgstab']}")
    check(kn.launches["matvec_win"] > 0 and kn.launches["bicgstab"] == 0,
          "[5h] the tentative CG did not run on K3 alone")


SLAB_WORLD = 2  # phase 4q's ranks on the one card (gloo, planes through the host)
SLAB_WORLD_BOUND = {"u": 5e-4, "p": 5e-3}  # f32 engines (ROADMAP known difference c)
# the slab path at world 1 against the single-device one, relative L2 after
# its steps in f32 at rtol 1e-5, by N: about twice the largest reading (taken
# after 5 + 25 steps)
# on an H100 (N=36: u 1.19e-2 and 1.62e-2, p 2.43e-2 and 2.35e-2; N=64: u
# 2.61e-2, p 0.141, its bound 1.8 times).  The two paths' MGs and tentative x0s differ (ROADMAP
# known differences a and f) and each solve stops within rtol 1e-5; the
# gap is that tolerance (``--slab-gap``: at f64 rtol 1e-8 it falls to u
# 4.3e-6, p 1.7e-5 at N=36 and u 8.2e-6, p 2.5e-5 at N=64), mostly the
# single-device path's, whose rtol-1e-5 state lies farther from the
# converged one.  No bound at an N without readings.
SLAB_SINGLE_BOUND = {36: {"u": 0.03, "p": 0.05}, 64: {"u": 0.05, "p": 0.25}}
SLAB_TIMEOUT = 900.0  # a rank group's time limit (each collective: 60 s)
SLAB_PROFILE = 1  # steps under torch.profiler after the timed ones: the device's share


def _rel2(a, b) -> tuple[float, float]:
    """(max, L2) relative differences."""
    import numpy as np

    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return (float(np.abs(a - b).max() / np.abs(b).max()),
            float(np.linalg.norm(a - b) / np.linalg.norm(b)))


def slab_group(label: str, world: int, backend: str, cfg: dict, group=None,
               t0: float | None = None) -> dict:
    """One group of ranks (``parallel/launch.py``) running
    ``parallel.ranks.run_tgv`` (``group``: the ranks already started, at
    ``t0``; None: started here): every rank's per-shard K3, K5, K6 and K7
    against their plain versions (f32: 1e-5 relative, halo and padding
    slots 0), every solve converged, the velocity finite, each rank's
    launches of K3, K5, K6, K7 and K8 after the warm-up all > 0 and equal
    across ranks, no plain version on the path, every rank's iterations
    equal; printed with the steps/s, iterations a step, the traffic and
    the times of a sum over ranks and of a halo exchange.  Returns rank
    0's result."""
    import numpy as np

    from oasisx_tpu_torch.assembly.kernels import SLAB_KERNELS
    from oasisx_tpu_torch.parallel import ranks
    from oasisx_tpu_torch.parallel.launch import start

    if group is None:
        t0, group = time.perf_counter(), start(ranks.run_tgv, world, (cfg,), backend=backend)
    out = group.join(SLAB_TIMEOUT)
    r0 = out[0]
    steps = cfg["steps"]
    rep = r0["config"]
    print(f"[{label}] world {world} ({backend}, {rep['device']} x{world}) N={cfg['N']}: "
          f"{time.perf_counter() - t0:.1f} s with set-up (rank 0 {r0['setup_s']:.1f} s); "
          f"{rep['planes_per_rank']} cube planes a rank, pressure {rep['pressure_pc']} "
          f"({rep['pressure_mg_levels']} levels)")
    check(rep["sharding"] == "slab-halo" and rep["ndev"] == world
          and rep["run"].startswith("eager: "), f"[{label}] {rep}")
    for r in out:
        for name, k in r["kernels"].items():
            print(f"  rank {r['rank']} {name} per shard on {k['shape']}: max abs err "
                  f"{k['max_abs_err']:.3e} (rel {k['rel_err']:.3e} of {k['max_out']:.3e}), halo "
                  f"and padding 0: {k['halo_zero']}")
            check(k["max_out"] > 0 and k["rel_err"] <= 1e-5 and k["halo_zero"],
                  f"[{label}] rank {r['rank']} {name}: {k}")
        st = r["stats"]
        for f in ("u", "p", "c"):
            check(bool(np.all(st[f + "_converged"])), f"[{label}] rank {r['rank']}: a {f} solve "
                  "did not converge")
            check(np.array_equal(st[f + "_iters"], r0["stats"][f + "_iters"]),
                  f"[{label}] rank {r['rank']}: {f} iterations differ from rank 0's")
        used = {k: r["launches"].get(k, 0) for k in SLAB_KERNELS}
        print(f"  rank {r['rank']} launches in {steps} steps {used}, plain calls "
              f"{r['plain_calls']}; comm {r['comm']}")
        check(all(v > 0 for v in used.values()), f"[{label}] rank {r['rank']}: {used}")
        check(used == {k: r0["launches"].get(k, 0) for k in SLAB_KERNELS},
              f"[{label}] rank {r['rank']}'s launches differ from rank 0's")
        check(not r["plain_calls"], f"[{label}] rank {r['rank']}: plain calls {r['plain_calls']}")
    check(bool(np.isfinite(r0["u"]).all()), f"[{label}] velocity not finite")
    it = ranks.iters_per_step(r0["stats"])
    tr, cm = r0["traffic"], r0["comm"]
    print(f"[{label}] {steps} steps in {r0['wall_s']:.3f} s = {r0['steps_per_s']:.4f} steps/s; "
          f"iterations a step u {it['u']:.3f} p {it['p']:.3f} c {it['c']:.3f}; worst exit "
          f"residuals u {float(r0['stats']['u_res'].max()):.3e} p "
          f"{float(r0['stats']['p_res'].max()):.3e} c {float(r0['stats']['c_res'].max()):.3e}")
    ex = cm["shift"][0] / steps
    sent = sum(r["comm"]["shift"][1] for r in out) / steps
    print(f"    a step: {ex:.1f} halo exchanges, {cm['sum'][0] / steps:.1f} sums over ranks, "
          f"{cm['gather'][0] / steps:.1f} gathers ({cm['gather'][1] / steps / 1e6:.4f} MB sent "
          f"by rank 0); halo_traffic_report bytes_per_exchange (a plane of one component at "
          f"every boundary) v {tr['v']['bytes_per_exchange']} q {tr['q']['bytes_per_exchange']}, "
          f"x {ex:.1f} exchanges = {tr['v']['bytes_per_exchange'] * ex / 1e6:.4f} MB (v); "
          f"planes sent by all ranks {sent / 1e6:.4f} MB (the velocity's 3 components "
          f"together)")
    print(f"    one sum over ranks {r0['sum_ms']:.4f} ms, one halo refresh of u "
          f"{r0['halo_ms']:.4f} ms ({backend}, host clock, mean of 50)")
    if "profile_wall_ms" in r0:
        dev_ms = [r["profile_device_ms"] for r in out]
        wall = max(r["profile_wall_ms"] for r in out)
        cards = len({r["config"]["device"] for r in out})
        busy = sum(dev_ms) / wall / cards  # ranks on one card add up
        print(f"    profile of {r0['profile_steps']} more steps: wall {wall:.3f} ms, device time "
              f"a rank {[round(v, 3) for v in dev_ms]} ms (NCCL's kernels apart: "
              f"{[round(r['profile_nccl_ms'], 3) for r in out]} ms); busy share a card "
              f"{100 * busy:.1f}%, idle {100 - 100 * busy:.1f}%")
    if "split" in r0:  # phase 4k''s split step after the run, every rank's
        r0["splits_all"] = [r["split"] for r in out]
    return r0


def slab_path(n: int = N, warmup: int = SHARD_STEPS[0], steps: int = SHARD_STEPS[1], worlds=None,
              device: str = "cuda", single: dict | None = None) -> None:
    """Phase 4q: bench.py's configuration (N, float32, rtol 1e-5) on the
    slab path, ``warmup`` + ``steps`` steps, at world 1 (the slab code
    with no neighbours) and over ``SLAB_WORLD`` ranks on the one card
    (gloo), and over NCCL at world = the card count where that is 2 or
    more (``worlds``: [(world, backend)] in place of these); each world's
    state against world 1's (the f32 engines' bound), and world 1's against
    the single-device path's (the solves' tolerance; ``single``: its u, p
    and stats after as many steps, from phase 4, or None: run here).
    ``device`` "cpu" rehearses it (its launch checks then fail).  The gloo groups of world 1
    and ``SLAB_WORLD`` end with phase 4k''s split step; returns every rank's
    split result by world.  The gloo groups start at once: their spawns,
    set-ups and warm-ups overlap, and each times its steps, profile and
    comm with the card to itself (``ranks._card_alone``); then NCCL's."""
    import contextlib
    import multiprocessing as mp

    import numpy as np
    import torch

    from oasisx_tpu_torch.parallel import ranks
    from oasisx_tpu_torch.parallel.launch import start

    ncard = torch.cuda.device_count()
    if worlds is None:
        worlds = [(1, "gloo"), (SLAB_WORLD, "gloo")] + ([(ncard, "nccl")] if ncard >= 2 else [])
    cfg = dict(N=n, dtype="float32", device=device, rtol=1e-5, warmup=warmup, steps=steps,
               check=True, time_comm=True, profile=SLAB_PROFILE)
    # the gloo groups run at once, each timing its steps with the card alone
    lock = mp.get_context("spawn").Lock()
    cfgs = {(w, b): dict(cfg, split=b == "gloo" and w in (1, SLAB_WORLD),
                         card_lock=lock if b == "gloo" else None) for w, b in worlds}
    runs = {}
    with contextlib.ExitStack() as stack:
        t0 = time.perf_counter()
        groups = {key: stack.enter_context(start(ranks.run_tgv, key[0], (cfgs[key],),
                                                 backend=key[1]))
                  for key in cfgs if key[1] == "gloo"}
        for key, group in groups.items():
            runs[key] = slab_group("4q", *key, cfgs[key], group=group, t0=t0)
    for key in cfgs:
        if key not in runs:
            runs[key] = slab_group("4q", *key, cfgs[key])
            torch.cuda.empty_cache()
    splits = {w: r["splits_all"] for (w, _), r in runs.items() if "splits_all" in r}
    base = runs.get((1, "gloo"))
    if base is None:
        return splits
    for key, r in runs.items():
        if key == (1, "gloo"):
            continue
        du, dp = _rel2(r["u"], base["u"]), _rel2(r["p"], base["p"])
        print(f"[4q] world {key[0]} ({key[1]}) against world 1 after {warmup + steps} steps: u "
              f"max {du[0]:.3e} L2 {du[1]:.3e}, p max {dp[0]:.3e} L2 {dp[1]:.3e} (bound "
              f"{SLAB_WORLD_BOUND})")
        check(du[0] <= SLAB_WORLD_BOUND["u"] and dp[0] <= SLAB_WORLD_BOUND["p"],
              f"[4q] world {key[0]} against world 1: u {du[0]:.3e}, p {dp[0]:.3e}")
    if single is None:
        solver = tgv_solver(n, torch.float32, device, rtol=1e-5)
        single = single_steps(solver, None, warmup, steps)
        del solver
        torch.cuda.empty_cache()
    u, p, st = single["u"], single["p"], single["stats"]
    du, dp = _rel2(base["u"], u), _rel2(base["p"], p)
    mean = lambda k: float(st[k].reshape(steps, -1).sum(axis=1).mean())
    bound = SLAB_SINGLE_BOUND.get(n)
    print(f"[4q] world 1 against the single-device path (K1's MG, the kernel path's x0): u max "
          f"{du[0]:.3e} L2 {du[1]:.3e}, p max {dp[0]:.3e} L2 {dp[1]:.3e} (L2 bound at N={n} "
          f"{bound}); single-device iterations a step u {mean('u_iters'):.3f} p "
          f"{mean('p_iters'):.3f} c {mean('c_iters'):.3f}")
    check(bound is not None and du[1] <= bound["u"] and dp[1] <= bound["p"],
          f"[4q] world 1 against the single-device path at N={n}: u {du[1]:.3e}, p {dp[1]:.3e} "
          f"(bound {bound})")
    return splits


SLAB_GAP_CASES = (("float32", 1e-5), ("float64", 1e-5), ("float64", 1e-8))


def slab_gap(ns, warmup: int = WARMUP, steps: int = STEPS, device: str = "cuda") -> None:
    """The slab path at world 1 against the single-device path, as phase 4q
    compares them, at each N of ``ns`` and each (dtype, rtol) of
    SLAB_GAP_CASES: whether the gap shrinks with the solves' tolerance.
    Printed: the two states' relative max and L2 differences after
    ``warmup + steps`` steps, each one's distance from the single-device
    float64 rtol 1e-8 run, and the iterations a step.  Measures, checks
    nothing."""
    import numpy as np
    import torch

    from oasisx_tpu_torch.parallel import ranks
    from oasisx_tpu_torch.parallel.launch import launch

    for n in ns:
        got = {}
        for dtype, rtol in SLAB_GAP_CASES:
            t0 = time.perf_counter()
            cfg = dict(N=n, dtype=dtype, device=device, rtol=rtol, warmup=warmup, steps=steps)
            slab = launch(ranks.run_tgv, 1, (cfg,), timeout=SLAB_TIMEOUT)[0]
            single = tgv_solver(n, getattr(torch, dtype), device, rtol=rtol)
            single.run(warmup, DT, NU)
            st = single.run(steps, DT, NU)
            one = dict(u=np.stack([f.x.array.double().cpu().numpy() for f in single._u]),
                       p=single._p.x.array.double().cpu().numpy(),
                       iters=ranks.iters_per_step(st))
            del single
            torch.cuda.empty_cache()
            got[dtype, rtol] = (slab, one)
            du, dp = _rel2(slab["u"], one["u"]), _rel2(slab["p"], one["p"])
            its = lambda r: " ".join(f"{k} {v:.2f}" for k, v in r.items())
            print(f"[gap] N={n} {dtype} rtol {rtol:g}: world 1 against single-device u max "
                  f"{du[0]:.3e} L2 {du[1]:.3e}, p max {dp[0]:.3e} L2 {dp[1]:.3e}; iterations a "
                  f"step slab {its(ranks.iters_per_step(slab['stats']))}, single "
                  f"{its(one['iters'])} ({time.perf_counter() - t0:.1f} s)")
        ref = got["float64", 1e-8][1]
        for (dtype, rtol), pair in got.items():
            d = [(_rel2(r["u"], ref["u"])[1], _rel2(r["p"], ref["p"])[1]) for r in pair]
            print(f"[gap] N={n} {dtype} rtol {rtol:g} against single-device float64 rtol 1e-8 "
                  f"(L2): slab u {d[0][0]:.3e} p {d[0][1]:.3e}, single u {d[1][0]:.3e} p "
                  f"{d[1][1]:.3e}")


def deferred(phase):
    """``phase(..., stack=None)``, a phase that starts rank groups and then
    checks their results: with an ``contextlib.ExitStack`` ``stack`` it
    starts its groups there and returns the check, to be called later (so
    that several phases' groups run at once); without one it runs whole."""
    import contextlib
    import functools

    @functools.wraps(phase)
    def run(*args, stack=None, **kw):
        if stack is not None:
            return phase(*args, stack=stack, **kw)
        with contextlib.ExitStack() as own:
            return phase(*args, stack=own, **kw)()
    return run


def two_groups(stack, fn, world: int, args_of, devices) -> list:
    """A group of ``world`` ranks running ``fn`` on each device of
    ``devices`` (``args_of(device)`` its arguments), all started at once
    and closed with ``stack`` (the CPU groups leave the card to the
    others)."""
    from oasisx_tpu_torch.parallel.launch import start

    return [stack.enter_context(start(fn, world, args_of(dev))) for dev in devices]


@deferred
def slab_gpu_vs_cpu(n: int = 6, world: int = SLAB_WORLD, steps: int = 3,
                    devices=("cuda", "cpu"), stack=None):
    """Phase 5i: the slab path at world 2 (gloo) on cuda and on cpu, float64,
    N=6, rtol 1e-8, ``steps`` steps: every iteration count equal, u and p
    to 1e-12 relative (``devices`` ("cpu", "cpu") rehearses it)."""
    from oasisx_tpu_torch.parallel import ranks

    cfg = lambda dev: (dict(N=n, dtype="float64", device=dev, rtol=1e-8, steps=steps),)
    ga, gc = two_groups(stack, ranks.run_tgv, world, cfg, devices)
    return lambda: _slab_gpu_vs_cpu(n, world, steps, ga.join(SLAB_TIMEOUT)[0],
                                    gc.join(SLAB_TIMEOUT)[0])


def _slab_gpu_vs_cpu(n: int, world: int, steps: int, g: dict, c: dict) -> None:
    import numpy as np

    du, dp = _rel2(g["u"], c["u"]), _rel2(g["p"], c["p"])
    print(f"  N={n} world {world} f64 {steps} steps: u rel diff {du[0]:.3e}, p rel diff "
          f"{dp[0]:.3e}; launches on cuda {g['launches']}")
    for k in ("u_iters", "p_iters", "c_iters"):
        print(f"  {k}: cuda {g['stats'][k].tolist()} cpu {c['stats'][k].tolist()}")
        check(np.array_equal(g["stats"][k], c["stats"][k]), f"[5i] {k} differ between cuda "
              "and cpu")
    check(du[0] <= 1e-12 and dp[0] <= 1e-12,
          f"[5i] cuda and cpu disagree (u {du[0]:.3e}, p {dp[0]:.3e})")


HALO_WORLD = 2  # phase 4r's ranks on the one card (gloo)
HALO_TIMEOUT = 900.0  # a rank group's time limit (each collective: 60 s)
HALO_PROFILE = 1  # steps under torch.profiler after the timed ones
HALO_BAND_N = 18  # the vessel of phase 4r's band-layout group
HALO_CYL_RES = 30  # the cylinder of phase 4r-prime
HALO_CYL_STEPS = (1, 4)  # its warm-up and timed steps (5 + 10 before the graph legs)
# phase 4r's state gaps after its steps in f32 at rtol 1e-5, relative L2
# (the first readings were taken after 5 + 25 steps):
# world 2 against world 1, and world 1 against phase 4b's single-device
# path (K15 / K17's fused solves, the kernel path's x0: ROADMAP known
# differences f and h).  About twice the first readings on an H100 (PERF.md
# section 6: u 3.979e-6, p 1.019e-4; u 1.085e-2, p 3.254e-2).
HALO_WORLD_BOUND = {"u": 8e-6, "p": 2e-4}
HALO_SINGLE_BOUND = {"u": 0.022, "p": 0.065}


def halo_group(world: int, backend: str, runs: list, kres: dict | None = None, group=None,
               t0: float | None = None) -> list:
    """One group of ranks running ``parallel.ranks.halo_checks`` on the
    cfgs of ``runs`` [(phase label, cfg)], one after another (one spawn and
    set-up of the group for all; ``group``: the ranks already started, at
    ``t0``), each reported by ``halo_run`` (by ``replicated_run`` for
    phase 4s's).  Returns rank 0's result of each."""
    from oasisx_tpu_torch.parallel import ranks
    from oasisx_tpu_torch.parallel.launch import start

    if group is None:
        t0 = time.perf_counter()
        group = start(ranks.halo_checks, world, halo_args(runs), backend=backend)
    out = group.join(HALO_TIMEOUT)
    print(f"[{runs[0][0]}] a group of {world} ({backend}) for {len(runs)} run(s): "
          f"{time.perf_counter() - t0:.1f} s with the spawn")
    report = lambda label: replicated_run if label == "4s" else \
        (lambda *a: halo_run(*a, kres))
    return [report(label)(label, world, backend, cfg, [o["runs"][i] for o in out])
            for i, (label, cfg) in enumerate(runs)]


def halo_args(runs: list) -> tuple:
    """``parallel.ranks.halo_checks``'s arguments for the cfgs of ``runs``."""
    return None, [cfg for _, cfg in runs]


def halo_run(label: str, world: int, backend: str, cfg: dict, out: list,
             kres: dict | None = None) -> dict:
    """One run of ``parallel.ranks.run_halo`` (``out``: every rank's
    result): every rank's per-shard K14 (K18 under the band layout)
    against its plain version between the halo refresh and fold (f32:
    1e-5 relative, halo and sentinel slots exactly 0), every solve
    converged, the velocity finite, the path's kernels launched on every
    rank in the timed steps with the same count on every rank, no plain
    version, every rank's iterations equal; printed with the steps/s,
    iterations a step, exchanges, sums and gathers a step, the traffic,
    the partition, a halo refresh's and a sum's host ms, the set-up and
    other seconds by part and the card's busy share.  With ``kres`` each
    rank's timed per-shard cases join the kernel records.  Returns rank
    0's result, with its seconds on rank 0 (``seconds``: set-up and
    parts)."""
    import numpy as np

    from oasisx_tpu_torch.parallel import ranks

    r0 = out[0]
    steps = cfg["steps"]
    rep = r0["config"]
    r0["seconds"] = r0["setup_s"] + sum(r0["times"].values())
    size = (f"N={cfg['N']}" if cfg["problem"] == "vessel" else f"res={cfg['res']}"
            + (" rotational" if cfg.get("rotational") else ""))
    print(f"[{label}] {cfg['problem']} {size} {rep['ell_layout']}, world {world} ({backend}, "
          f"{rep['device']} x{world}): {r0['seconds']:.1f} s on rank 0 with set-up; pressure "
          f"{rep['pressure_pc']} ({rep['pressure_mg_levels']} levels); partition "
          f"{rep['partitioner']}; cells a rank {[r['config']['cells'] for r in out]}")
    check(rep["sharding"] == "graph-halo" and rep["ndev"] == world
          and rep["run"].startswith("eager: "), f"[{label}] {rep}")
    for r in out:
        parts = " ".join(f"{k} {v:.2f}" for k, v in {**r["setup_parts"], **r["times"]}.items())
        print(f"  rank {r['rank']} set-up {r['setup_s']:.1f} s ({parts})")
        for name, k in r.get("kernels", {}).items():
            t = (f"; kernel {k['ms']:.4f} ms, plain {k['plain_ms']:.4f} ms, library "
                 f"{k['library_ms']:.4f} ms, bound {bound(k['bytes'], k['flops'])['bound_ms']:.4f}"
                 f" ms" if "ms" in k else "")
            print(f"  rank {r['rank']} {name} per shard on {k['shape']}: before the fold rel "
                  f"err {k['raw_rel_err']:.3e} on every slot, sentinel 0: {k['sentinel_zero']}; "
                  f"after it max abs err {k['max_abs_err']:.3e} (rel {k['rel_err']:.3e} of "
                  f"{k['max_out']:.3e}), halo and sentinel 0: {k['halo_zero']}{t}")
            check(k["max_out"] > 0 and k["rel_err"] <= 1e-5 and k["raw_rel_err"] <= 1e-5
                  and k["sentinel_zero"] and k["halo_zero"],
                  f"[{label}] rank {r['rank']} {name}: {k}")
            if kres is not None and "ms" in k:
                kname, case = name.split(" ", 1)
                kres.setdefault(kname, []).append(dict(
                    case=f"per shard {case} batch {k['shape'][0] if len(k['shape']) == 2 else 1} "
                         f"{cfg['problem']} {size} {rep['ell_layout']} rank {r['rank']} of "
                         f"{world}",
                    max_abs_err=k["max_abs_err"], ms=k["ms"], plain_ms=k["plain_ms"],
                    **bound(k["bytes"], k["flops"]), library_ms=k["library_ms"]))
        st = r["stats"]
        for f in ("u", "p", "c") + (("rot",) if "rot_iters" in st else ()):
            check(bool(np.all(st[f + "_converged"])), f"[{label}] rank {r['rank']}: a {f} solve "
                  "did not converge")
            check(np.array_equal(st[f + "_iters"], r0["stats"][f + "_iters"]),
                  f"[{label}] rank {r['rank']}: {f} iterations differ from rank 0's")
        used = {k: r["launches"].get(k, 0) for k in rep["path_kernels"]}
        print(f"  rank {r['rank']} launches in {steps} steps {used}, plain calls "
              f"{r['plain_calls']}; comm {r['comm']}")
        check(all(v > 0 for v in used.values()), f"[{label}] rank {r['rank']}: {used}")
        check(used == {k: r0["launches"].get(k, 0) for k in rep["path_kernels"]},
              f"[{label}] rank {r['rank']}'s launches differ from rank 0's")
        check(not r["plain_calls"], f"[{label}] rank {r['rank']}: plain calls {r['plain_calls']}")
    check(bool(np.isfinite(r0["u"]).all()), f"[{label}] velocity not finite")
    it = ranks.iters_per_step(r0["stats"])
    tr, cm = r0["traffic"], r0["comm"]
    print(f"[{label}] {steps} steps in {r0['wall_s']:.3f} s = {r0['steps_per_s']:.4f} steps/s; "
          f"iterations a step u {it['u']:.3f} p {it['p']:.3f} c {it['c']:.3f}; worst exit "
          f"residuals u {float(r0['stats']['u_res'].max()):.3e} p "
          f"{float(r0['stats']['p_res'].max()):.3e} c {float(r0['stats']['c_res'].max()):.3e}")
    print(f"    a step: {cm['shift'][0] / steps:.1f} exchange rounds, {cm['sum'][0] / steps:.1f} "
          f"sums over ranks, {cm['gather'][0] / steps:.1f} gathers; bytes sent a step by rank 0: "
          f"{cm['shift'][1] / steps / 1e6:.4f} MB halo, {cm['sum'][1] / steps / 1e6:.4f} MB sums")
    print(f"    halo_traffic_report: {tr}")
    if "sum_ms" in r0:
        print(f"    one sum over ranks {r0['sum_ms']:.4f} ms, one halo refresh of u "
              f"{r0['halo_ms']:.4f} ms ({backend}, host clock, mean of 50)")
    if "profile_wall_ms" in r0:
        dev_ms = [r["profile_device_ms"] for r in out]
        wall = max(r["profile_wall_ms"] for r in out)
        cards = len({r["config"]["device"] for r in out})
        busy = sum(dev_ms) / wall / cards  # ranks on one card add up
        print(f"    profile of {r0['profile_steps']} more steps: wall {wall:.3f} ms, device time "
              f"a rank {[round(v, 3) for v in dev_ms]} ms (NCCL's kernels apart: "
              f"{[round(r['profile_nccl_ms'], 3) for r in out]} ms); busy share a card "
              f"{100 * busy:.1f}%, idle {100 - 100 * busy:.1f}%")
    r0["launch_counts"] = {k: r0["launches"].get(k, 0) for k in rep["path_kernels"]}
    if "split" in r0:  # phase 4k''s split step after the run, every rank's
        r0["splits_all"] = [r["split"] for r in out]
    return r0


def _gap(label: str, a: dict, b: dict, what: str, bound_: dict | None) -> None:
    du, dp = _rel2(a["u"], b["u"]), _rel2(a["p"], b["p"])
    print(f"[{label}] {what}: u max {du[0]:.3e} L2 {du[1]:.3e}, p max {dp[0]:.3e} L2 "
          f"{dp[1]:.3e} (L2 bound {bound_})")
    if bound_ is not None:
        check(du[1] <= bound_["u"] and dp[1] <= bound_["p"],
              f"[{label}] {what}: u {du[1]:.3e}, p {dp[1]:.3e} (bound {bound_})")


def halo_path(single: dict | None, kres: dict | None = None, n: int = N,
              warmup: int = SHARD_STEPS[0], steps: int = SHARD_STEPS[1], worlds=None,
              device: str = "cuda", band_n: int = HALO_BAND_N, cyl_res: int = HALO_CYL_RES,
              cyl_steps: tuple = HALO_CYL_STEPS, rep_steps: tuple = None) -> dict:
    """Phases 4r, 4r' and 4s.  4r: bench.py's unstructured configuration (the
    vessel at N, float32, rtol 1e-5, low_memory_version False) on the
    graph-halo path, ``warmup`` + ``steps`` steps, at world 1, over
    ``HALO_WORLD`` ranks on the one card (gloo) and over NCCL at world =
    the card count where that is 2 or more (``worlds``: [(world, backend)]
    in place of these); at world 2 the per-shard kernels timed and 5 steps
    profiled, then the band layout (the vessel at ``band_n``, K18 per
    shard, 3 steps).  The state gaps: world 2 against world 1, world 1
    against ``single`` (phase 4b's u and p after the same steps; None: not
    compared).  4r', in the world-2 group: the DFG cylinder at ``cyl_res``
    with its PressureBC(0) outlet and the rotational update, ``cyl_steps``
    (warm-up, timed) steps.  The vessel runs of the gloo groups of world 1
    and ``HALO_WORLD`` end with phase 4k''s split step.  4s, the last run
    of every group: the replicated mode (``options={"replicated": True}``)
    on the same vessel, ``rep_steps`` (warm-up, timed) steps, checked by
    ``replicated_run``; each world against world 1 (REP_WORLD_BOUND), and
    world 1, taken on to ``warmup + steps`` steps in all, against 4r's
    world-1 state after as many (REP_HALO_BOUND).  The gloo groups start at
    once: their spawns, set-ups and warm-ups overlap, and each run times
    its kernels, steps, profile and comm with the card to its group
    (``ranks._card_alone``); then NCCL's.  Returns {"counts": each run's launch counts,
    "cylinder_s": the 4r' run's seconds on rank 0, "world1": rank 0's
    world-1 vessel result, "splits": every rank's split result by
    world}."""
    import contextlib
    import multiprocessing as mp

    import torch

    from oasisx_tpu_torch.parallel import ranks
    from oasisx_tpu_torch.parallel.launch import start

    rep_steps = rep_steps or REP_STEPS
    ncard = torch.cuda.device_count()
    if worlds is None:
        worlds = [(1, "gloo"), (HALO_WORLD, "gloo")] + ([(ncard, "nccl")] if ncard >= 2 else [])
    cfg = dict(problem="vessel", N=n, dtype="float32", device=device, rtol=1e-5, warmup=warmup,
               steps=steps, dt=DT, nu=NU, check=True, time_comm=True)
    band = dict(cfg, N=band_n, warmup=1, steps=3, time_comm=False,
                options={"ell_layout": "band"}, time_kernels=True)
    cyl = dict(problem="cylinder", res=cyl_res, rotational=True, dtype="float32",
               device=device, rtol=1e-5, warmup=cyl_steps[0], steps=cyl_steps[1], check=True)
    rep = dict(problem="vessel", N=n, dtype="float32", device=device, rtol=1e-5,
               warmup=rep_steps[0], steps=rep_steps[1], dt=DT, nu=NU,
               options={"replicated": True}, time_comm=True)
    group_runs = {}
    for world, backend in worlds:
        vessel = dict(cfg, split=backend == "gloo" and world in (1, HALO_WORLD))
        runs = [("4r", vessel), ("4s", dict(rep, until=warmup + steps))]
        if world > 1:
            runs = [("4r", vessel), ("4s", dict(rep, profile=REP_PROFILE))]
        if world == HALO_WORLD and backend == "gloo":
            runs = [("4r", dict(vessel, profile=HALO_PROFILE, time_kernels=True)), ("4r", band),
                    ("4r'", cyl)] + runs[1:]
        group_runs[(world, backend)] = runs
    # the gloo groups run at once, each run timing its work with the card alone
    lock = mp.get_context("spawn").Lock()
    for (world, backend), runs in group_runs.items():
        if backend == "gloo":
            group_runs[(world, backend)] = [(label, dict(c, card_lock=lock)) for label, c in runs]
    results = {}
    with contextlib.ExitStack() as stack:
        t0 = time.perf_counter()
        groups = {key: stack.enter_context(start(ranks.halo_checks, key[0], halo_args(runs),
                                                 backend=key[1]))
                  for key, runs in group_runs.items() if key[1] == "gloo"}
        for key, group in groups.items():
            results[key] = halo_group(*key, group_runs[key], kres, group=group, t0=t0)
    for key, runs in group_runs.items():
        if key not in results:
            results[key] = halo_group(*key, runs, kres)
            torch.cuda.empty_cache()
    vessels, reps, out = {}, {}, {"counts": {}, "splits": {}}
    for (world, backend), res in results.items():
        vessels[(world, backend)], reps[(world, backend)] = res[0], res[-1]
        if "splits_all" in res[0]:
            out["splits"][world] = res[0]["splits_all"]
        for (label, c), r in zip(group_runs[(world, backend)], res):
            if label == "4s":
                continue
            what = ("cylinder" if c["problem"] == "cylinder" else
                    f"vessel N={c['N']} {(c.get('options') or {}).get('ell_layout', 'ell')}")
            out["counts"][f"{what} world {world} {backend}"] = r["launch_counts"]
            if label == "4r'":
                print(f"[4r'] rotational iterations a step "
                      f"{float(r['stats']['rot_iters'].mean()):.3f}")
                out["cylinder_s"] = r["seconds"]
    base = vessels.get((1, "gloo"))
    for key, r in vessels.items():
        if base is not None and key != (1, "gloo"):
            _gap("4r", r, base, f"world {key[0]} ({key[1]}) against world 1 after "
                 f"{warmup + steps} steps", HALO_WORLD_BOUND)
    if base is not None and single is not None:
        _gap("4r", base, single, "world 1 against phase 4b's single-device path",
             HALO_SINGLE_BOUND)
    one = reps.get((1, "gloo"))
    for (world, backend), r in reps.items():
        if one is not None and world > 1:
            _gap("4s", r, one, f"world {world} ({backend}) against world 1 after "
                 f"{sum(rep_steps)} steps", REP_WORLD_BOUND)
    if one is not None and base is not None:
        _gap("4s", one["until"], base, f"world 1 against phase 4r's graph-halo path at world 1 "
             f"after {warmup + steps} steps", REP_HALO_BOUND)
    out["world1"] = base
    return out


@deferred
def halo_gpu_vs_cpu(world: int = HALO_WORLD, steps: int = 3, devices=("cuda", "cpu"),
                    stack=None):
    """Phase 5j: the graph-halo path at world 2 (gloo) on cuda and on cpu,
    float64, rtol 1e-12, ``steps`` steps, on the res=10 cylinder (outlet,
    rotational) and the vessel at N=6: every iteration count equal, u and p
    to 1e-12 relative; the card's run against the port's single-device
    general path on the card to 1e-8 (``devices`` ("cpu", "cpu")
    rehearses it)."""
    from oasisx_tpu_torch.parallel import ranks

    cfgs = [dict(cfg, dtype="float64", rtol=1e-12, steps=steps)
            for cfg in (dict(problem="cylinder", res=10, rotational=True),
                        dict(problem="vessel", N=6, dt=DT, nu=NU))]
    runs = lambda dev: (None, [dict(c, device=dev) for c in cfgs])
    ga, gc = two_groups(stack, ranks.halo_checks, world, runs, devices)
    return lambda: _halo_gpu_vs_cpu(world, steps, devices, cfgs,
                                    ga.join(HALO_TIMEOUT)[0]["runs"],
                                    gc.join(HALO_TIMEOUT)[0]["runs"])


def _halo_gpu_vs_cpu(world: int, steps: int, devices, cfgs: list, gs: list, cs: list) -> None:
    import numpy as np
    import torch

    from oasisx_tpu_torch.parallel import ranks

    for cfg, g, c in zip(cfgs, gs, cs):
        label = f"{cfg['problem']} " + (f"res={cfg['res']}" if "res" in cfg else f"N={cfg['N']}")
        du, dp = _rel2(g["u"], c["u"]), _rel2(g["p"], c["p"])
        print(f"  {label} world {world} f64 {steps} steps: u rel diff {du[0]:.3e}, p rel diff "
              f"{dp[0]:.3e}; launches on {devices[0]} {g['launches']}")
        for k in ("u_iters", "p_iters", "c_iters"):
            print(f"  {k}: {devices[0]} {g['stats'][k].tolist()} {devices[1]} "
                  f"{c['stats'][k].tolist()}")
            check(np.array_equal(g["stats"][k], c["stats"][k]), f"[5j] {label}: {k} differ "
                  "between the devices")
        check(du[0] <= 1e-12 and dp[0] <= 1e-12,
              f"[5j] {label}: the devices disagree (u {du[0]:.3e}, p {dp[0]:.3e})")
        single = ranks.halo_solver(cfg, torch.float64, devices[0])
        single.run(steps, cfg.get("dt", ranks.CYL_DT), cfg.get("nu", ranks.CYL_NU))
        one = _state(single)
        du, dp = _rel2(g["u"], one["u"]), _rel2(g["p"], one["p"])
        print(f"  {label}: world {world} against the single-device general path: u rel diff "
              f"{du[0]:.3e}, p rel diff {dp[0]:.3e}")
        check(du[0] <= 1e-8 and dp[0] <= 1e-8, f"[5j] {label}: world {world} against the "
              f"single-device path (u {du[0]:.3e}, p {dp[0]:.3e})")
        del single
        torch.cuda.empty_cache()


def single_steps(solver, state0: dict | None, warmup: int, steps: int) -> dict:
    """The single-device reference of a sharded phase: from ``state0`` (a
    device state; None: the solver's own), ``warmup`` then ``steps`` steps;
    u, p (``_state``) after them and the timed steps' stats."""
    if state0 is not None:
        solver._set_device_state({k: v.clone() for k, v in state0.items()})
    solver.run(warmup, DT, NU, max_iter=1)
    stats = solver.run(steps, DT, NU, max_iter=1)
    return dict(_state(solver), stats=stats)


def _state(solver) -> dict:
    """A solver's u (d, n) and p on the host, float64."""
    import numpy as np

    return dict(u=np.stack([f.x.array.double().cpu().numpy() for f in solver._u]),
                p=solver._p.x.array.double().cpu().numpy())


def halo_phases(single: dict | None, kres: dict, worlds=None, gpu_vs_cpu: bool = True) -> dict:
    """Phases 4r, 4r' and 5j, each one's seconds printed, and K14's and
    K18's launches in each 4r / 4r' group's timed steps.  Returns
    ``halo_path``'s result."""
    import torch

    t0 = time.perf_counter()
    res = halo_path(single, kres, worlds=worlds)
    torch.cuda.empty_cache()
    took = time.perf_counter() - t0
    print(f"[4r] {took - res.get('cylinder_s', 0.0):.1f} s; [4r'] {res.get('cylinder_s', 0.0):.1f} "
          "s (its run in 4r's world-2 group)")
    for k, v in res["counts"].items():
        print(f"  launches in the timed steps, {k}, rank 0: {v}")
    if gpu_vs_cpu:
        print("[5j] cuda against cpu: the graph-halo path")
        t0 = time.perf_counter()
        halo_gpu_vs_cpu()
        print(f"[5j] {time.perf_counter() - t0:.1f} s")
    return res


SPLIT_WORLD = 2  # the ranks of 4s's second group and of 5k's groups on the one card (gloo)
REP_STEPS = (1, 3)  # phase 4s's warm-up and timed steps (2 + 5 before the graph legs)
# steps under torch.profiler after the timed ones, at world 2 and above
# (at world 1 two of them cost ~20 s on an H100's host, which records each
# of a step's thousands of small ops)
REP_PROFILE = 1
# phase 4s's state gaps in f32 at rtol 1e-5, relative L2: the replicated
# mode at world 1 against phase 4r's graph-halo state at world 1 after the
# same steps (their pressure preconditioners differ, Jacobi against the
# distributed AMG, and each solve stops within rtol 1e-5); over the ranks
# against world 1 after REP_STEPS (the f32 sums grouped by rank).  About
# twice the first readings on an H100, after 5 + 25 and 2 + 5 steps (PERF.md section 6: u
# 2.989e-4, p 1.362e-2; u 1.565e-6, p 7.459e-6).
REP_HALO_BOUND = {"u": 6e-4, "p": 0.028}
REP_WORLD_BOUND = {"u": 3.2e-6, "p": 1.5e-5}
# phase 4k-prime's split step at world 2 against world 1, relative L2 of u
# and ps, by path: f32 sums grouped by rank (and a shard-pure AMG under
# graph-halo), each solve to rtol 1e-5.  About twice the first readings
# (PERF.md section 6: slab u 5.485e-6, ps 9.125e-6; graph-halo u
# 3.885e-6, ps 4.014e-5).
SPLIT_MESH_BOUND = {"slab-halo": {"u": 1.1e-5, "p": 1.8e-5},
                    "graph-halo": {"u": 7.8e-6, "p": 8e-5}}
# each split phase's kernels under a device_mesh, by path (phases 4k-prime
# and 5k): the slab's cube kernels, K14 between the halo exchanges under
# graph-halo (the element assembly and the gathers launch none), none when
# replicated
SPLIT_MESH_KERNELS = {
    "slab-halo": {"assemble_first": {"cube_gather", "matvec_const", "matvec_win"},
                  "velocity_tentative_assemble": {"mixed"},
                  "velocity_tentative_solve": {"matvec_win"},
                  "pressure_assemble": {"divergence"}, "pressure_solve": {"matvec_const"},
                  "velocity_update": {"mixed", "matvec_const"}},
    "graph-halo": {"assemble_first": set(), "velocity_tentative_assemble": set(),
                   "velocity_tentative_solve": {"ell_matvec"}, "pressure_assemble": set(),
                   "pressure_solve": {"ell_matvec"}, "velocity_update": {"ell_matvec"}},
    "replicated": {p: set() for p in SPLIT_PHASES},
}
# the dense export's kernel by path: K3 per slab, K14 per rank, none replicated
DENSE_KERNEL = {"slab-halo": "matvec_win", "graph-halo": "ell_matvec", "replicated": None}


def replicated_run(label: str, world: int, backend: str, cfg: dict, out: list) -> dict:
    """One run of ``parallel.ranks.run_halo`` in the replicated mode
    (``out``: every rank's result): the mode and Jacobi-PCG reported, every
    solve converged, every rank's iterations and state bits rank 0's, no
    kernel and no plain version, the velocity finite; printed with the
    steps/s, iterations a step, the sums a step and bytes summed, one
    whole-vector sum's and one scalar sum's host ms, the card's busy share
    (where the run was profiled) and rank 0's seconds by part.  Returns
    rank 0's result."""
    import numpy as np

    from oasisx_tpu_torch.parallel import ranks

    r0, steps, rep = out[0], cfg["steps"], out[0]["config"]
    print(f"[{label}] vessel N={cfg['N']} replicated, world {world} ({backend}, "
          f"{rep['device']} x{world}): set-up {r0['setup_s']:.1f} s on rank 0; pressure "
          f"{rep['pressure_pc']}; cells a rank {[r['config']['cells'] for r in out]}")
    check(rep["sharding"] == "replicated" and rep["ndev"] == world
          and rep["pressure_pc"] == "jacobi-pcg" and rep["run"].startswith("eager: "),
          f"[{label}] {rep}")
    for r in out:
        for f in ("u", "p", "c"):
            check(bool(np.all(r["stats"][f + "_converged"])), f"[{label}] rank {r['rank']}: a {f} "
                  "solve did not converge")
            check(np.array_equal(r["stats"][f + "_iters"], r0["stats"][f + "_iters"]),
                  f"[{label}] rank {r['rank']}: {f} iterations differ from rank 0's")
        check(r["digest"] == r0["digest"], f"[{label}] rank {r['rank']}'s state differs from "
              "rank 0's in its bits")
        check(not r["launches"] and not r["plain_calls"], f"[{label}] rank {r['rank']}: launches "
              f"{r['launches']}, plain calls {r['plain_calls']}")
    check(bool(np.isfinite(r0["u"]).all()), f"[{label}] velocity not finite")
    it, cm = ranks.iters_per_step(r0["stats"]), r0["comm"]
    print(f"[{label}] {steps} steps in {r0['wall_s']:.3f} s = {r0['steps_per_s']:.4f} steps/s; "
          f"iterations a step u {it['u']:.3f} p {it['p']:.3f} c {it['c']:.3f}; worst exit "
          f"residuals u {float(r0['stats']['u_res'].max()):.3e} p "
          f"{float(r0['stats']['p_res'].max()):.3e} c {float(r0['stats']['c_res'].max()):.3e}; "
          f"every rank's state bit for bit rank 0's")
    print(f"    a step: {cm['sum'][0] / steps:.1f} sums over ranks, {cm['sum'][1] / steps / 1e6:.4f} "
          f"MB summed by rank 0; one sum of a velocity component {r0['vector_sum_ms']:.4f} ms, of "
          f"one value {r0['sum_ms']:.4f} ms ({backend}, host clock, mean of 50)")
    if "profile_wall_ms" in r0:
        dev_ms = [r["profile_device_ms"] for r in out]
        wall = max(r["profile_wall_ms"] for r in out)
        busy = sum(dev_ms) / wall / len({r["config"]["device"] for r in out})
        print(f"    profile of {r0['profile_steps']} more step(s): wall {wall:.3f} ms, device time a "
              f"rank {[round(v, 3) for v in dev_ms]} ms (NCCL's kernels apart: "
              f"{[round(r['profile_nccl_ms'], 3) for r in out]} ms); busy share a card "
              f"{100 * busy:.1f}%, idle {100 - 100 * busy:.1f}%")
    print("    seconds by part on rank 0: "
          + " ".join(f"{k} {v:.1f}" for k, v in r0["times"].items()))
    return r0


def split_report(mode: str, world: int, rs: list) -> None:
    """Phase 4k': one split step under the mesh on every rank (``rs``: each
    rank's ``ranks._split_result``): the mode, every reason 2, each phase's
    launches on every rank those of SPLIT_MESH_KERNELS and no plain call;
    printed with the diff, the iterations, each phase's wall (the slowest
    rank) and rank 0's launches by phase."""
    import numpy as np

    check(all(r["config"]["sharding"] == mode for r in rs), f"[4k'] {mode}: "
          f"{[r['config']['sharding'] for r in rs]}")
    for r in rs:
        reasons = np.concatenate([np.ravel(v) for v in r["reasons"].values()])
        check(bool(np.all(reasons == 2)), f"[4k'] {mode} world {world} rank {r['rank']}: "
              f"reasons {r['reasons']}")
        for phase, want in SPLIT_MESH_KERNELS[mode].items():
            ph = r["phases"][phase]
            check(set(ph["launches"]) == want and not ph["plain_calls"],
                  f"[4k'] {mode} world {world} rank {r['rank']} {phase}: launches "
                  f"{ph['launches']} (want {sorted(want)}), plain {ph['plain_calls']}")
    walls = {p: max(r["phases"][p]["s"] for r in rs) * 1e3 for p in SPLIT_PHASES}
    print(f"[4k'] {mode} world {world}: diff {rs[0]['diff']:.6e}, iterations {rs[0]['iters']}; "
          "each phase's wall, the slowest rank (ms): "
          + ", ".join(f"{p} {t:.3f}" for p, t in walls.items()) + f"; sum {sum(walls.values()):.3f}")
    print("    rank 0's launches by phase: "
          + "; ".join(f"{p} {rs[0]['phases'][p]['launches']}" for p in SPLIT_PHASES))


def split_mesh_report(splits: dict) -> None:
    """Phase 4k': the split steps that end 4q's and 4r's gloo groups
    (``splits``: {mode: {world: every rank's result}}), each by
    ``split_report``, and the largest world's step's u and ps against world
    1's (SPLIT_MESH_BOUND)."""
    for mode, by_world in splits.items():
        for world in sorted(by_world):
            split_report(mode, world, by_world[world])
        w = max(by_world, default=1)
        if 1 in by_world and w > 1:
            a, b = by_world[w][0], by_world[1][0]
            _gap("4k'", dict(u=a["u"], p=a["ps"]), dict(u=b["u"], p=b["ps"]),
                 f"{mode}: the split step at world {w} against world 1 (p: ps)",
                 SPLIT_MESH_BOUND[mode])


@deferred
def shard_gpu_vs_cpu(world: int = SPLIT_WORLD, devices=("cuda", "cpu"), stack=None):
    """Phase 5k: every sharded mode on cuda and on cpu at world 2 (gloo),
    float64, rtol 1e-12, small sizes.  The replicated mode 3 ``run`` steps
    on the vessel at N=6 and the res=10 cylinder: every iteration count
    equal, u and p to 1e-10.  One split step each on the slab path (the box
    at N=6), graph-halo (the vessel at N=6) and the replicated mode (the
    vessel at N=6, the cylinder at res=10): reasons and iterations equal, u
    and ps to 1e-10; on cuda each split phase's and the dense export's
    kernels launched (SPLIT_MESH_KERNELS, DENSE_KERNEL), no plain version.
    ``tentative_matrix_dense`` after each: equal to the cpu export and to
    the single-device export on cuda to 1e-12.  ``devices`` ("cpu", "cpu")
    rehearses it."""
    from oasisx_tpu_torch.parallel import ranks

    rep = {"replicated": True}
    small = (dict(problem="vessel", N=6), dict(problem="cylinder", res=10))
    base = dict(dtype="float64", rtol=1e-12)
    runs = [dict(base, **c, options=rep, steps=3) for c in small]
    splits = [dict(base, problem="box", N=6, dense=True), dict(base, **small[0], dense=True)]
    splits += [dict(base, **c, options=rep, dense=True) for c in small]
    args = lambda dev: (None, [dict(c, device=dev) for c in runs],
                        [dict(c, device=dev) for c in splits])
    ga, gc = two_groups(stack, ranks.halo_checks, world, args, devices)
    return lambda: _shard_gpu_vs_cpu(world, devices, runs, splits, ga.join(HALO_TIMEOUT),
                                     gc.join(HALO_TIMEOUT))


def _shard_gpu_vs_cpu(world: int, devices, runs: list, splits: list, g_all: list,
                      c_all: list) -> None:
    import numpy as np
    import torch

    from oasisx_tpu_torch.parallel import ranks

    name = lambda c: c["problem"] + (f" N={c['N']}" if "N" in c else f" res={c['res']}")
    for i, cfg in enumerate(runs):
        g, c = g_all[0]["runs"][i], c_all[0]["runs"][i]
        du, dp = _rel2(g["u"], c["u"]), _rel2(g["p"], c["p"])
        print(f"  {name(cfg)} replicated world {world} f64 3 steps: u rel diff {du[0]:.3e}, p "
              f"rel diff {dp[0]:.3e}; {devices[0]} launches {g['launches']}, plain "
              f"{g['plain_calls']}")
        for k in ("u_iters", "p_iters", "c_iters"):
            print(f"  {k}: {devices[0]} {g['stats'][k].tolist()} {devices[1]} "
                  f"{c['stats'][k].tolist()}")
            check(np.array_equal(g["stats"][k], c["stats"][k]), f"[5k] {name(cfg)} replicated: "
                  f"{k} differ between the devices")
        check(du[0] <= 1e-10 and dp[0] <= 1e-10, f"[5k] {name(cfg)} replicated: the devices "
              f"disagree (u {du[0]:.3e}, p {dp[0]:.3e})")
        check(len({o["runs"][i]["digest"] for o in g_all}) == 1, f"[5k] {name(cfg)} replicated: "
              "the ranks' states differ in their bits")
    for i, cfg in enumerate(splits):
        g, c = g_all[0]["splits"][i], c_all[0]["splits"][i]
        mode = g["config"]["sharding"]
        label = f"{name(cfg)} {mode}"
        du, dp = _rel2(g["u"], c["u"]), _rel2(g["ps"], c["ps"])
        reasons = lambda r: {k: np.asarray(v).tolist() for k, v in r["reasons"].items()}
        print(f"  {label} split step: u rel diff {du[0]:.3e}, ps rel diff {dp[0]:.3e}; reasons "
              f"{reasons(g)}; iterations {devices[0]} {g['iters']} {devices[1]} {c['iters']}")
        check(reasons(g) == reasons(c) and g["iters"] == c["iters"],
              f"[5k] {label}: reasons or iterations differ between the devices")
        check(du[0] <= 1e-10 and dp[0] <= 1e-10, f"[5k] {label}: the split steps disagree (u "
              f"{du[0]:.3e}, ps {dp[0]:.3e})")
        if torch.device(devices[0]).type == "cuda":
            for r in (o["splits"][i] for o in g_all):
                used = {p: set(ph["launches"]) for p, ph in r["phases"].items()}
                plain = {p: ph["plain_calls"] for p, ph in r["phases"].items() if ph["plain_calls"]}
                want = DENSE_KERNEL[mode]
                check(used == SPLIT_MESH_KERNELS[mode] and not plain,
                      f"[5k] {label} rank {r['rank']}: launches {used}, plain {plain}")
                check(set(r["dense_launches"]) == ({want} if want else set()),
                      f"[5k] {label} rank {r['rank']}: the dense export launched "
                      f"{r['dense_launches']}")
            print(f"  {label}: rank 0's launches by phase "
                  + "; ".join(f"{p} {ph['launches']}" for p, ph in g["phases"].items())
                  + f"; the dense export {g['dense_launches']}")
        single = ranks.halo_solver(dict(cfg, options=None), torch.float64, devices[0])
        single.assemble_first(*ranks.step_size(cfg))
        A1 = single.tentative_matrix_dense()
        del single
        e_dev = float(np.abs(g["dense"] - c["dense"]).max())
        e_one = float(np.abs(g["dense"] - A1).max())
        print(f"  {label} tentative_matrix_dense {g['dense'].shape}: against {devices[1]} "
              f"{e_dev:.3e}, against the single-device export on {devices[0]} {e_one:.3e}")
        check(e_dev <= 1e-12 and e_one <= 1e-12, f"[5k] {label}: the dense export differs "
              f"({e_dev:.3e}, {e_one:.3e})")
        torch.cuda.empty_cache()


def shard_phases(slab_splits: dict, halo: dict, gpu_vs_cpu: bool = True) -> None:
    """Phases 4k' (the split steps that 4q's and 4r's gloo groups ended
    with: ``slab_splits``, ``halo["splits"]``) and 5k, its seconds
    printed (4s runs in 4r's groups)."""
    split_mesh_report({"slab-halo": slab_splits, "graph-halo": halo["splits"]})
    if not gpu_vs_cpu:
        return
    print("[5k] cuda against cpu: the replicated mode, the split step and the dense export on "
          "every sharded mode")
    t0 = time.perf_counter()
    shard_gpu_vs_cpu()
    print(f"[5k] {time.perf_counter() - t0:.1f} s")


PTX_SOURCES = ("cube_ops.cu", "krylov_ops.cu", "ell_ops.cu")
PTX_NO_DIVISION = ("cube_ops.cu", "krylov_ops.cu")  # phase 2 fails on a 64-bit div/rem there


def ptx_divisions(roots: dict) -> dict:
    """Per checkout ``roots[tag]`` and per source of PTX_SOURCES, the 64-bit
    integer divisions and remainders (div/rem on .s64/.u64) in the PTX that
    nvcc -ptx emits for the kernels' target (sm_90a, -std=c++17 -O3), every
    source of every checkout compiled in parallel into build/ptx/.  Imports
    no package, so that --tree still loads the other checkout's."""
    import os
    import re
    import shutil

    nvcc = shutil.which("nvcc") or os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                                                "bin", "nvcc")
    outdir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "ptx")
    os.makedirs(outdir, exist_ok=True)
    jobs = {}
    for tag, root in roots.items():
        for src in PTX_SOURCES:
            out = os.path.join(outdir, f"{tag}.{src}.ptx")
            cmd = [nvcc, "-ptx", "-arch=sm_90a", "-std=c++17", "-O3", "-o", out,
                   os.path.join(root, "oasisx_tpu_torch", "csrc", src)]
            jobs[tag, src] = (out, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                    stderr=subprocess.STDOUT, text=True))
    pat = re.compile(r"\b(?:div|rem)\.[su]64\b")
    counts: dict = {}
    for (tag, src), (out, proc) in jobs.items():
        log = proc.communicate()[0]
        check(proc.returncode == 0, f"nvcc -ptx {src} ({tag}) failed:\n{log}")
        with open(out) as f:
            counts.setdefault(tag, {})[src] = len(pat.findall(f.read()))
    return counts


def nvidia_smi() -> str:
    try:
        r = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
        return r.stdout.strip().splitlines()[0] if r.returncode == 0 and r.stdout.strip() else "not available"
    except (OSError, subprocess.TimeoutExpired):
        return "not available"


def solves_phases(log: StepLog, profile: int = 0) -> None:
    """--solves-only: phase 3's whole-solve cases (solve_cases on the N=36
    systems, box_solve_cases on the two unequal grids; float64 and float32),
    K1 MG at N=64 (mg_cube_cases) and on the MG_BOXES and MG_CUBES grids
    and MG_GRID_BOXES (mg_route_cases),
    phase 3e's K1 cases at N=35, the N=35 main path 4f and the N=36 main
    path 4 with its graph leg, the main paths into ``log``: K1's and K4's kernels against
    their plain versions and timed, in a few minutes; with ``profile``, a
    torch.profiler window of that many steps after 4f's and 4's
    (profile_steps).  Under --tree the other checkout's package runs these
    cases, so that both trees run the same ones."""
    import torch

    t0 = time.perf_counter()
    smi = nvidia_smi()
    solver = tgv_solver(N, torch.float32, "cuda", rtol=1e-5)
    solver64 = tgv_solver(N, torch.float64, "cuda", rtol=SOLVE_RTOL["float64"])
    print(f"[3] whole solves against plain versions (N={N})")
    compare_solves({"float64": solver64, "float32": solver}, "cuda")
    del solver64
    print(f"[3c] K1 MG against its plain version (N={N64}: N={N}'s cube matrix scaled by the "
          "cell width)")
    compare_solves({"float64": (solver, torch.float64), "float32": (solver, torch.float32)},
                   "cuda", cases_fn=mg_cube_cases, suffix=f" N={N64}")
    for cells in BOXES:
        box = tgv_solver(cells, torch.float32, "cuda", rtol=1e-5)
        tag = " " + "x".join(map(str, cells))
        print(f"[3] whole solves against plain versions ({len(cells)}D, {tag[1:]} cells)")
        compare_solves({"float64": (box, torch.float64), "float32": (box, torch.float32)},
                       "cuda", cases_fn=box_solve_cases, suffix=tag)
        del box
    mg_route_cases(solver, "cuda", MG_BOXES + MG_GRID_BOXES)
    s35 = tgv_solver(N_ODD, torch.float32, "cuda", rtol=1e-5)
    rep35 = s35.config_report()
    check(rep35["pressure_pc"] == "cheb-pcg", f"N={N_ODD}: pressure {rep35['pressure_pc']}")
    print(f"[3e] K1's non-MG modes against plain versions (N={N_ODD})")
    compare_solves({"float64": (s35, torch.float64), "float32": (s35, torch.float32)}, "cuda",
                   cases_fn=pcg_solve_cases, suffix=f" N={N_ODD}")
    res = drive_main_path(s35, WARMUP, STEPS, "cuda", rep35["path_kernels"])
    report_path("4f", res, STEPS, 3 * s35._Vi[0][0].num_dofs, smi, {}, log)
    if profile:
        profile_steps(s35, profile, "build/chip_smoke_trace_n35.json")
    del s35
    # 4. the N=36 main path (K1 MG), last: under --tree its step check ends
    # the run where the two trees' iterations part
    rep = solver.config_report()
    check(rep["pressure_pc"] == "mg-pcg", f"N={N}: pressure {rep['pressure_pc']}, not mg-pcg")
    res = drive_main_path(solver, WARMUP, STEPS, "cuda", rep["path_kernels"])
    report_path("4", res, STEPS, 3 * solver._Vi[0][0].num_dofs, smi, TPU_ERA_ITERS, log)
    graph_leg(solver, "4", smi)
    if profile:
        profile_steps(solver, profile, "build/chip_smoke_trace.json")
    print(f"[solves] {time.perf_counter() - t0:.1f} s")


def run_tree(root: str, argv: list, solves_only: bool = False, profile: int = 0) -> int:
    """--tree: the chip_smoke.py of another checkout ``root`` on its own
    package and kernel build, with this file's ``time_ms``, so that the
    times of two trees come from one timer.  Its phases and checks are its
    own; with ``solves_only``, this file's solves_phases on its package
    (``profile`` its 4f profile window)."""
    import importlib.util
    import os

    global OTHER_TREE
    root = os.path.abspath(root)
    here = os.path.dirname(os.path.abspath(__file__))
    if solves_only:
        OTHER_TREE = True
        os.chdir(root)
        sys.path.insert(0, root)
        print(f"[tree] {root}: its package, this file's solves_phases and time_ms")
        log = StepLog("tree")
        solves_phases(log, profile)
        log.report_skipped()
        return 0
    counts = ptx_divisions({"tree": root, "this": here})
    print(f"[2] 64-bit integer div/rem in the PTX: {root} {counts['tree']}; {here} "
          f"{counts['this']}")
    os.chdir(root)
    sys.path.insert(0, root)
    spec = importlib.util.spec_from_file_location("chip_smoke_tree",
                                                  os.path.join(root, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.time_ms = time_ms
    # the other tree's main paths in this checkout's step log, role "tree"
    log = StepLog("tree")
    drive, report = mod.drive_main_path, mod.report_path

    def drive_logged(solver, *a, **k):
        return dict(drive(solver, *a, **k), state_sha=state_sha(solver))

    def report_logged(tag, res, *a, **k):
        log.add(tag, res, res["state_sha"])
        return report(tag, res, *a, **k)

    mod.drive_main_path, mod.report_path = drive_logged, report_logged
    sys.argv = [spec.origin, *argv]
    print(f"[tree] {root}: its chip_smoke.py, timed by this one's time_ms")
    try:
        rc = mod.main()
    except mod.SmokeError as e:
        raise SmokeError(f"{root}: {e}") from e
    log.report_skipped()
    return rc


def band_setup(n: int, tree: str | None) -> int:
    """--band-setup: ``build_band_assembly`` (RCM, slots, pair tables,
    assembly map) of the vessel's P2 velocity dofmap at ``n``, on the CPU:
    its seconds and the process's peak resident memory before and after
    it; with ``tree``, the package of that checkout."""
    import os
    import resource

    if tree:
        sys.path.insert(0, os.path.abspath(tree))
    import oasisx_tpu_torch
    from oasisx_tpu_torch.assembly.band import build_band_assembly
    from oasisx_tpu_torch.elements.element import make_element
    from oasisx_tpu_torch.meshes import create_box
    from oasisx_tpu_torch.spaces.functionspace import FunctionSpace

    mesh = deform_vessel(create_box((-1.0, -1.0, -1.0), (1.0, 1.0, 1.0), (n, n, n)))
    el = make_element(("Lagrange", 2), mesh.cell_type)
    V = FunctionSpace(mesh, el, shape=(mesh.dim,)).sub(0).collapse()[0]
    peak_mib = lambda: resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024  # KiB on Linux
    before = peak_mib()
    t0 = time.perf_counter()
    asm = build_band_assembly(V.dofmap.cell_dofs, V.num_dofs, "cpu")
    seconds = time.perf_counter() - t0
    print(f"[band-setup] {os.path.dirname(oasisx_tpu_torch.__file__)}: vessel N={n}, "
          f"{V.num_dofs} dofs, S {asm.S} R {asm.R} P {asm.P}, {seconds:.2f} s; peak resident "
          f"memory {before:.1f} MiB before, {peak_mib():.1f} MiB after")
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", type=int, default=0, metavar="STEPS",
                    help="profile this many more steps after each main path")
    ap.add_argument("--tree", metavar="DIR",
                    help="run another checkout's chip_smoke.py with this file's time_ms")
    ap.add_argument("--band-setup", type=int, default=0, metavar="N",
                    help="only time the band layout's host set-up of the vessel at N")
    ap.add_argument("--slab-only", action="store_true",
                    help="only build the kernels and run phase 4q")
    ap.add_argument("--slab-n", type=int, default=N, choices=sorted(SLAB_SINGLE_BOUND),
                    help="phase 4q's N (default %(default)s)")
    ap.add_argument("--slab-world", type=int, default=0,
                    help="with --slab-only: phase 4q at world 1 and over this many ranks (NCCL, "
                         "a card each, where the cards suffice; else gloo on one card)")
    ap.add_argument("--halo-only", action="store_true",
                    help="only build the kernels and run phases 4r, 4r' and 5j (with the "
                         "single-device vessel run that 4r compares with)")
    ap.add_argument("--halo-world", type=int, default=0,
                    help="with --halo-only: phase 4r at world 1 and over this many ranks (NCCL, "
                         "a card each, where the cards suffice; else gloo on one card)")
    ap.add_argument("--shard-only", action="store_true",
                    help="only build the kernels and run phases 4q and 4r (with 4r' and 4s; "
                         "their groups end with 4k''s split steps), 4k' and 5k")
    ap.add_argument("--solves-only", action="store_true",
                    help="only build the kernels and run phase 3's whole-solve cases, 3e's K1 "
                         "cases and the N=35 main path 4f (with --tree: on that checkout's "
                         "package)")
    ap.add_argument("--slab-gap", type=int, nargs="+", metavar="N",
                    help="only build the kernels and measure, at each N, the slab path at world "
                         "1 against the single-device path in f32 and f64 at two tolerances")
    args = ap.parse_args()
    if args.band_setup:
        return band_setup(args.band_setup, args.tree)
    if args.tree:
        return run_tree(args.tree, ["--profile", str(args.profile)] if args.profile else [],
                        solves_only=args.solves_only, profile=args.profile)

    import os

    import torch

    t_start = time.perf_counter()
    # 1. card
    check(torch.cuda.is_available(), "no CUDA device (torch.cuda.is_available() is false)")
    try:
        import oasisx_tpu_torch  # noqa: F401
        from oasisx_tpu_torch import _build
        from oasisx_tpu_torch.assembly import kernels as kn
    except ImportError as e:
        raise SmokeError(f"oasisx_tpu_torch not importable; run from a checkout ({e})")
    check("jax" not in sys.modules, "jax was imported")
    steps_log = StepLog("this")
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    print(f"[1] card: {kind}; nvidia-smi: {smi}; torch {torch.__version__} cuda {torch.version.cuda}")

    # 2. build, and the PTX of phase 2's division count compiled meanwhile
    from concurrent.futures import ThreadPoolExecutor

    t0 = time.perf_counter()
    with ThreadPoolExecutor(1) as pool:
        ptx = pool.submit(ptx_divisions, {"this": os.path.dirname(os.path.abspath(__file__))})
        _build.library()
        print(f"[2] build: {time.perf_counter() - t0:.1f} s (nvcc {_build.build_seconds})")
        if _build.build_log.strip():
            print(_build.build_log.strip())
        divs = ptx.result()["this"]
    print(f"[2] 64-bit integer div/rem in the PTX: {divs} ({time.perf_counter() - t0:.1f} s with "
          "the build)")
    for src in PTX_NO_DIVISION:
        check(divs[src] == 0, f"{src}'s PTX has {divs[src]} 64-bit integer divisions or "
              "remainders")
    check_tiles()
    check_mg_plans()
    if args.solves_only:
        solves_phases(steps_log, args.profile)
        print(f"total {time.perf_counter() - t_start:.1f} s")
        print(smi)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
        return 0
    if args.slab_gap:
        slab_gap(args.slab_gap)
        print(f"total {time.perf_counter() - t_start:.1f} s")
        return 0
    if args.halo_only:
        worlds = None
        if args.halo_world:
            w = args.halo_world
            worlds = [(1, "gloo"), (w, "nccl" if torch.cuda.device_count() >= w > 1 else "gloo")]
        t0 = time.perf_counter()
        vessel = tgv_solver(N, torch.float32, "cuda", rtol=1e-5, vessel=True)
        res = drive_main_path(vessel, *SHARD_STEPS, "cuda", kn.ELL_KERNELS)
        single = _state(vessel)
        del vessel
        torch.cuda.empty_cache()
        print(f"[4b] the single-device vessel for 4r: {res['wall']:.3f} s for {SHARD_STEPS[1]} steps "
              f"({time.perf_counter() - t0:.1f} s with set-up)")
        halo_phases(single, {}, worlds)
        print(f"total {time.perf_counter() - t_start:.1f} s")
        print(smi)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
        return 0
    if args.shard_only:
        t0 = time.perf_counter()
        slab_splits = slab_path()
        print(f"[4q] {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        halo = halo_path(None)
        print(f"[4r] [4r'] {time.perf_counter() - t0:.1f} s")
        shard_phases(slab_splits, halo)
        print(f"total {time.perf_counter() - t_start:.1f} s")
        print(smi)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
        return 0
    if args.slab_only:
        worlds = None
        if args.slab_world:
            w = args.slab_world
            worlds = [(1, "gloo"), (w, "nccl" if torch.cuda.device_count() >= w > 1 else "gloo")]
        t0 = time.perf_counter()
        slab_path(n=args.slab_n, worlds=worlds)
        print(f"[4q] {time.perf_counter() - t0:.1f} s")
        print(f"total {time.perf_counter() - t_start:.1f} s")
        print(smi)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
        return 0

    # 4a. structured main-path setup (its shapes feed phase 3)
    t0 = time.perf_counter()
    solver = tgv_solver(N, torch.float32, "cuda", rtol=1e-5)
    _sync("cuda")
    nvel = 3 * solver._Vi[0][0].num_dofs
    print(f"[4] setup N={N}: {time.perf_counter() - t0:.1f} s, {nvel} velocity dofs")

    # 3. cube kernels against their plain versions
    print(f"[3] kernels against plain versions (N={N} shapes)")
    kres = compare_kernels(solver, "cuda")
    gather_loops(solver)
    print("[3] K3 on every cube degree and batch")
    check_win_sweep("cuda")
    print("[3] K6 and K7 on every degree pair")
    check_mixed_sweep("cuda")
    box_solves: dict = {}
    for cells in BOXES:
        box = tgv_solver(cells, torch.float32, "cuda", rtol=1e-5)
        tag = " " + "x".join(map(str, cells))
        print(f"[3] kernels against plain versions ({len(cells)}D, {tag[1:]} cells)")
        for name, recs in compare_kernels(box, "cuda", tag=tag).items():
            kres[name] = kres[name] + recs
        for name, recs in compare_solves(
                {"float64": (box, torch.float64), "float32": (box, torch.float32)}, "cuda",
                cases_fn=box_solve_cases, suffix=tag).items():
            box_solves[name] = box_solves.get(name, []) + recs
        del box
    solver64 = tgv_solver(N, torch.float64, "cuda", rtol=SOLVE_RTOL["float64"])
    kres.update(compare_solves({"float64": solver64, "float32": solver}, "cuda"))
    del solver64
    for name, recs in mg_route_cases(solver, "cuda").items():
        box_solves[name] = box_solves.get(name, []) + recs
    for name, recs in box_solves.items():
        kres[name] = kres.get(name, []) + recs

    # 4. the structured main path
    rep = solver.config_report()
    check(rep["pressure_pc"] == "mg-pcg", f"N={N}: pressure {rep['pressure_pc']}, not mg-pcg")
    state0 = {k: v.clone() for k, v in solver._state_from_functions().items()}
    res = drive_main_path(solver, WARMUP, STEPS, "cuda", rep["path_kernels"])
    report_path("4", res, STEPS, nvel, smi, TPU_ERA_ITERS, steps_log)
    launches = {k: v for k, v in res["launches"].items() if v}
    base4 = res["launches"]
    graph_leg(solver, "4", smi)
    single4 = single_steps(solver, state0, *SHARD_STEPS)  # phase 4q's reference
    del state0
    if args.profile:
        profile_steps(solver, args.profile, "build/chip_smoke_trace.json")
    # 4t, 4u, 4v. the device while loops: phase 4's solver at max_iter 3,
    # the option solves' Krylov loops; the loop alone first
    loop_rec = loop_probe()
    legs = loop_legs(solver, smi)
    loop_rec["launches"] = legs["4t"]["setter"]
    del solver
    torch.cuda.empty_cache()

    # 4g. the structured main path with the lumped velocity update: K6 on
    # Gw_c in place of K4's mass solve
    lumped = {"pc_type": "lumped"}
    t0 = time.perf_counter()
    slump = tgv_solver(N, torch.float32, "cuda", rtol=1e-5, scalar=lumped)
    _sync("cuda")
    rep = slump.config_report()
    print(f"[4g] setup N={N}, lumped update: {time.perf_counter() - t0:.1f} s; velocity update "
          f"{rep['velocity_update']}, kernels {rep['path_kernels']}")
    check(rep["velocity_update"] == "lumped" and "cg_mass" not in rep["path_kernels"],
          f"[4g] {rep['velocity_update']} update with {rep['path_kernels']}")
    res = drive_main_path(slump, WARMUP, STEPS, "cuda", rep["path_kernels"])
    report_path("4g", res, STEPS, nvel, smi, {}, steps_log)
    check_lumped("4g", res, STEPS, 1e-5, {"matvec_const": 1, "mixed": 2, "cg_mass": 0})
    if args.profile:
        profile_steps(slump, args.profile, "build/chip_smoke_trace_lumped.json")
    del slump
    torch.cuda.empty_cache()

    # 4i. the structured main path with the rotational pressure update: K5
    # and K4 at batch 1 on Mq_c, K7's output reused
    t0 = time.perf_counter()
    srot = tgv_solver(N, torch.float32, "cuda", rtol=1e-5, rotational=True)
    _sync("cuda")
    rep = srot.config_report()
    print(f"[4i] setup N={N}, rotational update: {time.perf_counter() - t0:.1f} s; pressure "
          f"update {rep['pressure_update']}, kernels {rep['path_kernels']}")
    check(rep["pressure_update"] == "rotational", f"[4i] pressure update {rep['pressure_update']}")
    res = drive_main_path(srot, WARMUP, STEPS, "cuda", rep["path_kernels"])
    report_path("4i", res, STEPS, nvel, smi, {}, steps_log)
    check_rotational("4i", res, STEPS, 1e-5, base4, {"matvec_const": 1, "cg_mass": 1})
    if args.profile:
        profile_steps(srot, args.profile, "build/chip_smoke_trace_rotational.json")
    del srot
    torch.cuda.empty_cache()

    # 4k. the split-phase API at N=36 against run, step by step
    t0 = time.perf_counter()
    split_phase_path("cuda", smi)
    torch.cuda.empty_cache()
    print(f"[4k] {time.perf_counter() - t0:.1f} s")

    # 5. GPU against CPU
    print("[5] cuda against cpu")
    gpu_vs_cpu(lambda dt, dev: tgv_solver(6, dt, dev, rtol=1e-8), "N=6", pressure_pc="mg-pcg")

    # 3e. K1's non-MG modes at the N=35 shapes (the grid does not coarsen),
    # with the cube kernels there; 4f. the N=35 main path
    t0 = time.perf_counter()
    s35 = tgv_solver(N_ODD, torch.float32, "cuda", rtol=1e-5)
    _sync("cuda")
    rep35 = s35.config_report()
    cheb = rep35.get("pressure_cheb")
    nvel35 = 3 * s35._Vi[0][0].num_dofs
    print(f"[4f] setup N={N_ODD}: {time.perf_counter() - t0:.1f} s, {nvel35} velocity dofs, "
          f"{s35._npad_q} pressure dofs, pressure {rep35['pressure_pc']} {cheb}")
    check(rep35["pressure_pc"] == "cheb-pcg", f"N={N_ODD}: pressure {rep35['pressure_pc']}")
    print(f"[3e] kernels against plain versions (N={N_ODD} shapes)")
    for name, recs in compare_kernels(s35, "cuda", tag=f" N={N_ODD}").items():
        kres[name] = kres[name] + recs
    pcg35 = compare_solves({"float64": (s35, torch.float64), "float32": (s35, torch.float32)},
                           "cuda", cases_fn=pcg_solve_cases, suffix=f" N={N_ODD}")
    kres["pressure_cg"] = pcg35["pressure_cg"] + kres.get("pressure_cg", [])
    res = drive_main_path(s35, WARMUP, STEPS, "cuda", rep35["path_kernels"])
    report_path("4f", res, STEPS, nvel35, smi, {}, steps_log)
    print(f"    pressure Chebyshev({cheb['degree']})-Jacobi: lmax estimated "
          f"{cheb['lmax_estimate']:.6f}, validated {cheb['lmax']:.6f}, lmin {cheb['lmin']:.6f}")
    launches["pressure_cg"] = res["launches"]["pressure_cg"]
    graph_leg(s35, "4f", smi)
    if args.profile:
        profile_steps(s35, args.profile, "build/chip_smoke_trace_n35.json")
    del s35
    torch.cuda.empty_cache()

    # 5d. GPU against CPU with K1's non-MG modes
    print("[5d] cuda against cpu, K1's non-MG modes")
    gpu_vs_cpu(lambda dt, dev: tgv_solver(5, dt, dev, rtol=1e-8), "N=5", pressure_pc="cheb-pcg")
    gpu_vs_cpu(lambda dt, dev: tgv_solver(6, dt, dev, rtol=1e-8, pressure={"pc_type": "jacobi"}),
               "N=6 pc_type jacobi", pressure_pc="jacobi-pcg")

    # 3c. the structured kernels at the N=64 shapes (the f64 cases on the
    # f32 solver's operators cast), and 4d. the N=64 main path
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    s64 = tgv_solver(N64, torch.float32, "cuda", rtol=1e-5)
    _sync("cuda")
    setup64 = time.perf_counter() - t0
    nvel64 = 3 * s64._Vi[0][0].num_dofs
    rep64 = s64.config_report()
    levels64 = rep64["pressure_mg_levels"]
    print(f"[4d] setup N={N64}: {setup64:.1f} s, {nvel64} velocity dofs, pressure MG "
          f"{levels64} levels, device memory {torch.cuda.memory_allocated() / 2**20:.1f} MiB")
    check(rep64["pressure_pc"] == "mg-pcg" and levels64 == 5,
          f"N={N64}: pressure {rep64['pressure_pc']} with {levels64} levels, not mg-pcg with 5")
    print(f"[3c] kernels against plain versions (N={N64} shapes)")
    for name, recs in compare_kernels(s64, "cuda", tag=f" N={N64}").items():
        kres[name] = kres[name] + recs
    gather_loops(s64, tag=f" N={N64}")
    for name, recs in compare_solves(
            {"float64": (s64, torch.float64), "float32": (s64, torch.float32)}, "cuda",
            cases_fn=lambda pr, dev: solve_cases(pr[0], dev, dtype=pr[1]),
            suffix=f" N={N64}").items():
        kres[name] = kres[name] + recs
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    res = drive_main_path(s64, WARMUP, STEPS, "cuda", rep64["path_kernels"])
    report_path("4d", res, STEPS, nvel64, smi, TPU_ERA_ITERS_N64, steps_log)
    print(f"    pressure MG levels {levels64}; peak device memory in the steps "
          f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB; setup {setup64:.1f} s")
    graph_leg(s64, "4d", smi)
    if args.profile:
        profile_steps(s64, args.profile, "build/chip_smoke_trace_n64.json")
    del s64
    torch.cuda.empty_cache()

    # 3b. ELL kernels at the vessel's N=36 shapes
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    vessel = tgv_solver(N, torch.float32, "cuda", rtol=1e-5, vessel=True)
    _sync("cuda")
    rep = vessel.config_report()
    print(f"[4b] vessel setup N={N}: {time.perf_counter() - t0:.1f} s, "
          f"{3 * vessel._Vi[0][0].num_dofs} velocity dofs, ELL {rep['ell']}, "
          f"AMG {rep['pressure_mg_levels']} levels (coarse n {vessel._amg.coarse_n}), "
          f"device memory {torch.cuda.memory_allocated() / 2**20:.1f} MiB")
    vessel_state0 = vessel._state_from_functions()  # phase 3d's inputs, taken before 4b runs
    m0 = torch.cuda.memory_allocated()
    vessel64 = tgv_solver(N, torch.float64, "cuda", rtol=SOLVE_RTOL["float64"], vessel=True)
    own64 = torch.cuda.memory_allocated() - m0  # kept for 3d: left out of 4b's device memory
    cyl = cylinder_solver(CYL_RES, torch.float32, "cuda", rtol=1e-5)
    cyl64 = cylinder_solver(CYL_RES, torch.float64, "cuda", rtol=SOLVE_RTOL["float64"])
    print(f"[3b] ELL kernels against plain versions (vessel N={N}, cylinder res={CYL_RES})")
    for label, e in (("A_lhs, M", vessel._ell_v), ("Ap", vessel._ell_q)):
        rb, fill = ell_read(e, 4)
        print(f"  {label}: K {e.K}, n {e.n}, nnz {e.nnz}; a float32 K14 product reads "
              f"{rb / 1e6:.1f} MB of its slices' widths (fill {fill:.4f}) in place of "
              f"{8 * e.K * e.n / 1e6:.1f} MB of all K slots (fill {e.nnz / (e.K * e.n):.4f}); "
              f"real nonzeros {8 * e.nnz / 1e6:.1f} MB")
    amg_report(f"vessel N={N}", vessel)
    amg_report(f"cylinder res={CYL_RES}", cyl)
    kres.update(compare_ell_kernels({"float64": vessel64, "float32": vessel}, "cuda"))
    for name, recs in compare_solves({"float64": (vessel64, cyl64), "float32": (vessel, cyl)},
                                     "cuda", cases_fn=ell_solve_cases).items():
        kres[name] = recs + kres.get(name, [])  # the solve first: it is the main path's call
    del cyl64
    torch.cuda.empty_cache()

    # 4b. the vessel main path, before the band solver exists (so that 4b's
    # device memory holds no band tables; the float64 vessel's own is left out)
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated() - own64
    res = drive_main_path(vessel, WARMUP, STEPS, "cuda", kn.ELL_KERNELS)
    report_path("4b", res, STEPS, 3 * vessel._Vi[0][0].num_dofs, smi, {}, steps_log)
    base4b = res["launches"]
    print(f"    device memory {resident / 2**20:.1f} MiB before the steps, peak "
          f"{(torch.cuda.max_memory_allocated() - own64) / 2**20:.1f} MiB in the steps (the "
          f"float64 vessel's {own64 / 2**20:.1f} MiB left out)")
    graph_leg(vessel, "4b", smi)
    single4b = single_steps(vessel, vessel_state0, *SHARD_STEPS)  # phase 4r's reference
    for k, v in res["launches"].items():
        if v:
            launches.setdefault(k, v)
    iters_4b = {f: float(res["stats"][f"{f}_iters"].mean()) for f in ("u", "p", "c")}
    if args.profile:
        profile_steps(vessel, args.profile, "build/chip_smoke_trace_vessel.json")

    # 3d. the band-ELL kernels at the vessel's N=36 shapes (tables of the
    # band-layout solver of phase 4e; elements of the flat-ELL solvers, at
    # the initial state: the float64 one kept from 3b, which ran no step)
    from oasisx_tpu_torch.assembly.band import build_band_assembly

    t0 = time.perf_counter()
    vband = tgv_solver(N, torch.float32, "cuda", rtol=1e-5, vessel=True, layout="band")
    _sync("cuda")
    setup_band = time.perf_counter() - t0
    bq = build_band_assembly(vband._Q.dofmap.cell_dofs, vband._Q.num_dofs, "cuda")
    print(f"[4e] vessel band setup N={N}: {setup_band:.1f} s, {vband.config_report()['ell']}, "
          f"device memory {torch.cuda.memory_allocated() / 2**20:.1f} MiB")
    print(f"[3d] band-ELL kernels against plain versions (vessel N={N})")
    for label, bt, et in (("A_lhs, M", vband._band_v, vessel._ell_v),
                          ("Ap", bq, vessel._ell_q)):
        lay = band_layouts(bt, et, 4)
        print(f"  {label}: S {lay['S']} R {lay['R']} P {lay['P']} ({lay['pairs_per_tile']:.1f} "
              f"pairs a tile; K {lay['K']}), stored lanes holding a value: pairs "
              f"{lay['pair_fill']:.4f}, (S, R, 128) {lay['slab_fill']:.4f}, ELL "
              f"{lay['ell_fill']:.4f}; a float32 product reads {lay['pair_bytes'] / 1e6:.1f} MB "
              f"pairs, {lay['slab_bytes'] / 1e6:.1f} MB (S, R, 128), {lay['ell_bytes'] / 1e6:.1f} "
              f"MB ELL, {lay['nnz_bytes'] / 1e6:.1f} MB of real nonzeros")
    pairs = {"float64": (vband, vessel64, None), "float32": (vband, vessel, vessel_state0)}
    kres.update(compare_ell_kernels({k: (v, bq) for k, v in pairs.items()}, "cuda",
                                    cases_fn=band_kernel_cases))
    for name, recs in compare_solves(pairs, "cuda", cases_fn=band_solve_cases).items():
        kres[name] = recs
    del vessel64, vessel, vessel_state0, bq, pairs
    torch.cuda.empty_cache()

    # 4e. the vessel with the band layout, the flat-ELL solvers freed
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    res = drive_main_path(vband, WARMUP, STEPS, "cuda", kn.BAND_KERNELS)
    report_path("4e", res, STEPS, 3 * vband._Vi[0][0].num_dofs, smi, {}, steps_log)
    iters_4e = {f: float(res["stats"][f"{f}_iters"].mean()) for f in ("u", "p", "c")}
    print(f"    device memory {resident / 2**20:.1f} MiB before the steps, peak "
          f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB in the steps; setup "
          f"{setup_band:.1f} s")
    for k in ("band_matvec", "band_bicgstab", "band_cg"):
        launches[k] = res["launches"][k]
    print(f"    per-component mean iterations, band (4e) {iters_4e} against ELL (4b) {iters_4b}")
    for f in ("u", "p", "c"):
        check(abs(iters_4e[f] - iters_4b[f]) <= 0.1 * iters_4b[f] + 1e-9,
              f"band layout: {f} iterations {iters_4e[f]:.3f} against {iters_4b[f]:.3f} (4b)")
    if args.profile:
        profile_steps(vband, args.profile, "build/chip_smoke_trace_band.json")
    del vband
    torch.cuda.empty_cache()
    print(f"    the band solver's own device memory "
          f"{(resident - torch.cuda.memory_allocated()) / 2**20:.1f} MiB (before the steps, "
          f"less what stays once it is freed)")

    # 4h. the vessel with the lumped update: BENCH_unstructured_r05.json's
    # configuration (AMG-PCG pressure, low_memory_version False)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    vlump = tgv_solver(N, torch.float32, "cuda", rtol=1e-5, vessel=True, scalar=lumped)
    _sync("cuda")
    rep = vlump.config_report()
    resident = torch.cuda.memory_allocated()
    print(f"[4h] vessel setup N={N}, lumped update: {time.perf_counter() - t0:.1f} s; kernels "
          f"{rep['path_kernels']}, device memory {resident / 2**20:.1f} MiB")
    check(rep["velocity_update"] == "lumped" and "ell_cg" not in rep["path_kernels"],
          f"[4h] {rep['velocity_update']} update with {rep['path_kernels']}")
    res = drive_main_path(vlump, WARMUP, STEPS, "cuda", rep["path_kernels"])
    report_path("4h", res, STEPS, 3 * vlump._Vi[0][0].num_dofs, smi, {}, steps_log)
    check_lumped("4h", res, STEPS, 1e-5, {"ell_cg": 0, "ell_bicgstab": 1, "ell_pcg_amg": 1})
    means = {f: round(float(res["stats"][f"{f}_iters"].mean()), 4) for f in ("u", "p")}
    print(f"    per-component mean iterations {means} against the TPU-era capture of this "
          f"configuration {TPU_ERA_ITERS_VESSEL} (BENCH_unstructured_r05.json); device memory "
          f"{resident / 2**20:.1f} MiB before the steps, peak "
          f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB in the steps")
    if args.profile:
        profile_steps(vlump, args.profile, "build/chip_smoke_trace_vessel_lumped.json")
    del vlump
    torch.cuda.empty_cache()

    # 4j. the vessel with the rotational update and a constant body force:
    # K14 and K16 at batch 1 on Mq's ELL values
    t0 = time.perf_counter()
    vrot = tgv_solver(N, torch.float32, "cuda", rtol=1e-5, vessel=True, rotational=True,
                      body_force=(0.0, 0.0, -0.5))
    _sync("cuda")
    rep = vrot.config_report()
    print(f"[4j] vessel setup N={N}, rotational update, body force: "
          f"{time.perf_counter() - t0:.1f} s; kernels {rep['path_kernels']}")
    check(rep["pressure_update"] == "rotational" and rep["body_force"],
          f"[4j] pressure update {rep['pressure_update']}, body force {rep['body_force']}")
    res = drive_main_path(vrot, WARMUP, STEPS, "cuda", kn.ELL_KERNELS)
    report_path("4j", res, STEPS, 3 * vrot._Vi[0][0].num_dofs, smi, {}, steps_log)
    check_rotational("4j", res, STEPS, 1e-5, base4b, {"ell_matvec": 1, "ell_cg": 1})
    if args.profile:
        profile_steps(vrot, args.profile, "build/chip_smoke_trace_vessel_rotational.json")
    del vrot
    torch.cuda.empty_cache()

    # 4c. the cylinder with its outlet
    res = drive_main_path(cyl, 2, CYL_STEPS, "cuda", kn.ELL_KERNELS, dt=CYL_DT, nu=CYL_NU)
    report_path("4c", res, CYL_STEPS, 2 * cyl._Vi[0][0].num_dofs, smi, {}, steps_log)
    del cyl

    # 4c'. the cylinder with a time-varying inflow, from a table; 4c''. a
    # callback that reads the host, refused
    cylinder_transient("cuda", smi)
    host_read_callback("cuda")

    # 5b, 5c. GPU against CPU on the general path, both layouts
    print("[5b] cuda against cpu, general path")
    gpu_vs_cpu(lambda dt, dev: tgv_solver(6, dt, dev, rtol=1e-8, vessel=True), "vessel N=6")
    gpu_vs_cpu(lambda dt, dev: cylinder_solver(10, dt, dev, rtol=1e-8), "cylinder res=10",
               dt=CYL_DT, nu=CYL_NU)
    print("[5c] cuda against cpu, band layout")
    gpu_vs_cpu(lambda dt, dev: tgv_solver(6, dt, dev, rtol=1e-8, vessel=True, layout="band"),
               "vessel band N=6")
    print("[5e] cuda against cpu, the options off the default configurations")
    options_gpu_vs_cpu()
    print("[5f] cuda against cpu, the rotational update, body forces and the forms")
    rotational_gpu_vs_cpu()
    forms_gpu_vs_cpu()

    # 4l. the vessel demo on the tagged patient mesh
    t0 = time.perf_counter()
    vessel_demo_path("cuda")
    print(f"[4l] {time.perf_counter() - t0:.1f} s")
    # 4m. the CLI and the Taylor-Green demo
    t0 = time.perf_counter()
    cli_and_demo("cuda")
    print(f"[4m] {time.perf_counter() - t0:.1f} s")
    print("[5g] cuda against cpu: the split phases, the dense tentative matrix, a checkpoint")
    t0 = time.perf_counter()
    split_gpu_vs_cpu()
    print(f"[5g] {time.perf_counter() - t0:.1f} s")
    print("[5h] cuda against cpu: the structured path's tentative ksp_type cg")
    t0 = time.perf_counter()
    structured_cg_gpu_vs_cpu()
    print(f"[5h] {time.perf_counter() - t0:.1f} s")
    strategies_path("cuda")
    dfg1_path("cuda")
    fidelity_path("cuda")
    # 4q. the slab path over ranks; 5i. its cuda against cpu
    t0 = time.perf_counter()
    slab_splits = slab_path(single=single4)
    print(f"[4q] {time.perf_counter() - t0:.1f} s")
    # 4r, 4r', 4s. the graph-halo path and the replicated mode over ranks
    halo = halo_phases(single4b, kres, gpu_vs_cpu=False)
    # 4k'. the split phases under a device_mesh (ending 4q's and 4r's groups)
    shard_phases(slab_splits, halo, gpu_vs_cpu=False)
    # 5i, 5j, 5k. every sharded mode GPU against CPU, their groups at once
    import contextlib

    t0 = time.perf_counter()
    with contextlib.ExitStack() as stack:
        checks = [(tag, what, phase(stack=stack)) for tag, what, phase in (
            ("5i", "the slab path", slab_gpu_vs_cpu),
            ("5j", "the graph-halo path", halo_gpu_vs_cpu),
            ("5k", "the replicated mode, the split step and the dense export on every "
                   "sharded mode", shard_gpu_vs_cpu))]
        for tag, what, finish in checks:
            print(f"[{tag}] cuda against cpu: {what}")
            finish()
    print(f"[5i] [5j] [5k] {time.perf_counter() - t0:.1f} s (their groups started at once)")

    # the kernels redesigned against their one-call library yardsticks
    for name, label in (("cube_scatter", "U batch 3"), ("cube_scatter", f"U batch 3 N={N64}"),
                        ("matvec_const", "Ap_c batch 1"),
                        ("matvec_const", f"Ap_c batch 1 N={N64}"),
                        ("cube_gather", "TGV uab"), ("cube_gather", f"TGV uab N={N64}"),
                        ("band_matvec", "A_lhs batch 3")):
        r = next(c for c in kres[name] if c["case"] == label)
        side = "at or below" if r["ms"] <= r["library_ms"] else "above"
        print(f"  {name} {label}: kernel {r['ms']:.4f} ms, library call {r['library_ms']:.4f} ms "
              f"({side} it)")

    # per kernel: its first case's numbers, and every case under "cases"
    print(f"total {time.perf_counter() - t_start:.1f} s")
    kernels = [
        {**kres[n][0], "name": n, "route": "cuda", "source": SOURCE[n], "replaces": REPLACES[n],
         "launches": launches.get(n, 0), "cases": kres[n]}
        for n in kn.KERNELS
    ]
    # the device while loops' condition setter: its launches are 4t's
    kernels.append(dict(loop_rec, cases=[dict(loop_rec)]))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeError as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        sys.exit(1)
