// Whole Krylov solves as persistent cooperative kernels, for sm_90a.
//
// They replace these TPU kernels (oasisx_tpu/assembly/pallas_ops.py) together
// with the device-side loops that drive them:
//   oasisx_cg_mass      <- make_cg_iter_pf (K4) and the loop of cg_pf_solve /
//                          fracstep.py's velocity update: batched Jacobi-PCG on
//                          a constant cube matrix, from the caller's r0 and x0
//   oasisx_bicgstab     <- make_bicgstab_iter (K2) and bicgstab_fused_from_r0:
//                          batched BiCGStab on A_W (per-cube weights) with
//                          zero-masked Dirichlet rows and Jacobi
//   oasisx_pressure_mg  <- make_pressure_cg(..., mg=build_pressure_mg_data(...))
//                          (K1): the MG-preconditioned pressure CG, nullspace
//                          demeaning included
//   oasisx_pressure_cg  <- make_pressure_cg(..., mg=None) (K1's other modes):
//                          the same CG with Jacobi (cheb_degree 0) or
//                          Chebyshev-Jacobi preconditioning, for grids that
//                          do not coarsen
//
// Form.  On the TPU one core walks the grid in order and the state sits in
// VMEM.  Here one kernel launch runs the whole solve: the grid is as many
// blocks as fit on the card at once (cudaOccupancyMaxActiveBlocksPerMultiprocessor
// times the SM count, fewer when the grid has fewer points), launched with
// cudaLaunchCooperativeKernel.  Every phase is a grid-stride loop over the
// points, and phases are separated by grid barriers (cooperative_groups
// grid_group::sync).  The Krylov loop runs inside the kernel until every row
// has converged or maxiter is reached; the host reads nothing during a solve.
// grid_group::sync needs no relocatable device code (-rdc) since CUDA 11.
//
// Reductions and the cooperative launch are those of grid_reduce.cuh:
// deterministic, the same bits on every block, no floating-point atomics;
// K1's non-MG modes and K4 on the P1 cube reduce with warp shuffles
// (grid_sum_warp, below), as deterministic, with one block barrier a sum.
//
// Operators: the cube device functions of cube_device.cuh, with the
// constant matrix (K4's M_c) staged in shared memory.  K1 (every mode) and
// K4 on the P1 cube run the P1 stencil (cube_device.cuh: each point sums its
// 3^d neighbours times its class's coefficients, in one order with explicit
// fmas), on a tile where a level spans the grid (a block reads a box of its
// tile and a halo into shared memory once), with the direction update
// riding on the product and two grid barriers in the CG body
// (pressure_cg_kernel says how K1 fits its Chebyshev steps in,
// pressure_mg_kernel how the V-cycle's coarse levels run).
//
// K4's product on the P2 cube is K5's block-tiled one (tile_product; the P1
// cube takes the stencil tile, any other cube, P3 among them, goes point by
// point, cg_mass_point_kernel): the grid-stride
// loop runs over tiles, a block a tile at a time, each input read once a tile
// into shared memory, a thread a cube with its 27 nb inputs in registers
// (kMassBlocks 2 an SM: at most 128 registers), pAp summed cube by cube
// (p_c . C p_c, each cube on the one tile that owns its base point).  The
// direction update p = z + beta p rides on the next product: a tile
// computes p from r and the last p wherever it reads p (its box, halo
// included) and writes its owned points to the other of two p buffers (by
// iteration parity, an explicit fma).  So an iteration
// has two grid barriers (pAp; rz and |r|^2) and two passes over the state,
// where the product, the update and the direction pass had three of each.
//
// K2's per-cube weights W (nl^2 x ncubes, 764 MB in f32 at N=64) do not fit
// in L2, so its product is cube-owned and in two phases.  Phase A, a
// grid-stride loop over cubes: a thread copies its cube's nb * nl inputs
// once into its own column of shared memory and streams the cube's nl^2
// weights (27 loads in flight, NL unrolled; cube_device.cuh win_cube, which
// K3's phase A runs too), coalesced across the warp's neighbouring cubes,
// into nb * nl staged outputs (stage, (nb, nl, ncubes):
// 15.1 MB at N=36, 84.9 MB at N=64).  Phase B, after a grid barrier, is
// the output side of every cube operator: a point sums its <= 2^d staged
// values in cube_visit's order, with the zmask, the store and the dot
// products of the solve's loop fused in.  A product point by point through
// cube_point (the form before) read each cube's 27 nb inputs once for each
// of its 27 output slots, through the L1/L2 that W streams through, and ran
// at a third of the standalone product's rate.  Blocks an SM are
// fixed (kMinBlocks, kMassBlocks, kSolveBlocks: launch bound and grid cap), and K1's
// Chebyshev updates fuse c1 dk into an explicit fma, so neither the grid
// nor the rounding of a step depends on how the compiler allocates
// registers or contracts products: a run repeats bit for bit across
// builds of this source.  K1's grid transfers split a point the same way
// (coords), and every grid-stride loop counts in int32 or is not unrolled
// (nvcc unrolls these loops and divides their trip count, in 64 bits for a
// 64-bit index), so no kernel here divides in 64 bits.  cube_fits and
// coop_launch bound every index, and an index plus a stride, below 2^31.
//
// K1's V-cycle runs its coarse levels on a sub-group of blocks and its
// coarsest on one block (pressure_mg_kernel, mg_plan).
//
// Bound on the H100.  K2: memory; each iteration applies A_W twice, and each
// application streams W (nl^2 x ncubes, 136 MB in f32 at N=36) once for all
// components, so two W streams per iteration are the floor, plus the staged
// outputs written and read once a product; the ~10 state vectors (3 x 1.6
// MB each at N=36) stay in L2.  K4: at N=36 its state (3 x 405k points a
// vector) fits in L2 and an iteration is bound by its product's operations
// and its two grid barriers; at N=64 a state vector is 26.4 MB in float32
// (batch 3) and does not, so an iteration moves its two passes from HBM:
// 10 vectors of nb rows and the shared invd twice, ~282 MB (0.084 ms).
// K1: latency; the 50k / 7k / 1k point pressure levels fit in L2, and the
// time goes to barriers (per MG iteration at N=36, 6 grid barriers, 6 among
// the sub-group's blocks and 13 of one block, mg_barriers; 2 an iteration
// of the Jacobi and Chebyshev modes where the steps' box fits,
// pcg_barriers).
//
// Each entry point launches on the stream it is given, allocates nothing
// (the caller passes the work and reduction buffers), and returns the launch
// error, or cudaErrorInvalidValue for arguments it does not take.

#include <algorithm>

#include "cube_device.cuh"
#include "grid_reduce.cuh"

namespace {

using namespace oasisx;

static_assert(kThreads == kRedThreads, "one block size for the cube and reduction code");
static_assert(kThreads == kTileThreads, "K4's blocks run the tiled product");
static_assert(kMaxRed == 2 * kMaxBatch, "two sums per batch row");
static_assert(kMaxRed == kTileRed, "K4's reduction as tile_choose counts it");

constexpr int kMaxLevels = 8;
// Blocks an SM of each whole-solve kernel: its launch bound and the cap of
// its cooperative grid, so that the grid, and with it the order of every
// reduction, does not depend on the registers the compiler assigns.  K4 on
// a cube other than P2 holds 3 in float32 (<= 80 registers), the others 2
// (K4's kMassBlocks; K1's non-MG mode, whose box code spilled at 80
// registers, and which has at most a block a tile: 225 at N=35).
template <typename T>
constexpr int kMinBlocks = sizeof(T) == 4 ? 3 : 2;
constexpr int kSolveBlocks = 2;

// Shared memory: [matrix (mat_len T)] [slot offsets (nl ints)] [reduction].
template <typename T>
__host__ __device__ inline size_t red_offset(int mat_len, int nl) {
  return align16(sizeof(T) * mat_len + sizeof(int) * nl);
}

template <typename T>
__host__ __device__ inline size_t smem_bytes(int mat_len, int nl) {
  return red_offset<T>(mat_len, nl) + sizeof(T) * kMaxRed * kThreads;
}

// K1's non-MG modes and K4 on the P1 cube reduce with warp shuffles: each
// warp sums its lanes by a butterfly of __shfl_xor_sync (a + b == b + a, so
// every lane ends with the same bits), thread 0 adds the block's warp sums
// in order into the block's slot, and after the grid barrier every warp
// sums the slots (lane l the slots l, l + 32, ... in order) and ends with
// a butterfly: every thread of the grid gets the same bits, with one block
// barrier where grid_sum has two trees of nine.  The slots alternate halves
// as grid_sum's; the warp sums need kMaxRed * kWarps values of shared memory.
constexpr int kWarps = kThreads / 32;

template <int N, typename T>
__device__ __forceinline__ void warp_sum(T* v) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1)
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] += __shfl_xor_sync(0xffffffffu, v[i], m);
}

template <int N, typename T>
__device__ void grid_sum_warp(Reducer<T>& red, T* v) {
  warp_sum<N>(v);
  const int lane = threadIdx.x & 31;
  if (lane == 0)
    for (int i = 0; i < N; ++i) red.sred[i * kWarps + (threadIdx.x >> 5)] = v[i];
  __syncthreads();
  T* slot = red.slots + (size_t)red.half * kMaxRed * gridDim.x;
  red.half ^= 1;
  if (threadIdx.x == 0)
    for (int i = 0; i < N; ++i) {
      T b = T(0);
      for (int w = 0; w < kWarps; ++w) b += red.sred[i * kWarps + w];
      slot[i * gridDim.x + blockIdx.x] = b;
    }
  cg::this_grid().sync();  // also ends the block's reads of sred
  for (int i = 0; i < N; ++i) {
    T t = T(0);
    for (int b = lane; b < (int)gridDim.x; b += 32) t += slot[i * gridDim.x + b];
    v[i] = t;
  }
  warp_sum<N>(v);
}

template <bool kWarp, int N, typename T>
__device__ __forceinline__ void solve_sum(Reducer<T>& red, T* v) {
  if constexpr (kWarp)
    grid_sum_warp<N>(red, v);
  else
    grid_sum<N>(red, v);
}

// ---------------------------------------------------------------------------
// K4: batched Jacobi-PCG on a constant cube matrix, nb rows at once
// ---------------------------------------------------------------------------

template <typename T>
struct CgMassArgs {
  const T* C;     // (nl, nl) cube matrix
  const T* r0;    // (nb, n) initial residual
  const T* x0;    // (nb, n) initial guess
  const T* invd;  // (n) Jacobi inverse diagonal, shared by the rows
  const T* tol;   // (nb) absolute tolerance per row
  T* x;           // (nb, n) out
  T* r;           // (nb, n) work
  T* p[2];        // (nb, n) work each: the search direction, by iteration parity
  T* Ap;          // (nb, n) work
  T* red;         // reduction slots
  int* iters;     // (nb) out
  T* rnorm;       // (nb) out
  CubeArgs a;     // nbo = nb rows; on the P2 cube, the tile of the product
  StencilPlan s;  // on the P1 cube, the stencil's tiles (halo 1)
  size_t red_off; // bytes of shared memory before the reduction's
  int maxiter;
};

// Blocks an SM of K4: its launch bound and the cap of its cooperative grid.
// Two, so that a thread keeps its cube's 81 inputs (batch 3) in registers.
constexpr int kMassBlocks = 2;
// K4's grid barriers an iteration: the product's reduction (pAp) and the
// update's (rz, |r|^2); the direction update rides on the next product.
constexpr int kMassBarriers = 2;

// K4's shared memory on the P2 cube: [matrix (tile rows)] [tile buffer]
// [reduction], tile_block_smem bytes; on the P1 cube: [stencil
// coefficients] [box, nb rows] [warp sums] (p1_mass_smem).
template <typename T>
inline size_t p1_box_bytes(const StencilPlan& s, int nb) {
  return align16(sizeof(T) * nb * s.boxpts);
}
template <typename T>
inline size_t p1_mass_smem(int d, const StencilPlan& s, int nb) {
  return stencil_table_bytes<T>(d) + p1_box_bytes<T>(s, nb) + sizeof(T) * kMaxRed * kWarps;
}

// NL: 27 (3D) or 9 (2D) slots of the P2 cube, or 8 (3D) or 4 (2D) of the
// P1 cube (kP1); NB as tile_product's (0 on the P1 cube).  The rows'
// scalars (rz, |r|, tol, beta, iterations, last activity) are the same in
// every thread: they live in shared memory, written by thread 0 after each
// reduction, so that the registers go to the product's inputs.  The P1 cube
// runs the stencil tile (cube_device.cuh) with a halo of one layer, three
// blocks an SM in float32, and reduces with warp shuffles; the P2 cube
// keeps grid_sum and its rounding.
template <typename T, int NL, int NB, bool kP1>
__global__ void __launch_bounds__(kThreads, kP1 ? kMinBlocks<T> : kMassBlocks)
    cg_mass_kernel(CgMassArgs<T> P) {
  constexpr int NBX = NB > 0 ? NB : kMaxBatch;
  constexpr int D = NL == 27 || NL == 8 ? 3 : 2;
  const CubeArgs& a = P.a;
  const StencilPlan& sp = P.s;
  const int nb = NB > 0 ? NB : a.nbo;  // rows solved together
  const int n = a.npad_out;            // nb * n < 2^31 (cube_fits)
  unsigned char* smem = dynamic_smem();
  T* smat = reinterpret_cast<T*>(smem);
  T* sbuf = kP1 ? reinterpret_cast<T*>(smem + stencil_table_bytes<T>(D))
                : smat + NL * tile_ld<T>(NL);
  Reducer<T> red{P.red, reinterpret_cast<T*>(smem + P.red_off), 0};
  __shared__ T rz[kMaxBatch], rn[kMaxBatch], tol[kMaxBatch], beta[kMaxBatch];
  __shared__ int it[kMaxBatch];
  __shared__ bool upd[kMaxBatch];  // the row was active in the last iteration: p = z + beta p
  if constexpr (kP1) {
    stencil_stage<T, D>(P.C, smat);
    __syncthreads();
  } else {
    tile_stage<T, NL>(P.C, smat);
  }
  // K4's point loops: int32 (coop_launch bounds an index plus a stride
  // below 2^31) and not unrolled (nvcc would divide their trip count); each
  // point loads every row before it stores any, so that its loads are in
  // flight together (a store may alias a later row's load).
  const int first = blockIdx.x * blockDim.x + threadIdx.x;
  const int stride = gridDim.x * blockDim.x;
  const int ntiles = kP1 ? sp.ntile[0] * sp.ntile[1] * sp.ntile[2]
                         : a.ntile[0] * a.ntile[1] * a.ntile[2];
  auto active = [&](int b) { return b < nb && rn[b] > tol[b]; };

  // x = x0, r = r0, p = z0 = invd r0; rz = r0.z0, rnorm = |r0|
  T s[kMaxRed];
  zero(s);
  #pragma unroll 1
  for (int idx = first; idx < n; idx += stride) {
    const T iv = P.invd[idx];
    T rv[NBX], xv[NBX];
    #pragma unroll
    for (int b = 0; b < NBX; ++b)
      if (b < nb) {
        rv[b] = P.r0[b * n + idx];
        xv[b] = P.x0[b * n + idx];
      }
    #pragma unroll
    for (int b = 0; b < NBX; ++b)
      if (b < nb) {
        const int i = b * n + idx;
        const T z = iv * rv[b];
        P.x[i] = xv[b];
        P.r[i] = rv[b];
        P.p[0][i] = z;
        s[b] += rv[b] * z;
        s[kMaxBatch + b] += rv[b] * rv[b];
      }
  }
  solve_sum<kP1, kMaxRed>(red, s);
  if (threadIdx.x == 0)
    for (int b = 0; b < kMaxBatch; ++b) {
      rz[b] = s[b];
      rn[b] = vsqrt(s[kMaxBatch + b]);
      tol[b] = b < nb ? P.tol[b] : T(0);
      it[b] = 0;
      beta[b] = T(0);
      upd[b] = false;
    }
  __syncthreads();

  for (int k = 0; k < P.maxiter; ++k) {
    bool any = false;
    for (int b = 0; b < kMaxBatch; ++b) any = any || active(b);
    if (!any) break;

    // p = z + beta p on the rows active in the last iteration (the others
    // keep p), from r and the last p, wherever a tile reads it (its box,
    // halo included); its owned points go to the other buffer.  Ap = C p,
    // and pAp = sum over cubes of p_c . (C p_c), each cube on the tile that
    // owns its base point.  A padding point lies in no box: its owner
    // updates its p where it stores its Ap (0).
    const T* po = P.p[k & 1];
    T* pn = P.p[(k & 1) ^ 1];
    auto dir = [&](int b, int i, T iv) {
      const T old = po[i];
      return upd[b] ? vfma(beta[b], old, iv * P.r[i]) : old;
    };
    zero(s);
    if constexpr (kP1) {
      // the box (region 1) holds p; each owned point's Ap and p . Ap
      #pragma unroll 1
      for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
        int B0[3];
        stencil_tile(sp, t, B0);
        __syncthreads();  // the last tile's stencils have read the box
        // a point's loads: invd, then each row's last p and r
        stencil_load<D, 2>(
            a, sp, B0, 1,
            [&](int i, bool) {
              Vals<T, 2 * NBX + 1> v;
              v.v[0] = P.invd[i];
              #pragma unroll
              for (int b = 0; b < NBX; ++b)
                if (b < nb) {
                  v.v[1 + 2 * b] = po[b * n + i];
                  v.v[2 + 2 * b] = P.r[b * n + i];
                }
              return v;
            },
            [&](int i, int l, bool own, const Vals<T, 2 * NBX + 1>& v) {
              #pragma unroll
              for (int b = 0; b < NBX; ++b)
                if (b < nb) {
                  const T old = v.v[1 + 2 * b];
                  const T pb =
                      i < 0 ? T(0) : upd[b] ? vfma(beta[b], old, v.v[0] * v.v[2 + 2 * b]) : old;
                  sbuf[b * sp.boxpts + l] = pb;
                  if (own) pn[b * n + i] = pb;
                }
            });
        __syncthreads();
        stencil_region<D>(a, sp, B0, 0, [&](int i, int l, int cls, bool) {
          if (i < 0) return;
          T acc[NBX];
          stencil_apply<T, D, NBX>(smat, cls, sbuf, sp, l, nb, acc);
          #pragma unroll
          for (int b = 0; b < NBX; ++b)
            if (b < nb) {
              P.Ap[b * n + i] = acc[b];
              s[b] = vfma(sbuf[b * sp.boxpts + l], acc[b], s[b]);
            }
        });
      }
    } else {
    #pragma unroll 1
    for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
      const unsigned q = fast_quo((unsigned)t, a.div_ntile[2]);
      const int i0 = (int)fast_quo(q, a.div_ntile[1]);
      tile_product<T, NL, NB>(
          a, smat, sbuf, i0, (int)q - i0 * a.ntile[1], t - (int)q * a.ntile[2],
          [&](int i, auto& v) {
            const T iv = P.invd[i];
            #pragma unroll
            for (int b = 0; b < NBX; ++b)
              if (b < nb) v[b] = dir(b, b * n + i, iv);
          },
          [&](int i, const auto& v) {
            #pragma unroll
            for (int b = 0; b < NBX; ++b)
              if (b < nb) pn[b * n + i] = v[b];
          },
          [&](const T* dots) {
            #pragma unroll
            for (int b = 0; b < NBX; ++b)
              if (b < nb) s[b] += dots[b];
          },
          [&](int i, const auto& acc, bool pad) {
            #pragma unroll
            for (int b = 0; b < NBX; ++b)
              if (b < nb) {
                P.Ap[b * n + i] = acc[b];
                if (pad) pn[b * n + i] = dir(b, b * n + i, P.invd[i]);
              }
          });
    }
    }
    solve_sum<kP1, kMaxBatch>(red, s);
    T alpha[kMaxBatch];
    for (int b = 0; b < kMaxBatch; ++b) alpha[b] = active(b) ? rz[b] / nz(s[b]) : T(0);

    // x += alpha p; r -= alpha Ap; z = invd r; rz_new = r.z, |r|^2
    zero(s);
    #pragma unroll 1
    for (int idx = first; idx < n; idx += stride) {
      const T iv = P.invd[idx];
      T xv[NBX], pv[NBX], rv[NBX], av[NBX];
      #pragma unroll
      for (int b = 0; b < NBX; ++b)
        if (b < nb) {
          const int i = b * n + idx;
          xv[b] = P.x[i];
          pv[b] = pn[i];
          rv[b] = P.r[i];
          av[b] = P.Ap[i];
        }
      #pragma unroll
      for (int b = 0; b < NBX; ++b)
        if (b < nb) {
          const int i = b * n + idx;
          P.x[i] = xv[b] + alpha[b] * pv[b];
          const T rr = rv[b] - alpha[b] * av[b];
          P.r[i] = rr;
          const T z = iv * rr;
          s[b] += rr * z;
          s[kMaxBatch + b] += rr * rr;
        }
    }
    solve_sum<kP1, kMaxRed>(red, s);  // its block barrier ends the block's reads of the scalars
    if (threadIdx.x == 0)
      for (int b = 0; b < kMaxBatch; ++b) {
        const bool act = active(b);
        const T rz_new = act ? s[b] : rz[b];
        beta[b] = act ? rz_new / nz(rz[b]) : T(0);
        rz[b] = rz_new;
        upd[b] = act;
        if (act) {
          rn[b] = vsqrt(s[kMaxBatch + b]);
          ++it[b];
        }
      }
    __syncthreads();
  }
  if (blockIdx.x == 0 && threadIdx.x == 0)
    #pragma unroll
    for (int b = 0; b < kMaxBatch; ++b) {
      if (b >= nb) break;
      P.iters[b] = it[b];
      P.rnorm[b] = rn[b];
    }
}

// K4 on any cube but P1 and P2 (P3: the velocity update's mass CG and
// K11 of a structured P3 velocity, fracstep's u_element): point by point
// (cube_point), with the cube matrix and its slot offsets staged in shared
// memory, and three grid barriers an iteration (the product's pAp, the
// update's rz and |r|^2, the direction update).  The P1 cube (the
// rotational update's Mq_c solve at batch 1, phase 4i every step; a P1
// velocity's mass CG) runs cg_mass_kernel's stencil tile.
template <typename T>
__global__ void __launch_bounds__(kThreads, kMinBlocks<T>)
    cg_mass_point_kernel(CgMassArgs<T> P) {
  const CubeArgs& a = P.a;
  const int nb = a.nbo;  // rows solved together
  const int64_t n = a.npad_out;
  T* p = P.p[0];  // one search direction, updated in its own pass
  unsigned char* smem = dynamic_smem();
  T* smat = reinterpret_cast<T*>(smem);
  int* soff = reinterpret_cast<int*>(smem + sizeof(T) * a.mat_len);
  Reducer<T> red{P.red, reinterpret_cast<T*>(smem + red_offset<T>(a.mat_len, a.nl_in)), 0};
  cube_stage(P.C, a, smat, soff);
  __syncthreads();
  // K4's grid-stride loops: 64-bit and not unrolled.  Unrolled, nvcc divides
  // their trip count (in 64 bits for a 64-bit index), and on an H100 80GB
  // HBM3 at 700 W they ran 1-2% slower either way, in 32 or 64 bits.
  const int64_t first = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;

  // x = x0, r = r0, p = z0 = invd r0; rz = r0.z0, rnorm = |r0|
  T s[kMaxRed];
  zero(s);
  #pragma unroll 1
  for (int64_t idx = first; idx < n; idx += stride) {
    const T iv = P.invd[idx];
    #pragma unroll
    for (int b = 0; b < kMaxBatch; ++b) {
      if (b >= nb) break;
      const int64_t i = b * n + idx;
      const T rr = P.r0[i];
      const T z = iv * rr;
      P.x[i] = P.x0[i];
      P.r[i] = rr;
      p[i] = z;
      s[b] += rr * z;
      s[kMaxBatch + b] += rr * rr;
    }
  }
  grid_sum<kMaxRed>(red, s);
  T rz[kMaxBatch], rn[kMaxBatch], tol[kMaxBatch];
  int it[kMaxBatch];
  for (int b = 0; b < kMaxBatch; ++b) {
    rz[b] = s[b];
    rn[b] = vsqrt(s[kMaxBatch + b]);
    tol[b] = b < nb ? P.tol[b] : T(0);
    it[b] = 0;
  }

  for (int k = 0; k < P.maxiter; ++k) {
    bool act[kMaxBatch];
    bool any = false;
    for (int b = 0; b < kMaxBatch; ++b) {
      act[b] = b < nb && rn[b] > tol[b];
      any = any || act[b];
    }
    if (!any) break;

    // Ap = C p; pAp
    zero(s);
    #pragma unroll 1
    for (int64_t idx = first; idx < n; idx += stride) {
      T acc[kMaxBatch];
      cube_point(p, smat, soff, a, cube_split(a, (int)idx), acc);
      #pragma unroll
      for (int b = 0; b < kMaxBatch; ++b) {
        if (b >= nb) break;
        const int64_t i = b * n + idx;
        P.Ap[i] = acc[b];
        s[b] += p[i] * acc[b];
      }
    }
    grid_sum<kMaxBatch>(red, s);
    T alpha[kMaxBatch];
    for (int b = 0; b < kMaxBatch; ++b) alpha[b] = act[b] ? rz[b] / nz(s[b]) : T(0);

    // x += alpha p; r -= alpha Ap; z = invd r; rz_new = r.z, |r|^2
    zero(s);
    #pragma unroll 1
    for (int64_t idx = first; idx < n; idx += stride) {
      const T iv = P.invd[idx];
      #pragma unroll
      for (int b = 0; b < kMaxBatch; ++b) {
        if (b >= nb) break;
        const int64_t i = b * n + idx;
        P.x[i] = P.x[i] + alpha[b] * p[i];
        const T rr = P.r[i] - alpha[b] * P.Ap[i];
        P.r[i] = rr;
        const T z = iv * rr;
        s[b] += rr * z;
        s[kMaxBatch + b] += rr * rr;
      }
    }
    grid_sum<kMaxRed>(red, s);
    T beta[kMaxBatch];
    for (int b = 0; b < kMaxBatch; ++b) {
      const T rz_new = act[b] ? s[b] : rz[b];
      beta[b] = act[b] ? rz_new / nz(rz[b]) : T(0);
      rz[b] = rz_new;
      if (act[b]) {
        rn[b] = vsqrt(s[kMaxBatch + b]);
        ++it[b];
      }
    }

    // p = z + beta p on the active rows (inactive rows keep p)
    #pragma unroll 1
    for (int64_t idx = first; idx < n; idx += stride) {
      const T iv = P.invd[idx];
      #pragma unroll
      for (int b = 0; b < kMaxBatch; ++b) {
        if (b >= nb) break;
        if (!act[b]) continue;
        const int64_t i = b * n + idx;
        p[i] = iv * P.r[i] + beta[b] * p[i];
      }
    }
    cg::this_grid().sync();
  }
  if (blockIdx.x == 0 && threadIdx.x == 0)
    #pragma unroll
    for (int b = 0; b < kMaxBatch; ++b) {
      if (b >= nb) break;
      P.iters[b] = it[b];
      P.rnorm[b] = rn[b];
    }
}

// ---------------------------------------------------------------------------
// K2: batched BiCGStab on A_W with zero-masked Dirichlet rows
// ---------------------------------------------------------------------------

template <typename T>
struct BicgArgs {
  const T* W;      // (nl*nl, ncubes) per-cube weights
  const T* r0;     // (nb, n) zmask (b - A_W x0); also rhat
  const T* x0;     // (nb, n), bc rows preset to the bc values
  const T* zmask;  // (nb, n) 0 on Dirichlet rows, 1 elsewhere
  const T* invd;   // (n) Jacobi inverse diagonal, shared by the rows
  const T* tol;    // (nb)
  T* x;            // (nb, n) out
  T* r;            // (nb, n) work: r, and s between the two matvecs
  T* p;            // (nb, n) work
  T* v;            // (nb, n) work
  T* t;            // (nb, n) work
  T* y;            // (nb, n) work: invd p, then invd s (the matvec input)
  T* stage;        // (nb, nl, ncubes) work: a product's per-cube outputs
  T* red;
  int* iters;
  T* rnorm;
  CubeArgs a;      // nbo = nb rows, weights from global memory
  FastDiv div_c1, div_c2;  // divisions by a.c[1] and a.c[2] (a cube's coordinates)
  int ncubes;
  int maxiter;
};

// K2's shared memory: [slot offsets (nl ints)] [reduction] [each thread's
// cube inputs, nb * nl values, value k of thread i at k * kThreads + i].
template <typename T>
__host__ __device__ inline size_t bicg_smem(int nl, int nb) {
  return smem_bytes<T>(0, nl) + sizeof(T) * nb * nl * kThreads;
}

// NB > 0: NB rows solved together, fixed at compile time (the 3D P2 cube's
// batch 3, the velocity solve's), so that the batch loops of phase A emit no
// predicated-off loads and fmas (faster at batch 3 than a run-time count on
// an NVIDIA H100 80GB HBM3 at 700 W); NB == 0 takes a.nbo rows.
template <typename T, int NL, int NB>
__global__ void __launch_bounds__(kThreads, kSolveBlocks) bicgstab_kernel(BicgArgs<T> P) {
  const CubeArgs& a = P.a;
  const int nb = NB > 0 ? NB : a.nbo;
  const int n = a.npad_out;
  const int nl = NL > 0 ? NL : a.nl_in;
  const int nc = P.ncubes;
  unsigned char* smem = dynamic_smem();
  int* soff = reinterpret_cast<int*>(smem);
  Reducer<T> red{P.red, reinterpret_cast<T*>(smem + red_offset<T>(0, a.nl_in)), 0};
  T* xs = reinterpret_cast<T*>(smem + smem_bytes<T>(0, a.nl_in)) + threadIdx.x;
  cube_stage<T>(nullptr, a, nullptr, soff);
  __syncthreads();
  const int first = blockIdx.x * blockDim.x + threadIdx.x;
  const int stride = gridDim.x * blockDim.x;

  // A_W y, phase A, cube-owned (cube_device.cuh win_cube, as K3's phase A):
  // stage[b, to, c] = sum_ti W[to nl + ti, c] y_b[slot ti of cube c], the
  // slots in order.  A thread copies its cube's nb * nl inputs once into its
  // own shared-memory column, then streams the cube's nl^2 weights.
  auto cube_products = [&]() {
    for (int c = first; c < nc; c += stride) {
      const int cbase = cube_base(a, c, P.div_c1, P.div_c2);
#pragma unroll
      for (int b = 0; b < kMaxBatch; ++b) {
        if (b >= nb) break;
        const T* yb = P.y + b * n + cbase;
        for (int ti = 0; ti < nl; ++ti) xs[(b * nl + ti) * kThreads] = yb[soff[ti]];
      }
      win_cube<T, NL, NB>(P.W + c, P.stage + c, nl, nb, nc,
                          [&](int b, int ti) { return xs[(b * nl + ti) * kThreads]; });
    }
  };
  // A_W y, phase B, after a grid barrier: acc[b] at output point idx, the
  // sum of its <= 2^d staged values in cube_visit's order (no atomics)
  auto point_sum = [&](int idx, T (&acc)[kMaxBatch]) {
#pragma unroll
    for (int b = 0; b < kMaxBatch; ++b) acc[b] = T(0);
    cube_visit(a, cube_split(a, idx), [&](int to, int cube, int) {
      const T* st = P.stage + to * nc + cube;
#pragma unroll
      for (int b = 0; b < kMaxBatch; ++b)
        if (b < nb) acc[b] += st[b * nl * nc];
    });
  };

  // x = x0, r = p = rhat = r0, y = invd p; rho = |r0|^2, rnorm = |r0|
  T s[kMaxRed];
  zero(s);
  for (int idx = first; idx < n; idx += stride) {
    const T iv = P.invd[idx];
    #pragma unroll
    for (int b = 0; b < kMaxBatch; ++b) {
      if (b >= nb) break;
      const int64_t i = b * n + idx;
      const T rr = P.r0[i];
      P.x[i] = P.x0[i];
      P.r[i] = rr;
      P.p[i] = rr;
      P.y[i] = iv * rr;
      s[b] += rr * rr;
    }
  }
  grid_sum<kMaxBatch>(red, s);
  T rho[kMaxBatch], rn[kMaxBatch], tol[kMaxBatch];
  int it[kMaxBatch];
  for (int b = 0; b < kMaxBatch; ++b) {
    rho[b] = s[b];
    rn[b] = vsqrt(s[b]);
    tol[b] = b < nb ? P.tol[b] : T(0);
    it[b] = 0;
  }

  for (int k = 0; k < P.maxiter; ++k) {
    bool act[kMaxBatch];
    bool any = false;
    for (int b = 0; b < kMaxBatch; ++b) {
      act[b] = b < nb && rn[b] > tol[b];
      any = any || act[b];
    }
    if (!any) break;

    // v = zmask A_W (invd p); rv = rhat.v
    cube_products();
    cg::this_grid().sync();
    zero(s);
    for (int idx = first; idx < n; idx += stride) {
      T acc[kMaxBatch];
      point_sum(idx, acc);
      #pragma unroll
      for (int b = 0; b < kMaxBatch; ++b) {
        if (b >= nb) break;
        const int64_t i = b * n + idx;
        const T vv = P.zmask[i] * acc[b];
        P.v[i] = vv;
        s[b] += P.r0[i] * vv;
      }
    }
    grid_sum<kMaxBatch>(red, s);
    T alpha[kMaxBatch];
    for (int b = 0; b < kMaxBatch; ++b) alpha[b] = rho[b] / nz(s[b]);

    // s = r - alpha v (kept in r); y = invd s
    for (int idx = first; idx < n; idx += stride) {
      const T iv = P.invd[idx];
      #pragma unroll
      for (int b = 0; b < kMaxBatch; ++b) {
        if (b >= nb) break;
        const int64_t i = b * n + idx;
        const T ss = P.r[i] - alpha[b] * P.v[i];
        P.r[i] = ss;
        P.y[i] = iv * ss;
      }
    }
    cg::this_grid().sync();

    // t = zmask A_W (invd s); tt = t.t, ts = t.s
    cube_products();
    cg::this_grid().sync();
    zero(s);
    for (int idx = first; idx < n; idx += stride) {
      T acc[kMaxBatch];
      point_sum(idx, acc);
      #pragma unroll
      for (int b = 0; b < kMaxBatch; ++b) {
        if (b >= nb) break;
        const int64_t i = b * n + idx;
        const T tv = P.zmask[i] * acc[b];
        P.t[i] = tv;
        s[b] += tv * tv;
        s[kMaxBatch + b] += tv * P.r[i];
      }
    }
    grid_sum<kMaxRed>(red, s);
    T omega[kMaxBatch];
    for (int b = 0; b < kMaxBatch; ++b) omega[b] = s[kMaxBatch + b] / nz(s[b]);

    // x += alpha phat + omega shat (active rows); r = s - omega t, or restored
    // to s + alpha v on an inactive row; rho_new = rhat.r, |r|^2
    zero(s);
    for (int idx = first; idx < n; idx += stride) {
      const T iv = P.invd[idx];
      #pragma unroll
      for (int b = 0; b < kMaxBatch; ++b) {
        if (b >= nb) break;
        const int64_t i = b * n + idx;
        const T ss = P.r[i];
        const T dx = alpha[b] * (iv * P.p[i]) + omega[b] * (iv * ss);
        P.x[i] = P.x[i] + (act[b] ? T(1) : T(0)) * dx;
        const T rr = act[b] ? ss - omega[b] * P.t[i] : ss + alpha[b] * P.v[i];
        P.r[i] = rr;
        s[b] += P.r0[i] * rr;
        s[kMaxBatch + b] += rr * rr;
      }
    }
    grid_sum<kMaxRed>(red, s);
    T beta[kMaxBatch];
    for (int b = 0; b < kMaxBatch; ++b) {
      const T rho_new = act[b] ? s[b] : rho[b];
      beta[b] = (rho_new / nz(rho[b])) * (alpha[b] / nz(omega[b]));
      rho[b] = rho_new;
      if (act[b]) {
        rn[b] = vsqrt(s[kMaxBatch + b]);
        ++it[b];
      }
    }

    // p = r + beta (p - omega v) on the active rows; y = invd p
    for (int idx = first; idx < n; idx += stride) {
      const T iv = P.invd[idx];
      #pragma unroll
      for (int b = 0; b < kMaxBatch; ++b) {
        if (b >= nb) break;
        const int64_t i = b * n + idx;
        T pp = P.p[i];
        if (act[b]) {
          pp = P.r[i] + beta[b] * (pp - omega[b] * P.v[i]);
          P.p[i] = pp;
        }
        P.y[i] = iv * pp;
      }
    }
    cg::this_grid().sync();
  }
  if (blockIdx.x == 0 && threadIdx.x == 0)
    #pragma unroll
    for (int b = 0; b < kMaxBatch; ++b) {
      if (b >= nb) break;
      P.iters[b] = it[b];
      P.rnorm[b] = rn[b];
    }
}

// ---------------------------------------------------------------------------
// K1: MG-preconditioned CG for the singular P1 pressure Poisson
// ---------------------------------------------------------------------------
//
// make_pressure_cg with mg=build_pressure_mg_data(...): b demeaned, tol =
// rtol |b|, r0 = demean(b - A x0), z = demean(V-cycle(r)), every A p
// demeaned, x demeaned at the end.  The V-cycle: per level above the
// coarsest, nsmooth damped-Jacobi sweeps (the first from zero), the
// residual, its restriction; the coarsest level's degree-cheb_degree
// Chebyshev-Jacobi; back up, the prolongation and nsmooth sweeps.
//
// Every phase ends with a barrier of its level's team (mg_plan).  The
// levels are small (50,653 / 6,859 / 1,000 points at N=36 against ~64k
// threads), so a phase is bound by latency, its loads and its barrier, not
// by bytes or operations.  So:
//   - the levels on the whole grid (the fine level, and at N=64 level 1)
//     run their products on the P1 stencil tile with a halo of one layer
//     (cube_device.cuh, as K1's other modes: a block reads its tile's box
//     once, each point sums its 3^d neighbours in shared memory; level l's
//     coefficients are the fine level's times 2^(l (d-2)), a power of two,
//     applied to the sum, which leaves its bits those of the scaled table);
//   - the CG body has one grid barrier of its own, a reduction.  Phase A,
//     on the tile: p = (z - mz) + beta p wherever the tile reads p (two p
//     buffers by parity), Ap on the owned points, and the sums of Ap, p .
//     Ap and p, so that p . demean(Ap) = p . Ap - sum(Ap) sum(p) / n.
//     Phase B (x += alpha p, r' = r - alpha (Ap - mean) into the other of
//     two r buffers, the first sweep z = omega invd r', |r'|^2) rides on
//     the loads of the V-cycle's first product, which computes r' and z in
//     its box, halo included, and sums |r'|^2.  The last up-sweep of the
//     fine level sums z, r . z and r, so that rz = r . demean(z) = r . z -
//     mean(z) sum(r): z is never demeaned in memory, and p is formed where
//     it is read;
//   - on those levels the prolongation rides on the first up-sweep's loads
//     (a box point takes z + P z' of the coarser level);
//   - the levels with at most one point a thread of kSubBlocks blocks run
//     point by point on those blocks, each point's 3^d neighbours loaded at
//     once (stencil_sum), separated by a barrier among them (sub_sync);
//   - the coarsest levels (at most kBlockPoints points a thread of one
//     block) run on block 0 alone, their vectors in its shared memory as
//     boxes with a layer of zeros, the stencil read there, each phase
//     (every coarse Chebyshev step among them) ending with a
//     __syncthreads; the last one also writes z to the level's global slot
//     and ends with the level above's barrier, whose team prolongs from
//     there.
// Every level sums a point's stencil in one order with explicit fmas
// (stencil_apply, stencil_sum), so a point's value does not depend on the
// team that computes it: the plan moves no bit.  A grid transfer's point
// loads its taps at once, a tap beyond the grid at weight 0 (transfer).
// Per iteration at N=36: 6 grid barriers, 6 among the sub-group and 13 of
// block 0; at N=64 11, 6 and 19 (mg_barriers; with every level on the whole
// grid and point by point there were 30 grid barriers at N=36, with a
// sub-group alone 11 and 19).  On an NVIDIA H100
// 80GB HBM3 at 700 W an iteration took ~77 us at N=36, of which the 13
// coarse Chebyshev steps on block 0 ~2 us each; riding phase B and the
// prolongation on products (two grid barriers fewer) saved ~1 us each
// (PERF.md).

struct Level {
  int g[3];            // grid points per axis; a 2D grid is (1, g0, g1)
  FastDiv div1, div2;  // divisions by g[1] and g[2] (coords)
  int n;               // points
  int64_t off;         // first point of this level in the concatenated level arrays
};

// Levels that may run on the whole grid, each with its stencil plan (a
// kernel's parameters hold at most 4 KB); the sub-group starts at level
// kStencilLevels at the latest.
constexpr int kStencilLevels = 4;

template <typename T>
struct MgArgs {
  const T* Ap;    // (nl, nl) fine cube matrix
  const T* b;     // (n0)
  const T* x0;    // (n0)
  const T* invd;  // every level's Jacobi inverse diagonal, concatenated
  T* x;           // (n0) out
  T* work;        // 4 vectors per level (r, z, z', t), then p twice, Ap and r's
                  // second buffer (n0 each), then sub_sync's words
  T* red;
  int* iters;     // (1) out
  T* rnorm;       // (1) out
  int* conv;      // (1) out
  Level lev[kMaxLevels];
  CubeArgs lv[kStencilLevels];     // the grids of the levels on the whole grid
  StencilPlan sp[kStencilLevels];  // and their tiles
  T scale[kMaxLevels];      // 2^(l (d-2))
  int L, nsmooth, cheb_degree, maxiter;
  // the teams of mg_plan: levels [sub_level, block_level) on the first
  // sub_blocks blocks, [block_level, L) on block 0 with their vectors in
  // shared memory
  int sub_level, block_level, sub_blocks;
  size_t red_off, box_off, block_off;  // shared memory (mg_smem)
  double omega, lmin, lmax, rtol;
};

// K1 MG's teams (mg_plan).  The sub-group: kSubBlocks blocks of kThreads run
// the levels from the first one below the finest with at most kSubPoints
// points a thread of theirs (timed at 8, 16 and 32 blocks and a cluster of
// 8 with cluster.sync(): a coarse phase is bound by the work of the
// sub-group's SMs, so 8 blocks were slower than the whole grid; 16 and 32
// tie once the first sub-group level has at most a point a thread).  Block
// 0: the levels from the first one below the finest with at most
// kBlockPoints points a thread of one block (the coarsest at N=36, 1,000
// points; levels 3-4 at N=64, 729 and 125) hold their r, z, z', t and
// invd in its shared memory and take block barriers, so that the coarse
// Chebyshev steps cost a __syncthreads each in place of a sub-group
// barrier (4 points a thread timed faster than 2 and than no level on
// block 0, PERF.md).  The sub-group starts there at the latest.
constexpr int kSubBlocks = 32;
constexpr int kSubPoints = 1;
constexpr int kBlockPoints = 4;
constexpr int kMgBody = 1;  // grid barriers of the CG body outside the V-cycle

// A point's coordinates on its level, by exact multiply-and-shift divisions
// (FastDiv, exact below 2^31; cube_fits bounds every level).
__device__ __forceinline__ void coords(int idx, const Level& lv, int* c) {
  const int q = (int)fast_quo((unsigned)idx, lv.div2);
  c[2] = idx - q * lv.g[2];
  c[0] = (int)fast_quo((unsigned)q, lv.div1);
  c[1] = q - c[0] * lv.g[1];
}

// Fine neighbours of coarse index I along an axis of f fine points: the
// column of the 1-D linear interpolation (weights 0.5, 1, 0.5), a tap beyond
// the axis at weight 0 and clamped onto it.
template <typename T>
__device__ __forceinline__ void restrict_taps(int I, int f, int* j, T* w) {
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const int v = 2 * I + a - 1;
    const bool in = v >= 0 && v < f;
    j[a] = in ? v : 2 * I;
    w[a] = in ? (a == 1 ? T(1) : T(0.5)) : T(0);
  }
}

// Coarse neighbours of fine index i along an axis of c coarse points: the
// row of the same interpolation (an even i: its coarse point at weight 1
// and a second tap at weight 0).
template <typename T>
__device__ __forceinline__ void prolong_taps(int i, int c, int* j, T* w) {
  j[0] = i >> 1;
  j[1] = (i >> 1) + 1 < c ? (i >> 1) + 1 : i >> 1;
  w[0] = i & 1 ? T(0.5) : T(1);
  w[1] = i & 1 ? T(0.5) : T(0);
}

// sum over a0 (outer), a1, a2 of w0 (w1 (w2 v)) for the taps j with weights
// w (M a side; a 2D grid's leading axis its first tap only): a point of a
// grid transfer, every load in flight before the sums.  A weight-0 tap adds
// an exact 0, so the sum is the one over the taps on the grid.
template <typename T, int D, int M>
__device__ __forceinline__ T transfer(const T* v, int pl, int pr, const int (&j)[3][M],
                                      const T (&w)[3][M]) {
  constexpr int M0 = D == 3 ? M : 1;
  T x[M0][M][M];
#pragma unroll
  for (int a0 = 0; a0 < M0; ++a0)
#pragma unroll
    for (int a1 = 0; a1 < M; ++a1)
#pragma unroll
      for (int a2 = 0; a2 < M; ++a2) x[a0][a1][a2] = v[j[0][a0] * pl + j[1][a1] * pr + j[2][a2]];
  T acc0 = T(0);
#pragma unroll
  for (int a0 = 0; a0 < M0; ++a0) {
    T acc1 = T(0);
#pragma unroll
    for (int a1 = 0; a1 < M; ++a1) {
      T acc2 = T(0);
#pragma unroll
      for (int a2 = 0; a2 < M; ++a2) acc2 += w[2][a2] * x[a0][a1][a2];
      acc1 += w[1][a1] * acc2;
    }
    acc0 += (D == 3 ? w[0][a0] : T(1)) * acc1;
  }
  return acc0;
}

// K1 MG's shared memory: [stencil coefficients] [warp sums] [the tile's
// box] [block 0's levels: r, z, z', t and invd, each a box of
// mg_box_points].
struct MgSmem {
  size_t red_off, box_off, block_off, bytes;
};

// Points of a level's box on block 0: a layer of zeros round each real axis.
inline int64_t mg_box_points(int d, const Level& lv) {
  return (int64_t)(d == 3 ? lv.g[0] + 2 : 1) * (lv.g[1] + 2) * (lv.g[2] + 2);
}

template <typename T>
inline MgSmem mg_smem(int d, const StencilPlan& s, int64_t block_pts) {
  MgSmem m;
  m.red_off = stencil_table_bytes<T>(d);
  m.box_off = align16(m.red_off + sizeof(T) * kMaxRed * kWarps);
  m.block_off = align16(m.box_off + sizeof(T) * s.boxpts);
  m.bytes = m.block_off + sizeof(T) * 5 * block_pts;
  return m;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, kSolveBlocks) pressure_mg_kernel(MgArgs<T> P) {
  const int L = P.L;
  unsigned char* smem = dynamic_smem();
  T* S = reinterpret_cast<T*>(smem);
  Reducer<T> red{P.red, reinterpret_cast<T*>(smem + P.red_off), 0};
  T* BX = reinterpret_cast<T*>(smem + P.box_off);
  stencil_stage<T, D>(P.Ap, S);
  const int first = blockIdx.x * blockDim.x + threadIdx.x;
  const int stride = gridDim.x * blockDim.x;
  const bool lead = blockIdx.x == 0;  // block 0: the levels from block_level
  const int lsub = P.sub_level, lblk = P.block_level;

  // A level's vectors and their layout: point (c0, c1, c2) at org + c0 pl +
  // c1 pr + c2.  In global memory the level's own order; from lblk in block
  // 0's shared memory (invd staged there too), each vector a box with a
  // layer of zeros round the grid's real axes, which the stencil reads
  // beyond the edge (a box point outside the grid is never written).
  T* rr[kMaxLevels];
  T* z[kMaxLevels];
  T* zb[kMaxLevels];
  T* t[kMaxLevels];
  const T* iv[kMaxLevels];
  int org[kMaxLevels], pl[kMaxLevels], pr[kMaxLevels];
  T* sb = reinterpret_cast<T*>(smem + P.block_off);
  for (int l = 0; l < L; ++l) {
    const int* g = P.lev[l].g;
    int len;
    if (l < lblk) {
      rr[l] = P.work + 4 * P.lev[l].off;
      iv[l] = P.invd + P.lev[l].off;
      len = P.lev[l].n;
      pr[l] = g[2];
      pl[l] = g[1] * g[2];
      org[l] = 0;
    } else {
      pr[l] = g[2] + 2;
      pl[l] = (g[1] + 2) * pr[l];
      org[l] = (D == 3 ? pl[l] : 0) + pr[l] + 1;
      len = (D == 3 ? g[0] + 2 : 1) * pl[l];
      rr[l] = sb;
      sb += 5 * len;
      iv[l] = rr[l] + 4 * len;
    }
    z[l] = rr[l] + len;
    zb[l] = z[l] + len;
    t[l] = zb[l] + len;
  }
  if (lead && lblk < L) {
    T* b0 = reinterpret_cast<T*>(smem + P.block_off);
    for (int i = threadIdx.x; i < (int)(sb - b0); i += blockDim.x) b0[i] = T(0);
    __syncthreads();
    for (int l = lblk; l < L; ++l) {
      T* ivs = t[l] + (t[l] - zb[l]);
      for (int idx = threadIdx.x; idx < P.lev[l].n; idx += blockDim.x) {
        int c[3];
        coords(idx, P.lev[l], c);
        ivs[org[l] + c[0] * pl[l] + c[1] * pr[l] + c[2]] = P.invd[P.lev[l].off + idx];
      }
    }
  }
  __syncthreads();
  const int n0 = P.lev[0].n;
  T* pv[2] = {P.work + 4 * (P.lev[L - 1].off + P.lev[L - 1].n), nullptr};
  pv[1] = pv[0] + n0;
  T* Ap = pv[1] + n0;  // A p, from phase A to phase B
  T* rnext = Ap + n0;  // the fine level's r by iteration parity, with rr[0]
  T* x = P.x;
  const T nmean = (T)n0;
  const T om = (T)P.omega;
  const int ns = P.nsmooth;

  // The team of a level: the whole grid above level lsub; on lsub and below
  // the first B blocks (a level there has at most ~8 points a thread of
  // theirs); from lblk block 0 alone (at most kBlockPoints points a thread).
  // The blocks outside a team, which would have no work, run through the
  // same phases with empty loops and no barrier, and so make the same z/zb
  // swaps, up to the barrier that closes the team's part: the grid's after
  // the sub-group's last phase; after block 0's last phase, which also
  // writes level lblk's z to its global slot zg, the barrier of the level
  // above, whose team then prolongs from zg.  A coarse phase holds no
  // reduction and a point's arithmetic does not depend on its thread.
  const bool subpart = lsub < lblk;  // levels on the sub-group
  const int B = P.sub_blocks < (int)gridDim.x ? P.sub_blocks : (int)gridDim.x;
  const bool member = (int)blockIdx.x < B;
  const int sub_first = member ? first : INT32_MAX;
  const int sub_stride = B * blockDim.x;
  const int blk_first = lead ? (int)threadIdx.x : INT32_MAX;
  auto lo = [&](int l) { return l < lsub ? first : l < lblk ? sub_first : blk_first; };
  auto step = [&](int l) { return l < lsub ? stride : l < lblk ? sub_stride : (int)blockDim.x; };
  unsigned* bar = reinterpret_cast<unsigned*>(rnext + n0);  // sub_sync's words
  if (blockIdx.x == 0 && threadIdx.x == 0) bar[0] = 0u;  // before the first grid barrier
  T* zg = lblk < L ? P.work + 4 * P.lev[lblk].off + P.lev[lblk].n : nullptr;
  // the barrier that ends a phase on level l: the grid's above lsub and for
  // the phase that closes the sub-group's part, the sub-group's above lblk,
  // else block 0's; block 0's last phase (publish) ends with the level
  // above's
  auto sync = [&](int l, bool closing, bool publish = false) {
    if (publish) l = lblk - 1;
    if (l < lsub || closing) {
      cg::this_grid().sync();
    } else if (l < lblk) {
      if (member) sub_sync(bar, (unsigned)B);
    } else if (lead) {
      __syncthreads();
    }
  };

  // A v on level l < lsub, a tile at a time (the grid's blocks in turn):
  // fetch(i, own) (global loads) and put(i, own, v) give the input at grid
  // point i into the box (region 1); then store(i, (A v)_i, v_i) at each
  // owned point
  auto tiled = [&](int l, auto&& fetch, auto&& put, auto&& store) {
    const StencilPlan& sp = P.sp[l];
    const CubeArgs& a = P.lv[l];
    const T sc = P.scale[l];
    const int nt = sp.ntile[0] * sp.ntile[1] * sp.ntile[2];
#pragma unroll 1
    for (int tt = blockIdx.x; tt < nt; tt += gridDim.x) {
      int B0[3];
      stencil_tile(sp, tt, B0);
      __syncthreads();  // the last tile's readers of the box are done
      stencil_load<D, 4>(
          a, sp, B0, 1, [&](int i, bool own) { return fetch(i, own); },
          [&](int i, int lb, bool own, const auto& v) { BX[lb] = i >= 0 ? put(i, own, v) : T(0); });
      __syncthreads();
      stencil_region<D>(a, sp, B0, 0, [&](int i, int lb, int cls, bool) {
        if (i < 0) return;
        T acc[1];
        stencil_apply<T, D, 1>(S, cls, BX, sp, lb, 1, acc);
        store(i, acc[0] * sc, BX[lb]);
      });
    }
  };
  // point idx of level l: its coordinates c, its index in the level's
  // layout; A v there (l >= lsub) point by point: each neighbour's load in
  // flight at once (stencil_sum), a neighbour beyond the grid read at the
  // nearest point of the grid (its coefficient is 0) or in the box's zeros
  auto at = [&](int l, int idx, int* c) {
    coords(idx, P.lev[l], c);
    return org[l] + c[0] * pl[l] + c[1] * pr[l] + c[2];
  };
  auto klass = [&](int l, const int* c) {  // the stencil's class of point c
    const int* g = P.lev[l].g;
    int cls = 0;
#pragma unroll
    for (int k = 3 - D; k < 3; ++k) cls = 3 * cls + (c[k] == 0 ? 0 : c[k] == g[k] - 1 ? 2 : 1);
    return cls;
  };
  auto mv = [&](int l, const T* src, int si, const int* c) -> T {
    const int* g = P.lev[l].g;
    const int cls = klass(l, c);
    T y;
    if (l < lblk) {
      auto in = [](int v, int n) { return v < 0 ? 0 : v >= n ? n - 1 : v; };
      y = stencil_sum<T, D>(S, cls, [&](int e0, int e1, int e2) {
        return src[(in(c[0] + e0, g[0]) * g[1] + in(c[1] + e1, g[1])) * g[2] + in(c[2] + e2, g[2])];
      });
    } else {
      y = stencil_sum<T, D>(S, cls, [&](int e0, int e1, int e2) {
        return src[si + e0 * pl[l] + e1 * pr[l] + e2];
      });
    }
    return y * P.scale[l];
  };
  // store(idx, si, load(idx, si, c)) at each point idx of level l >= lsub
  // for its team, si its index in the level's layout and c its coordinates
  auto points = [&](int l, auto&& load, auto&& store) {
    for (int idx = lo(l); idx < P.lev[l].n; idx += step(l)) {
      int c[3];
      const int si = at(l, idx, c);
      store(idx, si, load(idx, si, c));
    }
  };
  auto swapz = [&](int l) {
    T* tmp = z[l];
    z[l] = zb[l];
    zb[l] = tmp;
  };
  T s[kMaxRed];

  // The input z of a product on level l < lsub, a tile at a time, into
  // store: z[l]; kProlong: z[l] + P z' of the coarser level (zc_p, its rows
  // cpr_p and planes cpl_p apart), the prolongation riding on the first
  // up-sweep; kPhaseB (level 0, the V-cycle's first product): phase B of
  // the CG body riding on it, r' = r - alpha (Ap - ma) from the last
  // iteration's r (r_b) and z = omega invd r', with r', z and x += alpha p
  // written at the owned points and |r'|^2 summed into s[0].
  enum { kPlain, kProlong, kPhaseB };
  T alpha_b = T(0), ma_b = T(0);
  const T* p_b = nullptr;
  const T* r_b = nullptr;
  const T* zc_p = nullptr;
  int cpl_p = 0, cpr_p = 0;
  auto tiled_z = [&](int l, int mode, auto&& store) {
    const T* zl = z[l];
    if (mode == kPhaseB) {
      T* z0 = z[0];
      tiled(
          0,
          [&](int i, bool own) {
            return Vals<T, 5>{{r_b[i], Ap[i], iv[0][i], own ? p_b[i] : T(0), own ? x[i] : T(0)}};
          },
          [&](int i, bool own, const Vals<T, 5>& v) {
            const T r = vfma(-alpha_b, v.v[1] - ma_b, v.v[0]);
            const T zz = (om * v.v[2]) * r;
            if (own) {
              rr[0][i] = r;
              z0[i] = zz;
              x[i] = vfma(alpha_b, v.v[3], v.v[4]);
              s[0] = vfma(r, r, s[0]);
            }
            return zz;
          },
          store);
    } else if (mode == kProlong) {
      const Level& F = P.lev[l];
      const Level& C = P.lev[l + 1];
      tiled(
          l,
          [&](int i, bool) {
            int c[3], j[3][2];
            T w[3][2];
            coords(i, F, c);
            for (int k = 0; k < 3; ++k) prolong_taps(c[k], C.g[k], j[k], w[k]);
            return Vals<T, 2>{{zl[i], transfer<T, D, 2>(zc_p, cpl_p, cpr_p, j, w)}};
          },
          [&](int, bool, const Vals<T, 2>& v) { return v.v[0] + v.v[1]; }, store);
    } else {
      tiled(l, [&](int i, bool) { return Vals<T, 1>{{zl[i]}}; },
            [&](int, bool, const Vals<T, 1>& v) { return v.v[0]; }, store);
    }
  };

  // z' = z + omega invd (r - A z); with_sum (level 0): the grid sums of z',
  // r . z' and r into s, else the level's barrier (closing: the grid's;
  // publish: block 0's last phase; kPhaseB: the grid sum of s[0])
  auto sweep = [&](int l, bool with_sum, bool closing, bool publish, int mode) {
    zero(s);
    auto upd = [&](int i, T az, T zi) {
      const T zn = zi + (om * iv[l][i]) * (rr[l][i] - az);
      zb[l][i] = zn;
      if (with_sum) {
        const T r = rr[l][i];
        s[0] += zn;
        s[1] = vfma(r, zn, s[1]);
        s[2] += r;
      }
      return zn;
    };
    if (l < lsub) {
      tiled_z(l, mode, upd);
    } else {
      points(
          l, [&](int, int si, const int* c) { return mv(l, z[l], si, c); },
          [&](int idx, int si, T az) {
            const T zn = upd(si, az, z[l][si]);
            if (publish) zg[idx] = zn;
          });
    }
    swapz(l);
    if (with_sum)
      grid_sum_warp<3>(red, s);
    else if (mode == kPhaseB)
      grid_sum_warp<1>(red, s);
    else
      sync(l, closing, publish);
  };

  const double theta = 0.5 * (P.lmax + P.lmin);
  const double delta = 0.5 * (P.lmax - P.lmin);
  const double sigma1 = theta / delta;

  // z[0] holds omega invd r[0] (the first sweep from zero) on entry, or,
  // with phase_b, comes from phase B riding on the first product (its |r'|^2
  // in rsq); leaves the V-cycle's z in z[0] and the grid sums of z, r . z
  // and r in s
  T rsq = T(0);
  auto vcycle = [&](bool phase_b) {
    for (int l = 0; l + 1 < L; ++l) {
      for (int k = 1; k < ns; ++k) {
        const bool b = phase_b && l == 0 && k == 1;
        sweep(l, false, false, false, b ? kPhaseB : kPlain);
        if (b) rsq = s[0];
      }
      // t[l] = r[l] - A z[l]
      const bool b = phase_b && l == 0 && ns == 1;
      if (l < lsub) {
        zero(s);
        tiled_z(l, b ? kPhaseB : kPlain, [&](int i, T az, T) { t[l][i] = rr[l][i] - az; });
      } else {
        points(
            l, [&](int, int si, const int* c) { return mv(l, z[l], si, c); },
            [&](int, int si, T az) { t[l][si] = rr[l][si] - az; });
      }
      if (b) {
        grid_sum_warp<1>(red, s);
        rsq = s[0];
      } else {
        sync(l, false);
      }
      // r[l+1] = P^T t[l], then the next level's first step
      const Level& F = P.lev[l];
      const Level& C = P.lev[l + 1];
      const bool coarsest = l + 2 == L;
      const bool publish = coarsest && l + 1 == lblk && P.cheb_degree < 2;
      points(
          l + 1,
          [&](int, int, const int* I) {
            int j[3][3];
            T w[3][3];
            for (int k = 0; k < 3; ++k) restrict_taps(I[k], F.g[k], j[k], w[k]);
            return transfer<T, D, 3>(t[l] + org[l], pl[l], pr[l], j, w);
          },
          [&](int idx, int si, T acc0) {
            rr[l + 1][si] = acc0;
            if (coarsest) {
              const T dk = (iv[l + 1][si] * acc0) / (T)theta;
              t[l + 1][si] = dk;
              z[l + 1][si] = dk;
              if (publish) zg[idx] = dk;
            } else {
              z[l + 1][si] = (om * iv[l + 1][si]) * acc0;
            }
          });
      sync(l + 1, subpart && coarsest && l + 1 == lsub && P.cheb_degree < 2, publish);
    }
    // coarsest level: Chebyshev-Jacobi, dk kept in t
    const int lc = L - 1;
    double rho = 1.0 / sigma1;
    if (lc >= lblk) {
      // on block 0: a thread's points (at most kBlockPoints), their index in
      // the box and their class, and the level's vectors held in registers
      // over the steps
      int si[kBlockPoints], cl[kBlockPoints];
#pragma unroll
      for (int j = 0; j < kBlockPoints; ++j) {
        const int idx = threadIdx.x + j * blockDim.x;
        si[j] = -1;
        if (lead && idx < P.lev[lc].n) {
          int c[3];
          si[j] = at(lc, idx, c);
          cl[j] = klass(lc, c);
        }
      }
      T* R = rr[lc];
      T* TK = t[lc];
      const T* IV = iv[lc];
      T* za = z[lc];
      T* zo = zb[lc];
      const int ppl = pl[lc], ppr = pr[lc];
      const T sc = P.scale[lc];
      for (int k = 0; k + 1 < P.cheb_degree; ++k) {
        const double rho_new = 1.0 / (2.0 * sigma1 - rho);
        const T c1 = (T)(rho_new * rho);
        const T c2 = (T)(2.0 * rho_new / delta);
        const bool publish = lc == lblk && k + 2 == P.cheb_degree;
#pragma unroll 1
        for (int j = 0; j < kBlockPoints; ++j) {
          const int q = si[j];
          if (q < 0) continue;
          const T az = stencil_sum<T, D>(S, cl[j], [&](int e0, int e1, int e2) {
                         return za[q + e0 * ppl + e1 * ppr + e2];
                       }) * sc;
          const T dk = vfma(c1, TK[q], c2 * (IV[q] * (R[q] - az)));
          TK[q] = dk;
          const T zn = za[q] + dk;
          zo[q] = zn;
          if (publish) zg[threadIdx.x + j * blockDim.x] = zn;
        }
        T* tmp = za;
        za = zo;
        zo = tmp;
        sync(lc, false, publish);
        rho = rho_new;
      }
      z[lc] = za;
      zb[lc] = zo;
    }
    for (int k = 0; lc < lblk && k + 1 < P.cheb_degree; ++k) {
      const double rho_new = 1.0 / (2.0 * sigma1 - rho);
      const T c1 = (T)(rho_new * rho);
      const T c2 = (T)(2.0 * rho_new / delta);
      const bool publish = lc == lblk && k + 2 == P.cheb_degree;
      points(
          lc, [&](int, int si, const int* c) { return mv(lc, z[lc], si, c); },
          [&](int idx, int si, T az) {
            const T dk = vfma(c1, t[lc][si], c2 * (iv[lc][si] * (rr[lc][si] - az)));
            t[lc][si] = dk;
            const T zn = z[lc][si] + dk;
            zb[lc][si] = zn;
            if (publish) zg[idx] = zn;
          });
      swapz(lc);
      sync(lc, subpart && lc == lsub && k + 2 == P.cheb_degree, publish);
      rho = rho_new;
    }
    for (int l = L - 2; l >= 0; --l) {
      // z[l] += P z[l+1] (from zg out of block 0's first level): on a level
      // of the whole grid riding on the first sweep's loads, else a phase
      const Level& C = P.lev[l + 1];
      const bool out = l + 1 == lblk;
      const T* zc = out ? zg : z[l + 1];
      const int corg = out ? 0 : org[l + 1], cpl = out ? C.g[1] * C.g[2] : pl[l + 1];
      const int cpr = out ? C.g[2] : pr[l + 1];
      if (l >= lsub) {
        points(
            l,
            [&](int, int, const int* i) {
              int j[3][2];
              T w[3][2];
              for (int k = 0; k < 3; ++k) prolong_taps(i[k], C.g[k], j[k], w[k]);
              return transfer<T, D, 2>(zc + corg, cpl, cpr, j, w);
            },
            [&](int, int si, T acc0) { z[l][si] += acc0; });
        sync(l, false);
      }
      zc_p = zc + corg;
      cpl_p = cpl;
      cpr_p = cpr;
      for (int k = 0; k < ns; ++k)
        sweep(l, l == 0 && k + 1 == ns, subpart && l == lsub && k + 1 == ns,
              l == lblk && k + 1 == ns, l < lsub && k == 0 ? kProlong : kPlain);
    }
  };

  // b = demean(b); tol = rtol |b|; x = x0; r = demean(b - A x0)
  zero(s);
  tiled(
      0, [&](int i, bool) { return Vals<T, 1>{{P.x0[i]}}; },
      [&](int i, bool own, const Vals<T, 1>& v) {
        if (own) x[i] = v.v[0];
        return v.v[0];
      },
      [&](int i, T ap, T) {
        Ap[i] = ap;
        s[0] += P.b[i];
      });
  grid_sum_warp<1>(red, s);
  const T mb = s[0] / nmean;
  zero(s);
  for (int idx = first; idx < n0; idx += stride) {
    const T bd = P.b[idx] - mb;
    const T v = bd - Ap[idx];
    rr[0][idx] = v;
    s[0] = vfma(bd, bd, s[0]);
    s[1] += v;
  }
  grid_sum_warp<2>(red, s);
  const T tol = (T)P.rtol * vsqrt(s[0]);
  const T mr = s[1] / nmean;
  zero(s);
  for (int idx = first; idx < n0; idx += stride) {
    const T r = rr[0][idx] - mr;
    rr[0][idx] = r;
    z[0][idx] = (om * iv[0][idx]) * r;
    s[0] = vfma(r, r, s[0]);
  }
  grid_sum_warp<1>(red, s);
  T rn = vsqrt(s[0]);
  // z = V-cycle(r); rz = r . demean(z)
  vcycle(false);
  T mz = s[0] / nmean;
  T rz = vfma(-mz, s[2], s[1]);

  int k = 0;
  T beta = T(0);
  while (k < P.maxiter && rn > tol) {
    // phase A: p = demean(z) + beta p (k = 0: demean(z)); Ap; alpha = rz /
    // p . demean(Ap)
    T* pn = pv[k & 1];
    const T* po = pv[(k & 1) ^ 1];
    const T* zl = z[0];
    zero(s);
    tiled(
        0, [&](int i, bool) { return Vals<T, 2>{{zl[i], k == 0 ? T(0) : po[i]}}; },
        [&](int i, bool own, const Vals<T, 2>& v) {
          const T zz = v.v[0] - mz;
          const T pp = k == 0 ? zz : vfma(beta, v.v[1], zz);
          if (own) pn[i] = pp;
          return pp;
        },
        [&](int i, T ap, T pp) {
          Ap[i] = ap;
          s[0] += ap;
          s[1] = vfma(pp, ap, s[1]);
          s[2] += pp;
        });
    grid_sum_warp<3>(red, s);
    ma_b = s[0] / nmean;
    alpha_b = rz / nz(vfma(-ma_b, s[2], s[1]));
    // phase B (x += alpha p; r -= alpha (Ap - ma) into the other r buffer;
    // |r|; the V-cycle's first sweep) rides on the V-cycle's first product
    p_b = pn;
    r_b = rr[0];
    rr[0] = rnext;
    rnext = const_cast<T*>(r_b);
    vcycle(true);
    const T rn_new = vsqrt(rsq);
    mz = s[0] / nmean;
    const T rz_new = vfma(-mz, s[2], s[1]);
    beta = rz_new / nz(rz);
    rz = rz_new;
    rn = rn_new;
    ++k;
  }

  // x = demean(x)
  zero(s);
  for (int idx = first; idx < n0; idx += stride) s[0] += x[idx];
  grid_sum_warp<1>(red, s);
  const T mx = s[0] / nmean;
  for (int idx = first; idx < n0; idx += stride) x[idx] = x[idx] - mx;
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    P.iters[0] = k;
    P.rnorm[0] = rn;
    P.conv[0] = rn <= tol ? 1 : 0;
  }
}

// ---------------------------------------------------------------------------
// K1, non-MG modes: Jacobi- or Chebyshev-Jacobi-preconditioned CG for the
// singular P1 pressure Poisson
// ---------------------------------------------------------------------------
//
// make_pressure_cg with mg=None: b demeaned, tol = rtol |b|, r0 = demean(b -
// A x0), every A p demeaned, x demeaned at the end; z = M r is not demeaned.
// M r is invd r (cheb_degree 0), or the recurrence of cheb_into on the fine
// operator: dk = invd r / theta, z = dk, then cheb_degree - 1 steps of
// dk = c1 dk + c2 invd (r - A z), z += dk.
//
// The grid is small (46,656 points at N=35, 9 work vectors of 187 KB in
// float32, L2-resident) and an iteration's time goes to its grid-wide
// phases, not to bytes or operations: a grid-wide phase (a barrier, a
// reduction and a pass) takes 5-7.5 us on an NVIDIA H100 80GB HBM3 at
// 700 W, against ~0.05 us of arithmetic.  So an iteration has two grid
// barriers, both reductions, at any degree whose box fits:
//   phase A, on the stencil tile (cube_device.cuh) with a halo of one
//     layer: p = z + beta p wherever the tile reads p (its owned points go
//     to the other of two p buffers, by iteration parity), Ap = A p on the
//     owned points, and the sums of Ap, p . Ap and p, so that p . demean(Ap)
//     = p . Ap - sum(Ap) sum(p) / n needs no pass of its own;
//   phase B: x += alpha p and r' = r - alpha (Ap - mean) on the owned
//     points, and z = M r'.  A Chebyshev step reads the neighbours' z, so a
//     block takes a box of `steps` halo layers: r' and the first term on the
//     whole box, then each step on one layer less, in shared memory, and it
//     writes r' and z on its owned points with the sums |r'|^2 and r' . z.
//     A value computed in a halo is the owner's formula on the owner's inputs
//     (stencil_apply's order, explicit fmas), so it has the owner's bits.
// Where a box of deg - 1 layers does not fit (a high degree), the steps run
// in segments of `steps`, each on its box, a grid barrier after each: 1 +
// ceil((deg - 1) / steps) barriers an iteration (pcg_barriers).  Jacobi and
// degree 1 run phase B point by point.  A block loops over its tiles (N=63:
// 512 tiles of 4 x 8 x 8 against 264 resident blocks, two an SM), so the
// state stays in global memory and a block re-reads its box after each
// barrier.  A box load issues four points' loads a thread before it stores
// any (stencil_load), and a point reads its class's coefficients in 16-byte
// loads (stencil_apply).

template <typename T>
struct PcgArgs {
  const T* Ap;    // (nl, nl) cube matrix
  const T* b;     // (n)
  const T* x0;    // (n)
  const T* invd;  // (n) Jacobi inverse diagonal
  T* x;           // (n) out
  T* work;        // 9 vectors: r[2], p[2], Ap, z[2], dk[2] (each pair by parity)
  T* red;
  int* iters;     // (1) out
  T* rnorm;       // (1) out
  int* conv;      // (1) out
  CubeArgs a;     // the grid
  StencilPlan s;  // the tiles, with a box of s.H = steps halo layers
  int steps;      // Chebyshev steps a segment of phase B
  int cheb_degree, maxiter;
  double lmin, lmax, rtol;
};

// K1's shared memory: [stencil coefficients] [warp sums] [box: r', invd, dk
// and z twice for the Chebyshev steps; one array (phase A's p) for Jacobi
// and degree 1].
template <typename T>
__host__ __device__ inline size_t pcg_box_offset(int d) {
  return stencil_table_bytes<T>(d) + align16(sizeof(T) * kMaxRed * kWarps);
}
template <typename T>
inline size_t pcg_smem(int d, const StencilPlan& s, int deg) {
  return pcg_box_offset<T>(d) + sizeof(T) * (deg > 1 ? 5 : 1) * s.boxpts;
}
inline int pcg_barriers(int deg, int steps) {
  const int nsteps = deg > 1 ? deg - 1 : 0;
  return 1 + (nsteps > 0 ? (nsteps + steps - 1) / steps : 1);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, kSolveBlocks) pressure_cg_kernel(PcgArgs<T> P) {
  const CubeArgs& a = P.a;
  const StencilPlan& sp = P.s;
  const int n = a.npad_out;
  unsigned char* smem = dynamic_smem();
  T* S = reinterpret_cast<T*>(smem);
  Reducer<T> red{P.red, reinterpret_cast<T*>(smem + stencil_table_bytes<T>(D)), 0};
  T* R = reinterpret_cast<T*>(smem + pcg_box_offset<T>(D));  // phase A's p, then r'
  T* IV = R + sp.boxpts;
  T* DK = IV + sp.boxpts;
  T* Z0 = DK + sp.boxpts;
  T* Z1 = Z0 + sp.boxpts;
  stencil_stage<T, D>(P.Ap, S);
  __syncthreads();
  const int first = blockIdx.x * blockDim.x + threadIdx.x;
  const int stride = gridDim.x * blockDim.x;
  const int ntiles = sp.ntile[0] * sp.ntile[1] * sp.ntile[2];

  T* r[2] = {P.work, P.work + n};
  T* p[2] = {P.work + 2 * n, P.work + 3 * n};
  T* Ap = P.work + 4 * n;
  T* zs[2] = {P.work + 5 * n, P.work + 6 * n};
  T* dks[2] = {P.work + 7 * n, P.work + 8 * n};
  T* x = P.x;
  const T* iv = P.invd;
  const T nmean = (T)n;
  const int deg = P.cheb_degree;
  const int nsteps = deg > 1 ? deg - 1 : 0;  // Chebyshev steps an application
  const int nseg = nsteps > 0 ? (nsteps + P.steps - 1) / P.steps : 1;
  T* zf = zs[(nseg - 1) & 1];  // z = M r, as phase A reads it
  const double theta = 0.5 * (P.lmax + P.lmin);
  const double delta = 0.5 * (P.lmax - P.lmin);
  const double sigma1 = deg > 0 ? theta / delta : 0.0;
  const T rtheta = deg > 0 ? (T)theta : T(1);
  T s[kMaxRed];

  // A x on a tile: fetch(i) (global loads) and put(i, own, v) give the input
  // at grid point i, into the box (region 1); then store(i, (A x)_i, x_i) at
  // each owned point
  auto product = [&](const int (&B0)[3], auto&& fetch, auto&& put, auto&& store) {
    __syncthreads();  // the last tile's readers of the box are done
    stencil_load<D, 4>(
        a, sp, B0, 1, [&](int i, bool) { return fetch(i); },
        [&](int i, int l, bool own, const Vals<T, 2>& v) { R[l] = i >= 0 ? put(i, own, v) : T(0); });
    __syncthreads();
    stencil_region<D>(a, sp, B0, 0, [&](int i, int l, int cls, bool) {
      if (i < 0) return;
      T acc[1];
      stencil_apply<T, D, 1>(S, cls, R, sp, l, 1, acc);
      store(i, acc[0], R[l]);
    });
  };

  // Phase B: x += alpha p (not on init), r' = r - alpha (Ap - ma) (on init
  // r - ma) from rin into rout, z = M r' into zf; s[0] = |r'|^2 and s[1] =
  // r' . z over the block's owned points (the caller sums the grid).
  auto phase_b = [&](bool init, T alpha, T ma, const T* pv, const T* rin, T* rout) {
    zero(s);
    auto rnew = [&](int i) { return init ? rin[i] - ma : vfma(-alpha, Ap[i] - ma, rin[i]); };
    if (nsteps == 0) {
      for (int idx = first; idx < n; idx += stride) {
        if (!init) x[idx] = vfma(alpha, pv[idx], x[idx]);
        const T rr = rnew(idx);
        const T zz = deg > 0 ? (iv[idx] * rr) / rtheta : iv[idx] * rr;
        rout[idx] = rr;
        zf[idx] = zz;
        s[0] = vfma(rr, rr, s[0]);
        s[1] = vfma(rr, zz, s[1]);
      }
      return;
    }
    double rho0 = 1.0 / sigma1;  // rho before a segment's first step
    for (int m = 0, done = 0; m < nseg; ++m) {
      const int st = nsteps - done < P.steps ? nsteps - done : P.steps;
      const bool last = m + 1 == nseg;
      const T* zi = zs[(m + 1) & 1];  // the last segment's
      const T* dki = dks[(m + 1) & 1];
      T* zo = zs[m & 1];
      T* dko = dks[m & 1];
      #pragma unroll 1
      for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
        int B0[3];
        stencil_tile(sp, t, B0);
        __syncthreads();  // the last tile's readers of the box are done
        // the box (region st): r', invd and the first term, or the last
        // segment's dk and z; 0 outside the grid
        stencil_load<D, 4>(
            a, sp, B0, st,
            [&](int i, bool own) {
              Vals<T, 5> v;  // invd; r and Ap, or r', dk and z; p and x if owned
              v.v[0] = iv[i];
              if (m == 0) {
                v.v[1] = rin[i];
                v.v[2] = init ? T(0) : Ap[i];
                v.v[3] = own && !init ? pv[i] : T(0);
                v.v[4] = own && !init ? x[i] : T(0);
              } else {
                v.v[1] = rout[i];
                v.v[2] = dki[i];
                v.v[3] = zi[i];
              }
              return v;
            },
            [&](int i, int l, bool own, const Vals<T, 5>& v) {
              T rr = T(0), d = T(0), zz = T(0);
              if (i >= 0) {
                if (m == 0) {
                  rr = init ? v.v[1] - ma : vfma(-alpha, v.v[2] - ma, v.v[1]);
                  d = (v.v[0] * rr) / rtheta;
                  zz = d;
                  if (own) {
                    rout[i] = rr;
                    if (!init) x[i] = vfma(alpha, v.v[3], v.v[4]);
                  }
                } else {
                  rr = v.v[1];
                  d = v.v[2];
                  zz = v.v[3];
                }
              }
              R[l] = rr;
              IV[l] = v.v[0];
              DK[l] = d;
              Z0[l] = zz;
              Z1[l] = zz;
            });
        double rho = rho0;
        T* za = Z0;
        T* zb = Z1;
        for (int j = 1; j <= st; ++j) {
          const double rho_new = 1.0 / (2.0 * sigma1 - rho);
          const T c1 = (T)(rho_new * rho);
          const T c2 = (T)(2.0 * rho_new / delta);
          const bool out = j == st;  // region 0: the owned points
          __syncthreads();
          stencil_region<D>(a, sp, B0, st - j, [&](int i, int l, int cls, bool) {
            if (i < 0) return;
            T acc[1];
            stencil_apply<T, D, 1>(S, cls, za, sp, l, 1, acc);
            const T dn = vfma(c1, DK[l], c2 * (IV[l] * (R[l] - acc[0])));
            const T zn = za[l] + dn;
            DK[l] = dn;
            zb[l] = zn;
            if (out) {
              zo[i] = zn;
              if (!last) {
                dko[i] = dn;
              } else {
                s[0] = vfma(R[l], R[l], s[0]);
                s[1] = vfma(R[l], zn, s[1]);
              }
            }
          });
          T* tmp = za;
          za = zb;
          zb = tmp;
          rho = rho_new;
        }
      }
      for (int j = 0; j < st; ++j) rho0 = 1.0 / (2.0 * sigma1 - rho0);
      done += st;
      if (!last) cg::this_grid().sync();
    }
  };

  // b = demean(b); tol = rtol |b|; x = x0; r = demean(b - A x0) (r[0])
  zero(s);
  #pragma unroll 1
  for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
    int B0[3];
    stencil_tile(sp, t, B0);
    product(
        B0, [&](int i) { return Vals<T, 2>{{P.x0[i], T(0)}}; },
        [&](int i, bool own, const Vals<T, 2>& v) {
          if (own) x[i] = v.v[0];
          return v.v[0];
        },
        [&](int i, T ap, T) {
          Ap[i] = ap;
          s[0] += P.b[i];
        });
  }
  grid_sum_warp<1>(red, s);
  const T mb = s[0] / nmean;
  zero(s);
  for (int idx = first; idx < n; idx += stride) {
    const T bd = P.b[idx] - mb;
    const T v = bd - Ap[idx];
    r[1][idx] = v;
    s[0] = vfma(bd, bd, s[0]);
    s[1] += v;
  }
  grid_sum_warp<2>(red, s);
  const T tol = (T)P.rtol * vsqrt(s[0]);
  // z = M r; rz = r.z, |r|
  phase_b(true, T(0), s[1] / nmean, nullptr, r[1], r[0]);
  grid_sum_warp<2>(red, s);
  T rn = vsqrt(s[0]);
  T rz = s[1];

  int k = 0;
  T beta = T(0);
  while (k < P.maxiter && rn > tol) {
    // phase A: p = z + beta p (k = 0: p = z); Ap; alpha = rz / p.demean(Ap)
    T* pn = p[k & 1];
    const T* po = p[(k & 1) ^ 1];
    zero(s);
    #pragma unroll 1
    for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
      int B0[3];
      stencil_tile(sp, t, B0);
      product(
          B0, [&](int i) { return Vals<T, 2>{{zf[i], k == 0 ? T(0) : po[i]}}; },
          [&](int i, bool own, const Vals<T, 2>& v) {
            const T pp = k == 0 ? v.v[0] : vfma(beta, v.v[1], v.v[0]);
            if (own) pn[i] = pp;
            return pp;
          },
          [&](int i, T ap, T pv) {
            Ap[i] = ap;
            s[0] += ap;
            s[1] = vfma(pv, ap, s[1]);
            s[2] += pv;
          });
    }
    grid_sum_warp<3>(red, s);
    const T ma = s[0] / nmean;
    const T alpha = rz / nz(vfma(-ma, s[2], s[1]));
    // phase B: x += alpha p; r -= alpha Apv; z = M r; |r|, r.z
    phase_b(false, alpha, ma, pn, r[k & 1], r[(k & 1) ^ 1]);
    grid_sum_warp<2>(red, s);
    const T rz_new = s[1];
    beta = rz_new / nz(rz);
    rz = rz_new;
    rn = vsqrt(s[0]);
    ++k;
  }

  // x = demean(x)
  zero(s);
  for (int idx = first; idx < n; idx += stride) s[0] += x[idx];
  grid_sum_warp<1>(red, s);
  const T mx = s[0] / nmean;
  for (int idx = first; idx < n; idx += stride) x[idx] = x[idx] - mx;
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    P.iters[0] = k;
    P.rnorm[0] = rn;
    P.conv[0] = rn <= tol ? 1 : 0;
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <typename T>
auto mass_kernel(int nl, int nb) {
  if (nl == 8) return cg_mass_kernel<T, 8, 0, true>;
  if (nl == 4) return cg_mass_kernel<T, 4, 0, true>;
  if (nl != 27) return cg_mass_kernel<T, 9, 0, false>;
  return nb == 1 ? cg_mass_kernel<T, 27, 1, false>
         : nb == 2 ? cg_mass_kernel<T, 27, 2, false>
         : nb == 3 ? cg_mass_kernel<T, 27, 3, false>
                   : cg_mass_kernel<T, 27, 4, false>;
}

// K4's routes (oasisx_cg_mass_route): the point-by-point product (any cube
// but P1 and P2), K5's block-tiled one (P2), the stencil tile (P1).
enum MassRoute { kMassPoint = 0, kMassTiled = 1, kMassStencil = 2 };

// K4's route, shared memory and blocks an SM on a (a.nbo rows), with the
// tile or the stencil plan set in a / s.  False where no tile fits.
template <typename T>
bool mass_plan(CubeArgs& a, StencilPlan& s, int deg, int* route, size_t* red_off, size_t* smem,
               int* blocks) {
  const int nb = a.nbo;
  if (deg == 2) {
    if (!tile_choose<T>(a, nb)) return false;
    *route = kMassTiled;
    *red_off = align16(tile_smem<T>(a, nb));
    *smem = tile_block_smem<T>(a, nb);
    *blocks = kMassBlocks;
  } else if (deg == 1) {
    if (!stencil_pick(a, kMinBlocks<T>, 1,
                      [&](const StencilPlan& c) { return p1_mass_smem<T>(a.d, c, nb); }, s))
      return false;
    *route = kMassStencil;
    *red_off = stencil_table_bytes<T>(a.d) + p1_box_bytes<T>(s, nb);
    *smem = p1_mass_smem<T>(a.d, s, nb);
    *blocks = kMinBlocks<T>;
  } else {
    *route = kMassPoint;
    *red_off = red_offset<T>(a.mat_len, a.nl_in);
    *smem = smem_bytes<T>(a.mat_len, a.nl_in);
    *blocks = kMinBlocks<T>;
  }
  return true;
}

template <typename T>
int cg_mass_launch(const void* C, const void* r0, const void* x0, const void* invd,
                   const void* tol, void* x, void* work, void* red, int max_blocks,
                   void* iters, void* rnorm, int d, int n0, int n1, int n2, int deg,
                   int batch, int maxiter, void* stream) {
  CgMassArgs<T> P;
  P.a = const_args(d, n0, n1, n2, deg, batch);
  const int64_t n = P.a.npad_out;
  P.C = static_cast<const T*>(C);
  P.r0 = static_cast<const T*>(r0);
  P.x0 = static_cast<const T*>(x0);
  P.invd = static_cast<const T*>(invd);
  P.tol = static_cast<const T*>(tol);
  P.x = static_cast<T*>(x);
  P.r = static_cast<T*>(work);
  P.p[0] = P.r + batch * n;
  P.p[1] = P.p[0] + batch * n;
  P.Ap = P.p[1] + batch * n;
  P.red = static_cast<T*>(red);
  P.iters = static_cast<int*>(iters);
  P.rnorm = static_cast<T*>(rnorm);
  P.maxiter = maxiter;
  size_t smem;
  int route, blocks;
  if (!mass_plan<T>(P.a, P.s, deg, &route, &P.red_off, &smem, &blocks))
    return (int)cudaErrorInvalidValue;
  void (*kernel)(CgMassArgs<T>) =
      route == kMassPoint ? cg_mass_point_kernel<T> : mass_kernel<T>(P.a.nl_in, batch);
  const cudaError_t e =
      cudaFuncSetAttribute((const void*)kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e != cudaSuccess) return (int)e;
  // the stencil tile: a block a tile where the card holds them (250 tiles
  // of 4 x 8 x 8 at N=36, where n / 256 gives 198 blocks)
  const int64_t points =
      route == kMassStencil
          ? std::max<int64_t>(n, (int64_t)P.s.ntile[0] * P.s.ntile[1] * P.s.ntile[2] * kThreads)
          : n;
  return coop_launch(kernel, P, points, smem, max_blocks, stream, blocks);
}

template <typename T>
auto bicg_kernel(int nl, int batch) {
  if (nl != 27) return bicgstab_kernel<T, 0, 0>;
  return batch == 3 ? bicgstab_kernel<T, 27, 3> : bicgstab_kernel<T, 27, 0>;
}

template <typename T>
int bicgstab_launch(const void* W, const void* r0, const void* x0, const void* zmask,
                    const void* invd, const void* tol, void* x, void* work, void* stage,
                    long long stage_len, void* red, int max_blocks, void* iters, void* rnorm,
                    int d, int n0, int n1, int n2, int deg, int batch, int maxiter,
                    void* stream) {
  BicgArgs<T> P;
  P.a = win_args(d, n0, n1, n2, deg, batch);
  const int64_t n = P.a.npad_out;
  const int nl = P.a.nl_in;
  P.ncubes = P.a.c[0] * P.a.c[1] * P.a.c[2];
  if (stage == nullptr || stage_len < (long long)batch * nl * P.ncubes)
    return (int)cudaErrorInvalidValue;
  P.div_c1 = fast_div(P.a.c[1]);
  P.div_c2 = fast_div(P.a.c[2]);
  P.W = static_cast<const T*>(W);
  P.r0 = static_cast<const T*>(r0);
  P.x0 = static_cast<const T*>(x0);
  P.zmask = static_cast<const T*>(zmask);
  P.invd = static_cast<const T*>(invd);
  P.tol = static_cast<const T*>(tol);
  P.x = static_cast<T*>(x);
  P.r = static_cast<T*>(work);
  P.p = P.r + batch * n;
  P.v = P.p + batch * n;
  P.t = P.v + batch * n;
  P.y = P.t + batch * n;
  P.stage = static_cast<T*>(stage);
  P.red = static_cast<T*>(red);
  P.iters = static_cast<int*>(iters);
  P.rnorm = static_cast<T*>(rnorm);
  P.maxiter = maxiter;
  // above 48 KB of dynamic shared memory only once the kernel allows it;
  // beyond the card's limit (batch 4 of a 3D float64 system) it refuses
  const size_t smem = bicg_smem<T>(nl, batch);
  auto kernel = bicg_kernel<T>(nl, batch);
  const cudaError_t e =
      cudaFuncSetAttribute((const void*)kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e != cudaSuccess) return (int)e;
  return coop_launch(kernel, P, n, smem, max_blocks, stream, kSolveBlocks);
}

// The levels' grids: cells halved per level; a 2D grid is (1, g0, g1).
inline void mg_levels(int d, int n0, int n1, int n2, int levels, Level* lev) {
  int cells[3] = {n0, n1, d == 3 ? n2 : 0};
  int64_t off = 0;
  for (int l = 0; l < levels; ++l) {
    Level& lv = lev[l];
    lv.g[0] = d == 3 ? cells[0] + 1 : 1;
    lv.g[1] = d == 3 ? cells[1] + 1 : cells[0] + 1;
    lv.g[2] = d == 3 ? cells[2] + 1 : cells[1] + 1;
    lv.div1 = fast_div(lv.g[1]);
    lv.div2 = fast_div(lv.g[2]);
    lv.n = lv.g[0] * lv.g[1] * lv.g[2];
    lv.off = off;
    off += lv.n;
    for (int k = 0; k < d; ++k) cells[k] /= 2;
  }
}

// K1 MG's plan: the route, the fine level's tile, the teams of the levels,
// the shared memory and the barriers of one iteration.  Routes: the
// stencil tile on the levels on the whole grid with the coarsest levels on
// block 0, or with no level on block 0 (none has at most kBlockPoints
// points a thread, or no level's boxes fit beside the smallest tile).
enum MgRoute { kMgStencilBlock = 0, kMgStencil = 1 };

struct MgPlan {
  int route, sub_level, block_level, sub_blocks;
  StencilPlan s;  // the fine level's tiles
  MgSmem sm;
  int grid_bars, sub_bars, block_bars;
};

// Barriers of one iteration: the CG body's kMgBody grid barriers, and one
// after each V-cycle phase (per level above the coarsest: nsmooth down (the
// sweeps after the first, the residual), the restriction into the next
// level, nsmooth + 1 up (the prolongation, the sweeps; on a level of the
// whole grid the prolongation rides on the first sweep); degree - 1
// Chebyshev steps on the coarsest), each its team's: the phases of levels
// from block_level are block 0's but the last, which takes the level
// above's barrier, and the sub-group's last phase takes the grid's barrier
// that closes its part.
inline void mg_barriers(int L, int nsmooth, int degree, MgPlan& m) {
  int phases[kMaxLevels] = {};
  for (int l = 0; l + 1 < L; ++l) {
    phases[l] += 2 * nsmooth + (l < m.sub_level ? 0 : 1);
    phases[l + 1] += 1;
  }
  phases[L - 1] += degree - 1;
  m.grid_bars = kMgBody;
  m.sub_bars = m.block_bars = 0;
  for (int l = 0; l < L; ++l)
    (l < m.sub_level ? m.grid_bars : l < m.block_level ? m.sub_bars : m.block_bars) += phases[l];
  if (m.block_level < L) {  // block 0's last phase ends with the level above's barrier
    --m.block_bars;
    ++(m.block_level - 1 < m.sub_level ? m.grid_bars : m.sub_bars);
  }
  if (m.sub_bars > 0) {
    --m.sub_bars;
    ++m.grid_bars;
  }
}

template <typename T>
bool mg_plan(int d, int n0, int n1, int n2, int L, int nsmooth, int degree, MgPlan& m) {
  Level lev[kMaxLevels];
  mg_levels(d, n0, n1, n2, L, lev);
  m.sub_blocks = kSubBlocks;
  int lsub = L, lblk = L;
  for (int l = L - 1; l >= 1; --l) {
    if (lev[l].n <= kSubPoints * kThreads * kSubBlocks) lsub = l;
    if (lev[l].n <= kBlockPoints * kThreads) lblk = l;
  }
  // block 0's levels from lblk where their boxes fit beside a tile, else
  // from a coarser level, else none
  const CubeArgs a0 = const_args(d, n0, n1, n2, 1, 1);
  for (;; ++lblk) {
    int64_t pts = 0;
    for (int l = lblk; l < L; ++l) pts += mg_box_points(d, lev[l]);
    if (stencil_pick(a0, kSolveBlocks, 1,
                     [&](const StencilPlan& c) { return mg_smem<T>(d, c, pts).bytes; }, m.s)) {
      m.sm = mg_smem<T>(d, m.s, pts);
      break;
    }
    if (lblk == L) return false;
  }
  m.route = lblk < L ? kMgStencilBlock : kMgStencil;
  m.block_level = lblk;
  m.sub_level = std::min(std::min(lsub, lblk), kStencilLevels);
  mg_barriers(L, nsmooth, degree, m);
  return true;
}

template <typename T>
int pressure_mg_launch(const void* Ap, const void* b, const void* x0, const void* invd,
                       void* x, void* work, void* red, int max_blocks, void* iters,
                       void* rnorm, void* conv, int d, int n0, int n1, int n2, int levels,
                       int nsmooth, double omega, double lmin, double lmax, int cheb_degree,
                       double rtol, int maxiter, void* stream) {
  MgArgs<T> P;
  MgPlan m;
  if (!mg_plan<T>(d, n0, n1, n2, levels, nsmooth, cheb_degree, m))
    return (int)cudaErrorInvalidValue;
  P.L = levels;
  P.sub_level = m.sub_level;
  P.block_level = m.block_level;
  P.sub_blocks = m.sub_blocks;
  P.red_off = m.sm.red_off;
  P.box_off = m.sm.box_off;
  P.block_off = m.sm.block_off;
  mg_levels(d, n0, n1, n2, levels, P.lev);
  int cells[3] = {n0, n1, d == 3 ? n2 : 0};
  for (int l = 0; l < levels; ++l) {
    P.scale[l] = (T)(double)(1 << (l * (d - 2)));
    if (l < m.sub_level) {
      P.lv[l] = const_args(d, cells[0], cells[1], cells[2], 1, 1);
      if (!stencil_set(P.lv[l], m.s.t, 1, P.sp[l])) return (int)cudaErrorInvalidValue;
    }
    for (int k = 0; k < d; ++k) cells[k] /= 2;
  }
  P.Ap = static_cast<const T*>(Ap);
  P.b = static_cast<const T*>(b);
  P.x0 = static_cast<const T*>(x0);
  P.invd = static_cast<const T*>(invd);
  P.x = static_cast<T*>(x);
  P.work = static_cast<T*>(work);
  P.red = static_cast<T*>(red);
  P.iters = static_cast<int*>(iters);
  P.rnorm = static_cast<T*>(rnorm);
  P.conv = static_cast<int*>(conv);
  P.nsmooth = nsmooth;
  P.cheb_degree = cheb_degree;
  P.maxiter = maxiter;
  P.omega = omega;
  P.lmin = lmin;
  P.lmax = lmax;
  P.rtol = rtol;
  auto kernel = d == 3 ? pressure_mg_kernel<T, 3> : pressure_mg_kernel<T, 2>;
  const cudaError_t e =
      cudaFuncSetAttribute((const void*)kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)m.sm.bytes);
  if (e != cudaSuccess) return (int)e;
  // a block a tile of the fine level at most: its phases walk the tiles
  const int64_t ntiles = (int64_t)m.s.ntile[0] * m.s.ntile[1] * m.s.ntile[2];
  return coop_launch(kernel, P, ntiles * kThreads, m.sm.bytes, max_blocks, stream, kSolveBlocks);
}

// K1's non-MG plan on a: the tile and the Chebyshev steps a segment (the
// box's halo), the most of the degree's deg - 1 steps (at least 1) for which
// a tile fits kSolveBlocks blocks an SM.  False where none fits.
template <typename T>
bool pcg_plan(const CubeArgs& a, int deg, StencilPlan& s, int* steps) {
  const int nsteps = deg > 1 ? deg - 1 : 0;
  for (int st = nsteps < 1 ? 1 : nsteps < kStencilHalo ? nsteps : kStencilHalo; st >= 1; --st)
    if (stencil_pick(a, kSolveBlocks, st,
                     [&](const StencilPlan& c) { return pcg_smem<T>(a.d, c, deg); }, s)) {
      *steps = st;
      return true;
    }
  return false;
}

template <typename T>
int pressure_cg_launch(const void* Ap, const void* b, const void* x0, const void* invd, void* x,
                       void* work, void* red, int max_blocks, void* iters, void* rnorm,
                       void* conv, int d, int n0, int n1, int n2, int cheb_degree, double lmin,
                       double lmax, double rtol, int maxiter, void* stream) {
  PcgArgs<T> P;
  P.a = const_args(d, n0, n1, n2, 1, 1);
  if (!pcg_plan<T>(P.a, cheb_degree, P.s, &P.steps)) return (int)cudaErrorInvalidValue;
  P.Ap = static_cast<const T*>(Ap);
  P.b = static_cast<const T*>(b);
  P.x0 = static_cast<const T*>(x0);
  P.invd = static_cast<const T*>(invd);
  P.x = static_cast<T*>(x);
  P.work = static_cast<T*>(work);
  P.red = static_cast<T*>(red);
  P.iters = static_cast<int*>(iters);
  P.rnorm = static_cast<T*>(rnorm);
  P.conv = static_cast<int*>(conv);
  P.cheb_degree = cheb_degree;
  P.maxiter = maxiter;
  P.lmin = lmin;
  P.lmax = lmax;
  P.rtol = rtol;
  const size_t smem = pcg_smem<T>(d, P.s, cheb_degree);
  auto kernel = d == 3 ? pressure_cg_kernel<T, 3> : pressure_cg_kernel<T, 2>;
  const cudaError_t e =
      cudaFuncSetAttribute((const void*)kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e != cudaSuccess) return (int)e;
  // a block a tile at most: every phase of an iteration walks the tiles
  const int64_t ntiles = (int64_t)P.s.ntile[0] * P.s.ntile[1] * P.s.ntile[2];
  return coop_launch(kernel, P, ntiles * kThreads, smem, max_blocks, stream, kSolveBlocks);
}

// d, batch and every index in int32 (cube_fits)
bool batch_ok(int d, int n0, int n1, int n2, int deg, int batch) {
  return batch <= kMaxBatch && cube_fits(d, n0, n1, n2, deg, deg, batch);
}

}  // namespace

extern "C" {

// Batched Jacobi-PCG with constant cube matrix C (nl, nl): rows b < batch of
// x (batch, grid) from r0, x0 (batch, grid); invd (grid); tol (batch).  The
// P2 cube runs the tiled product with the tile of tile_choose, the P1 cube
// the stencil tile, any other the point-by-point product (mass_plan).
// work: 4 * batch * grid; red: 2 * 8 * max_blocks.  Writes x, iters (int32,
// batch) and rnorm (batch).
int oasisx_cg_mass(const void* C, const void* r0, const void* x0, const void* invd,
                   const void* tol, void* x, void* work, void* red, int max_blocks,
                   void* iters, void* rnorm, int is_f64, int d, int n0, int n1, int n2,
                   int deg, int batch, int maxiter, void* stream) {
  if (!batch_ok(d, n0, n1, n2, deg, batch)) return (int)cudaErrorInvalidValue;
  return is_f64 ? cg_mass_launch<double>(C, r0, x0, invd, tol, x, work, red, max_blocks, iters,
                                         rnorm, d, n0, n1, n2, deg, batch, maxiter, stream)
                : cg_mass_launch<float>(C, r0, x0, invd, tol, x, work, red, max_blocks, iters,
                                        rnorm, d, n0, n1, n2, deg, batch, maxiter, stream);
}

// K4's grid barriers an iteration on a cube of degree deg (chip_smoke
// prints it): two on the tiled routes (P1, P2), three point by point.
int oasisx_cg_mass_barriers(int deg) { return deg == 1 || deg == 2 ? kMassBarriers : 3; }

// K4's route at batch rows of a d-dimensional grid of degree deg on the
// current device: out = (route: 0 point by point, 1 block-tiled (P2), 2
// stencil tile (P1); the tile t0, t1, t2 (3D form; 0 point by point); bytes
// of shared memory a block; grid barriers an iteration).  0 or a CUDA
// error.
int oasisx_cg_mass_route(int is_f64, int d, int deg, int batch, int* out) {
  if (!batch_ok(d, 8, 8, 8, deg, batch)) return (int)cudaErrorInvalidValue;
  CubeArgs a = const_args(d, 8, 8, 8, deg, batch);
  StencilPlan s = {};
  int route = 0, blocks = 0;
  size_t red_off = 0, smem = 0;
  if (!(is_f64 ? mass_plan<double>(a, s, deg, &route, &red_off, &smem, &blocks)
               : mass_plan<float>(a, s, deg, &route, &red_off, &smem, &blocks)))
    return (int)cudaErrorInvalidValue;
  out[0] = route;
  for (int k = 0; k < 3; ++k)
    out[1 + k] = route == kMassTiled ? a.tile[k] : route == kMassStencil ? s.t[k] : 0;
  out[4] = (int)smem;
  out[5] = oasisx_cg_mass_barriers(deg);
  return 0;
}

// Batched BiCGStab on A_W (W (nl*nl, ncubes)) with zero-masked rows, from
// r0 = zmask (b - A_W x0) and x0; invd (grid); zmask, r0, x0 (batch, grid);
// tol (batch).  work: 5 * batch * grid; stage: batch * nl * ncubes values
// (stage_len, checked); red: 2 * 8 * max_blocks.
int oasisx_bicgstab(const void* W, const void* r0, const void* x0, const void* zmask,
                    const void* invd, const void* tol, void* x, void* work, void* stage,
                    long long stage_len, void* red, int max_blocks, void* iters, void* rnorm,
                    int is_f64, int d, int n0, int n1, int n2, int deg, int batch, int maxiter,
                    void* stream) {
  if (!batch_ok(d, n0, n1, n2, deg, batch)) return (int)cudaErrorInvalidValue;
  return is_f64 ? bicgstab_launch<double>(W, r0, x0, zmask, invd, tol, x, work, stage,
                                          stage_len, red, max_blocks, iters, rnorm, d, n0, n1,
                                          n2, deg, batch, maxiter, stream)
                : bicgstab_launch<float>(W, r0, x0, zmask, invd, tol, x, work, stage, stage_len,
                                         red, max_blocks, iters, rnorm, d, n0, n1, n2, deg,
                                         batch, maxiter, stream);
}

// MG-PCG on the P1 grid of (n0, n1[, n2]) cells with cube matrix Ap (2^d, 2^d)
// and `levels` levels of halved cells, the levels' teams of mg_plan: b, x0,
// x (grid); invd (every level's points, concatenated); work: 4 * (points of
// all levels) + 4 * grid points + 2 (the sub-group barrier's words); red: 2
// * 8 * max_blocks.  Writes x, iters, rnorm and conv (int32, 1 each).
int oasisx_pressure_mg(const void* Ap, const void* b, const void* x0, const void* invd,
                       void* x, void* work, void* red, int max_blocks, void* iters,
                       void* rnorm, void* conv, int is_f64, int d, int n0, int n1, int n2,
                       int levels, int nsmooth, double omega, double lmin, double lmax,
                       int cheb_degree, double rtol, int maxiter, void* stream) {
  if (!cube_fits(d, n0, n1, n2, 1, 1, 1) || levels < 2 || levels > kMaxLevels || nsmooth < 1 ||
      cheb_degree < 1)
    return (int)cudaErrorInvalidValue;
  return is_f64 ? pressure_mg_launch<double>(Ap, b, x0, invd, x, work, red, max_blocks, iters,
                                             rnorm, conv, d, n0, n1, n2, levels, nsmooth, omega,
                                             lmin, lmax, cheb_degree, rtol, maxiter, stream)
                : pressure_mg_launch<float>(Ap, b, x0, invd, x, work, red, max_blocks, iters,
                                            rnorm, conv, d, n0, n1, n2, levels, nsmooth, omega,
                                            lmin, lmax, cheb_degree, rtol, maxiter, stream);
}

// K1 MG's plan on the current device for `levels` levels of the P1 grid of
// (n0, n1[, n2]) cells, nsmooth sweeps and coarse Chebyshev degree
// cheb_degree: out = (route: 0 the stencil tile with the coarsest levels on
// block 0, 1 the stencil tile with no level on block 0; the fine level's
// tile t0, t1, t2 (3D form); bytes of shared memory a block; sub_level,
// block_level, sub_blocks (the teams); grid, sub-group and block barriers
// an iteration).  0 or a CUDA error.
int oasisx_pressure_mg_plan(int is_f64, int d, int n0, int n1, int n2, int levels, int nsmooth,
                            int cheb_degree, int* out) {
  if (!cube_fits(d, n0, n1, n2, 1, 1, 1) || levels < 2 || levels > kMaxLevels || nsmooth < 1 ||
      cheb_degree < 1)
    return (int)cudaErrorInvalidValue;
  MgPlan m;
  if (!(is_f64 ? mg_plan<double>(d, n0, n1, n2, levels, nsmooth, cheb_degree, m)
               : mg_plan<float>(d, n0, n1, n2, levels, nsmooth, cheb_degree, m)))
    return (int)cudaErrorInvalidValue;
  const int v[11] = {m.route,        m.s.t[0],        m.s.t[1],     m.s.t[2],
                     (int)m.sm.bytes, m.sub_level,     m.block_level, m.sub_blocks,
                     m.grid_bars,     m.sub_bars,      m.block_bars};
  for (int k = 0; k < 11; ++k) out[k] = v[k];
  return 0;
}

// Jacobi (cheb_degree 0) or degree-cheb_degree Chebyshev-Jacobi PCG on the P1
// grid of (n0, n1[, n2]) cells with cube matrix Ap (2^d, 2^d), bounds
// lmin < lmax of D^-1 A: b, x0, x, invd (grid); work: 9 * grid points; red:
// 2 * 8 * max_blocks.  Writes x, iters, rnorm and conv (int32, 1 each).
int oasisx_pressure_cg(const void* Ap, const void* b, const void* x0, const void* invd,
                       void* x, void* work, void* red, int max_blocks, void* iters,
                       void* rnorm, void* conv, int is_f64, int d, int n0, int n1, int n2,
                       int cheb_degree, double lmin, double lmax, double rtol, int maxiter,
                       void* stream) {
  if (!cube_fits(d, n0, n1, n2, 1, 1, 1) || cheb_degree < 0 ||
      (cheb_degree > 0 && !(lmin < lmax)))
    return (int)cudaErrorInvalidValue;
  return is_f64 ? pressure_cg_launch<double>(Ap, b, x0, invd, x, work, red, max_blocks, iters,
                                             rnorm, conv, d, n0, n1, n2, cheb_degree, lmin, lmax,
                                             rtol, maxiter, stream)
                : pressure_cg_launch<float>(Ap, b, x0, invd, x, work, red, max_blocks, iters,
                                            rnorm, conv, d, n0, n1, n2, cheb_degree, lmin, lmax,
                                            rtol, maxiter, stream);
}

// K1's non-MG plan for a d-dimensional grid at Chebyshev degree cheb_degree
// (0: Jacobi) on the current device: out = (t0, t1, t2 (3D form), bytes of
// shared memory a block, Chebyshev steps a segment of phase B, grid
// barriers an iteration).  0 or a CUDA error.
int oasisx_pressure_cg_plan(int is_f64, int d, int cheb_degree, int* out) {
  if ((d != 2 && d != 3) || cheb_degree < 0) return (int)cudaErrorInvalidValue;
  const CubeArgs a = const_args(d, 8, 8, 8, 1, 1);
  StencilPlan s = {};
  int steps = 0;
  if (!(is_f64 ? pcg_plan<double>(a, cheb_degree, s, &steps)
               : pcg_plan<float>(a, cheb_degree, s, &steps)))
    return (int)cudaErrorInvalidValue;
  for (int k = 0; k < 3; ++k) out[k] = s.t[k];
  out[3] = (int)(is_f64 ? pcg_smem<double>(d, s, cheb_degree) : pcg_smem<float>(d, s, cheb_degree));
  out[4] = steps;
  out[5] = pcg_barriers(cheb_degree, steps);
  return 0;
}

// K1's non-MG grid barriers an iteration (oasisx_pressure_cg_plan's last
// value), or 0 where no plan fits.
int oasisx_pressure_cg_barriers(int is_f64, int d, int cheb_degree) {
  int out[6];
  return oasisx_pressure_cg_plan(is_f64, d, cheb_degree, out) == 0 ? out[5] : 0;
}

}  // extern "C"
