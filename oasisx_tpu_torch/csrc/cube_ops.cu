// Cube operators on the parity-split grid layout, for sm_90a.
//
// Every entry point but the gather and the scatter applies a cube device
// function of cube_device.cuh (y = sum_cubes P_c^T C P_c x, no atomics):
// point by point (cube_point), a block-tiled product (tile_product for K5,
// tile_mixed for K6 and K7), or K3's cube-owned product in two launches
// (win_cube, then the scatter).
// They replace these TPU kernels (oasisx_tpu/assembly/pallas_ops.py):
//   oasisx_matvec_const  <- make_matvec_pf (K5) and make_matvec (K12):
//                           constant cube matrix C (nl, nl), batch B; the P2
//                           cube (K5) by the block-tiled product of
//                           cube_device.cuh, the P1 cube (K12) point by point
//   oasisx_matvec_win    <- make_matvec_win (K3): per-cube weights
//                           W[to*nl + ti, cube], shared by the B components;
//                           with the optional multipliers y = zmask A_W (premul x)
//                           it is also make_matvec_hbm_chan (K10), and at batch 1
//                           make_tent_matvec_hbm (W streamed per slot row).
//                           Cube-owned: phase A (win_cube_kernel, a thread a
//                           cube) reads the cube's inputs once, premul multiplied
//                           in, and streams its weights into a stage (B, nl,
//                           ncubes); phase B is K13's scatter of the stage, the
//                           zmask multiplied in at its store.  A null multiplier
//                           means 1.
//   oasisx_mixed         <- make_mixed_pf (K6): r_g = C_g p, C_all (d, nl_v, nl_q)
//   oasisx_divergence    <- make_divergence_pf (K7): b2 = sum_g B_g^T u_g,
//                           B_all (d, nl_v, nl_q) read transposed [g, ti, to].
//                           Both block-tiled on the P2/P1 pair with d
//                           components (tile_mixed, on K5's tiles), any other
//                           pair point by point; oasisx_mixed_route names the
//                           route.
//   oasisx_cube_gather   <- make_gather / make_gather_chunked (K8): the cube-local
//                           values U (B, nl, ncubes) of a grid vector (B, npad);
//                           one launch for all B components, a block per
//                           (component, outer cube row), a thread per cube
//                           of that row's plane and all its slots, 32-bit
//                           indices.  The
//                           TPU's slot chunking existed only to fit VMEM and
//                           is dropped.
//   oasisx_cube_scatter  <- make_scatter / make_scatter_chunked (K13): the
//                           assembled grid vectors (B, npad) of cube-local values
//                           U (B, nl, ncubes).  Output owner: each grid point sums
//                           its <= 2^d cube slots in cube_visit's fixed order, no
//                           atomics, so repeat calls are bit-identical; no slot
//                           chunking.  Its kernel is K3's phase B; the entry
//                           point is on no solver path (the JAX package used it
//                           for the staged gather -> einsum -> scatter products
//                           of its N=64 tier).
//
// Bound on the H100.  K3 at N=36 (3D P2) must stream the 136 MB W
// (729 x 46656 f32) once per call, 764 MB at N=64: memory.  Point by point
// (cube_point, the form before) it read W once, each (output slot, cube)
// pair belonging to one point, but each thread read its cubes' 27 nb inputs
// once for every output slot it owned (with premul, 27 nb premul values
// too): at N=64 batch 3 ~2.2 GB of input requests through L1/L2 a product
// against W's 0.76 GB, 0.63 ms (0.95 with premul and zmask) on an NVIDIA
// H100 80GB HBM3 at 700 W.  Cube-owned, a thread reads its cube's inputs
// once, into registers (3D P2, at most 108 values: batch 1-4 in float32,
// 1-2 in float64) or into its own shared-memory column (any other cube or
// batch, as K2's phase A), and a product moves W once, the stage written
// and read once (2 x 84.9 MB at N=64; N=36's 15.1 MB stays in L2) and x and
// y once: 987 MB at N=64, 0.295 ms at 3.35 TB/s.  Measured there: 0.339 ms
// at batch 3, 0.355 with premul and zmask (0.061 and 0.065 at N=36).  A
// launch whose columns do not fit in a block's shared memory (64-slot cubes
// at batch 4 in float64), or whose grid has fewer cubes than one block of
// phase A an SM, keeps the point-by-point kernel; oasisx_win_route names
// each launch's route.  K13 reads U once (15 MB at N=36) and writes the
// grid once: memory-bound too.  What bounded the point-by-point kernels on
// this card was integer work at first: an output side that split each grid
// index with 64-bit divisions and remainders (a software sequence of
// dozens of instructions each) ran at 12-88x their bounds, as K8 did at
// 18x its present time before it took the shape below.  K5 (3D P2, batch
// 3) moves 2 x 3 x 4.9 MB at N=36 and 2 x 26.4 MB at N=64, and its 27 x 27
// products a cube are 1.15 GFLOP at N=64 (0.017 ms at the float32 rate): by
// the bound both sides are close.  Point by point (cube_point, the form
// before) it loaded each input once for each output slot of each cube that
// holds it, 27 loads a value, and ran at 23x its bound; so it is
// block-tiled (cube_device.cuh tile_product): a block reads a tile's
// inputs once into shared memory, a thread a cube sums them against the
// staged matrix (halo cubes recomputed, ~1.8x the operations at a 3 x 7 x 7
// tile), and each owned point sums its cubes' staged values.  K6 and K7
// move the P1 vector and the d P2 components once, 27.5 MB at N=64 (0.0082
// ms at 3.35 TB/s).  Point by point K7 loaded up to 8 cubes x 27 slots x 3
// components of u a P1 point, and K6 a cube's 8 P1 values for each of its
// 27 x 3 outputs: 0.0323 / 0.1564 ms (K6) and 0.0658 / 0.1695 (K7) at N=36
// / N=64.  Block-tiled on K5's tiles (tile_mixed) they take 0.0167 / 0.0634
// and 0.0175 / 0.0577 ms (float32, on an NVIDIA H100 80GB HBM3 at 700 W):
// K6 writes a cube's 81 staged values at 2 blocks an SM (its stage is 83
// KB at 3 x 7 x 7), K7 keeps a cube's 8 outputs in registers and streams
// its 81 inputs from the box at 4.  No tensor cores: the standing rule
// keeps TF32 off, and in float32 the products are a few hundredths of a
// millisecond of FFMA.
//
// Launch shape of the standalone cube kernels (every one but K8), K8's
// shape on the output grid: a block per (stretch of the plane of inner base
// coordinates, outer base row, parity channel) on blockIdx.x/y/z, a thread
// per output point for every output component.  In 3D the plane is (b1, b2)
// and the row b0; a 2D grid is one row and the plane (b0, b1).  So a
// thread's one division is t / g2 (32-bit), the channel's parities are
// block-uniform (by subtraction, no division), the cubes that can hold the
// point are the same across the block, and the padding test is a
// comparison.  Neighbouring threads own neighbouring base points, so for
// each cube slot they read neighbouring x, W and U (K13: U[b, to, :] for
// each to) and write neighbouring y.  The plane is flat, so a block of 128
// threads packs several of the short rows (36 base points a row at N=35, 37
// at N=36, 65 at N=64): a plane of 37 x 37 points fills 11 blocks with 97%
// of their threads useful (6 blocks of 256: 89%).  K13 keeps a thread's
// <= 4 components in the thread (the point split once for all), where a
// block per component would split it once each.
//
// Registers against latency.  A thread's loads are latency-bound: K12's 8
// slots a cube with one coefficient each are unrolled (8 loads in flight);
// the 27-slot loops of point-by-point K3, K6 and K7 (off the P2/P1 pair)
// stay rolled, since unrolled they take about twice the registers and the
// occupancy they lose costs more than the latency they hide.  Point-by-
// point K7 (several input components a slot) and K3 without premul (a W
// load a slot) are held to 32 registers (kFill: 16 blocks, every thread
// slot of an SM) when their grid has that many blocks; point-by-point K6
// keeps the registers the compiler gives it.  The tiled kernels: K5 keeps a
// cube's 27 nb inputs in registers, its batch a template parameter in 3D,
// at most 128 registers (2 blocks an SM, as its shared memory allows at
// batch 3 in float32); K6 (51 registers in 3D float32) runs 2 blocks an SM
// as its stage allows; K7 at most 64 registers (64 in 3D, no spills), 4
// blocks an SM.  K3's phase A unrolls a row's 27 weight loads
// (all in flight) beside a cube's NB x 27 inputs in registers (NB a
// template parameter): at most 128 registers, 4 blocks of 128 threads an
// SM, where the inputs take up to 81 of them (float32 batch 1-3, float64
// batch 1), else 255; no spills (ptxas).  128 threads a block and 256
// measured level (within 1.5%) at N=36, whose 46,656 cubes fill 365 blocks
// of 128 or 182 of 256, and at N=64.
//
// Each entry point launches on the stream it is given, allocates nothing,
// and returns cudaGetLastError() after the launch, or cudaErrorInvalidValue
// where an index would not fit in int32 (cube_fits) or a tiled route finds
// no tile that fits the device.

#include "cube_device.cuh"

namespace {

using namespace oasisx;

constexpr int kCubeThreads = 128;  // threads per block of the standalone cube kernels
constexpr int kFillBlocks = 16;    // blocks an SM when every thread slot is filled (2048 threads)

// The output point a thread of a standalone launch owns, and its flat index
// in one component: block (x: a stretch of the plane of base points, y: the
// base row b0, z: the parity channel); false past the plane's end.
__device__ __forceinline__ bool block_point(const CubeArgs& a, CubePoint& q, int& idx) {
  const int plane12 = a.g[1] * a.g[2];
  const int t = blockIdx.x * kCubeThreads + threadIdx.x;
  if (t >= plane12) return false;
  // the channel's parities (block-uniform), by subtraction: < deg steps an axis
  int r = blockIdx.z;
  const int s0 = a.par[1] * a.par[2];
  q.p[0] = 0;
  while (r >= s0) {
    r -= s0;
    ++q.p[0];
  }
  q.p[1] = 0;
  while (r >= a.par[2]) {
    r -= a.par[2];
    ++q.p[1];
  }
  q.p[2] = r;
  q.b[0] = blockIdx.y;
  q.b[1] = (int)((unsigned)t / (unsigned)a.g[2]);  // the thread's one division
  q.b[2] = t - q.b[1] * a.g[2];
  idx = blockIdx.z * a.plane + blockIdx.y * plane12 + t;
  return true;
}

dim3 block_grid(const CubeArgs& a) {
  return dim3((a.g[1] * a.g[2] + kCubeThreads - 1) / kCubeThreads, a.g[0],
              a.par[0] * a.par[1] * a.par[2]);
}

// kPm, kZm: y = zm * A (pm * x), pm and zm (batch, grid); NL as cube_point's.
// kFill: at most 32 registers a thread, so that kFillBlocks blocks fit on an SM.
template <typename T, bool kPm, bool kZm, int NL, bool kFill>
__global__ void __launch_bounds__(kCubeThreads, kFill ? kFillBlocks : 1)
cube_apply_kernel(const T* __restrict__ x, const T* __restrict__ mat,
                  T* __restrict__ y, CubeArgs a, const T* __restrict__ pm,
                  const T* __restrict__ zm) {
  unsigned char* smem = dynamic_smem();
  T* smat = reinterpret_cast<T*>(smem);
  int* soff = reinterpret_cast<int*>(smem + sizeof(T) * a.mat_len);
  cube_stage(mat, a, smat, soff);
  __syncthreads();
  CubePoint q;
  int idx;
  if (!block_point(a, q, idx)) return;
  T acc[kMaxBatch];
  cube_point<T, kPm, NL>(x, a.mat_len > 0 ? smat : mat, soff, a, q, acc, pm);
#pragma unroll
  for (int bo = 0; bo < kMaxBatch; ++bo)
    if (bo < a.nbo) {
      const int i = bo * a.npad_out + idx;
      y[i] = kZm ? zm[i] * acc[bo] : acc[bo];
    }
}

// K8's launch: the grid offset of every input slot relative to its cube's
// base (slot_offset, computed on the host), and the cube grid cut as
// (outer rows) x (a plane of A x B cubes): in 3D the rows are c0 and the
// plane (c1, c2), in 2D one row and the plane (c0, c1).
constexpr int kGatherThreads = 128;
constexpr int kGatherMaxSlots = 64;  // (deg + 1)^d: deg <= 3 in 3D, <= 7 in 2D

struct GatherArgs {
  int soff[kGatherMaxSlots];
  int nl, A, B, plane, ncube, npad;
};

// U[b, t, cube] = x[b, slot t of cube]: (batch, npad) -> (batch, nl, ncubes).
// A block owns (component b = blockIdx.z, outer row o = blockIdx.y) and a
// thread one cube q = ci * B + cj of the row's plane, for all nl slots: for
// each slot, neighbouring threads write neighbouring U and read neighbouring
// x, and a thread's nl loads are independent.  One 32-bit division a thread
// (q / B) and none a block; every index fits in int32 (the entry point checks
// it).  NL > 0 fixes nl at compile time (the slot loop unrolled, soff read at
// constant offsets); NL == 0 takes g.nl.
template <typename T, int NL>
__global__ void __launch_bounds__(kGatherThreads)
cube_gather_kernel(const T* __restrict__ x, T* __restrict__ u, GatherArgs g) {
  const int q = blockIdx.x * kGatherThreads + threadIdx.x;
  if (q >= g.plane) return;
  const int o = blockIdx.y, b = blockIdx.z;
  const int ci = q / g.B;
  const int cj = q - ci * g.B;
  const T* xc = x + b * g.npad + (o * (g.A + 1) + ci) * (g.B + 1) + cj;
  T* uc = u + b * g.nl * g.ncube + o * g.plane + q;
#pragma unroll
  for (int t = 0; t < (NL > 0 ? NL : kGatherMaxSlots); ++t) {
    if (NL == 0 && t >= g.nl) break;
    uc[t * g.ncube] = __ldg(xc + g.soff[t]);
  }
}

template <typename T, int NL>
void launch_gather(const void* x, void* u, const GatherArgs& g, dim3 grid, void* stream) {
  cube_gather_kernel<T, NL><<<grid, kGatherThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const T*>(x), static_cast<T*>(u), g);
}

// the main path's 3D P2 cubes (27 slots) unrolled, any other count at run
// time; `loop` takes the run-time loop for any count
template <typename T>
void gather_dispatch(const void* x, void* u, const GatherArgs& g, dim3 grid, void* stream,
                     bool loop) {
  if (g.nl == 27 && !loop)
    launch_gather<T, 27>(x, u, g, grid, stream);
  else
    launch_gather<T, 0>(x, u, g, grid, stream);
}

// K8 on any slot count: cudaErrorInvalidValue where x or U has 2^31
// entries or more, or a cube has more than kGatherMaxSlots slots.
int gather(const void* x, void* u, int is_f64, int d, int n0, int n1, int n2, int deg,
           int batch, void* stream, bool loop) {
  const int n[3] = {n0, n1, d == 3 ? n2 : 0};
  if ((d != 2 && d != 3) || deg < 1 || batch < 1 || batch > 65535)
    return (int)cudaErrorInvalidValue;
  const int nl = ipow(deg + 1, d);
  int64_t ncube = 1;
  for (int k = 0; k < d; ++k) ncube *= n[k];
  if (nl > kGatherMaxSlots || ncube < 1 || (int64_t)batch * nl * ncube >= ((int64_t)1 << 31) ||
      batch * grid_points(d, n, deg) >= ((int64_t)1 << 31))
    return (int)cudaErrorInvalidValue;
  const CubeArgs a = base_args(d, n0, n1, n2, deg, deg);
  GatherArgs g = {};
  for (int ti = 0; ti < nl; ++ti) g.soff[ti] = slot_offset(d, n, deg, a.plane, ti);
  g.nl = nl;
  g.A = d == 3 ? n[1] : n[0];
  g.B = n[d - 1];
  g.plane = g.A * g.B;
  g.ncube = (int)ncube;
  g.npad = a.npad_out;
  const int rows = d == 3 ? n[0] : 1;
  const dim3 grid((g.plane + kGatherThreads - 1) / kGatherThreads, rows, batch);
  if (is_f64)
    gather_dispatch<double>(x, u, g, grid, stream, loop);
  else
    gather_dispatch<float>(x, u, g, grid, stream, loop);
  return (int)cudaGetLastError();
}

// y[b, idx] = sum over the cubes c containing idx of U[b, slot of idx in c, c]:
// (nbo, nl, ncubes) -> (nbo, npad), 0 at padding, the components in the thread.
// kZm: y = zm * that sum, zm (nbo, npad) (K3's phase B with a zmask).
template <typename T, bool kZm>
__global__ void __launch_bounds__(kCubeThreads)
cube_scatter_kernel(const T* __restrict__ u, T* __restrict__ y, CubeArgs a, int ncube,
                    const T* __restrict__ zm) {
  CubePoint q;
  int idx;
  if (!block_point(a, q, idx)) return;
  const int comp = a.nl_out * ncube;  // one component of U
  T acc[kMaxBatch];
#pragma unroll
  for (int bo = 0; bo < kMaxBatch; ++bo) acc[bo] = T(0);
  cube_visit(a, q, [&](int to, int cube, int) {
    const T* ut = u + to * ncube + cube;
#pragma unroll
    for (int bo = 0; bo < kMaxBatch; ++bo)
      if (bo < a.nbo) acc[bo] += __ldg(ut + bo * comp);
  });
#pragma unroll
  for (int bo = 0; bo < kMaxBatch; ++bo)
    if (bo < a.nbo) {
      const int i = bo * a.npad_out + idx;
      y[i] = kZm ? zm[i] * acc[bo] : acc[bo];
    }
}

template <typename T, bool kZm>
void launch_scatter(const void* u, void* y, const CubeArgs& a, int ncube, const void* zm,
                    void* stream) {
  cube_scatter_kernel<T, kZm><<<block_grid(a), kCubeThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const T*>(u), static_cast<T*>(y), a, ncube, static_cast<const T*>(zm));
}

// SMs of the current device (asked once)
int sm_count() {
  static const int sms = [] {
    int dev = 0, n = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    return n;
  }();
  return sms;
}

// ---------------------------------------------------------------------------
// K3's cube-owned product: phase A (a thread a cube) into a stage, phase B
// K13's scatter of the stage, with the zmask at its store
// ---------------------------------------------------------------------------

template <typename T>
struct WinArgs {
  const T* x;   // (nb, grid) input components of this launch
  const T* pm;  // (nb, grid) premul, or null (1)
  const T* W;   // (nl*nl, ncubes)
  T* stage;     // (nb, nl, ncubes) out
  CubeArgs a;   // win_args, nbo = nb
  FastDiv div_c1, div_c2;  // divisions by a.c[1] and a.c[2] (cube_base)
  int nc;       // cubes
};

// Phase A's routes, chosen in C by shape (win_plan); oasisx_win_route
// reports them.
enum WinRoute { kWinPoint = 0, kWinRegisters = 1, kWinShared = 2 };
constexpr int kWinMaxThreads = 256;  // phase A's largest block (its launch bound)

// Blocks an SM that phase A's launch bound asks for: at most 128 registers
// a thread (2 blocks of kWinMaxThreads), or 255 where a thread's inputs in
// registers take more than 81 of them (float32 batch 4, float64 batch 2).
__host__ __device__ constexpr int win_min_blocks(int tsize, int nb, bool reg) {
  return reg && nb * tsize > 12 ? 1 : 2;
}

// Phase A: stage[b, to, c] = sum_ti W[to nl + ti, c] (pm x)_b[slot ti of
// cube c] for each cube c, a thread a cube.  kReg: the 3D P2 cube (NL 27) at
// a compile-time batch NB, the cube's NB * 27 inputs in registers; else each
// thread's own column of dynamic shared memory (as K2's phase A), NL 27 or
// 0 (run time), NB 0.  Dynamic shared memory: the slot offsets (nl ints,
// 16-byte aligned), then the columns (nb * nl values a thread).
template <typename T, int NL, int NB, bool kPm, bool kReg>
__global__ void __launch_bounds__(kWinMaxThreads, win_min_blocks(sizeof(T), NB, kReg))
win_cube_kernel(WinArgs<T> P) {
  const CubeArgs& a = P.a;
  unsigned char* smem = dynamic_smem();
  int* soff = reinterpret_cast<int*>(smem);
  cube_stage<T>(nullptr, a, nullptr, soff);
  __syncthreads();
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= P.nc) return;
  const int nl = NL > 0 ? NL : a.nl_in;
  const int nb = NB > 0 ? NB : a.nbo;
  const int cbase = cube_base(a, c, P.div_c1, P.div_c2);
  auto input = [&](int b, int ti) {
    const int i = b * a.npad_out + soff[ti] + cbase;
    return kPm ? __ldg(P.x + i) * __ldg(P.pm + i) : __ldg(P.x + i);
  };
  if constexpr (kReg) {
    T xin[NB][NL];
#pragma unroll
    for (int b = 0; b < NB; ++b)
#pragma unroll
      for (int ti = 0; ti < NL; ++ti) xin[b][ti] = input(b, ti);
    win_cube<T, NL, NB>(P.W + c, P.stage + c, nl, nb, P.nc,
                        [&](int b, int ti) { return xin[b][ti]; });
  } else {
    const int ld = blockDim.x;
    T* xs = reinterpret_cast<T*>(smem + ((sizeof(int) * nl + 15) & ~size_t(15))) + threadIdx.x;
#pragma unroll
    for (int b = 0; b < kMaxBatch; ++b) {
      if (b >= nb) break;
      for (int ti = 0; ti < nl; ++ti) xs[(b * nl + ti) * ld] = input(b, ti);
    }
    win_cube<T, NL, 0>(P.W + c, P.stage + c, nl, nb, P.nc,
                       [&](int b, int ti) { return xs[(b * nl + ti) * ld]; });
  }
}

constexpr int kWinThreads = 128;  // threads a block of phase A

template <typename T>
using WinKernel = void (*)(WinArgs<T>);

template <typename T>
struct WinPlan {
  int route;
  WinKernel<T> kernel;
  int threads;
  size_t smem;
};

template <typename T, bool kPm>
WinKernel<T> win_kernel(int nl, int nb, bool reg) {
  if (reg) {
    if (nb == 1) return win_cube_kernel<T, 27, 1, kPm, true>;
    if (nb == 2) return win_cube_kernel<T, 27, 2, kPm, true>;
    if constexpr (sizeof(T) == 4)
      return nb == 3 ? win_cube_kernel<T, 27, 3, kPm, true> : win_cube_kernel<T, 27, 4, kPm, true>;
  }
  return nl == 27 ? win_cube_kernel<T, 27, 0, kPm, false> : win_cube_kernel<T, 0, 0, kPm, false>;
}

// Phase A of one launch of nb components: its route, kernel, block and
// dynamic shared memory (its limit set on the kernel).  The 3D P2 cube keeps
// a cube's inputs in registers, up to 108 of them (float32 batch 1-4,
// float64 batch 1-2); any other cube and batch takes the shared-memory
// columns where a block's fit on the device; what fits neither stays point
// by point (the form before, cube_apply_kernel), as does a grid with fewer
// cubes than one block of phase A an SM: there a thread's rows of W run one
// after another on a few SMs (the 41 x 57 rectangle's 2,337 cubes, 19
// blocks: 0.0152 ms at batch 3, point by point 0.0102, on an NVIDIA H100
// 80GB HBM3 at 700 W).
template <typename T>
int win_plan(const CubeArgs& a, int nb, bool pm, WinPlan<T>* p) {
  const int nl = a.nl_in;
  const bool reg = nl == 27 && a.d == 3 && nb * (int)sizeof(T) * nl <= 108 * 4;
  p->threads = kWinThreads;
  const size_t soff = (sizeof(int) * nl + 15) & ~size_t(15);
  p->smem = reg ? soff : soff + sizeof(T) * nb * nl * p->threads;
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return (int)e;
  if (p->smem > (size_t)optin || a.c[0] * a.c[1] * a.c[2] < sm_count() * p->threads) {
    p->route = kWinPoint;
    p->kernel = nullptr;
    return 0;
  }
  p->route = reg ? kWinRegisters : kWinShared;
  p->kernel = pm ? win_kernel<T, true>(nl, nb, reg) : win_kernel<T, false>(nl, nb, reg);
  return (int)cudaFuncSetAttribute((const void*)p->kernel,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p->smem);
}

template <typename T, bool kPm, bool kZm, int NL, bool kFill>
void launch_nl(const void* x, const void* mat, void* y, const CubeArgs& a, void* stream,
               const void* pm, const void* zm) {
  const size_t smem = sizeof(T) * a.mat_len + sizeof(int) * a.nl_in;
  cube_apply_kernel<T, kPm, kZm, NL, kFill>
      <<<block_grid(a), kCubeThreads, smem, (cudaStream_t)stream>>>(
          static_cast<const T*>(x), static_cast<const T*>(mat), static_cast<T*>(y), a,
          static_cast<const T*>(pm), static_cast<const T*>(zm));
}

// blocks that fill every SM's thread slots at kFillBlocks blocks an SM
int fill_blocks() { return sm_count() * kFillBlocks; }

// K12's 8 slots a cube with one coefficient a slot: the slot loop unrolled.
// K3 without premul and K7, which load per slot from global memory (W) or
// three input components: kFill when the grid fills the card at kFillBlocks
// blocks an SM.  Every other case as it is.
template <typename T, bool kPm, bool kZm>
void launch_apply(const void* x, const void* mat, void* y, const CubeArgs& a, void* stream,
                  const void* pm, const void* zm) {
  const dim3 grid = block_grid(a);
  const bool coef = a.m_bo == 0 && a.m_bi == 0;
  if (coef && a.nl_in == 8 && a.mat_len > 0) {
    launch_nl<T, kPm, kZm, 8, false>(x, mat, y, a, stream, pm, zm);
    return;
  }
  if constexpr (!kPm) {
    if ((a.mat_len == 0 || a.nbi > 1) &&
        (int64_t)grid.x * grid.y * grid.z >= fill_blocks()) {
      launch_nl<T, kPm, kZm, 0, true>(x, mat, y, a, stream, pm, zm);
      return;
    }
  }
  launch_nl<T, kPm, kZm, 0, false>(x, mat, y, a, stream, pm, zm);
}

// One launch of the cube operator; a null pm or zm means 1 and picks the
// variant without that multiplier.
template <typename T>
int launch(const void* x, const void* mat, void* y, const CubeArgs& a, void* stream,
           const void* pm = nullptr, const void* zm = nullptr) {
  if (pm == nullptr && zm == nullptr)
    launch_apply<T, false, false>(x, mat, y, a, stream, pm, zm);
  else if (zm == nullptr)
    launch_apply<T, true, false>(x, mat, y, a, stream, pm, zm);
  else if (pm == nullptr)
    launch_apply<T, false, true>(x, mat, y, a, stream, pm, zm);
  else
    launch_apply<T, true, true>(x, mat, y, a, stream, pm, zm);
  return (int)cudaGetLastError();
}

int dispatch(int is_f64, const void* x, const void* mat, void* y, const CubeArgs& a,
             void* stream) {
  return is_f64 ? launch<double>(x, mat, y, a, stream) : launch<float>(x, mat, y, a, stream);
}

// K12 (K5's entry point off the P2 cube), one input per output component:
// launches of kMaxBatch components.
int batched(int is_f64, const void* x, const void* mat, void* y, CubeArgs a, int batch,
            void* stream) {
  const size_t esz = is_f64 ? sizeof(double) : sizeof(float);
  for (int b0 = 0; b0 < batch; b0 += kMaxBatch) {
    a.nbo = batch - b0 < kMaxBatch ? batch - b0 : kMaxBatch;
    const size_t off = esz * a.npad_out * b0;
    const int err = dispatch(is_f64, static_cast<const char*>(x) + off, mat,
                             static_cast<char*>(y) + off, a, stream);
    if (err) return err;
  }
  return 0;
}

// K3 in launches of kMaxBatch components, each phase A then phase B on the
// stream (the stage reused launch after launch), or point by point where
// win_plan finds phase A no room.  pm and zm are null or laid out as x.
template <typename T>
int win_product(const void* x, const void* W, const void* pm, const void* zm, void* y,
                void* stage, CubeArgs a, int batch, void* stream) {
  WinArgs<T> P;
  P.W = static_cast<const T*>(W);
  P.stage = static_cast<T*>(stage);
  P.div_c1 = fast_div(a.c[1]);
  P.div_c2 = fast_div(a.c[2]);
  P.nc = a.c[0] * a.c[1] * a.c[2];
  for (int b0 = 0; b0 < batch; b0 += kMaxBatch) {
    a.nbo = batch - b0 < kMaxBatch ? batch - b0 : kMaxBatch;
    const int64_t off = (int64_t)a.npad_out * b0;
    const T* xb = static_cast<const T*>(x) + off;
    const T* pmb = pm == nullptr ? nullptr : static_cast<const T*>(pm) + off;
    const T* zmb = zm == nullptr ? nullptr : static_cast<const T*>(zm) + off;
    T* yb = static_cast<T*>(y) + off;
    WinPlan<T> p;
    int err = win_plan<T>(a, a.nbo, pm != nullptr, &p);
    if (err) return err;
    if (p.route == kWinPoint) {
      err = launch<T>(xb, W, yb, a, stream, pmb, zmb);
      if (err) return err;
      continue;
    }
    P.x = xb;
    P.pm = pmb;
    P.a = a;
    p.kernel<<<(P.nc + p.threads - 1) / p.threads, p.threads, p.smem, (cudaStream_t)stream>>>(P);
    err = (int)cudaGetLastError();
    if (err) return err;
    if (zmb != nullptr)
      launch_scatter<T, true>(stage, yb, a, P.nc, zmb, stream);
    else
      launch_scatter<T, false>(stage, yb, a, P.nc, nullptr, stream);
    err = (int)cudaGetLastError();
    if (err) return err;
  }
  return 0;
}

template <typename T>
int win_route(const CubeArgs& a, int batch, bool pm, int* out) {
  WinPlan<T> p;
  int err = win_plan<T>(a, batch, pm, &p);
  if (err) return err;
  int blocks = 0;
  if (p.route != kWinPoint) {
    err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, p.kernel, p.threads, p.smem);
    if (err) return err;
  }
  out[0] = p.route;
  out[1] = p.route == kWinPoint ? 0 : p.threads;
  out[2] = p.route == kWinPoint ? 0 : (int)p.smem;
  out[3] = blocks;
  return 0;
}

// K5 on the P2 cube: one block a tile (tile_product), a grid of
// (ntile2, ntile1, ntile0) blocks.  NB > 0: the batch fixed at compile time
// (the 3D cube's inputs in registers, 27 NB of them); 0: a.nbo (2D).  At most
// 128 registers a thread (2 blocks an SM).
template <typename T, int NL, int NB>
__global__ void __launch_bounds__(kTileThreads, 2)
const_tile_kernel(const T* __restrict__ x, const T* __restrict__ mat, T* __restrict__ y,
                  CubeArgs a) {
  T* smat = reinterpret_cast<T*>(dynamic_smem());
  T* sbuf = smat + NL * tile_ld<T>(NL);
  tile_stage<T, NL>(mat, smat);
  const int nb = NB > 0 ? NB : a.nbo;
  tile_product<T, NL, NB>(
      a, smat, sbuf, blockIdx.z, blockIdx.y, blockIdx.x,
      [&](int i, auto& v) {
#pragma unroll
        for (int b = 0; b < (NB > 0 ? NB : kMaxBatch); ++b)
          if (b < nb) v[b] = __ldg(x + b * a.npad_out + i);
      },
      [](int, const auto&) {}, [](const T*) {},
      [&](int i, const auto& acc, bool) {
#pragma unroll
        for (int b = 0; b < (NB > 0 ? NB : kMaxBatch); ++b)
          if (b < nb) y[b * a.npad_out + i] = acc[b];
      });
}

template <typename T>
auto tile_kernel(int nl, int nb) {
  if (nl != 27) return const_tile_kernel<T, 9, 0>;
  return nb == 1 ? const_tile_kernel<T, 27, 1>
         : nb == 2 ? const_tile_kernel<T, 27, 2>
         : nb == 3 ? const_tile_kernel<T, 27, 3>
                   : const_tile_kernel<T, 27, 4>;
}

// the kernel of a.nbo components with its shared memory limit set
template <typename T>
int tile_prepare(const CubeArgs& a, void (**kernel)(const T*, const T*, T*, CubeArgs),
                 size_t* smem) {
  *kernel = tile_kernel<T>(a.nl_in, a.nbo);
  *smem = tile_smem<T>(a, a.nbo);
  return (int)cudaFuncSetAttribute((const void*)*kernel,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*smem);
}

template <typename T>
int tile_occupancy(const CubeArgs& a, int* blocks) {
  void (*kernel)(const T*, const T*, T*, CubeArgs);
  size_t smem;
  const int err = tile_prepare<T>(a, &kernel, &smem);
  if (err) return err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel, kTileThreads, smem);
}

// K5 in launches of kMaxBatch components
template <typename T>
int tiled(const void* x, const void* C, void* y, CubeArgs a, int batch, void* stream) {
  for (int b0 = 0; b0 < batch; b0 += kMaxBatch) {
    a.nbo = batch - b0 < kMaxBatch ? batch - b0 : kMaxBatch;
    void (*kernel)(const T*, const T*, T*, CubeArgs);
    size_t smem;
    int err = tile_prepare<T>(a, &kernel, &smem);
    if (err) return err;
    const int64_t off = (int64_t)a.npad_out * b0;
    kernel<<<dim3(a.ntile[2], a.ntile[1], a.ntile[0]), kTileThreads, smem,
             (cudaStream_t)stream>>>(static_cast<const T*>(x) + off, static_cast<const T*>(C),
                                     static_cast<T*>(y) + off, a);
    err = (int)cudaGetLastError();
    if (err) return err;
  }
  return 0;
}

// ---------------------------------------------------------------------------
// K6 and K7 on the P2/P1 pair: the block-tiled product (tile_mixed)
// ---------------------------------------------------------------------------

constexpr int kDivBlocks = 4;  // K7's blocks an SM: at most 64 registers a thread

// Bytes of shared memory of a tile of K6 (div false) or K7 (div true) with
// a.d components: C_all's a.d nl_v rows of nl_q values, then K6's stage (a.d
// P2 components) over its P1 box, or K7's box (a.d P2 components) over its
// P1 stage.
template <typename T>
size_t mixed_smem(const CubeArgs& a, bool div) {
  return div ? tile_bytes<T>(a, a.d * a.nl_in, a.nl_out, a.d, 1)
             : tile_bytes<T>(a, a.d * a.nl_out, a.nl_in, 1, a.d);
}

// One block a tile, a grid of (ntile2, ntile1, ntile0) blocks.  x: K6's p
// (the P1 grid) or K7's u (D components of the P2 grid, a.x_bi apart); y:
// K6's r (D components of the P2 grid) or K7's b2 (the P1 grid).  K6 at most
// 128 registers a thread (2 blocks an SM, as its stage allows), K7 at most
// 64 (kDivBlocks).
template <typename T, int D, bool kDiv>
__global__ void __launch_bounds__(kTileThreads, kDiv ? kDivBlocks : 2)
mixed_tile_kernel(const T* __restrict__ x, const T* __restrict__ mat, T* __restrict__ y,
                  CubeArgs a) {
  constexpr int NLV = D == 3 ? 27 : 9, NLQ = D == 3 ? 8 : 4;
  constexpr int NI = kDiv ? D : 1, NO = kDiv ? 1 : D;  // components in and out
  T* smat = reinterpret_cast<T*>(dynamic_smem());
  T* sbuf = smat + D * NLV * tile_ld<T>(NLQ);
  tile_stage<T, NLQ>(mat, smat, D * NLV);
  tile_mixed<T, D, kDiv>(
      a, smat, sbuf, blockIdx.z, blockIdx.y, blockIdx.x,
      [&](int i, auto& v) {
#pragma unroll
        for (int b = 0; b < NI; ++b) v[b] = __ldg(x + b * a.x_bi + i);
      },
      [&](int i, const auto& acc, bool) {
#pragma unroll
        for (int b = 0; b < NO; ++b) y[b * a.npad_out + i] = acc[b];
      });
}

template <typename T>
using MixedKernel = void (*)(const T*, const T*, T*, CubeArgs);

// The route of K6 (div false) or K7 (div true), chosen by degree and
// component count: the P2/P1 pair with a.d components takes the tiled
// product (tile set on a, kernel, shared memory a block with its limit set
// on the kernel, true), any other pair the point-by-point kernel (false).
// cudaErrorInvalidValue where the pair finds no tile.
template <typename T>
int mixed_plan(CubeArgs& a, bool div, int ncomp, bool* tiled, MixedKernel<T>* kernel,
               size_t* smem) {
  *tiled = ncomp == a.d && (div ? a.deg_out == 1 && a.deg_in == 2 : a.deg_out == 2 && a.deg_in == 1);
  if (!*tiled) return 0;
  if (!tile_pick(a, div ? kDivBlocks : 2, [div](const CubeArgs& c) { return mixed_smem<T>(c, div); }))
    return (int)cudaErrorInvalidValue;
  *kernel = a.d == 3 ? (div ? mixed_tile_kernel<T, 3, true> : mixed_tile_kernel<T, 3, false>)
                     : (div ? mixed_tile_kernel<T, 2, true> : mixed_tile_kernel<T, 2, false>);
  *smem = mixed_smem<T>(a, div);
  return (int)cudaFuncSetAttribute((const void*)*kernel,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*smem);
}

template <typename T>
int mixed_apply(const void* x, const void* mat, void* y, CubeArgs a, bool div, int ncomp,
                void* stream) {
  bool tiled;
  MixedKernel<T> kernel;
  size_t smem;
  const int err = mixed_plan<T>(a, div, ncomp, &tiled, &kernel, &smem);
  if (err) return err;
  if (!tiled) return launch<T>(x, mat, y, a, stream);
  kernel<<<dim3(a.ntile[2], a.ntile[1], a.ntile[0]), kTileThreads, smem, (cudaStream_t)stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(mat), static_cast<T*>(y), a);
  return (int)cudaGetLastError();
}

template <typename T>
int mixed_route(CubeArgs a, bool div, int ncomp, int* out) {
  bool tiled;
  MixedKernel<T> kernel;
  size_t smem;
  int err = mixed_plan<T>(a, div, ncomp, &tiled, &kernel, &smem);
  if (err) return err;
  int blocks = 0;
  if (tiled) {
    err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, kTileThreads, smem);
    if (err) return err;
  }
  out[0] = tiled ? 1 : 0;
  for (int k = 0; k < 3; ++k) out[1 + k] = tiled ? a.tile[k] : 0;
  out[4] = tiled ? (int)smem : 0;
  out[5] = blocks;
  return 0;
}

// K6's and K7's operator arguments (the output grid first): K6 r_g = C_all[g]
// p, C_all (ncomp, nl_v, nl_q) read [g, to, ti]; K7 b2 = sum_g B_all[g]^T
// u_g, u (ncomp, grid_v), B_all read transposed [g, ti, to].
CubeArgs mixed_args(int d, int n0, int n1, int n2, int deg_v, int deg_q, int ncomp) {
  CubeArgs a = base_args(d, n0, n1, n2, deg_v, deg_q);
  a.nbo = ncomp;
  a.nbi = 1;
  a.m_bo = a.nl_out * a.nl_in;
  a.m_to = a.nl_in;
  a.m_ti = 1;
  a.mat_len = ncomp * a.nl_out * a.nl_in;
  return a;
}

CubeArgs divergence_args(int d, int n0, int n1, int n2, int deg_v, int deg_q, int ncomp) {
  CubeArgs a = base_args(d, n0, n1, n2, deg_q, deg_v);
  a.nbo = 1;
  a.nbi = ncomp;
  a.x_bi = (int)grid_points(d, a.n, deg_v);
  a.m_bi = a.nl_out * a.nl_in;
  a.m_ti = a.nl_out;  // B_all[g] is (nl_v, nl_q) = (nl_in, nl_out): [ti, to]
  a.m_to = 1;
  a.mat_len = ncomp * a.nl_out * a.nl_in;
  return a;
}

}  // namespace

extern "C" {

// y[b] = A x[b] with constant cube matrix C (nl, nl); x, y (batch, grid).
// deg 2 (K5) takes the tiled product with the tile of tile_choose, any
// other degree (K12) the point-by-point product.
int oasisx_matvec_const(const void* x, const void* C, void* y, int is_f64, int d, int n0,
                        int n1, int n2, int deg, int batch, void* stream) {
  if (!cube_fits(d, n0, n1, n2, deg, deg, batch)) return (int)cudaErrorInvalidValue;
  CubeArgs a = const_args(d, n0, n1, n2, deg, batch);
  if (deg != 2) return batched(is_f64, x, C, y, a, batch, stream);
  const int nb = batch < kMaxBatch ? batch : kMaxBatch;
  if (!(is_f64 ? tile_choose<double>(a, nb) : tile_choose<float>(a, nb)))
    return (int)cudaErrorInvalidValue;
  return is_f64 ? tiled<double>(x, C, y, a, batch, stream)
                : tiled<float>(x, C, y, a, batch, stream);
}

// K5's and K4's tile for batch (1 to kMaxBatch) components of a
// d-dimensional P2 grid on the current device: out = (t0, t1, t2, bytes of
// shared memory a block of K5, blocks an SM of K5's kernel (the occupancy
// calculator), bytes a block of K4).  0 or a CUDA error.
int oasisx_const_tile(int is_f64, int d, int batch, int* out) {
  if ((d != 2 && d != 3) || batch < 1 || batch > kMaxBatch) return (int)cudaErrorInvalidValue;
  CubeArgs a = const_args(d, 8, 8, 8, 2, batch);
  if (!(is_f64 ? tile_choose<double>(a, batch) : tile_choose<float>(a, batch)))
    return (int)cudaErrorInvalidValue;
  int blocks = 0;
  const int err = is_f64 ? tile_occupancy<double>(a, &blocks) : tile_occupancy<float>(a, &blocks);
  if (err) return err;
  for (int k = 0; k < 3; ++k) out[k] = a.tile[k];
  out[3] = (int)(is_f64 ? tile_smem<double>(a, batch) : tile_smem<float>(a, batch));
  out[4] = blocks;
  out[5] = (int)(is_f64 ? tile_block_smem<double>(a, batch) : tile_block_smem<float>(a, batch));
  return 0;
}

// y[b] = zmask[b] * A_W (premul[b] * x[b]) with per-cube weights W
// (nl*nl, ncubes); x, y, premul, zmask (batch, grid), premul and zmask may be
// null (1).  stage: the cube-owned product's work buffer, at least
// min(batch, 4) * nl * ncubes values (stage_len, checked).
int oasisx_matvec_win(const void* x, const void* W, const void* premul, const void* zmask,
                      void* y, void* stage, long long stage_len, int is_f64, int d, int n0,
                      int n1, int n2, int deg, int batch, void* stream) {
  if (!cube_fits(d, n0, n1, n2, deg, deg, batch)) return (int)cudaErrorInvalidValue;
  const CubeArgs a = win_args(d, n0, n1, n2, deg, batch);
  const int nb = batch < kMaxBatch ? batch : kMaxBatch;
  if (stage == nullptr || stage_len < (long long)nb * a.nl_in * a.c[0] * a.c[1] * a.c[2])
    return (int)cudaErrorInvalidValue;
  return is_f64 ? win_product<double>(x, W, premul, zmask, y, stage, a, batch, stream)
                : win_product<float>(x, W, premul, zmask, y, stage, a, batch, stream);
}

// The route oasisx_matvec_win takes for a launch of batch (1 to kMaxBatch)
// components of a d-dimensional degree-deg grid with cells (n0, n1, n2) on
// the current device, with premul or without: out = (route: 0 point by
// point, 1 cube-owned with a cube's inputs in registers, 2 cube-owned with
// them in shared-memory columns; phase A's threads a block, its bytes of
// dynamic shared memory a block and its blocks an SM (the occupancy
// calculator), 0 for route 0).  0 or a CUDA error.
int oasisx_win_route(int is_f64, int d, int n0, int n1, int n2, int deg, int batch, int premul,
                     int* out) {
  if (batch > kMaxBatch || !cube_fits(d, n0, n1, n2, deg, deg, batch))
    return (int)cudaErrorInvalidValue;
  const CubeArgs a = win_args(d, n0, n1, n2, deg, batch);
  return is_f64 ? win_route<double>(a, batch, premul != 0, out)
                : win_route<float>(a, batch, premul != 0, out);
}

// r[g] = C_all[g] p for g < ncomp; p (grid_q) -> r (ncomp, grid_v).  The
// P2/P1 pair with d components takes the tiled product, any other pair the
// point-by-point one (oasisx_mixed_route).
int oasisx_mixed(const void* p, const void* C_all, void* r, int is_f64, int d, int n0,
                 int n1, int n2, int deg_v, int deg_q, int ncomp, void* stream) {
  if (ncomp > kMaxBatch || !cube_fits(d, n0, n1, n2, deg_v, deg_q, ncomp))
    return (int)cudaErrorInvalidValue;
  const CubeArgs a = mixed_args(d, n0, n1, n2, deg_v, deg_q, ncomp);
  return is_f64 ? mixed_apply<double>(p, C_all, r, a, false, ncomp, stream)
                : mixed_apply<float>(p, C_all, r, a, false, ncomp, stream);
}

// b2 = sum_g B_all[g]^T u[g]; u (ncomp, grid_v) -> b2 (grid_q).  Routes as
// oasisx_mixed's.
int oasisx_divergence(const void* u, const void* B_all, void* b2, int is_f64, int d,
                      int n0, int n1, int n2, int deg_v, int deg_q, int ncomp,
                      void* stream) {
  if (ncomp > kMaxBatch || !cube_fits(d, n0, n1, n2, deg_q, deg_v, ncomp))
    return (int)cudaErrorInvalidValue;
  const CubeArgs a = divergence_args(d, n0, n1, n2, deg_v, deg_q, ncomp);
  return is_f64 ? mixed_apply<double>(u, B_all, b2, a, true, ncomp, stream)
                : mixed_apply<float>(u, B_all, b2, a, true, ncomp, stream);
}

// The route oasisx_mixed (div 0) or oasisx_divergence (div 1) takes for
// ncomp components of a d-dimensional grid with cells (n0, n1, n2), velocity
// degree deg_v and pressure degree deg_q, on the current device: out =
// (route: 0 point by point, 1 block-tiled; the tile (t0, t1, t2) in the 3D
// form, bytes of shared memory a block and blocks an SM (the occupancy
// calculator), 0 for route 0).  0 or a CUDA error.
int oasisx_mixed_route(int is_f64, int div, int d, int n0, int n1, int n2, int deg_v, int deg_q,
                       int ncomp, int* out) {
  if (ncomp > kMaxBatch || !cube_fits(d, n0, n1, n2, deg_v, deg_q, ncomp))
    return (int)cudaErrorInvalidValue;
  const CubeArgs a = div ? divergence_args(d, n0, n1, n2, deg_v, deg_q, ncomp)
                         : mixed_args(d, n0, n1, n2, deg_v, deg_q, ncomp);
  return is_f64 ? mixed_route<double>(a, div != 0, ncomp, out)
                : mixed_route<float>(a, div != 0, ncomp, out);
}

// U[b] = the cube-local values of x[b]; x (batch, grid) -> U (batch, nl, ncubes).
// cudaErrorInvalidValue where x or U has 2^31 entries or more, or a cube has
// more than kGatherMaxSlots slots.
int oasisx_cube_gather(const void* x, void* u, int is_f64, int d, int n0, int n1, int n2,
                       int deg, int batch, void* stream) {
  return gather(x, u, is_f64, d, n0, n1, n2, deg, batch, stream, false);
}

// The same with the run-time slot loop whatever the slot count (the main
// path's 27 slots are otherwise unrolled): the two loops timed on one input.
int oasisx_cube_gather_loop(const void* x, void* u, int is_f64, int d, int n0, int n1,
                            int n2, int deg, int batch, void* stream) {
  return gather(x, u, is_f64, d, n0, n1, n2, deg, batch, stream, true);
}

// y[b] = the grid vector assembled from the cube-local values U[b];
// U (batch, nl, ncubes) -> y (batch, grid), in launches of kMaxBatch
// components.
int oasisx_cube_scatter(const void* u, void* y, int is_f64, int d, int n0, int n1, int n2,
                        int deg, int batch, void* stream) {
  if (!cube_fits(d, n0, n1, n2, deg, deg, batch)) return (int)cudaErrorInvalidValue;
  CubeArgs a = base_args(d, n0, n1, n2, deg, deg);
  int64_t ncube = 1;
  for (int k = 0; k < d; ++k) ncube *= a.n[k];
  const int64_t comp = a.nl_out * ncube;
  if (batch * comp >= ((int64_t)1 << 31)) return (int)cudaErrorInvalidValue;
  const size_t esz = is_f64 ? sizeof(double) : sizeof(float);
  for (int b0 = 0; b0 < batch; b0 += kMaxBatch) {
    a.nbo = batch - b0 < kMaxBatch ? batch - b0 : kMaxBatch;
    const void* ub = static_cast<const char*>(u) + esz * comp * b0;
    void* yb = static_cast<char*>(y) + esz * a.npad_out * b0;
    if (is_f64)
      launch_scatter<double, false>(ub, yb, a, (int)ncube, nullptr, stream);
    else
      launch_scatter<float, false>(ub, yb, a, (int)ncube, nullptr, stream);
    const int err = (int)cudaGetLastError();
    if (err) return err;
  }
  return 0;
}

}  // extern "C"
