// The cube operator as a device function, shared by every kernel of csrc/.
//
//     y = sum_cubes  P_c^T  (cube matrix)  P_c  x
//
// on the grid layout of oasisx_tpu_torch/assembly/structured.py: a vector
// of one space is a (nch, n_0+1, ..., n_{d-1}+1) array, nch = deg^d parity
// channels, C-order.  A dof at fine-lattice index f sits at parity
// p_k = f_k % deg, base b_k = f_k / deg.  Positions with p_k > 0 and
// b_k = n_k are padding and give 0.
//
// Three forms, all deterministic, with no atomics.  Point by point
// (cube_point; K12, K1, and K6 and K7 off the P2/P1 pair): the caller owns
// one output grid point (parity p, base b) for every output component.  It
// sums over the <= 2^d cubes b - delta that contain the point (delta_k in
// {0,1} on the axes with p_k == 0; the point is slot t = p + deg*delta of
// that cube), and for each cube over the nl_in input slots, in a fixed
// order, so a run repeats bit for bit.  Each (output slot, cube) pair
// belongs to exactly one output point, so each entry of a per-cube weight
// array is read once per application, for all components together; but
// each input is read once for every output slot of every cube that holds
// it.  Block-tiled (tile_product and tile_mixed, below; the P2 constant
// product of K5 and K4, and K6's and K7's products on the P2/P1 pair): a
// block reads a box of inputs once into shared memory, a thread a cube
// computes all the cube's output slots into a stage, and each owned point
// sums its cubes' staged values through cube_visit.  Cube-owned with
// per-cube weights (win_cube, below; K3 and K2's phase A): a thread a cube
// reads the cube's inputs once and streams its weights into a stage in
// global memory, and after it (K3's second launch, K2's grid barrier) each
// point sums its cubes' staged values through cube_visit.  The last two sum
// in one order, per cube slot by slot, then per point over its cubes.  The
// P1 stencil tile (stencil_*, at the end; K1's non-MG modes and K4 on the
// P1 cube): a block reads a box of inputs once into shared memory and each
// point sums its 3^d neighbours times its class's coefficients, which fold
// the cube matrix's entries over the cubes that hold the point.
//
// The output side takes a point already split into its parities and base
// coordinates (CubePoint), on a 3D form of the grid (a 2D grid gets a
// leading axis of one cell, one base point and one parity), with 32-bit
// indices and no division: the <= 8 cubes are a bit mask built from
// comparisons, visited in ascending delta bits (C-order), and each cube's
// slot, index and base offset are sums of strides.  A standalone launch
// takes the split from its block and thread indices (cube_ops.cu); a
// whole-solve kernel splits each point of its grid-stride loop by exact
// multiply-and-shift divisions (cube_split), whose constants are kernel
// parameters.  As with K8's gather (cube_ops.cu), 64-bit divisions and
// remainders per point, a software sequence of dozens of instructions each
// on the GPU, made the cube kernels integer-bound rather than memory-bound.
// Every index of one application fits in int32: the entry points check it
// (cube_fits).
//
// Inputs that a kernel writes itself between grid barriers are read through
// plain pointers (no __restrict__), so the compiler keeps them off the
// non-coherent read-only path.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace oasisx {

constexpr int kMaxBatch = 4;  // output components per application
constexpr int kThreads = 256;  // threads per block of the whole-solve kernels

// n / d = (n * m) >> s for 0 <= n < 2^31 (a 32 x 32 -> 64-bit product and
// a shift): s = 31 + ceil(log2 d), m = ceil(2^s / d), which is below 2^32.
// Exact: n m / 2^s = n / d + n e / (d 2^s) with e = m d - 2^s < d <= 2^(s-31),
// and n e < 2^s, so the excess stays below 1/d.
struct FastDiv {
  unsigned m;
  int s;
};

inline FastDiv fast_div(int d) {
  int l = 0;
  while (((int64_t)1 << l) < d) ++l;
  const int s = 31 + l;
  return {(unsigned)((((uint64_t)1 << s) + d - 1) / d), s};
}

__device__ __forceinline__ unsigned fast_quo(unsigned n, FastDiv f) {
  return (unsigned)(((uint64_t)n * f.m) >> f.s);
}

struct CubeArgs {
  int d;
  int n[3];            // cells per axis
  int deg_out, deg_in;
  int nl_out, nl_in;
  // the output grid in 3D form (in 2D, axis 0 has one cell, one base point
  // and one parity, and the real axes are 1 and 2)
  int g[3];            // base points per axis
  int c[3];            // cells per axis
  int par[3];          // parities per axis (deg_out)
  FastDiv div_g[3], div_par[3];  // divisions by g[k] and par[k] (cube_split)
  int plane;           // g0 g1 g2: one parity channel of the output and input grids
  int npad_out;        // grid size of one output component
  int nbo;             // output components
  int nbi;             // input components summed into each output component
  int x_bo, x_bi;      // input strides per output / input component
  int m_bo, m_bi, m_to, m_ti, m_cube;  // matrix strides
  int mat_len;         // > 0: the matrix is constant, staged in shared memory
  // the block-tiled product (tile_product; tile_choose fills these): base
  // points a tile owns per axis, tiles per axis, and divisions by both
  int tile[3], ntile[3];
  FastDiv div_tile[3], div_ntile[3];
};

// An output grid point in the 3D form: parity p_k and base b_k per axis.
struct CubePoint {
  int p[3], b[3];
};

__device__ __forceinline__ unsigned char* dynamic_smem() {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  return smem_raw;
}

// Grid offset of slot ti of a cube of a degree-deg grid with cells n
// (d axes) relative to the cube's base, in a grid whose parity channels
// are `plane` points apart: the slot's digits in C-order give its parity
// channel and its base step.  cube_stage and K8's entry point both use it.
__host__ __device__ inline int slot_offset(int d, const int* n, int deg, int plane, int ti) {
  int ch = 0, boff = 0, rem = ti, wch = 1, wb = 1;
#pragma unroll
  for (int k = 2; k >= 0; --k) {  // the last axis's digit first
    if (k >= d) continue;
    const int digit = rem % (deg + 1);
    rem /= deg + 1;
    ch += wch * (digit % deg);
    boff += wb * (digit / deg);
    wch *= deg;
    wb *= n[k] + 1;
  }
  return ch * plane + boff;
}

// Block-cooperative: copy a constant matrix (a.mat_len > 0) into smat and the
// grid offset of every input slot relative to its cube's base into soff.
// The caller synchronises the block before use.
template <typename T>
__device__ void cube_stage(const T* mat, const CubeArgs& a, T* smat, int* soff) {
  for (int i = threadIdx.x; i < a.mat_len; i += blockDim.x) smat[i] = mat[i];
  const int n[3] = {a.n[0], a.n[1], a.n[2]};  // not a.n: its address would copy a to the stack
  for (int ti = threadIdx.x; ti < a.nl_in; ti += blockDim.x)
    soff[ti] = slot_offset(a.d, n, a.deg_in, a.plane, ti);
}

// The output side of every cube operator: calls f(to, cube, cbase) for each
// of the <= 2^d cubes that contain output point q, in one fixed order (the
// delta bits in C-order, as cubes.cube_scatter sums them).  `to` is the
// point's slot in that cube, `cube` the cube's index (C-order over the
// cells) and `cbase` the offset of the cube's base in one input channel.
// A padding point lies in no cube and calls nothing.
template <typename F>
__device__ __forceinline__ void cube_visit(const CubeArgs& a, const CubePoint& q, F&& f) {
  // bit dm of mask: the cube b - delta, delta_k = bit (2 - k) of dm
  unsigned mask = 0xFFu;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const unsigned d0 = k == 0 ? 0x0Fu : k == 1 ? 0x33u : 0x55u;  // the dm with delta_k = 0
    if (q.b[k] >= a.c[k]) mask &= ~d0;                 // no cell at b_k
    if (q.p[k] != 0 || q.b[k] == 0) mask &= d0;        // no cell at b_k - 1 holds the point
  }
  const int D = a.deg_out, D1 = a.deg_out + 1;
  const int to0 = (q.p[0] * D1 + q.p[1]) * D1 + q.p[2];
  const int cube0 = (q.b[0] * a.c[1] + q.b[1]) * a.c[2] + q.b[2];
  const int cbase0 = (q.b[0] * a.g[1] + q.b[1]) * a.g[2] + q.b[2];
  while (mask) {
    const int dm = __ffs(mask) - 1;
    mask &= mask - 1;
    const int e0 = dm >> 2, e1 = (dm >> 1) & 1, e2 = dm & 1;
    f(to0 + D * ((e0 * D1 + e1) * D1 + e2), cube0 - ((e0 * a.c[1] + e1) * a.c[2] + e2),
      cbase0 - ((e0 * a.g[1] + e1) * a.g[2] + e2));
  }
}

// acc[bo] = (A x)_bo at output point q, for bo < a.nbo; 0 at padding.
// M is the staged matrix (a.mat_len > 0) or the matrix in global memory.
// kPm: the input is pm * x, pm laid out as x (K3's premul; K5 form only).
// NL > 0: the cube has NL input slots, fixed at compile time (the slot loop
// unrolled, so a thread's loads of one cube are in flight together); NL == 0
// takes a.nl_in at run time.
template <typename T, bool kPm = false, int NL = 0>
__device__ __forceinline__ void cube_point(const T* x, const T* M, const int* soff,
                                           const CubeArgs& a, const CubePoint& q,
                                           T (&acc)[kMaxBatch], const T* pm = nullptr) {
#pragma unroll
  for (int bo = 0; bo < kMaxBatch; ++bo) acc[bo] = T(0);
  cube_visit(a, q, [&](int to, int cube, int cbase) {
    const T* mc = M + to * a.m_to + cube * a.m_cube;
    auto slot = [&](int ti) {
      const T* mt = mc + ti * a.m_ti;
      const T* xt = x + soff[ti] + cbase;
      if (a.m_bo == 0 && a.m_bi == 0) {
        // one coefficient for every component (K5, K3): read it once
        const T coef = mt[0];
        const T* pt = kPm ? pm + soff[ti] + cbase : nullptr;
#pragma unroll
        for (int bo = 0; bo < kMaxBatch; ++bo)
          if (bo < a.nbo)
            acc[bo] += coef * (kPm ? xt[bo * a.x_bo] * pt[bo * a.x_bo] : xt[bo * a.x_bo]);
      } else {
#pragma unroll
        for (int bo = 0; bo < kMaxBatch; ++bo) {
          if (bo >= a.nbo) break;
#pragma unroll
          for (int bi = 0; bi < kMaxBatch; ++bi) {
            if (bi >= a.nbi) break;
            acc[bo] += mt[bo * a.m_bo + bi * a.m_bi] * xt[bo * a.x_bo + bi * a.x_bi];
          }
        }
      }
    };
    if constexpr (NL > 0) {
#pragma unroll
      for (int ti = 0; ti < NL; ++ti) slot(ti);
    } else {
      for (int ti = 0; ti < a.nl_in; ++ti) slot(ti);
    }
  });
}

// Output point idx (below the grid size) split into its parities and base
// coordinates: the mixed-radix digits of idx = ((p0 par1 + p1) par2 + p2)
// plane + (b0 g1 + b1) g2 + b2, by multiply-and-shift divisions.
__device__ __forceinline__ CubePoint cube_split(const CubeArgs& a, int idx) {
  CubePoint q;
  unsigned v = (unsigned)idx;
#pragma unroll
  for (int k = 2; k >= 0; --k) {
    const unsigned t = fast_quo(v, a.div_g[k]);
    q.b[k] = (int)(v - t * (unsigned)a.g[k]);
    v = t;
  }
#pragma unroll
  for (int k = 2; k >= 0; --k) {
    const unsigned t = fast_quo(v, a.div_par[k]);
    q.p[k] = (int)(v - t * (unsigned)a.par[k]);
    v = t;
  }
  return q;
}

inline int64_t grid_points(int d, const int* n, int deg) {
  int64_t g = 1;
  for (int k = 0; k < d; ++k) g *= (int64_t)deg * (n[k] + 1);
  return g;
}

inline int ipow(int b, int e) {
  int r = 1;
  for (int i = 0; i < e; ++i) r *= b;
  return r;
}

// True when the operator's every index fits in int32: `comps` components
// of its output and of its input grid, and per-cube weights
// (nl_out * nl_in, ncubes).  The entry points refuse other arguments.
inline bool cube_fits(int d, int n0, int n1, int n2, int deg_out, int deg_in, int comps) {
  if ((d != 2 && d != 3) || n0 < 1 || n1 < 1 || (d == 3 && n2 < 1) || deg_out < 1 ||
      deg_in < 1 || comps < 1)
    return false;
  const int n[3] = {n0, n1, n2};
  int64_t ncube = 1;
  for (int k = 0; k < d; ++k) ncube *= n[k];
  const int64_t lim = (int64_t)1 << 31;
  const int64_t nl_out = ipow(deg_out + 1, d), nl_in = ipow(deg_in + 1, d);
  return comps * grid_points(d, n, deg_out) < lim && comps * grid_points(d, n, deg_in) < lim &&
         nl_out * nl_in * ncube < lim && (d == 2 || n0 + 1 <= 65535);
}

// The arguments every operator shares; call after cube_fits.
inline CubeArgs base_args(int d, int n0, int n1, int n2, int deg_out, int deg_in) {
  CubeArgs a = {};
  a.d = d;
  a.n[0] = n0;
  a.n[1] = n1;
  a.n[2] = d == 3 ? n2 : 0;
  a.deg_out = deg_out;
  a.deg_in = deg_in;
  a.nl_out = ipow(deg_out + 1, d);
  a.nl_in = ipow(deg_in + 1, d);
  const int lead = 3 - d;  // the 3D form's extra leading axis (2D)
  for (int k = 0; k < 3; ++k) {
    const bool real = k >= lead;
    a.c[k] = real ? a.n[k - lead] : 1;
    a.g[k] = real ? a.n[k - lead] + 1 : 1;
    a.par[k] = real ? deg_out : 1;
    a.div_g[k] = fast_div(a.g[k]);
    a.div_par[k] = fast_div(a.par[k]);
  }
  a.plane = a.g[0] * a.g[1] * a.g[2];
  a.npad_out = a.par[0] * a.par[1] * a.par[2] * a.plane;
  return a;
}

// Operator arguments of y_b = A x_b, b < batch, on one grid: constant cube
// matrix C (nl, nl) staged in shared memory, or per-cube weights W
// (nl*nl, ncubes) in global memory.
inline CubeArgs const_args(int d, int n0, int n1, int n2, int deg, int batch) {
  CubeArgs a = base_args(d, n0, n1, n2, deg, deg);
  a.nbo = batch;
  a.nbi = 1;
  a.x_bo = a.npad_out;
  a.m_to = a.nl_in;
  a.m_ti = 1;
  a.mat_len = a.nl_out * a.nl_in;
  return a;
}

inline CubeArgs win_args(int d, int n0, int n1, int n2, int deg, int batch) {
  CubeArgs a = base_args(d, n0, n1, n2, deg, deg);
  int ncube = 1;
  for (int k = 0; k < d; ++k) ncube *= a.n[k];
  a.nbo = batch;
  a.nbi = 1;
  a.x_bo = a.npad_out;
  a.m_cube = 1;
  a.m_ti = ncube;
  a.m_to = ncube * a.nl_in;
  a.mat_len = 0;
  return a;
}

// ---------------------------------------------------------------------------
// The cube-owned product of per-cube weights W (K3, K10, K2's phase A)
// ---------------------------------------------------------------------------

// Offset of cube c's base in one input channel: c is C-order over the
// cells of the 3D form, split by multiply-and-shift divisions by c[2]
// (div_c2) and c[1] (div_c1).
__device__ __forceinline__ int cube_base(const CubeArgs& a, int c, FastDiv div_c1,
                                         FastDiv div_c2) {
  const int q = (int)fast_quo((unsigned)c, div_c2);
  const int i0 = (int)fast_quo((unsigned)q, div_c1);
  return (i0 * a.g[1] + (q - i0 * a.c[1])) * a.g[2] + (c - q * a.c[2]);
}

// One cube of A_W's phase A: stage[(b nl + to) nc] = sum_ti W[(to nl + ti)
// nc] in(b, ti) for b < nb, the slots in order, with W and stage offset to
// the cube.  The cube's weights are streamed evict-first (__ldcs: W is read
// once a product and does not fit in the L2), coalesced across the
// neighbouring cubes of a warp; NL > 0 fixes nl and unrolls the slot loop,
// so that a row's NL loads are in flight together.  in(b, ti) is input
// component b at slot ti, read once a cube by the caller (registers or a
// shared-memory column).  NB > 0 fixes nb.
template <typename T, int NL, int NB, typename In>
__device__ __forceinline__ void win_cube(const T* W, T* stage, int nl, int nb, int nc, In&& in) {
  const int n = NL > 0 ? NL : nl;
  const int m = NB > 0 ? NB : nb;
  for (int to = 0; to < n; ++to) {
    const T* wt = W + to * n * nc;
    T acc[kMaxBatch];
#pragma unroll
    for (int b = 0; b < kMaxBatch; ++b) acc[b] = T(0);
    auto slot = [&](int ti) {
      const T w = __ldcs(wt + ti * nc);
#pragma unroll
      for (int b = 0; b < kMaxBatch; ++b)
        if (b < m) acc[b] += w * in(b, ti);
    };
    if constexpr (NL > 0) {
#pragma unroll
      for (int ti = 0; ti < NL; ++ti) slot(ti);
    } else {
      for (int ti = 0; ti < n; ++ti) slot(ti);
    }
#pragma unroll
    for (int b = 0; b < kMaxBatch; ++b)
      if (b < m) stage[(b * n + to) * nc] = acc[b];
  }
}

// ---------------------------------------------------------------------------
// The block-tiled, cube-owned product of a constant cube matrix (K5 and K4 on
// the P2 cube, K6 and K7 on the P2/P1 pair)
// ---------------------------------------------------------------------------
//
// A block owns a tile: a box of a.tile[k] base points per axis (3D form), all
// parity channels of the output grid.  The cubes that hold an owned point
// are b - delta, so the tile's cubes reach one cube below the box on each
// axis (the halo, which every block recomputes: no block reads another's
// results).  Three steps, with block barriers between them, in one buffer of
// shared memory:
//   the box (tile_box): the inputs of every cube of the tile on the input
//     grid's lattice (deg_in ncu_k + 1 points an axis for ncu_k cubes), each
//     read once from global memory by the caller's load(i, v);
//   phase 1: a thread a cube computes all the cube's outputs into the stage
//     (output components, output slots, cubes of the tile), which overwrites
//     the box once the block has read what it needs of it.  The matrix rows
//     come from shared memory in 16-byte loads, the same address in every
//     lane.  tile_product (K5, K4): the cube's nl * nb inputs in registers,
//     each output slot sums its nl inputs in slot order.  tile_mixed, K6
//     (P1 in, d P2 components out): the cube's 2^d inputs in registers, each
//     output slot of each component sums them in slot order.  tile_mixed, K7
//     (d P2 components in, P1 out): the cube's 2^d outputs in registers, each
//     summing the components in order and, in each, the 3^d input slots in
//     order, read from the box;
//   phase 2 (tile_sum): a thread an owned output point sums its <= 2^d
//     staged values in cube_visit's order and hands them to the caller's
//     store(i, acc, pad).
// No atomics, and one order of sums: per cube, slot by slot, then per point
// over its cubes, as kernels.matvec_const_staged_plain, mixed_staged_plain
// and divergence_staged_plain.  Each input is read once a tile, not once for
// each output slot of each cube that holds it (as cube_point does).

constexpr int kTileThreads = 256;  // threads a block of the tiled product: at most one cube each

// Row stride of a staged matrix of nc columns: nc rounded up to whole 16-byte loads.
template <typename T>
__host__ __device__ constexpr int tile_ld(int nc) {
  return (nc + (int)(16 / sizeof(T)) - 1) / (int)(16 / sizeof(T)) * (int)(16 / sizeof(T));
}

// Bytes of shared memory of one tile: a staged matrix of `rows` rows of
// tile_ld(cols), then the larger of the box (nbx input components on the
// input lattice) and the stage (nbs components of nl_out slots a cube); the
// buffer holds both in turn.
template <typename T>
inline size_t tile_bytes(const CubeArgs& a, int rows, int cols, int nbx, int nbs) {
  int64_t cubes = 1, box = 1;
  for (int k = 0; k < 3; ++k)
    if (a.g[k] > 1) {
      cubes *= a.tile[k] + 1;
      box *= a.deg_in * (a.tile[k] + 1) + 1;
    }
  const size_t mat = (sizeof(T) * rows * tile_ld<T>(cols) + 15) & ~size_t(15);
  const int64_t stage = (int64_t)nbs * a.nl_out * cubes, in = (int64_t)nbx * box;
  return mat + sizeof(T) * (stage > in ? stage : in);
}

// K5's tile at batch nb: the (nl, nl) matrix, nb components in and out (the
// stage is never the smaller in 2D or 3D).
template <typename T>
inline size_t tile_smem(const CubeArgs& a, int nb) {
  return tile_bytes<T>(a, a.nl_in, a.nl_in, nb, nb);
}

// Set the tile of an operator of degrees (deg_out, deg_in) (2, 2), (2, 1) or
// (1, 2): a.tile = (t0, t1, t2) in the 3D form (t0 is 1 on a 2D grid's
// leading axis, the one axis of a single base point), at most kTileThreads
// cubes a tile and launchable tile counts.  False for any other tile.
inline bool tile_set(CubeArgs& a, const int (&t)[3]) {
  int64_t cubes = 1;
  for (int k = 0; k < 3; ++k) {
    if (t[k] < 1 || (a.g[k] == 1 && t[k] != 1)) return false;
    cubes *= a.g[k] > 1 ? t[k] + 1 : 1;
    a.tile[k] = t[k];
    a.ntile[k] = (a.g[k] + t[k] - 1) / t[k];
    a.div_tile[k] = fast_div(t[k]);
    a.div_ntile[k] = fast_div(a.ntile[k]);
  }
  return a.deg_out <= 2 && a.deg_in <= 2 && a.deg_out + a.deg_in >= 3 && cubes <= kTileThreads &&
         a.ntile[0] <= 65535 && a.ntile[1] <= 65535;
}

// Values a thread that K4 (krylov_ops.cu) keeps for its block reduction
// after the tile's buffer.  The tile is chosen with them for K5 as well, so
// that K5 and K4 take one tile.
constexpr int kTileRed = 2 * kMaxBatch;

// Bytes of shared memory of one block of K4 at batch nb: the tile's, then
// the reduction's (at a 16-byte boundary).
template <typename T>
inline size_t tile_block_smem(const CubeArgs& a, int nb) {
  return ((tile_smem<T>(a, nb) + 15) & ~size_t(15)) + sizeof(T) * kTileRed * kTileThreads;
}

// Choose and set (tile_set) a tile: the first candidate whose bytes(a) of
// shared memory a block let `blocks` blocks share an SM of the current
// device.  In 3D, 3 x 7 x 7 fills the 256 threads with cubes (4 x 8 x 8 with
// the halo), the most owned points a cube of the shapes that do; 3 x 3 x 7
// and 1 x 3 x 7 need less shared memory.  A 2D grid takes 1 x 15 x 15 (16 x
// 16 cubes).  False where none fits or the device cannot be asked.
template <typename Bytes>
inline bool tile_pick(CubeArgs& a, int blocks, Bytes&& bytes) {
  constexpr int k3[3][3] = {{3, 7, 7}, {3, 3, 7}, {1, 3, 7}};
  constexpr int k2[1][3] = {{1, 15, 15}};
  int dev = 0, per_sm = 0, reserved = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&per_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev) !=
          cudaSuccess ||
      cudaDeviceGetAttribute(&reserved, cudaDevAttrReservedSharedMemoryPerBlock, dev) !=
          cudaSuccess)
    return false;
  const size_t fit = (size_t)(per_sm / blocks - reserved);
  const bool three = a.g[0] > 1;
  for (int i = 0; i < (three ? 3 : 1); ++i)
    if (tile_set(a, three ? k3[i] : k2[i]) && bytes(a) <= fit) return true;
  return false;
}

// K5's and K4's tile at nb <= kMaxBatch components: two blocks an SM (K5 and
// K4 run two, at most 128 registers a thread), counting K4's reduction.
// float32 takes 3 x 7 x 7 up to batch 3; float64 and batch 4 take a smaller
// one.
template <typename T>
inline bool tile_choose(CubeArgs& a, int nb) {
  return tile_pick(a, 2, [nb](const CubeArgs& c) { return tile_block_smem<T>(c, nb); });
}

// Stage a constant matrix of `rows` rows of NC values in rows of
// tile_ld(NC), zero-padded.  The caller's first tile_box synchronises the
// block before use.
template <typename T, int NC>
__device__ __forceinline__ void tile_stage(const T* mat, T* smat, int rows = NC) {
  constexpr int LD = tile_ld<T>(NC);
  for (int i = threadIdx.x; i < rows * LD; i += blockDim.x) {
    const int r = i / LD, c = i - r * LD;
    smat[i] = c < NC ? mat[r * NC + c] : T(0);
  }
}

__device__ __forceinline__ float tile_fma(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ double tile_fma(double a, double b, double c) { return fma(a, b, c); }

template <typename T>
struct Vec16;
template <>
struct Vec16<float> {
  using type = float4;
  __device__ static float get(const float4& v, int u) {
    return u == 0 ? v.x : u == 1 ? v.y : u == 2 ? v.z : v.w;
  }
};
template <>
struct Vec16<double> {
  using type = double2;
  __device__ static double get(const double2& v, int u) { return u == 0 ? v.x : v.y; }
};

// Tile (i0, i1, i2) of a D-dimensional grid on the 3D form: per axis its
// first owned base point B0, first cube lo, cubes ncu, box points F (inputs
// of degree DI: DI ncu + 1 on a real axis, 1 on a 2D grid's leading axis)
// and owned base points; its cubes, and the box's plane and points (one
// component).
struct TileGeo {
  int B0[3], lo[3], ncu[3], F[3], own[3];
  int ncubes, plane, boxpts;
};

template <int DI, int D>
__device__ __forceinline__ TileGeo tile_geo(const CubeArgs& a, int i0, int i1, int i2) {
  TileGeo t;
  const int it[3] = {i0, i1, i2};
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    t.B0[k] = it[k] * a.tile[k];
    t.lo[k] = t.B0[k] > 0 ? t.B0[k] - 1 : 0;
    const int hi = min(a.c[k] - 1, t.B0[k] + a.tile[k] - 1);
    t.ncu[k] = hi - t.lo[k] + 1;
    t.F[k] = D == 3 || k > 0 ? DI * t.ncu[k] + 1 : 1;
    t.own[k] = min(a.tile[k], a.g[k] - t.B0[k]);
  }
  t.ncubes = t.ncu[0] * t.ncu[1] * t.ncu[2];
  t.plane = t.F[1] * t.F[2];
  t.boxpts = t.F[0] * t.plane;
  return t;
}

// The box, after a block barrier (the previous tile's readers of sbuf are
// done, and the matrix is staged): box point (b, f) at sbuf[b boxpts + (f0
// F1 + f1) F2 + f2], for b < nb; fine point f of an axis is parity f % DI of
// base lo + f / DI (DI 1 or 2) on the input grid, whose channels are
// a.plane points apart (DI 2: 2 parities a real axis, and a 2D grid's
// leading axis has one fine point, f0 = 0).  A thread takes
// a point of the (axis 1, axis 2) plane and walks axis 0 in chunks of kRows
// rows: every load of a chunk, then its stores, so that the loads are in
// flight together whatever the caller stores.  The caller's functions:
//   load(i, v): v[b] = input component b at grid index i of one component,
//     b < nb (no stores: the loads of several box rows are issued together);
//   keep(i, v): after the loads, v as load gave it at a point i whose base
//     the tile owns (each point of the grid but padding on one tile).
// Ends with a block barrier.
template <typename T, int DI, int NBX, typename Load, typename Keep>
__device__ __forceinline__ void tile_box(const CubeArgs& a, const TileGeo& t, T* sbuf, int nb,
                                         Load&& load, Keep&& keep) {
  constexpr int kRows = 3;
  __syncthreads();
  for (int j = threadIdx.x; j < t.plane; j += blockDim.x) {
    const int f1 = (int)((unsigned)j / (unsigned)t.F[2]);
    const int f2 = j - f1 * t.F[2];
    const int ch12 = DI == 2 ? (f1 & 1) * 2 + (f2 & 1) : 0;
    const int b1 = t.lo[1] + (DI == 2 ? f1 >> 1 : f1), b2 = t.lo[2] + (DI == 2 ? f2 >> 1 : f2);
    const int b12 = b1 * a.g[2] + b2;
    const bool own12 = b1 >= t.B0[1] && b1 < t.B0[1] + t.own[1] && b2 >= t.B0[2] &&
                       b2 < t.B0[2] + t.own[2];
    for (int r0 = 0; r0 < t.F[0]; r0 += kRows) {
      int gi[kRows];
      T v[kRows][NBX];
#pragma unroll
      for (int u = 0; u < kRows; ++u) {
        const int f0 = r0 + u;
        const int ch = DI == 2 ? (f0 & 1) * 4 + ch12 : 0;
        gi[u] = ch * a.plane + (t.lo[0] + (DI == 2 ? f0 >> 1 : f0)) * a.g[1] * a.g[2] + b12;
        if (f0 < t.F[0]) load(gi[u], v[u]);
      }
#pragma unroll
      for (int u = 0; u < kRows; ++u) {
        const int f0 = r0 + u;
        if (f0 >= t.F[0]) break;
        const int b0 = t.lo[0] + (DI == 2 ? f0 >> 1 : f0);
#pragma unroll
        for (int b = 0; b < NBX; ++b)
          if (b < nb) sbuf[b * t.boxpts + f0 * t.plane + j] = v[u][b];
        if (own12 && b0 >= t.B0[0] && b0 < t.B0[0] + t.own[0]) keep(gi[u], v[u]);
      }
    }
  }
  __syncthreads();
}

// Cube tid = (cl0 ncu1 + cl1) ncu2 + cl2 of the tile (tid < t.ncubes): its
// coordinates, by 32-bit divisions.
__device__ __forceinline__ void tile_cube(const TileGeo& t, int tid, int (&cl)[3]) {
  const int q = (int)((unsigned)tid / (unsigned)t.ncu[2]);
  cl[2] = tid - q * t.ncu[2];
  cl[0] = (int)((unsigned)q / (unsigned)t.ncu[1]);
  cl[1] = q - cl[0] * t.ncu[1];
}

// Offset in the box of slot ti of a degree-D cube of NL slots, from the
// cube's base (the last axis's digit fastest).
template <int D, int NL>
__device__ __forceinline__ int tile_slot(const TileGeo& t, int ti) {
  constexpr int S = D + 1;
  const int t0 = NL == S * S * S ? ti / (S * S) : 0, t1 = (ti / S) % S, t2 = ti % S;
  return t0 * t.plane + t1 * t.F[2] + t2;
}

// Phase 2, after phase 1's block barrier: owned output point j = ((ch t0 +
// l0) t1 + l1) t2 + l2 of the tile (output degree DO, 1 or 2, of a
// D-dimensional grid) sums its cubes' staged values sbuf[(b NLO + to)
// ncubes + cube], b < nb, in cube_visit's order, and hands them to store(i,
// acc, pad) (0 at padding, pad true there).
template <typename T, int NLO, int NBX, int D, int DO, typename Store>
__device__ __forceinline__ void tile_sum(const CubeArgs& a, const TileGeo& t, const T* sbuf,
                                         int nb, Store&& store) {
  CubeArgs v = a;  // the tile's cubes, so that cube_visit gives local cube indices
#pragma unroll
  for (int k = 0; k < 3; ++k) v.c[k] = t.ncu[k];
  constexpr int nch = DO == 2 ? 1 << D : 1;  // the output's parity channels
  const int nown = nch * a.tile[0] * a.tile[1] * a.tile[2];
  for (int j = threadIdx.x; j < nown; j += blockDim.x) {
    CubePoint q;
    int l[3];
    unsigned r = (unsigned)j;
#pragma unroll
    for (int k = 2; k >= 0; --k) {
      const unsigned s = fast_quo(r, a.div_tile[k]);
      l[k] = (int)(r - s * (unsigned)a.tile[k]);
      r = s;
    }
    if (l[0] >= t.own[0] || l[1] >= t.own[1] || l[2] >= t.own[2]) continue;
    const int ch = (int)r;
    unsigned c = r;
#pragma unroll
    for (int k = 2; k >= 0; --k) {
      const bool split = DO == 2 && (D == 3 || k > 0);
      q.p[k] = split ? (int)(c & 1u) : 0;
      if (split) c >>= 1;
    }
#pragma unroll
    for (int k = 0; k < 3; ++k) q.b[k] = t.B0[k] + l[k] - t.lo[k];
    T acc[NBX];
#pragma unroll
    for (int b = 0; b < NBX; ++b) acc[b] = T(0);
    bool pad = true;
    cube_visit(v, q, [&](int to, int cube, int) {
      pad = false;
#pragma unroll
      for (int b = 0; b < NBX; ++b)
        if (b < nb) acc[b] += sbuf[(b * NLO + to) * t.ncubes + cube];
    });
    store(ch * a.plane + ((t.B0[0] + l[0]) * a.g[1] + t.B0[1] + l[1]) * a.g[2] + t.B0[2] + l[2],
          acc, pad);
  }
}

// Tile (i0, i1, i2) of y_b = sum_c P_c^T C P_c x_b for b < nb (NB > 0: nb
// fixed at compile time; 0: a.nbo), NL = 27 (3D) or 9 (2D) slots of the P2
// cube, C staged in smat by tile_stage, sbuf the tile's buffer (tile_smem
// past the matrix).  Every thread of the block calls it, with blockDim.x >=
// the tile's cubes.  The caller's functions: tile_box's load and keep, and
//   dot(d): after phase 1, on the thread of each cube whose base point the
//     tile owns (each cube of the grid on one tile), d[b] = x_c . (C x_c),
//     x_c the cube's inputs of component b (K4's pAp, cube by cube);
//   store(i, acc, pad): tile_sum's.
template <typename T, int NL, int NB, typename Load, typename Keep, typename Dot, typename Store>
__device__ __forceinline__ void tile_product(const CubeArgs& a, const T* smat, T* sbuf, int i0,
                                             int i1, int i2, Load&& load, Keep&& keep, Dot&& dot,
                                             Store&& store) {
  constexpr int LD = tile_ld<T>(NL);
  constexpr int NBX = NB > 0 ? NB : kMaxBatch;
  constexpr int V = 16 / sizeof(T);
  const int nb = NB > 0 ? NB : a.nbo;
  constexpr int D = NL == 27 ? 3 : 2;
  const TileGeo t = tile_geo<2, D>(a, i0, i1, i2);
  tile_box<T, 2, NBX>(a, t, sbuf, nb, load, keep);

  // phase 1: thread tid owns local cube tid
  const int tid = threadIdx.x;
  const bool mine = tid < t.ncubes;
  bool base_owned = false;  // the cube's base point is the tile's
  T xin[NBX][NL];
  if (mine) {
    int cl[3];
    tile_cube(t, tid, cl);
    base_owned = t.lo[0] + cl[0] >= t.B0[0] && t.lo[1] + cl[1] >= t.B0[1] &&
                 t.lo[2] + cl[2] >= t.B0[2];
    const T* bx = sbuf + 2 * (cl[0] * t.plane + cl[1] * t.F[2] + cl[2]);
#pragma unroll
    for (int ti = 0; ti < NL; ++ti) {
      const int off = tile_slot<2, NL>(t, ti);
#pragma unroll
      for (int b = 0; b < NBX; ++b) xin[b][ti] = b < nb ? bx[b * t.boxpts + off] : T(0);
    }
  }
  __syncthreads();  // the box is read: the stage overwrites it
  if (mine) {
#pragma unroll 1
    for (int to = 0; to < NL; ++to) {
      T acc[NBX];
#pragma unroll
      for (int b = 0; b < NBX; ++b) acc[b] = T(0);
      const typename Vec16<T>::type* mr =
          reinterpret_cast<const typename Vec16<T>::type*>(smat + to * LD);
#pragma unroll
      for (int t4 = 0; t4 < LD / V; ++t4) {
        const typename Vec16<T>::type m = mr[t4];
#pragma unroll
        for (int u = 0; u < V; ++u) {
          const int ti = t4 * V + u;
          if (ti < NL) {
            const T c = Vec16<T>::get(m, u);
#pragma unroll
            for (int b = 0; b < NBX; ++b)
              if (NB > 0 || b < nb) acc[b] = tile_fma(c, xin[b][ti], acc[b]);
          }
        }
      }
#pragma unroll
      for (int b = 0; b < NBX; ++b)
        if (b < nb) sbuf[(b * NL + to) * t.ncubes + tid] = acc[b];
    }
    if (base_owned) {
      // x_c . (C x_c) from the thread's own staged outputs, the slots
      // unrolled (xin indexed at run time would leave the registers)
      T dots[NBX];
#pragma unroll
      for (int b = 0; b < NBX; ++b) dots[b] = T(0);
#pragma unroll
      for (int to = 0; to < NL; ++to)
#pragma unroll
        for (int b = 0; b < NBX; ++b)
          if (b < nb)
            dots[b] = tile_fma(xin[b][to], sbuf[(b * NL + to) * t.ncubes + tid], dots[b]);
      dot(dots);
    }
  }
  __syncthreads();
  tile_sum<T, NL, NBX, D, 2>(a, t, sbuf, nb, store);
}

// Tile (i0, i1, i2) of K6 (kDiv false: r_g = sum_c P_c^T C_g P_c p for g <
// D, p on the P1 grid, r on the P2 grid) or K7 (kDiv true: b2 = sum_c P_c^T
// sum_g C_g^T P_c u_g, u of D components on the P2 grid, b2 on the P1 grid)
// on a D-dimensional grid, C_all (D, nl_v, nl_q) staged in smat as D nl_v
// rows of tile_ld(nl_q) by tile_stage, sbuf the tile's buffer past it.  The
// caller's load and store as tile_product's, with D components on the P2
// side and one on the P1 side.
template <typename T, int D, bool kDiv, typename Load, typename Store>
__device__ __forceinline__ void tile_mixed(const CubeArgs& a, const T* smat, T* sbuf, int i0,
                                           int i1, int i2, Load&& load, Store&& store) {
  constexpr int NLV = D == 3 ? 27 : 9, NLQ = D == 3 ? 8 : 4;
  constexpr int LD = tile_ld<T>(NLQ);
  constexpr int V = 16 / sizeof(T);
  using Vec = typename Vec16<T>::type;
  constexpr int DI = kDiv ? 2 : 1;
  const TileGeo t = tile_geo<DI, D>(a, i0, i1, i2);
  tile_box<T, DI, kDiv ? D : 1>(a, t, sbuf, kDiv ? D : 1, load, [](int, const auto&) {});
  const int tid = threadIdx.x;
  const bool mine = tid < t.ncubes;
  int cl[3] = {0, 0, 0};
  if (mine) tile_cube(t, tid, cl);
  const T* bx = sbuf + DI * (cl[0] * t.plane + cl[1] * t.F[2] + cl[2]);
  if constexpr (kDiv) {
    // the cube's NLQ outputs: each over the components in order and, in
    // each, the NLV input slots in order, read from the box
    T acc[NLQ];
#pragma unroll
    for (int to = 0; to < NLQ; ++to) acc[to] = T(0);
    if (mine) {
#pragma unroll
      for (int g = 0; g < D; ++g)
#pragma unroll
        for (int ti = 0; ti < NLV; ++ti) {
          const T x = bx[g * t.boxpts + tile_slot<2, NLV>(t, ti)];
          const Vec* mr = reinterpret_cast<const Vec*>(smat + (g * NLV + ti) * LD);
#pragma unroll
          for (int t4 = 0; t4 < LD / V; ++t4) {
            const Vec m = mr[t4];
#pragma unroll
            for (int u = 0; u < V; ++u)
              if (t4 * V + u < NLQ)
                acc[t4 * V + u] = tile_fma(Vec16<T>::get(m, u), x, acc[t4 * V + u]);
          }
        }
    }
    __syncthreads();  // the box is read: the stage overwrites it
    if (mine)
#pragma unroll
      for (int to = 0; to < NLQ; ++to) sbuf[to * t.ncubes + tid] = acc[to];
    __syncthreads();
    tile_sum<T, NLQ, 1, D, 1>(a, t, sbuf, 1, store);
  } else {
    // the cube's NLQ inputs in registers; each output slot of each
    // component sums them in slot order
    T xin[NLQ];
#pragma unroll
    for (int ti = 0; ti < NLQ; ++ti) xin[ti] = mine ? bx[tile_slot<1, NLQ>(t, ti)] : T(0);
    __syncthreads();  // the box is read: the stage overwrites it
    if (mine) {
#pragma unroll 1
      for (int to = 0; to < NLV; ++to) {
        T acc[D];
#pragma unroll
        for (int g = 0; g < D; ++g) {
          acc[g] = T(0);
          const Vec* mr = reinterpret_cast<const Vec*>(smat + (g * NLV + to) * LD);
#pragma unroll
          for (int t4 = 0; t4 < LD / V; ++t4) {
            const Vec m = mr[t4];
#pragma unroll
            for (int u = 0; u < V; ++u)
              if (t4 * V + u < NLQ)
                acc[g] = tile_fma(Vec16<T>::get(m, u), xin[t4 * V + u], acc[g]);
          }
        }
#pragma unroll
        for (int g = 0; g < D; ++g) sbuf[(g * NLV + to) * t.ncubes + tid] = acc[g];
      }
    }
    __syncthreads();
    tile_sum<T, NLV, D, D, 2>(a, t, sbuf, D, store);
  }
}

// ---------------------------------------------------------------------------
// The P1 stencil tile (K1's non-MG modes and K4 on the P1 cube, krylov_ops.cu)
// ---------------------------------------------------------------------------
//
// On the P1 cube (one parity channel, 2^d slots) a point's row of the
// operator is a 3^d-point stencil:
//
//     (A x)_i = sum_e S_cls(i)[e] x_(i+e),   e in {-1, 0, 1}^d,
//     S_cls[e] = sum over the cubes b - delta that exist of C[delta][delta + e]
//               (delta, delta + e in {0, 1}^d),
//
// and which cubes exist is decided axis by axis (b_k = 0: delta_k = 0 only;
// b_k = n_k: delta_k = 1 only; else both), so 3^d classes of 3^d
// coefficients (729 values in 3D) cover every point.  stencil_stage builds
// them from C in shared memory (each summed in double over delta in C-order,
// then rounded once), and a point sums its neighbours in e's C-order with
// explicit fmas: a point's value does not depend on the block or tile that
// computes it.  That lets K1 recompute a neighbouring tile's points in a halo
// and get the owner's bits.
//
// A block owns a tile of t0 x t1 x t2 points (3D form; a 2D grid's leading
// axis has one) and holds a box of H halo layers around it in shared memory,
// B_k = t_k + 2H points an axis on a real axis, without clipping at the grid's
// edge.  Region j of a tile is its owned points and j layers round them;
// stencil_region walks a region's points that lie on the grid (a thread a
// point, the extents' divisions by multiply-and-shift constants of the plan)
// and the box points outside the grid, which a caller zero-fills so that a
// stencil at the edge reads zeros there (their coefficients are 0).  A
// stencil on region j reads region j + 1, so a box of H layers carries H
// products one after another without a grid barrier.  A block reads each
// input once a tile, and a product costs 3^d fmas and shared-memory loads a
// point, where the point-by-point product (cube_point) loaded 2^d inputs for
// each of its <= 2^d cubes from global memory.

constexpr int kStencilHalo = 8;  // the widest halo a plan takes

struct StencilPlan {
  int t[3];                      // points a tile owns per axis (3D form)
  int ntile[3];                  // tiles per axis
  FastDiv div_ntile[3];
  int H;                         // halo layers of the box
  int box[3];                    // t + 2H on a real axis, 1 on a 2D grid's leading axis
  int boxpts;
  FastDiv div_e1[kStencilHalo + 1], div_e2[kStencilHalo + 1];  // region j's extents, axes 1, 2
};

__host__ __device__ constexpr int stencil_len(int d) { return d == 3 ? 27 : 9; }

// Bytes of the coefficients of stencil_stage: 3^d classes of tile_ld(3^d)
// values (a class's row in whole 16-byte loads).
template <typename T>
__host__ __device__ inline size_t stencil_table_bytes(int d) {
  return sizeof(T) * stencil_len(d) * tile_ld<T>(stencil_len(d));
}

// Set a plan of tile t (3D form) and halo H on the grid of a (g, c).  False
// where the tile does not fit the grid's form or H is out of range.
inline bool stencil_set(const CubeArgs& a, const int (&t)[3], int H, StencilPlan& s) {
  if (H < 1 || H > kStencilHalo) return false;
  s.H = H;
  s.boxpts = 1;
  for (int k = 0; k < 3; ++k) {
    const bool real = a.g[k] > 1;
    if (t[k] < 1 || (!real && t[k] != 1)) return false;
    s.t[k] = t[k];
    s.ntile[k] = (a.g[k] + t[k] - 1) / t[k];
    s.div_ntile[k] = fast_div(s.ntile[k]);
    s.box[k] = real ? t[k] + 2 * H : 1;
    s.boxpts *= s.box[k];
  }
  for (int j = 0; j <= kStencilHalo; ++j) {
    s.div_e1[j] = fast_div(a.g[1] > 1 ? t[1] + 2 * j : 1);
    s.div_e2[j] = fast_div(a.g[2] > 1 ? t[2] + 2 * j : 1);
  }
  return true;
}

// Choose and set a plan of halo H: the first candidate tile whose bytes(plan)
// of shared memory a block let `blocks` blocks share an SM of the current
// device.  3D: 4 x 8 x 8 (256 points, a thread each), then smaller ones for
// wide halos or float64; 2D: 1 x 16 x 16 and smaller.  False where none fits
// or the device cannot be asked.
template <typename Bytes>
inline bool stencil_pick(const CubeArgs& a, int blocks, int H, Bytes&& bytes, StencilPlan& s) {
  constexpr int k3[5][3] = {{4, 8, 8}, {4, 4, 8}, {2, 4, 8}, {2, 4, 4}, {1, 2, 4}};
  constexpr int k2[4][3] = {{1, 16, 16}, {1, 8, 16}, {1, 8, 8}, {1, 4, 8}};
  int dev = 0, per_sm = 0, reserved = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&per_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev) !=
          cudaSuccess ||
      cudaDeviceGetAttribute(&reserved, cudaDevAttrReservedSharedMemoryPerBlock, dev) !=
          cudaSuccess)
    return false;
  const size_t fit = (size_t)(per_sm / blocks - reserved);
  const bool three = a.g[0] > 1;
  for (int i = 0; i < (three ? 5 : 4); ++i)
    if (stencil_set(a, three ? k3[i] : k2[i], H, s) && bytes(s) <= fit) return true;
  return false;
}

// Block-cooperative: the 3^d classes' coefficients S[cls LD + e] of the
// constant P1 cube matrix C (2^d, 2^d), cls and e with the last axis's digit
// fastest, each class's row zero-padded to LD = tile_ld(3^d).  The caller
// synchronises the block before use.
template <typename T, int D>
__device__ void stencil_stage(const T* C, T* S) {
  constexpr int NE = D == 3 ? 27 : 9, NL = 1 << D, LD = tile_ld<T>(NE);
  for (int idx = threadIdx.x; idx < NE * LD; idx += blockDim.x) {
    const int cls = idx / LD, e = idx - cls * LD;
    double acc = 0.0;
    for (int dl = 0; dl < NL; ++dl) {  // delta, the last axis's bit lowest
      bool ok = true;
      int ti = 0, pc = NE / 3;
      for (int k = 0; k < D; ++k, pc /= 3) {
        const int dk = (dl >> (D - 1 - k)) & 1;
        const int ck = cls / pc % 3, sk = dk + e / pc % 3 - 1;
        ok = ok && !(ck == 0 && dk == 1) && !(ck == 2 && dk == 0) && sk >= 0 && sk <= 1;
        ti = 2 * ti + sk;
      }
      if (ok && e < NE) acc += (double)C[dl * NL + ti];
    }
    S[idx] = (T)acc;
  }
}

// Tile tt (C-order over the plan's tiles): its first owned point per axis.
__device__ __forceinline__ void stencil_tile(const StencilPlan& s, int tt, int (&B0)[3]) {
  const int q = (int)fast_quo((unsigned)tt, s.div_ntile[2]);
  const int i0 = (int)fast_quo((unsigned)q, s.div_ntile[1]);
  B0[0] = i0 * s.t[0];
  B0[1] = (q - i0 * s.ntile[1]) * s.t[1];
  B0[2] = (tt - q * s.ntile[2]) * s.t[2];
}

// Region j of the tile at B0: its extents, its first grid point and the
// offset of its first point in the box, per axis (3D form).
struct StencilRegion {
  int e[3], lo[3], off[3], np, j;
};

template <int D>
__device__ __forceinline__ StencilRegion stencil_extent(const StencilPlan& s, const int (&B0)[3],
                                                        int j) {
  StencilRegion r;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const bool real = D == 3 || k > 0;
    r.e[k] = real ? s.t[k] + 2 * j : 1;
    r.lo[k] = real ? B0[k] - j : 0;
    r.off[k] = real ? s.H - j : 0;
  }
  r.np = r.e[0] * r.e[1] * r.e[2];
  r.j = j;
  return r;
}

// Point q (< r.np) of region r: its grid index i (-1 outside the grid), its
// index l in the box, its coefficients' class and whether the tile owns it.
template <int D>
__device__ __forceinline__ void stencil_point(const CubeArgs& a, const StencilPlan& s,
                                              const int (&B0)[3], const StencilRegion& r, int q,
                                              int& i, int& l, int& cls, bool& own) {
  const unsigned q01 = fast_quo((unsigned)q, s.div_e2[r.j]);
  const unsigned q0 = fast_quo(q01, s.div_e1[r.j]);
  const int fc[3] = {(int)q0, (int)(q01 - q0 * (unsigned)r.e[1]),
                     (int)((unsigned)q - q01 * (unsigned)r.e[2])};
  int gi[3];
  bool in = true;
  own = true;
  cls = 0;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    gi[k] = r.lo[k] + fc[k];
    in = in && gi[k] >= 0 && gi[k] < a.g[k];
    own = own && gi[k] >= B0[k] && gi[k] < B0[k] + s.t[k];
    if (D == 3 || k > 0) cls = 3 * cls + (gi[k] == 0 ? 0 : gi[k] == a.c[k] ? 2 : 1);
  }
  own = own && in;
  l = ((fc[0] + r.off[0]) * s.box[1] + fc[1] + r.off[1]) * s.box[2] + fc[2] + r.off[2];
  i = in ? (gi[0] * a.g[1] + gi[1]) * a.g[2] + gi[2] : -1;
}

// f(i, l, cls, own) for each point of region j of the tile at B0 (a thread a
// point): i its grid index (-1 outside the grid), l its index in the box,
// cls its coefficients' class, own whether the tile owns it.
template <int D, typename F>
__device__ __forceinline__ void stencil_region(const CubeArgs& a, const StencilPlan& s,
                                               const int (&B0)[3], int j, F&& f) {
  const StencilRegion r = stencil_extent<D>(s, B0, j);
  for (int q = threadIdx.x; q < r.np; q += blockDim.x) {
    int i, l, cls;
    bool own;
    stencil_point<D>(a, s, B0, r, q, i, l, cls, own);
    f(i, l, cls, own);
  }
}

// A box load: the points of region j, U a thread a round, with fetch(i,
// own) (global loads only, returning a value type) for each of a round's
// points on the grid, then put(i, l, own, v) for each of them (i -1 and v
// value-initialised outside the grid): a round's loads are in flight
// together whatever put stores.
template <int D, int U, typename Fetch, typename Put>
__device__ __forceinline__ void stencil_load(const CubeArgs& a, const StencilPlan& s,
                                             const int (&B0)[3], int j, Fetch&& fetch, Put&& put) {
  using V = decltype(fetch(0, false));
  const StencilRegion r = stencil_extent<D>(s, B0, j);
  for (int q0 = threadIdx.x; q0 < r.np; q0 += U * blockDim.x) {
    int i[U], l[U];
    bool own[U];
    V v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int q = q0 + u * (int)blockDim.x;
      int cls;
      i[u] = -1;
      own[u] = false;
      l[u] = 0;
      if (q < r.np) stencil_point<D>(a, s, B0, r, q, i[u], l[u], cls, own[u]);
      v[u] = i[u] >= 0 ? fetch(i[u], own[u]) : V{};
    }
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (q0 + u * (int)blockDim.x < r.np) put(i[u], l[u], own[u], v[u]);
  }
}

// A small value type for stencil_load's fetch.
template <typename T, int N>
struct Vals {
  T v[N];
};

// acc[b] = (A x_b) at box point l of class cls, b < nb: x_b at box[b boxpts
// + ...], the neighbours in e's C-order, explicit fmas.
template <typename T, int D, int NBX>
__device__ __forceinline__ void stencil_apply(const T* S, int cls, const T* box,
                                              const StencilPlan& s, int l, int nb,
                                              T (&acc)[NBX]) {
  constexpr int NE = D == 3 ? 27 : 9, LD = tile_ld<T>(NE), V = 16 / sizeof(T);
  using Vec = typename Vec16<T>::type;
  const Vec* c = reinterpret_cast<const Vec*>(S + cls * LD);  // the class's row, 16 bytes a load
#pragma unroll
  for (int b = 0; b < NBX; ++b) acc[b] = T(0);
#pragma unroll
  for (int t4 = 0; t4 < LD / V; ++t4) {
    const Vec m = c[t4];
#pragma unroll
    for (int w = 0; w < V; ++w) {
      const int u = t4 * V + w;
      if (u < NE) {
        const int e0 = D == 3 ? u / 9 - 1 : 0, e1 = u / 3 % 3 - 1, e2 = u % 3 - 1;
        const T coef = Vec16<T>::get(m, w);
        const int o = l + (e0 * s.box[1] + e1) * s.box[2] + e2;
#pragma unroll
        for (int b = 0; b < NBX; ++b)
          if (b < nb) acc[b] = tile_fma(coef, box[b * s.boxpts + o], acc[b]);
      }
    }
  }
}

// (A x) at a point of class cls whose neighbour at offset (e0, e1, e2) is
// x(e0, e1, e2): stencil_apply's sum for one vector, in its order with its
// fmas (K1 MG's levels below the whole grid).  An offset beyond the grid has
// coefficient 0, so x may return any finite value there.
template <typename T, int D, typename X>
__device__ __forceinline__ T stencil_sum(const T* S, int cls, X&& x) {
  constexpr int NE = D == 3 ? 27 : 9, LD = tile_ld<T>(NE), V = 16 / sizeof(T);
  using Vec = typename Vec16<T>::type;
  const Vec* c = reinterpret_cast<const Vec*>(S + cls * LD);
  T v[NE];  // every neighbour's load in flight before the sum
#pragma unroll
  for (int u = 0; u < NE; ++u) v[u] = x(D == 3 ? u / 9 - 1 : 0, u / 3 % 3 - 1, u % 3 - 1);
  T acc = T(0);
#pragma unroll
  for (int t4 = 0; t4 < LD / V; ++t4) {
    const Vec m = c[t4];
#pragma unroll
    for (int w = 0; w < V; ++w)
      if (t4 * V + w < NE) acc = tile_fma(Vec16<T>::get(m, w), v[t4 * V + w], acc);
  }
  return acc;
}

}  // namespace oasisx
