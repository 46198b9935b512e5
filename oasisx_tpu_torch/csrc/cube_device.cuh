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
// Form: output-owner, deterministic, no atomics.  The caller owns one
// output grid point (parity p, base b) for every output component.  It sums
// over the <= 2^d cubes b - delta that contain the point (delta_k in {0,1}
// on the axes with p_k == 0; the point is slot t = p + deg*delta of that
// cube), and for each cube over the nl_in input slots, in a fixed order, so
// a run repeats bit for bit.  Each (output slot, cube) pair belongs to
// exactly one output point, so each entry of a per-cube weight array is
// read once per application, for all components together.
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

}  // namespace oasisx
