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
// Inputs that a kernel writes itself between grid barriers are read through
// plain pointers (no __restrict__), so the compiler keeps them off the
// non-coherent read-only path.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace oasisx {

constexpr int kMaxBatch = 4;  // output components per application
constexpr int kThreads = 256;  // threads per block, every kernel

struct CubeArgs {
  int d;
  int n[3];            // cells per axis
  int deg_out, deg_in;
  int nl_out, nl_in;
  int64_t npad_out;    // grid size of one output component
  int64_t plane_in;    // prod(n_k + 1): one parity channel of the input grid
  int nbo;             // output components
  int nbi;             // input components summed into each output component
  int64_t x_bo, x_bi;  // input strides per output / input component
  int64_t m_bo, m_bi, m_to, m_ti, m_cube;  // matrix strides
  int mat_len;         // > 0: the matrix is constant, staged in shared memory
};

__device__ __forceinline__ unsigned char* dynamic_smem() {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  return smem_raw;
}

// Block-cooperative: copy a constant matrix (a.mat_len > 0) into smat and the
// grid offset of every input slot relative to its cube's base into soff.
// The caller synchronises the block before use.
template <typename T>
__device__ void cube_stage(const T* mat, const CubeArgs& a, T* smat, int* soff) {
  for (int i = threadIdx.x; i < a.mat_len; i += blockDim.x) smat[i] = mat[i];
  for (int ti = threadIdx.x; ti < a.nl_in; ti += blockDim.x) {
    int digit[3];
    int rem = ti;
    for (int k = a.d - 1; k >= 0; --k) {
      digit[k] = rem % (a.deg_in + 1);
      rem /= (a.deg_in + 1);
    }
    int ch = 0, boff = 0;
    for (int k = 0; k < a.d; ++k) {
      ch = ch * a.deg_in + digit[k] % a.deg_in;
      boff = boff * (a.n[k] + 1) + digit[k] / a.deg_in;
    }
    soff[ti] = (int)(ch * a.plane_in) + boff;
  }
}

// The output side of every cube operator: calls f(to, cube, cbase) for each
// of the <= 2^d cubes that contain output grid point idx, in one fixed order
// (the delta bits in C-order, as cubes.cube_scatter sums them).  `to` is the
// point's slot in that cube, `cube` the cube's index (C-order over the
// cells) and `cbase` the offset of the cube's base in one input channel.
// Returns false, calling nothing, at a padding position.
template <typename F>
__device__ __forceinline__ bool cube_visit(const CubeArgs& a, int64_t idx, F&& f) {
  int b[3], p[3];
  int64_t rem = idx;
  for (int k = a.d - 1; k >= 0; --k) {
    b[k] = (int)(rem % (a.n[k] + 1));
    rem /= (a.n[k] + 1);
  }
  int ch = (int)rem;
  bool valid = true;
  for (int k = a.d - 1; k >= 0; --k) {
    p[k] = ch % a.deg_out;
    ch /= a.deg_out;
    if (p[k] > 0 && b[k] == a.n[k]) valid = false;
  }
  if (!valid) return false;

  for (int dm = 0; dm < (1 << a.d); ++dm) {
    bool ok = true;
    int to = 0, cbase = 0;
    int64_t cube = 0;
    for (int k = 0; k < a.d; ++k) {
      const int dk = (dm >> (a.d - 1 - k)) & 1;
      const int c = b[k] - dk;
      if ((dk && p[k] != 0) || c < 0 || c >= a.n[k]) {
        ok = false;
        break;
      }
      to = to * (a.deg_out + 1) + p[k] + a.deg_out * dk;
      cube = cube * a.n[k] + c;
      cbase = cbase * (a.n[k] + 1) + c;
    }
    if (ok) f(to, cube, cbase);
  }
  return true;
}

// acc[bo] = (A x)_bo at output grid point idx, for bo < a.nbo; 0 at padding.
// M is the staged matrix (a.mat_len > 0) or the matrix in global memory.
// kPm: the input is pm * x, pm laid out as x (K3's premul; K5 form only).
template <typename T, bool kPm = false>
__device__ __forceinline__ void cube_point(const T* x, const T* M, const int* soff,
                                           const CubeArgs& a, int64_t idx,
                                           T (&acc)[kMaxBatch], const T* pm = nullptr) {
#pragma unroll
  for (int bo = 0; bo < kMaxBatch; ++bo) acc[bo] = T(0);
  cube_visit(a, idx, [&](int to, int64_t cube, int cbase) {
    const T* mc = M + to * a.m_to + cube * a.m_cube;
    for (int ti = 0; ti < a.nl_in; ++ti) {
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
    }
  });
}

// y[bo * npad_out + idx] = (A x)_bo for idx = first, first + stride, ...;
// kPm, kZm: y = zm * A (pm * x), pm laid out as x and zm as y.
template <typename T, bool kPm = false, bool kZm = false>
__device__ void cube_apply_range(const T* x, const T* M, const int* soff, const CubeArgs& a,
                                 T* y, int64_t first, int64_t stride, const T* pm = nullptr,
                                 const T* zm = nullptr) {
  for (int64_t idx = first; idx < a.npad_out; idx += stride) {
    T acc[kMaxBatch];
    cube_point<T, kPm>(x, M, soff, a, idx, acc, pm);
#pragma unroll
    for (int bo = 0; bo < kMaxBatch; ++bo)
      if (bo < a.nbo) {
        const int64_t i = bo * a.npad_out + idx;
        y[i] = kZm ? zm[i] * acc[bo] : acc[bo];
      }
  }
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
  a.npad_out = grid_points(d, a.n, deg_out);
  a.plane_in = grid_points(d, a.n, 1);
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
  int64_t ncube = 1;
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
