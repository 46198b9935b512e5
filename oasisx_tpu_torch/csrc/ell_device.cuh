// The ELL and band-ELL row products as device functions, shared by every
// kernel of ell_ops.cu.
//
//     y[r] = sum_k vals[k * n + r] * x[cols[k * n + r]]
//
// vals and cols are (K, n), slot-major: for a fixed slot k, neighbouring
// rows are neighbouring addresses, so one thread per row reads both arrays
// coalesced.  A padded slot holds value 0 and column 0 and adds exactly 0.
// The slots are summed in order k = 0, 1, ..., K-1 (the TPU kernel's order),
// so a run repeats bit for bit.  vals and cols are never written by a
// kernel and go through the read-only path; x may be a vector the calling
// kernel writes between grid barriers, so it is read through a plain
// pointer.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace oasisx {

constexpr int kEllMaxBatch = 4;  // vectors that share one operator read

template <typename T>
__device__ __forceinline__ T ell_row(const T* __restrict__ vals, const int* __restrict__ cols,
                                     int K, int64_t n, int64_t r, const T* x) {
  T acc = T(0);
  for (int k = 0; k < K; ++k) {
    const int64_t i = (int64_t)k * n + r;
    acc += __ldg(vals + i) * x[__ldg(cols + i)];
  }
  return acc;
}

// acc[b] = (A x_b)[r] for b < nb, x_b = x + b * xs: every slot's value and
// column are read once for all the vectors.
template <typename T>
__device__ __forceinline__ void ell_row_batch(const T* __restrict__ vals,
                                              const int* __restrict__ cols, int K, int64_t n,
                                              int64_t r, const T* x, int64_t xs, int nb,
                                              T (&acc)[kEllMaxBatch]) {
#pragma unroll
  for (int b = 0; b < kEllMaxBatch; ++b) acc[b] = T(0);
  for (int k = 0; k < K; ++k) {
    const int64_t i = (int64_t)k * n + r;
    const T v = __ldg(vals + i);
    const int64_t c = __ldg(cols + i);
#pragma unroll
    for (int b = 0; b < kEllMaxBatch; ++b) {
      if (b >= nb) break;
      acc[b] += v * x[b * xs + c];
    }
  }
}

// The band-ELL layout (K18; oasisx_tpu_torch/assembly/band.py): rows in
// reverse Cuthill-McKee order, grouped in tiles of kLane; vals and cols are
// (S, n) slot-major with n = R * kLane, and slot s of row r = rb * kLane + j
// reads the source tile rb + shifts[s] at lane cols[s, r]:
//
//     y[r] = sum_s vals[s * n + r] * x[(rb + shifts[s]) * kLane + cols[s * n + r]]
//
// A source tile outside [0, Rc) reads 0 (the TPU kernel's zero-filled frame;
// every such slot holds value 0).  A warp's rows share one tile, so the
// branch is uniform.  Slots are summed in order s = 0, 1, ..., S-1.
constexpr int kLane = 128;

template <typename T>
__device__ __forceinline__ void band_row_batch(const T* __restrict__ vals,
                                               const int* __restrict__ cols,
                                               const int* __restrict__ shifts, int S,
                                               int64_t n, int Rc, int64_t r, const T* x,
                                               int64_t xs, int nb, T (&acc)[kEllMaxBatch]) {
#pragma unroll
  for (int b = 0; b < kEllMaxBatch; ++b) acc[b] = T(0);
  const int rb = (int)(r / kLane);
  for (int s = 0; s < S; ++s) {
    const int src = rb + __ldg(shifts + s);
    if (src < 0 || src >= Rc) continue;
    const int64_t i = (int64_t)s * n + r;
    const T v = __ldg(vals + i);
    const int64_t c = (int64_t)src * kLane + __ldg(cols + i);
#pragma unroll
    for (int b = 0; b < kEllMaxBatch; ++b) {
      if (b >= nb) break;
      acc[b] += v * x[b * xs + c];
    }
  }
}

// The operators of the kernels of ell_ops.cu: rows(r, x, xs, nb, acc) sets
// acc[b] = (A x_b)[r] for b < nb, x_b = x + b * xs.
template <typename T>
struct EllOp {
  const T* vals;  // (K, n)
  const int* cols;
  int K;
  int64_t n;
  __device__ __forceinline__ void rows(int64_t r, const T* x, int64_t xs, int nb,
                                       T (&acc)[kEllMaxBatch]) const {
    ell_row_batch(vals, cols, K, n, r, x, xs, nb, acc);
  }
};

template <typename T>
struct BandOp {
  const T* vals;  // (S, n), n = R * kLane
  const int* cols;
  const int* shifts;  // (S)
  int S, Rc;
  int64_t n;
  __device__ __forceinline__ void rows(int64_t r, const T* x, int64_t xs, int nb,
                                       T (&acc)[kEllMaxBatch]) const {
    band_row_batch(vals, cols, shifts, S, n, Rc, r, x, xs, nb, acc);
  }
};

}  // namespace oasisx
