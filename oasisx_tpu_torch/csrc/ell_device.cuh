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
//
// K14-K17 (EllOp) stop a row at its slice's width: widths[r / 32] is the
// largest slot count among the 32 rows r & ~31 .. r | 31 (a warp's rows:
// every kernel of ell_ops.cu gives a warp 32 consecutive rows starting at a
// multiple of 32, since its blocks start and stride by multiples of 256), so
// the bound is uniform across a warp.  A row's slots past its own length
// hold value 0 and column 0 (build_ell_tables, and the AMG's _to_ell for
// K17's level tables, fill each row's slots from k = 0), so dropping them
// changes no sum: acc starts at +0 and adding
// 0 * x = +-0 leaves it as it is.  The operator is a stream read once per
// product, larger than L2 at the vessel's size, so its values and columns
// are loaded evict-first (__ldcs) and the gathered x keeps its lines in L1
// and L2.  The entry points check K * n < 2^31 (ell_fits): a row and each
// slot's offset fit in int32, and each slot advances the pointers by n.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "grid_reduce.cuh"

namespace oasisx {

constexpr int kEllMaxBatch = 4;  // vectors that share one operator read

constexpr int kEllSlice = 32;  // rows of one width (parallel/graph.py ELL_SLICE): a warp
static_assert(kEllSlice == 1 << 5, "ell_row_batch finds a row's slice by a shift");

// Loads of an ELL table: a stream read once a product (K14-K16: the
// operator does not fit in L2) evict-first (__ldcs); a table read again and
// again in one launch (kReuse: K17's AMG levels and fine operator, a few MB
// in all) through the read-only path, keeping its lines (__ldg: faster for
// K17 at the vessel's N=36 size on an NVIDIA H100 80GB HBM3 at 700 W).
template <typename T, bool kReuse>
__device__ __forceinline__ T ell_load(const T* p) {
  return kReuse ? __ldg(p) : __ldcs(p);
}

// acc[b] = (A x_b)[r] for b < nb, x_b = x + b * xs, over the w slots of
// row r's slice: every slot's value and column are read once for all the
// vectors, and each product is added by an explicit fma, in slot order.
template <typename T, bool kReuse>
__device__ __forceinline__ void ell_row_batch(const T* __restrict__ vals,
                                              const int* __restrict__ cols, int w, int n, int r,
                                              const T* x, int64_t xs, int nb,
                                              T (&acc)[kEllMaxBatch]) {
#pragma unroll
  for (int b = 0; b < kEllMaxBatch; ++b) acc[b] = T(0);
  const T* v = vals + r;
  const int* c = cols + r;
  for (int k = 0; k < w; ++k, v += n, c += n) {
    const T a = ell_load<T, kReuse>(v);
    const int j = ell_load<int, kReuse>(c);
#pragma unroll
    for (int b = 0; b < kEllMaxBatch; ++b) {
      if (b >= nb) break;
      acc[b] = vfma(a, x[b * xs + j], acc[b]);
    }
  }
}

// The same sum for one vector by a warp, every lane getting it (r uniform
// across the warp): the lanes load 4 x 32 slots of the row at a time, the
// values, the columns and the gathered x, and every lane adds the products
// in slot order by explicit fmas, each slot's operands broadcast from its
// lane by shuffles, so the bits are ell_row_batch's.  For a row of hundreds
// of slots (K17's coarse levels: 373-596) a thread's chain of dependent
// loads takes tens of microseconds; the warp keeps 128 of them in flight.
template <typename T, bool kReuse>
__device__ __forceinline__ T ell_row_warp(const T* __restrict__ vals,
                                          const int* __restrict__ cols, int w, int n, int r,
                                          const T* x) {
  const int lane = threadIdx.x & (kEllSlice - 1);
  T acc = T(0);
  for (int base = 0; base < w; base += 4 * kEllSlice) {
    T a[4], xv[4];
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      const int k = base + g * kEllSlice + lane;
      const bool on = k < w;
      a[g] = on ? ell_load<T, kReuse>(vals + k * n + r) : T(0);
      const int j = on ? ell_load<int, kReuse>(cols + k * n + r) : 0;
      xv[g] = on ? x[j] : T(0);
    }
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      const int m = min(kEllSlice, w - base - g * kEllSlice);
#pragma unroll 8
      for (int l = 0; l < m; ++l)
        acc = vfma(__shfl_sync(0xffffffffu, a[g], l), __shfl_sync(0xffffffffu, xv[g], l), acc);
    }
  }
  return acc;
}

// The band-ELL layout (K18; oasisx_tpu_torch/assembly/band.py): rows in
// reverse Cuthill-McKee order, grouped in tiles of kLane, and only the
// (tile, slot) pairs that hold an entry stored.  The pairs of tile rb are
// p = tile_ptr[rb] .. tile_ptr[rb + 1] - 1, in ascending slot order; pair p
// reads the source tile rb + pair_shift[p] at the lanes lanes[p, :]
// (uint8), with the values vals[p, :]:
//
//     y[rb * kLane + j] = sum_p vals[p * kLane + j]
//                                * x[(rb + pair_shift[p]) * kLane + lanes[p * kLane + j]]
//
// Every pair's source tile is in frame (check_pair_tables, where the
// tables are built, raises otherwise).  A
// warp's 32 rows share rb, so the loop bounds and the shift are uniform, and a
// warp reads 128 B of f32 values and 32 B of lanes per pair, coalesced;
// the gathers stay inside one 512 B source tile.  The pairs are summed in
// ascending order; a lane of a pair that holds no entry has value 0 and
// adds 0 * x, exactly 0 for finite x, so the sums equal the (S, R, 128)
// layout's.
constexpr int kLane = 128;
static_assert(kLane == 1 << 7, "band_row_batch splits a row index by shift and mask");

template <typename T>
__device__ __forceinline__ void band_row_batch(const T* __restrict__ vals,
                                               const int* __restrict__ tile_ptr,
                                               const int* __restrict__ pair_shift,
                                               const uint8_t* __restrict__ lanes, int64_t r,
                                               const T* x, int64_t xs, int nb,
                                               T (&acc)[kEllMaxBatch]) {
#pragma unroll
  for (int b = 0; b < kEllMaxBatch; ++b) acc[b] = T(0);
  const int rb = (int)(r >> 7);
  const int j = (int)(r & (kLane - 1));
  const int p1 = __ldg(tile_ptr + rb + 1);
#pragma unroll 4
  for (int p = __ldg(tile_ptr + rb); p < p1; ++p) {
    const int64_t i = (int64_t)p * kLane + j;
    const T v = __ldg(vals + i);
    const int64_t c = (int64_t)(rb + __ldg(pair_shift + p)) * kLane + __ldg(lanes + i);
#pragma unroll
    for (int b = 0; b < kEllMaxBatch; ++b) {
      if (b >= nb) break;
      acc[b] += v * x[b * xs + c];
    }
  }
}

// The operators of the kernels of ell_ops.cu: rows(r, x, xs, nb, acc) sets
// acc[b] = (A x_b)[r] for b < nb, x_b = x + b * xs.
template <typename T, bool kReuse = false>
struct EllOp {
  const T* vals;  // (K, n)
  const int* cols;
  const int* widths;  // (ceil(n / kEllSlice)): each slice's slot count
  int K;
  int n;
  // a width past K is read as K, so a row never reads past its K slots
  __device__ __forceinline__ int width(int64_t r) const { return min(__ldg(widths + (r >> 5)), K); }
  __device__ __forceinline__ void rows(int64_t r, const T* x, int64_t xs, int nb,
                                       T (&acc)[kEllMaxBatch]) const {
    ell_row_batch<T, kReuse>(vals, cols, width(r), n, (int)r, x, xs, nb, acc);
  }
  // (A x)[r] of one vector by the calling warp
  __device__ __forceinline__ T row_warp(int64_t r, const T* x) const {
    return ell_row_warp<T, kReuse>(vals, cols, width(r), n, (int)r, x);
  }
};

template <typename T>
struct BandOp {
  const T* vals;  // (P, kLane)
  const int* tile_ptr;  // (R + 1)
  const int* pair_shift;  // (P)
  const uint8_t* lanes;  // (P, kLane)
  __device__ __forceinline__ void rows(int64_t r, const T* x, int64_t xs, int nb,
                                       T (&acc)[kEllMaxBatch]) const {
    band_row_batch(vals, tile_ptr, pair_shift, lanes, r, x, xs, nb, acc);
  }
};

}  // namespace oasisx
