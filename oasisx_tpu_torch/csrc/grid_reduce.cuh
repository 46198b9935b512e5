// Deterministic grid-wide reductions and the cooperative launch, shared by
// the whole-solve kernels of krylov_ops.cu and ell_ops.cu.
//
// A whole-solve kernel runs as many blocks as fit on the card at once
// (cudaLaunchCooperativeKernel); its phases are grid-stride loops separated
// by grid barriers (cooperative_groups grid_group::sync, no -rdc needed
// since CUDA 11).  Reductions give the same bits on every block: each block
// sums its threads' partial sums in a fixed tree, writes the result to its
// own slot, and after the barrier every block sums all slots in the same
// fixed order.  So every block takes the same branch of a loop condition (a
// block that saw another decision would deadlock the grid), no
// floating-point atomics are used, and a run repeats bit for bit.  The slot
// arrays alternate between two halves, so a block that runs ahead into the
// next reduction never overwrites slots another block is still reading.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace oasisx {

namespace cg = cooperative_groups;

constexpr int kRedThreads = 256;  // threads per block of every whole-solve kernel
constexpr int kMaxRed = 8;        // values reduced together

__device__ __forceinline__ float vsqrt(float v) { return sqrtf(v); }
__device__ __forceinline__ double vsqrt(double v) { return sqrt(v); }
__device__ __forceinline__ float vfma(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ double vfma(double a, double b, double c) { return fma(a, b, c); }

template <typename T>
__device__ __forceinline__ T nz(T v) {
  return v != T(0) ? v : T(1);
}

__host__ __device__ inline size_t align16(size_t n) { return (n + 15) & ~size_t(15); }

// Deterministic block sum of N values (blockDim.x == kRedThreads); every
// thread gets the sums.  sred holds N * kRedThreads values.
template <int N, typename T>
__device__ void block_sum(T* v, T* sred) {
  __syncthreads();  // the previous reduction's readers are done
  for (int i = 0; i < N; ++i) sred[i * kRedThreads + threadIdx.x] = v[i];
  __syncthreads();
  for (int s = kRedThreads / 2; s > 0; s >>= 1) {
    if ((int)threadIdx.x < s)
      for (int i = 0; i < N; ++i)
        sred[i * kRedThreads + threadIdx.x] += sred[i * kRedThreads + threadIdx.x + s];
    __syncthreads();
  }
  for (int i = 0; i < N; ++i) v[i] = sred[i * kRedThreads];
}

template <typename T>
struct Reducer {
  T* slots;  // 2 * kMaxRed * gridDim.x, global
  T* sred;   // kMaxRed * kRedThreads, shared
  int half;
};

// Sum N values over the whole grid; a grid barrier.  Every block returns the
// same bits.
template <int N, typename T>
__device__ void grid_sum(Reducer<T>& red, T* v) {
  block_sum<N>(v, red.sred);
  T* slot = red.slots + (size_t)red.half * kMaxRed * gridDim.x;
  red.half ^= 1;
  if (threadIdx.x == 0)
    for (int i = 0; i < N; ++i) slot[i * gridDim.x + blockIdx.x] = v[i];
  cg::this_grid().sync();
  for (int i = 0; i < N; ++i) {
    T s = T(0);
    for (int b = threadIdx.x; b < (int)gridDim.x; b += blockDim.x) s += slot[i * gridDim.x + b];
    v[i] = s;
  }
  block_sum<N>(v, red.sred);
}

// A barrier among the first nb blocks of a cooperative grid (every block is
// resident, so a spin cannot deadlock): bar[0] counts the arrivals, bar[1]
// is the generation, both in global memory, neither shared with the
// reduction slots.  Thread 0 of a block reads the generation, releases the
// block's writes (the fence) and arrives; the last to arrive resets the
// count and advances the generation, the others spin until it moves, then
// acquire (the fence).  The kernel sets bar[0] = 0 before its first grid
// barrier; each barrier leaves it 0 again.  The generation may start at
// any value.
__device__ __forceinline__ void sub_sync(unsigned* bar, unsigned nb) {
  __syncthreads();
  if (threadIdx.x == 0) {
    volatile unsigned* gen = bar + 1;
    const unsigned g = *gen;
    __threadfence();
    if (atomicAdd(bar, 1u) == nb - 1) {
      atomicExch(bar, 0u);
      __threadfence();
      atomicAdd(bar + 1, 1u);
    } else {
      while (*gen == g) {
      }
    }
    __threadfence();
  }
  __syncthreads();
}

template <typename T>
__device__ __forceinline__ void zero(T* v) {
#pragma unroll
  for (int i = 0; i < kMaxRed; ++i) v[i] = T(0);
}

// Cooperative launch of one block per kRedThreads points of `work`, at most
// as many blocks as fit on the card at once, and at most per_sm_cap an SM
// when it is > 0 (a kernel's launch bound: then the grid, and with it the
// order of every reduction, does not depend on the registers the compiler
// assigns); refuses (returns an error) rather than launching a grid that
// cannot be resident, one larger than the caller's reduction slots
// (max_blocks), or one whose grid-stride loops over `work` points would
// step past 2^31 - 1 (krylov_ops.cu's loops count in int32).
template <typename Args>
int coop_launch(void (*kernel)(Args), Args& args, int64_t work, size_t smem, int max_blocks,
                void* stream, int per_sm_cap = 0) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kRedThreads, smem);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  if (per_sm_cap > 0 && per_sm > per_sm_cap) per_sm = per_sm_cap;
  const int64_t need = (work + kRedThreads - 1) / kRedThreads;
  int64_t grid = (int64_t)per_sm * sms;
  if (need < grid) grid = need < 1 ? 1 : need;
  if (grid > max_blocks) return (int)cudaErrorInvalidValue;
  if (work + grid * kRedThreads > INT32_MAX) return (int)cudaErrorInvalidValue;  // int32 loops
  void* params[] = {&args};
  e = cudaLaunchCooperativeKernel((const void*)kernel, dim3((unsigned)grid), dim3(kRedThreads),
                                  params, smem, (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace oasisx
