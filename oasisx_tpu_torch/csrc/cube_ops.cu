// Cube operators on the parity-split grid layout, for sm_90a.
//
// Every entry point but the gather and the scatter applies the cube device
// function of cube_device.cuh (y = sum_cubes P_c^T C P_c x, output-owner, no
// atomics).  They replace these TPU kernels (oasisx_tpu/assembly/pallas_ops.py):
//   oasisx_matvec_const  <- make_matvec_pf (K5) and make_matvec (K12):
//                           constant cube matrix C (nl, nl), batch B
//   oasisx_matvec_win    <- make_matvec_win (K3): per-cube weights
//                           W[to*nl + ti, cube], shared by the B components;
//                           with the optional multipliers y = zmask A_W (premul x)
//                           it is also make_matvec_hbm_chan (K10), and at batch 1
//                           make_tent_matvec_hbm (W streamed per slot row).  The
//                           multipliers are fused into the input loads and the
//                           output stores; a null pointer means 1.
//   oasisx_mixed         <- make_mixed_pf (K6): r_g = C_g p, C_all (d, nl_v, nl_q)
//   oasisx_divergence    <- make_divergence_pf (K7): b2 = sum_g B_g^T u_g,
//                           B_all (d, nl_v, nl_q) read transposed [g, ti, to]
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
//                           chunking.  No solver path of the port calls it: its
//                           matvecs fuse gather, product and scatter (the JAX
//                           package used it for the staged gather -> einsum ->
//                           scatter products of its N=64 tier).
//
// Bound on the H100: memory.  K3 at N=36 (3D P2) must stream the 136 MB W
// (729 x 46656 f32) once per call, 764 MB at N=64; x and y are 3 x 1.6 MB
// (3 x 8.8 MB at N=64) and stay in L2.  K5, K6 and K7 read and write a few MB
// with the small constant matrix in shared memory; their re-reads of x (each
// input value is read by the <= 8 cubes around it) hit L1/L2.  No tensor
// cores: the contractions are 27 x 27 per cube with nothing to batch into a
// tile that the grid layout does not already give as a gather.  K8 writes U
// (3 x 27 x 46656 f32, 15 MB at N=36) once and reads each grid value up to
// 2^d times from L2; its index arithmetic is 32-bit with at most one
// division a thread, where 64-bit divisions (a software sequence on the GPU)
// made it integer-bound.  K13 reads U once and writes the grid once.
//
// Each entry point launches on the stream it is given, allocates nothing,
// and returns cudaGetLastError() after the launch.

#include "cube_device.cuh"

namespace {

using namespace oasisx;

// kPm, kZm: y = zm * A (pm * x), pm and zm (batch, grid).
template <typename T, bool kPm, bool kZm>
__global__ void __launch_bounds__(kThreads)
cube_apply_kernel(const T* __restrict__ x, const T* __restrict__ mat,
                  T* __restrict__ y, CubeArgs a, const T* __restrict__ pm,
                  const T* __restrict__ zm) {
  unsigned char* smem = dynamic_smem();
  T* smat = reinterpret_cast<T*>(smem);
  int* soff = reinterpret_cast<int*>(smem + sizeof(T) * a.mat_len);
  cube_stage(mat, a, smat, soff);
  __syncthreads();
  cube_apply_range<T, kPm, kZm>(x, a.mat_len > 0 ? smat : mat, soff, a, y,
                                (int64_t)blockIdx.x * blockDim.x + threadIdx.x,
                                (int64_t)gridDim.x * blockDim.x, pm, zm);
}

// K8's launch: the grid offset of every input slot relative to its cube's
// base (cube_stage's soff, computed on the host), and the cube grid cut as
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

// the main path's 3D P2 cubes (27 slots) unrolled, any other count at run time
template <typename T>
void gather_dispatch(const void* x, void* u, const GatherArgs& g, dim3 grid, void* stream) {
  if (g.nl == 27)
    launch_gather<T, 27>(x, u, g, grid, stream);
  else
    launch_gather<T, 0>(x, u, g, grid, stream);
}

// y[b, idx] = sum over the cubes c containing idx of U[b, slot of idx in c, c]:
// (batch, nl, ncubes) -> (batch, npad), 0 at padding.
template <typename T>
__global__ void __launch_bounds__(kThreads)
cube_scatter_kernel(const T* __restrict__ u, T* __restrict__ y, CubeArgs a, int batch,
                    int64_t ncube) {
  const int64_t total = (int64_t)batch * a.npad_out;
  for (int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += (int64_t)gridDim.x * blockDim.x) {
    const int64_t b = e / a.npad_out;
    const T* ub = u + b * a.nl_out * ncube;
    T acc = T(0);
    cube_visit(a, e - b * a.npad_out,
               [&](int to, int64_t cube, int) { acc += ub[to * ncube + cube]; });
    y[e] = acc;
  }
}

int grid_blocks(int64_t work) {
  const int64_t blocks_needed = (work + kThreads - 1) / kThreads;
  return (int)(blocks_needed < 65535 * 16 ? blocks_needed : 65535 * 16);
}

template <typename T, bool kPm, bool kZm>
void launch_apply(const void* x, const void* mat, void* y, const CubeArgs& a, void* stream,
                  const void* pm, const void* zm) {
  const int blocks = grid_blocks(a.npad_out);
  const size_t smem = sizeof(T) * a.mat_len + sizeof(int) * a.nl_in;
  cube_apply_kernel<T, kPm, kZm><<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(mat), static_cast<T*>(y), a,
      static_cast<const T*>(pm), static_cast<const T*>(zm));
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
             void* stream, const void* pm = nullptr, const void* zm = nullptr) {
  return is_f64 ? launch<double>(x, mat, y, a, stream, pm, zm)
                : launch<float>(x, mat, y, a, stream, pm, zm);
}

// Batched operators with one input per output component (K5, K3): launch
// in chunks of kMaxBatch components; pm and zm (null, or laid out as x and
// y) follow the chunks.
int batched(int is_f64, const void* x, const void* mat, void* y, CubeArgs a, int batch,
            void* stream, const void* pm = nullptr, const void* zm = nullptr) {
  const size_t esz = is_f64 ? sizeof(double) : sizeof(float);
  auto at = [&](const void* base, int64_t off) -> const void* {
    return base == nullptr ? nullptr : static_cast<const char*>(base) + esz * off;
  };
  for (int b0 = 0; b0 < batch; b0 += kMaxBatch) {
    a.nbo = batch - b0 < kMaxBatch ? batch - b0 : kMaxBatch;
    char* yb = static_cast<char*>(y) + esz * a.npad_out * b0;
    const int err = dispatch(is_f64, at(x, a.x_bo * b0), mat, yb, a, stream,
                             at(pm, a.x_bo * b0), at(zm, a.npad_out * b0));
    if (err) return err;
  }
  return 0;
}

}  // namespace

extern "C" {

// y[b] = A x[b] with constant cube matrix C (nl, nl); x, y (batch, grid).
int oasisx_matvec_const(const void* x, const void* C, void* y, int is_f64, int d, int n0,
                        int n1, int n2, int deg, int batch, void* stream) {
  return batched(is_f64, x, C, y, const_args(d, n0, n1, n2, deg, batch), batch, stream);
}

// y[b] = zmask[b] * A_W (premul[b] * x[b]) with per-cube weights W
// (nl*nl, ncubes); x, y, premul, zmask (batch, grid), premul and zmask may be
// null (1).
int oasisx_matvec_win(const void* x, const void* W, const void* premul, const void* zmask,
                      void* y, int is_f64, int d, int n0, int n1, int n2, int deg, int batch,
                      void* stream) {
  return batched(is_f64, x, W, y, win_args(d, n0, n1, n2, deg, batch), batch, stream, premul,
                 zmask);
}

// r[g] = C_all[g] p for g < ncomp; p (grid_q) -> r (ncomp, grid_v).
int oasisx_mixed(const void* p, const void* C_all, void* r, int is_f64, int d, int n0,
                 int n1, int n2, int deg_v, int deg_q, int ncomp, void* stream) {
  if (ncomp > kMaxBatch) return (int)cudaErrorInvalidValue;
  CubeArgs a = base_args(d, n0, n1, n2, deg_v, deg_q);
  a.nbo = ncomp;
  a.nbi = 1;
  a.m_bo = (int64_t)a.nl_out * a.nl_in;
  a.m_to = a.nl_in;
  a.m_ti = 1;
  a.mat_len = ncomp * a.nl_out * a.nl_in;
  return dispatch(is_f64, p, C_all, r, a, stream);
}

// b2 = sum_g B_all[g]^T u[g]; u (ncomp, grid_v) -> b2 (grid_q).
int oasisx_divergence(const void* u, const void* B_all, void* b2, int is_f64, int d,
                      int n0, int n1, int n2, int deg_v, int deg_q, int ncomp,
                      void* stream) {
  if (ncomp > kMaxBatch) return (int)cudaErrorInvalidValue;
  CubeArgs a = base_args(d, n0, n1, n2, deg_q, deg_v);
  a.nbo = 1;
  a.nbi = ncomp;
  a.x_bi = grid_points(d, a.n, deg_v);
  a.m_bi = (int64_t)a.nl_out * a.nl_in;
  a.m_ti = a.nl_out;  // B_all[g] is (nl_v, nl_q) = (nl_in, nl_out): [ti, to]
  a.m_to = 1;
  a.mat_len = ncomp * a.nl_out * a.nl_in;
  return dispatch(is_f64, u, B_all, b2, a, stream);
}

// U[b] = the cube-local values of x[b]; x (batch, grid) -> U (batch, nl, ncubes).
// cudaErrorInvalidValue where x or U has 2^31 entries or more, or a cube has
// more than kGatherMaxSlots slots.
int oasisx_cube_gather(const void* x, void* u, int is_f64, int d, int n0, int n1, int n2,
                       int deg, int batch, void* stream) {
  const CubeArgs a = base_args(d, n0, n1, n2, deg, deg);
  int64_t ncube = 1;
  for (int k = 0; k < d; ++k) ncube *= a.n[k];
  if (a.nl_in > kGatherMaxSlots || batch < 1 || ncube < 1 ||
      (int64_t)batch * a.nl_in * ncube >= ((int64_t)1 << 31) ||
      (int64_t)batch * a.npad_out >= ((int64_t)1 << 31) || batch > 65535)
    return (int)cudaErrorInvalidValue;
  GatherArgs g = {};
  // cube_stage's offsets: slot digits in C-order, parity channel and base
  for (int ti = 0; ti < a.nl_in; ++ti) {
    int digit[3];
    int rem = ti;
    for (int k = d - 1; k >= 0; --k) {
      digit[k] = rem % (deg + 1);
      rem /= deg + 1;
    }
    int ch = 0, boff = 0;
    for (int k = 0; k < d; ++k) {
      ch = ch * deg + digit[k] % deg;
      boff = boff * (a.n[k] + 1) + digit[k] / deg;
    }
    g.soff[ti] = (int)(ch * a.plane_in) + boff;
  }
  g.nl = a.nl_in;
  g.A = d == 3 ? a.n[1] : a.n[0];
  g.B = a.n[d - 1];
  g.plane = g.A * g.B;
  g.ncube = (int)ncube;
  g.npad = (int)a.npad_out;
  const int rows = d == 3 ? a.n[0] : 1;
  const dim3 grid((g.plane + kGatherThreads - 1) / kGatherThreads, rows, batch);
  if (is_f64)
    gather_dispatch<double>(x, u, g, grid, stream);
  else
    gather_dispatch<float>(x, u, g, grid, stream);
  return (int)cudaGetLastError();
}

// y[b] = the grid vector assembled from the cube-local values U[b];
// U (batch, nl, ncubes) -> y (batch, grid).
int oasisx_cube_scatter(const void* u, void* y, int is_f64, int d, int n0, int n1, int n2,
                        int deg, int batch, void* stream) {
  const CubeArgs a = base_args(d, n0, n1, n2, deg, deg);
  int64_t ncube = 1;
  for (int k = 0; k < d; ++k) ncube *= a.n[k];
  const int blocks = grid_blocks((int64_t)batch * a.npad_out);
  if (is_f64)
    cube_scatter_kernel<double><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        static_cast<const double*>(u), static_cast<double*>(y), a, batch, ncube);
  else
    cube_scatter_kernel<float><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        static_cast<const float*>(u), static_cast<float*>(y), a, batch, ncube);
  return (int)cudaGetLastError();
}

}  // extern "C"
