// Cube operators on the parity-split grid layout, for sm_90a.
//
// All four entry points compute
//
//     y = sum_cubes  P_c^T  (cube matrix)  P_c  x
//
// on the grid layout of oasisx_tpu_torch/assembly/structured.py: a vector
// of one space is a (nch, n_0+1, ..., n_{d-1}+1) array, nch = deg^d parity
// channels, C-order.  A dof at fine-lattice index f sits at parity
// p_k = f_k % deg, base b_k = f_k / deg.  Positions with p_k > 0 and
// b_k = n_k are padding and are written as 0.
//
// They replace these TPU kernels (oasisx_tpu/assembly/pallas_ops.py):
//   oasisx_matvec_const  <- make_matvec_pf (K5) and make_matvec (K12):
//                           constant cube matrix C (nl, nl), batch B
//   oasisx_matvec_win    <- make_matvec_win (K3): per-cube weights
//                           W[to*nl + ti, cube], shared by the B components
//   oasisx_mixed         <- make_mixed_pf (K6): r_g = C_g p, C_all (d, nl_v, nl_q)
//   oasisx_divergence    <- make_divergence_pf (K7): b2 = sum_g B_g^T u_g,
//                           B_all (d, nl_v, nl_q) read transposed [g, ti, to]
//
// Form: output-owner, deterministic, no atomics.  One thread owns one
// output grid point (parity p, base b) for every output component.  It sums
// over the <= 2^d cubes b - delta that contain the point (delta_k in {0,1}
// on the axes with p_k == 0; the point is slot t = p + deg*delta of that
// cube), and for each cube over the nl_in input slots.  The summation order
// is fixed, so a run repeats bit for bit.  Each (output slot, cube) pair
// belongs to exactly one output point, so each entry of K3's W is read
// once per call, for all B components together.
//
// Bound on the H100: memory.  K3 at N=36 (3D P2) must stream the 136 MB W
// (729 x 46656 f32) once per call; x and y are 3 x 1.6 MB and stay in L2.
// K5, K6 and K7 read and write a few MB with the small constant matrix in
// shared memory; their re-reads of x (each input value is read by the
// <= 8 cubes around it) hit L1/L2.  No tensor cores: the contractions are
// 27 x 27 per cube with nothing to batch into a tile that the grid layout
// does not already give as a gather.
//
// Each entry point launches on the stream it is given, allocates nothing,
// and returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxBatch = 4;    // output components per launch
constexpr int kThreads = 256;

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

template <typename T>
__global__ void __launch_bounds__(kThreads)
cube_apply_kernel(const T* __restrict__ x, const T* __restrict__ mat,
                  T* __restrict__ y, CubeArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smat = reinterpret_cast<T*>(smem_raw);
  int* soff = reinterpret_cast<int*>(smem_raw + sizeof(T) * a.mat_len);

  for (int i = threadIdx.x; i < a.mat_len; i += blockDim.x) smat[i] = mat[i];
  // offset of input slot ti relative to the cube's base position
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
  __syncthreads();
  const T* M = a.mat_len > 0 ? smat : mat;

  for (int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; idx < a.npad_out;
       idx += (int64_t)gridDim.x * blockDim.x) {
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
    T acc[kMaxBatch];
#pragma unroll
    for (int bo = 0; bo < kMaxBatch; ++bo) acc[bo] = T(0);

    if (valid) {
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
        if (!ok) continue;
        const T* mc = M + to * a.m_to + cube * a.m_cube;
        for (int ti = 0; ti < a.nl_in; ++ti) {
          const T* mt = mc + ti * a.m_ti;
          const T* xt = x + soff[ti] + cbase;
          if (a.m_bo == 0 && a.m_bi == 0) {
            // one coefficient for every component (K5, K3): read it once
            const T coef = mt[0];
#pragma unroll
            for (int bo = 0; bo < kMaxBatch; ++bo)
              if (bo < a.nbo) acc[bo] += coef * xt[bo * a.x_bo];
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
      }
    }
#pragma unroll
    for (int bo = 0; bo < kMaxBatch; ++bo)
      if (bo < a.nbo) y[bo * a.npad_out + idx] = acc[bo];
  }
}

int64_t grid_points(int d, const int* n, int deg) {
  int64_t g = 1;
  for (int k = 0; k < d; ++k) g *= (int64_t)deg * (n[k] + 1);
  return g;
}

int ipow(int b, int e) {
  int r = 1;
  for (int i = 0; i < e; ++i) r *= b;
  return r;
}

CubeArgs base_args(int d, int n0, int n1, int n2, int deg_out, int deg_in) {
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

template <typename T>
int launch(const void* x, const void* mat, void* y, const CubeArgs& a, void* stream) {
  const int64_t blocks_needed = (a.npad_out + kThreads - 1) / kThreads;
  const int blocks = (int)(blocks_needed < 65535 * 16 ? blocks_needed : 65535 * 16);
  const size_t smem = sizeof(T) * a.mat_len + sizeof(int) * a.nl_in;
  cube_apply_kernel<T><<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(mat), static_cast<T*>(y), a);
  return (int)cudaGetLastError();
}

int dispatch(int is_f64, const void* x, const void* mat, void* y, const CubeArgs& a,
             void* stream) {
  return is_f64 ? launch<double>(x, mat, y, a, stream) : launch<float>(x, mat, y, a, stream);
}

// Batched operators with one input per output component (K5, K3): launch
// in chunks of kMaxBatch components.
int batched(int is_f64, const void* x, const void* mat, void* y, CubeArgs a, int batch,
            void* stream) {
  const size_t esz = is_f64 ? sizeof(double) : sizeof(float);
  for (int b0 = 0; b0 < batch; b0 += kMaxBatch) {
    a.nbo = batch - b0 < kMaxBatch ? batch - b0 : kMaxBatch;
    const char* xb = static_cast<const char*>(x) + esz * a.x_bo * b0;
    char* yb = static_cast<char*>(y) + esz * a.npad_out * b0;
    const int err = dispatch(is_f64, xb, mat, yb, a, stream);
    if (err) return err;
  }
  return 0;
}

}  // namespace

extern "C" {

// y[b] = A x[b] with constant cube matrix C (nl, nl); x, y (batch, grid).
int oasisx_matvec_const(const void* x, const void* C, void* y, int is_f64, int d, int n0,
                        int n1, int n2, int deg, int batch, void* stream) {
  CubeArgs a = base_args(d, n0, n1, n2, deg, deg);
  a.nbi = 1;
  a.x_bo = a.npad_out;
  a.m_to = a.nl_in;
  a.m_ti = 1;
  a.mat_len = a.nl_out * a.nl_in;
  return batched(is_f64, x, C, y, a, batch, stream);
}

// y[b] = A_W x[b] with per-cube weights W (nl*nl, ncubes); x, y (batch, grid).
int oasisx_matvec_win(const void* x, const void* W, void* y, int is_f64, int d, int n0,
                      int n1, int n2, int deg, int batch, void* stream) {
  CubeArgs a = base_args(d, n0, n1, n2, deg, deg);
  int64_t ncube = 1;
  for (int k = 0; k < d; ++k) ncube *= a.n[k];
  a.nbi = 1;
  a.x_bo = a.npad_out;
  a.m_cube = 1;
  a.m_ti = ncube;
  a.m_to = ncube * a.nl_in;
  a.mat_len = 0;
  return batched(is_f64, x, W, y, a, batch, stream);
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

}  // extern "C"
