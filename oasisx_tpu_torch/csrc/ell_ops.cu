// The unstructured path's ELL kernels, for sm_90a.
//
// They replace these TPU kernels (oasisx_tpu/assembly/pallas_ops.py),
// together with the device-side loops that drive them:
//   oasisx_ell_matvec   <- make_ell_matvec (K14), make_ell_matvec_batched:
//                          y_b = A x_b for nb vectors sharing one operator
//   oasisx_ell_bicgstab <- make_ell_bicgstab_iter (K15) and
//                          ell_bicgstab_from_r0: batched BiCGStab with
//                          zero-masked Dirichlet rows, Jacobi, per-row
//                          freezing of converged rows
//   oasisx_ell_cg       <- make_ell_cg_iter (K16) and ell_cg_batched_from_r0:
//                          batched Jacobi-PCG (the velocity update's mass
//                          solves)
//   oasisx_ell_pcg_amg  <- make_ell_pcg_amg_iter (K17) with _emit_vcycle and
//                          the loop of ell_pcg_amg_solve: CG preconditioned by
//                          the smoothed-aggregation V(pre, post) cycle, with
//                          an outlet mask or a nullspace projection
//   oasisx_ell_vcycle   <- make_ell_vcycle: K17's V-cycle alone
//   oasisx_band_matvec, <- make_band_matvec_batched, make_band_bicgstab_iter
//   oasisx_band_bicgstab,  and make_band_cg_iter (K18): K14, K15 and K16 on the
//   oasisx_band_cg         band-ELL layout, the solves driven as K15's and
//                          K16's loops drive theirs
//
// Operators are ELL tables (K, n), slot-major (ell_device.cuh): one thread
// per row, coalesced reads of vals and cols, the input vector gathered.  The
// band-ELL layout is ELL in reverse Cuthill-McKee order whose column is a
// per-slot tile shift plus a lane, stored as the (tile, slot) pairs that hold
// an entry (P pairs of 128 lanes).  K14-K16 and K18 differ only
// in that row product: the matvec and the BiCGStab and CG solve bodies are
// templates on an operator (EllOp or BandOp of ell_device.cuh), so the
// Krylov math, the zero-masked rows, the Jacobi preconditioner, the freezing
// of converged rows and the exit test are one code for both layouts.
//
// Form.  K14 is an ordinary kernel, one thread per row.  K15, K16 and K17
// are whole solves, each one cooperative launch with the loop on the device
// (grid_reduce.cuh): phases are grid-stride loops over rows separated by
// grid barriers, reductions are deterministic and identical on every block,
// and the host reads nothing during a solve.  On the TPU each iteration was
// one kernel call inside an XLA while loop, with the state in VMEM.
//
// Bound on the H100.  K14: memory, the operator's (4+sizeof(T)) bytes per
// slot for all nb vectors.  Each 32-row slice reads only its width's slots
// (ell_device.cuh): at the vessel's N=36 velocity operator (K=65,
// n=389,017, rows of 65, 27 and 19 entries interleaved) a float32 product
// reads ~98 MB, 89% of it real nonzeros, where all K slots are 202 MB.
// K15 (two operator reads per iteration) and K16 (one): memory, the
// operator does not fit in the 50 MB L2; the state vectors do.  K18 as
// K14-K16, reading P * 128 * (1 + sizeof(T)) bytes a product (the vessel's
// N=36 velocity operator: P = 371,620 pairs, 238 MB in f32, where the
// (S, R, 128) layout of the TPU kernel held 2,794 slots for every tile,
// 8.7 GB, 1% of it values).  K17: latency.  An iteration of the vessel's
// V(2, 2) cycle over 3 ELL levels and the dense coarse one holds 26 grid
// barriers, and its time goes to the coarse tables' long rows: level 2's A
// has rows of up to 432 slots and the restrictions into levels 2 and 3 up
// to 373 and 596 on a few hundred rows, and a thread walks such a row as a
// chain of dependent loads.  So a table of kWarpRowK slots or more is read
// a warp a row (ell_row_warp: 128 loads in flight, the products added in
// slot order), every table to its 32-row slices' widths (EllOp, as
// K14-K16), through the read-only path (its few MB are read again every
// V-cycle).  Running the coarse levels on a sub-group of the grid's blocks
// (as K1 does) was slower with the warp rows, which want the whole grid's
// warps, and on the cylinder, whose grid is smaller than such a group.
//
// Each entry point launches on the stream it is given, allocates nothing
// (the caller passes the work and reduction buffers), and returns the launch
// error, or cudaErrorInvalidValue for arguments it does not take.

#include "ell_device.cuh"
#include "grid_reduce.cuh"

namespace {

using namespace oasisx;

static_assert(kMaxRed >= 2 * kEllMaxBatch, "two sums per batch row");

constexpr int kThreadsMv = 256;
constexpr int kMaxAmgLevels = 10;
// A K17 table at least this wide (its K) is read a warp a row (ell_row_warp):
// the vessel's coarse A and R (373-596 slots a row on a few hundred rows);
// narrower ones a thread a row.
constexpr int kWarpRowK = 128;

template <typename T>
size_t red_smem() {
  return sizeof(T) * kMaxRed * kRedThreads;
}

template <typename T>
__device__ __forceinline__ T* red_shared() {
  extern __shared__ __align__(16) unsigned char ell_smem_raw[];
  return reinterpret_cast<T*>(ell_smem_raw);
}

// ---------------------------------------------------------------------------
// K14, K18: y_b = A x_b
// ---------------------------------------------------------------------------

template <typename T, typename Op>
__global__ void __launch_bounds__(kThreadsMv) ell_matvec_kernel(
    Op op, const T* __restrict__ x, T* __restrict__ y, int64_t n, int64_t nin, int nb) {
  const int64_t r = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n) return;
  T acc[kEllMaxBatch];
  op.rows(r, x, nin, nb, acc);
#pragma unroll
  for (int b = 0; b < kEllMaxBatch; ++b) {
    if (b >= nb) break;
    y[b * n + r] = acc[b];
  }
}

// ---------------------------------------------------------------------------
// K15, K18: batched BiCGStab with zero-masked Dirichlet rows
// ---------------------------------------------------------------------------

template <typename T, typename Op>
struct EllBicgArgs {
  Op op;           // the operator, n rows
  const T* r0;     // (nb, n) zmask (b - A x0); also rhat
  const T* x0;     // (nb, n), bc rows preset to the bc values
  const T* zmask;  // (nb, n) 0 on Dirichlet rows, 1 elsewhere
  const T* invd;   // (n) Jacobi inverse diagonal, shared by the rows
  const T* tol;    // (nb)
  T* x;            // (nb, n) out
  T *r, *s, *p, *v, *t, *y;  // (nb, n) work; y = invd p, then invd s
  T* red;
  int* iters;
  T* rnorm;
  int nb, maxiter;
  int64_t n;
};

template <typename T, typename Op>
__global__ void __launch_bounds__(kRedThreads, 2) ell_bicgstab_kernel(EllBicgArgs<T, Op> P) {
  const int nb = P.nb;
  const int64_t n = P.n;
  Reducer<T> red{P.red, red_shared<T>(), 0};
  const int64_t first = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;

  // x = x0, r = p = rhat = r0, y = invd p; rho = |r0|^2, rnorm = |r0|
  T s[kMaxRed];
  zero(s);
  for (int64_t idx = first; idx < n; idx += stride) {
    const T iv = P.invd[idx];
    #pragma unroll
    for (int b = 0; b < kEllMaxBatch; ++b) {
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
  grid_sum<kEllMaxBatch>(red, s);
  T rho[kEllMaxBatch], rn[kEllMaxBatch], tol[kEllMaxBatch];
  int it[kEllMaxBatch];
  for (int b = 0; b < kEllMaxBatch; ++b) {
    rho[b] = s[b];
    rn[b] = vsqrt(s[b]);
    tol[b] = b < nb ? P.tol[b] : T(0);
    it[b] = 0;
  }

  for (int k = 0; k < P.maxiter; ++k) {
    bool act[kEllMaxBatch];
    bool any = false;
    for (int b = 0; b < kEllMaxBatch; ++b) {
      act[b] = b < nb && rn[b] > tol[b];
      any = any || act[b];
    }
    if (!any) break;

    // v = zmask A (invd p); rv = rhat.v
    zero(s);
    for (int64_t idx = first; idx < n; idx += stride) {
      T acc[kEllMaxBatch];
      P.op.rows(idx, P.y, n, nb, acc);
      #pragma unroll
      for (int b = 0; b < kEllMaxBatch; ++b) {
        if (b >= nb) break;
        const int64_t i = b * n + idx;
        const T vv = P.zmask[i] * acc[b];
        P.v[i] = vv;
        s[b] += P.r0[i] * vv;
      }
    }
    grid_sum<kEllMaxBatch>(red, s);
    T alpha[kEllMaxBatch];
    for (int b = 0; b < kEllMaxBatch; ++b) alpha[b] = rho[b] / nz(s[b]);

    // s = r - alpha v; y = invd s
    for (int64_t idx = first; idx < n; idx += stride) {
      const T iv = P.invd[idx];
      #pragma unroll
      for (int b = 0; b < kEllMaxBatch; ++b) {
        if (b >= nb) break;
        const int64_t i = b * n + idx;
        const T ss = P.r[i] - alpha[b] * P.v[i];
        P.s[i] = ss;
        P.y[i] = iv * ss;
      }
    }
    cg::this_grid().sync();

    // t = zmask A (invd s); tt = t.t, ts = t.s
    zero(s);
    for (int64_t idx = first; idx < n; idx += stride) {
      T acc[kEllMaxBatch];
      P.op.rows(idx, P.y, n, nb, acc);
      #pragma unroll
      for (int b = 0; b < kEllMaxBatch; ++b) {
        if (b >= nb) break;
        const int64_t i = b * n + idx;
        const T tv = P.zmask[i] * acc[b];
        P.t[i] = tv;
        s[b] += tv * tv;
        s[kEllMaxBatch + b] += tv * P.s[i];
      }
    }
    grid_sum<kMaxRed>(red, s);
    T omega[kEllMaxBatch];
    for (int b = 0; b < kEllMaxBatch; ++b) omega[b] = s[kEllMaxBatch + b] / nz(s[b]);

    // x += alpha phat + omega shat and r = s - omega t on the active rows
    // (an inactive row keeps x and r); rho_new = rhat.r, |r|^2
    zero(s);
    for (int64_t idx = first; idx < n; idx += stride) {
      const T iv = P.invd[idx];
      #pragma unroll
      for (int b = 0; b < kEllMaxBatch; ++b) {
        if (b >= nb) break;
        const int64_t i = b * n + idx;
        const T ss = P.s[i];
        T rr = P.r[i];
        if (act[b]) {
          P.x[i] = P.x[i] + (alpha[b] * (iv * P.p[i]) + omega[b] * (iv * ss));
          rr = ss - omega[b] * P.t[i];
          P.r[i] = rr;
        }
        s[b] += P.r0[i] * rr;
        s[kEllMaxBatch + b] += rr * rr;
      }
    }
    grid_sum<kMaxRed>(red, s);
    T beta[kEllMaxBatch];
    for (int b = 0; b < kEllMaxBatch; ++b) {
      const T rho_new = act[b] ? s[b] : rho[b];
      beta[b] = (rho_new / nz(rho[b])) * (alpha[b] / nz(omega[b]));
      rho[b] = rho_new;
      if (act[b]) {
        rn[b] = vsqrt(s[kEllMaxBatch + b]);
        ++it[b];
      }
    }

    // p = r + beta (p - omega v) on the active rows; y = invd p
    for (int64_t idx = first; idx < n; idx += stride) {
      const T iv = P.invd[idx];
      #pragma unroll
      for (int b = 0; b < kEllMaxBatch; ++b) {
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
    for (int b = 0; b < kEllMaxBatch; ++b) {
      if (b >= nb) break;
      P.iters[b] = it[b];
      P.rnorm[b] = rn[b];
    }
}

// ---------------------------------------------------------------------------
// K16, K18: batched Jacobi-PCG
// ---------------------------------------------------------------------------

template <typename T, typename Op>
struct EllCgArgs {
  Op op;          // the operator, n rows
  const T* r0;    // (nb, n) b - A x0
  const T* x0;    // (nb, n)
  const T* invd;  // (n)
  const T* tol;   // (nb)
  T* x;           // (nb, n) out
  T *r, *p, *Ap;  // (nb, n) work
  T* red;
  int* iters;
  T* rnorm;
  int nb, maxiter;
  int64_t n;
};

template <typename T, typename Op>
__global__ void __launch_bounds__(kRedThreads, 2) ell_cg_kernel(EllCgArgs<T, Op> P) {
  const int nb = P.nb;
  const int64_t n = P.n;
  Reducer<T> red{P.red, red_shared<T>(), 0};
  const int64_t first = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;

  // x = x0, r = r0, p = z0 = invd r0; rz = r0.z0, rnorm = |r0|
  T s[kMaxRed];
  zero(s);
  for (int64_t idx = first; idx < n; idx += stride) {
    const T iv = P.invd[idx];
    #pragma unroll
    for (int b = 0; b < kEllMaxBatch; ++b) {
      if (b >= nb) break;
      const int64_t i = b * n + idx;
      const T rr = P.r0[i];
      const T z = iv * rr;
      P.x[i] = P.x0[i];
      P.r[i] = rr;
      P.p[i] = z;
      s[b] += rr * z;
      s[kEllMaxBatch + b] += rr * rr;
    }
  }
  grid_sum<kMaxRed>(red, s);
  T rz[kEllMaxBatch], rn[kEllMaxBatch], tol[kEllMaxBatch];
  int it[kEllMaxBatch];
  for (int b = 0; b < kEllMaxBatch; ++b) {
    rz[b] = s[b];
    rn[b] = vsqrt(s[kEllMaxBatch + b]);
    tol[b] = b < nb ? P.tol[b] : T(0);
    it[b] = 0;
  }

  for (int k = 0; k < P.maxiter; ++k) {
    bool act[kEllMaxBatch];
    bool any = false;
    for (int b = 0; b < kEllMaxBatch; ++b) {
      act[b] = b < nb && rn[b] > tol[b];
      any = any || act[b];
    }
    if (!any) break;

    // Ap = A p; pAp
    zero(s);
    for (int64_t idx = first; idx < n; idx += stride) {
      T acc[kEllMaxBatch];
      P.op.rows(idx, P.p, n, nb, acc);
      #pragma unroll
      for (int b = 0; b < kEllMaxBatch; ++b) {
        if (b >= nb) break;
        const int64_t i = b * n + idx;
        P.Ap[i] = acc[b];
        s[b] += P.p[i] * acc[b];
      }
    }
    grid_sum<kEllMaxBatch>(red, s);
    T alpha[kEllMaxBatch];
    for (int b = 0; b < kEllMaxBatch; ++b) alpha[b] = act[b] ? rz[b] / nz(s[b]) : T(0);

    // x += alpha p; r -= alpha Ap; z = invd r; rz_new = r.z, |r|^2
    zero(s);
    for (int64_t idx = first; idx < n; idx += stride) {
      const T iv = P.invd[idx];
      #pragma unroll
      for (int b = 0; b < kEllMaxBatch; ++b) {
        if (b >= nb) break;
        const int64_t i = b * n + idx;
        P.x[i] = P.x[i] + alpha[b] * P.p[i];
        const T rr = P.r[i] - alpha[b] * P.Ap[i];
        P.r[i] = rr;
        s[b] += rr * (iv * rr);
        s[kEllMaxBatch + b] += rr * rr;
      }
    }
    grid_sum<kMaxRed>(red, s);
    T beta[kEllMaxBatch];
    for (int b = 0; b < kEllMaxBatch; ++b) {
      const T rz_new = act[b] ? s[b] : rz[b];
      beta[b] = act[b] ? rz_new / nz(rz[b]) : T(0);
      rz[b] = rz_new;
      if (act[b]) {
        rn[b] = vsqrt(s[kEllMaxBatch + b]);
        ++it[b];
      }
    }

    // p = z + beta p on the active rows (an inactive row keeps p)
    for (int64_t idx = first; idx < n; idx += stride) {
      const T iv = P.invd[idx];
      #pragma unroll
      for (int b = 0; b < kEllMaxBatch; ++b) {
        if (b >= nb) break;
        if (!act[b]) continue;
        const int64_t i = b * n + idx;
        P.p[i] = iv * P.r[i] + beta[b] * P.p[i];
      }
    }
    cg::this_grid().sync();
  }
  if (blockIdx.x == 0 && threadIdx.x == 0)
    #pragma unroll
    for (int b = 0; b < kEllMaxBatch; ++b) {
      if (b >= nb) break;
      P.iters[b] = it[b];
      P.rnorm[b] = rn[b];
    }
}

// ---------------------------------------------------------------------------
// K17: AMG-preconditioned CG, and its V-cycle alone
// ---------------------------------------------------------------------------

template <typename T>
struct AmgLevel {
  EllOp<T, true> A;  // (KA, n) level operator
  const T* sm;       // (n) omega_s / diag: the damped-Jacobi smoother
  EllOp<T, true> P;  // (KP, n) prolongation, columns < nc
  EllOp<T, true> R;  // (KR, nc) restriction, columns < n
  int64_t n, nc;
};

template <typename T>
struct AmgArgs {
  AmgLevel<T> lv[kMaxAmgLevels];
  int L;           // AMG levels in ELL form; the dense coarse level is L
  int64_t cn;      // coarse size
  const T* cinvT;  // (cn, cn) the coarse pseudo-inverse, transposed
  const T* nullv;  // (n0) nullspace vector, or null
  const T* mask;   // (n0) 1 on outlet rows, or null
  EllOp<T, true> A0;  // (K0, n0) the fine operator of the CG
  int64_t n0;
  int pre, post;
  const T* r0;     // (n0) initial residual (projected with a nullspace)
  const T* x0;     // (n0)
  const T* tol;    // (1) absolute tolerance
  T* x;            // (n0) out: the solution, or the V-cycle's z
  T* work;         // 4 vectors per level (coarse included), then r, p (n0)
  T* red;
  int* iters;
  T* rnorm;
  int* conv;
  int maxiter;
  int vcycle_only;
};

template <typename T>
struct AmgVecs {
  T* rr[kMaxAmgLevels + 1];  // level input
  T* z[kMaxAmgLevels + 1];   // level correction (ping-pong with zb)
  T* zb[kMaxAmgLevels + 1];
  T* t[kMaxAmgLevels + 1];   // residual; t[0] also holds the CG's A p
  int64_t n[kMaxAmgLevels + 1];
};

// (A x)[r] of one vector
template <typename T>
__device__ __forceinline__ T ell_row1(const EllOp<T, true>& A, int64_t r, const T* x) {
  T acc[kEllMaxBatch];
  A.rows(r, x, 0, 1, acc);
  return acc[0];
}

template <typename T>
__global__ void __launch_bounds__(kRedThreads, 2) ell_pcg_amg_kernel(AmgArgs<T> P) {
  const int L = P.L;
  Reducer<T> red{P.red, red_shared<T>(), 0};
  const int64_t first = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t n0 = P.n0;
  const bool has_null = P.nullv != nullptr;

  AmgVecs<T> V;
  {
    T* w = P.work;
    for (int l = 0; l <= L; ++l) {
      const int64_t m = l < L ? P.lv[l].n : P.cn;
      V.n[l] = m;
      V.rr[l] = w;
      V.z[l] = w + m;
      V.zb[l] = w + 2 * m;
      V.t[l] = w + 3 * m;
      w += 4 * m;
    }
  }
  T* r = P.work;
  for (int l = 0; l <= L; ++l) r += 4 * V.n[l];
  T* p = r + n0;

  // f(i, (A x)[i]) for every row i of a level table: a thread a row, or a
  // warp a row (lane 0 calls f) for a table of kWarpRowK slots or more
  auto level_rows = [&](const EllOp<T, true>& A, const T* x, auto&& f) {
    if (A.K >= kWarpRowK) {
      const bool lead = (threadIdx.x & (kEllSlice - 1)) == 0;
      for (int64_t i = first >> 5; i < A.n; i += stride >> 5) {
        const T ax = A.row_warp(i, x);
        if (lead) f(i, ax);
      }
    } else {
      for (int64_t i = first; i < A.n; i += stride) f(i, ell_row1(A, i, x));
    }
  };

  T s[kMaxRed];
  T nn = T(1);
  if (has_null) {
    zero(s);
    for (int64_t i = first; i < n0; i += stride) s[0] += P.nullv[i] * P.nullv[i];
    grid_sum<1>(red, s);
    nn = s[0];
  }

  // z' = z + sm (r - A z) on level l, then a barrier
  auto sweep = [&](int l) {
    const AmgLevel<T>& A = P.lv[l];
    level_rows(A.A, V.z[l], [&](int64_t i, T az) {
      V.zb[l][i] = V.z[l][i] + A.sm[i] * (V.rr[l][i] - az);
    });
    T* tmp = V.z[l];
    V.z[l] = V.zb[l];
    V.zb[l] = tmp;
    cg::this_grid().sync();
  };

  // the V-cycle on rr[0] (visible to every block); for L > 0 the caller has
  // also written z[0] = sm rr[0].  Leaves the (unprojected) result in z[0].
  auto vcycle = [&]() {
    for (int l = 0; l < L; ++l) {
      const AmgLevel<T>& A = P.lv[l];
      for (int k = 1; k < P.pre; ++k) sweep(l);
      level_rows(A.A, V.z[l], [&](int64_t i, T az) { V.t[l][i] = V.rr[l][i] - az; });
      cg::this_grid().sync();
      // restriction, and the next level's first smoothing step
      const bool coarse = l + 1 == L;
      level_rows(A.R, V.t[l], [&](int64_t I, T rc) {
        V.rr[l + 1][I] = rc;
        if (!coarse) V.z[l + 1][I] = P.lv[l + 1].sm[I] * rc;
      });
      cg::this_grid().sync();
    }
    // coarsest: z_c[j] = sum_i CinvT[i, j] r_c[i], read from global memory
    const int64_t cn = P.cn;
    for (int64_t j = first; j < cn; j += stride) {
      T acc = T(0);
      for (int64_t i = 0; i < cn; ++i) acc += __ldg(P.cinvT + i * cn + j) * V.rr[L][i];
      V.z[L][j] = acc;
    }
    cg::this_grid().sync();
    for (int l = L - 1; l >= 0; --l) {
      const AmgLevel<T>& A = P.lv[l];
      level_rows(A.P, V.z[l + 1], [&](int64_t i, T pz) { V.z[l][i] = V.z[l][i] + pz; });
      cg::this_grid().sync();
      for (int k = 0; k < P.post; ++k) sweep(l);
    }
  };

  // rr[0] = v - c nullv (c = 0 without a nullspace), z[0] = sm rr[0]
  auto vcycle_input = [&](const T* v, T c) {
    const T* sm = L > 0 ? P.lv[0].sm : nullptr;
    for (int64_t i = first; i < n0; i += stride) {
      const T q = has_null ? v[i] - c * P.nullv[i] : v[i];
      V.rr[0][i] = q;
      if (L > 0) V.z[0][i] = sm[i] * q;
    }
    cg::this_grid().sync();
  };

  // z[0] -= (nullv.z / nn) nullv; with_r: returns r.z (a grid sum)
  auto vcycle_output = [&](const T* rv) -> T {
    T c = T(0);
    if (has_null) {
      zero(s);
      for (int64_t i = first; i < n0; i += stride) s[0] += P.nullv[i] * V.z[0][i];
      grid_sum<1>(red, s);
      c = s[0] / nn;
    }
    zero(s);
    for (int64_t i = first; i < n0; i += stride) {
      const T zz = has_null ? V.z[0][i] - c * P.nullv[i] : V.z[0][i];
      V.z[0][i] = zz;
      if (rv != nullptr) s[0] += rv[i] * zz;
    }
    grid_sum<1>(red, s);
    return s[0];
  };

  if (P.vcycle_only) {
    T c = T(0);
    if (has_null) {
      zero(s);
      for (int64_t i = first; i < n0; i += stride) s[0] += P.nullv[i] * P.r0[i];
      grid_sum<1>(red, s);
      c = s[0] / nn;
    }
    vcycle_input(P.r0, c);
    vcycle();
    vcycle_output(nullptr);
    for (int64_t i = first; i < n0; i += stride) P.x[i] = V.z[0][i];
    return;
  }

  // x = x0, r = r0; rn = |r0|; z = M r0; p = z; rz = r.z
  zero(s);
  for (int64_t i = first; i < n0; i += stride) {
    const T rv = P.r0[i];
    P.x[i] = P.x0[i];
    r[i] = rv;
    s[0] += rv * rv;
    if (has_null) s[1] += P.nullv[i] * rv;
  }
  grid_sum<2>(red, s);
  T rn = vsqrt(s[0]);
  vcycle_input(r, s[1] / nn);
  vcycle();
  T rz = vcycle_output(r);
  for (int64_t i = first; i < n0; i += stride) p[i] = V.z[0][i];
  cg::this_grid().sync();
  const T tol = *P.tol;

  int k = 0;
  bool brk = false;
  while (k < P.maxiter && rn > tol && !brk) {
    // Ap = A p, or where(mask, p, A (1 - mask) p), each row to its slice's
    // width; projected with a nullspace
    T* Ap = V.t[0];
    zero(s);
    for (int64_t i = first; i < n0; i += stride) {
      T ap;
      if (P.mask != nullptr) {
        const EllOp<T, true>& A0 = P.A0;
        const T* v = A0.vals + i;
        const int* cc = A0.cols + i;
        T acc = T(0);
        for (int kk = A0.width(i); kk > 0; --kk, v += A0.n, cc += A0.n) {
          const int c = __ldg(cc);
          acc = vfma(__ldg(v), (T(1) - P.mask[c]) * p[c], acc);
        }
        const T m = P.mask[i];
        ap = m * p[i] + (T(1) - m) * acc;
      } else {
        ap = ell_row1(P.A0, i, p);
      }
      Ap[i] = ap;
      if (has_null) s[0] += P.nullv[i] * ap;
      else s[0] += p[i] * ap;
    }
    grid_sum<1>(red, s);
    if (has_null) {
      const T c = s[0] / nn;
      zero(s);
      for (int64_t i = first; i < n0; i += stride) {
        const T ap = Ap[i] - c * P.nullv[i];
        Ap[i] = ap;
        s[0] += p[i] * ap;
      }
      grid_sum<1>(red, s);
    }
    const T pAp = s[0];
    brk = brk || pAp == T(0) || rz == T(0);
    const T alpha = rz / nz(pAp);

    // x += alpha p; r -= alpha Ap; |r|^2 (and nullv.r)
    zero(s);
    for (int64_t i = first; i < n0; i += stride) {
      P.x[i] = P.x[i] + alpha * p[i];
      const T rv = r[i] - alpha * Ap[i];
      r[i] = rv;
      s[0] += rv * rv;
      if (has_null) s[1] += P.nullv[i] * rv;
    }
    grid_sum<2>(red, s);
    const T rn_new = vsqrt(s[0]);
    vcycle_input(r, s[1] / nn);
    vcycle();
    const T rz_new = vcycle_output(r);
    const T beta = rz_new / nz(rz);
    for (int64_t i = first; i < n0; i += stride) p[i] = V.z[0][i] + beta * p[i];
    cg::this_grid().sync();
    rz = rz_new;
    rn = rn_new;
    ++k;
  }

  // x = x - (nullv.x / nn) nullv
  if (has_null) {
    zero(s);
    for (int64_t i = first; i < n0; i += stride) s[0] += P.nullv[i] * P.x[i];
    grid_sum<1>(red, s);
    const T c = s[0] / nn;
    for (int64_t i = first; i < n0; i += stride) P.x[i] = P.x[i] - c * P.nullv[i];
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    P.iters[0] = k;
    P.rnorm[0] = rn;
    P.conv[0] = rn <= tol ? 1 : 0;
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

bool nb_ok(int nb) { return nb >= 1 && nb <= kEllMaxBatch; }

// The pair tables are square (build_pair_tables checks every source tile
// against R): a source of another size is refused, never read out of frame.
bool band_ok(int P, int R, int Rc) { return P >= 1 && R >= 1 && Rc == R; }

// K * n slots addressed in int32 (EllOp)
bool ell_fits(int K, long long n) {
  return K >= 1 && n >= 1 && (long long)K * n <= INT32_MAX;
}

template <typename T, bool kReuse = false>
EllOp<T, kReuse> ell_op(const void* vals, const void* cols, const void* widths, int K,
                        long long n) {
  return EllOp<T, kReuse>{static_cast<const T*>(vals), static_cast<const int*>(cols),
                          static_cast<const int*>(widths), K, (int)n};
}

template <typename T>
BandOp<T> band_op(const void* vals, const void* tile_ptr, const void* pair_shift,
                  const void* lanes) {
  return BandOp<T>{static_cast<const T*>(vals), static_cast<const int*>(tile_ptr),
                   static_cast<const int*>(pair_shift), static_cast<const uint8_t*>(lanes)};
}

template <typename T, typename Op>
int matvec_launch(const Op& op, const void* x, void* y, int64_t n, int64_t nin, int nb,
                  void* stream) {
  if (n == 0) return 0;
  const unsigned grid = (unsigned)((n + kThreadsMv - 1) / kThreadsMv);
  ell_matvec_kernel<T, Op><<<grid, kThreadsMv, 0, (cudaStream_t)stream>>>(
      op, static_cast<const T*>(x), static_cast<T*>(y), n, nin, nb);
  return (int)cudaGetLastError();
}

template <typename T, typename Op>
int bicgstab_launch(const Op& op, const void* r0, const void* x0, const void* zmask,
                    const void* invd, const void* tol, void* x, void* work, void* red,
                    int max_blocks, void* iters, void* rnorm, int64_t n, int nb, int maxiter,
                    void* stream) {
  EllBicgArgs<T, Op> P;
  P.op = op;
  P.r0 = static_cast<const T*>(r0);
  P.x0 = static_cast<const T*>(x0);
  P.zmask = static_cast<const T*>(zmask);
  P.invd = static_cast<const T*>(invd);
  P.tol = static_cast<const T*>(tol);
  P.x = static_cast<T*>(x);
  P.r = static_cast<T*>(work);
  P.s = P.r + nb * n;
  P.p = P.s + nb * n;
  P.v = P.p + nb * n;
  P.t = P.v + nb * n;
  P.y = P.t + nb * n;
  P.red = static_cast<T*>(red);
  P.iters = static_cast<int*>(iters);
  P.rnorm = static_cast<T*>(rnorm);
  P.nb = nb;
  P.maxiter = maxiter;
  P.n = n;
  return coop_launch(ell_bicgstab_kernel<T, Op>, P, n, red_smem<T>(), max_blocks, stream);
}

template <typename T, typename Op>
int cg_launch(const Op& op, const void* r0, const void* x0, const void* invd, const void* tol,
              void* x, void* work, void* red, int max_blocks, void* iters, void* rnorm,
              int64_t n, int nb, int maxiter, void* stream) {
  EllCgArgs<T, Op> P;
  P.op = op;
  P.r0 = static_cast<const T*>(r0);
  P.x0 = static_cast<const T*>(x0);
  P.invd = static_cast<const T*>(invd);
  P.tol = static_cast<const T*>(tol);
  P.x = static_cast<T*>(x);
  P.r = static_cast<T*>(work);
  P.p = P.r + nb * n;
  P.Ap = P.p + nb * n;
  P.red = static_cast<T*>(red);
  P.iters = static_cast<int*>(iters);
  P.rnorm = static_cast<T*>(rnorm);
  P.nb = nb;
  P.maxiter = maxiter;
  P.n = n;
  return coop_launch(ell_cg_kernel<T, Op>, P, n, red_smem<T>(), max_blocks, stream);
}

template <typename T>
int ell_amg_launch(const void* const* lvl_ptrs, const long long* lvl_dims, int L, long long cn,
                   const void* cinvT, const void* nullv, const void* mask, const void* vals0,
                   const void* cols0, const void* widths0, int K0, long long n0, int pre,
                   int post, const void* r0, const void* x0, const void* tol, void* x,
                   void* work, void* red, int max_blocks, void* iters, void* rnorm, void* conv,
                   int maxiter, int vcycle_only, void* stream) {
  if (L < 0 || L > kMaxAmgLevels || cn < 1 || n0 < 1 || n0 > INT32_MAX || pre < 1 || post < 0)
    return (int)cudaErrorInvalidValue;
  AmgArgs<T> P;
  for (int l = 0; l < L; ++l) {
    AmgLevel<T>& A = P.lv[l];
    const void* const* q = lvl_ptrs + 10 * l;
    const long long* d = lvl_dims + 5 * l;
    const long long n = d[0], nc = d[1];
    const int KA = (int)d[2], KP = (int)d[3], KR = (int)d[4];
    const long long next = l + 1 < L ? lvl_dims[5 * (l + 1)] : cn;
    if (n != (l == 0 ? n0 : lvl_dims[5 * (l - 1) + 1]) || nc != next || !ell_fits(KA, n) ||
        !ell_fits(KP, n) || !ell_fits(KR, nc) || q[2] == nullptr || q[6] == nullptr ||
        q[9] == nullptr)
      return (int)cudaErrorInvalidValue;
    A.A = ell_op<T, true>(q[0], q[1], q[2], KA, n);
    A.sm = static_cast<const T*>(q[3]);
    A.P = ell_op<T, true>(q[4], q[5], q[6], KP, n);
    A.R = ell_op<T, true>(q[7], q[8], q[9], KR, nc);
    A.n = n;
    A.nc = nc;
  }
  if (L == 0 && cn != n0) return (int)cudaErrorInvalidValue;
  if (!vcycle_only) {
    if (!ell_fits(K0, n0) || widths0 == nullptr) return (int)cudaErrorInvalidValue;
    P.A0 = ell_op<T, true>(vals0, cols0, widths0, K0, n0);
  } else {
    P.A0 = EllOp<T, true>{nullptr, nullptr, nullptr, 0, 0};
  }
  P.L = L;
  P.cn = cn;
  P.cinvT = static_cast<const T*>(cinvT);
  P.nullv = static_cast<const T*>(nullv);
  P.mask = static_cast<const T*>(mask);
  P.n0 = n0;
  P.pre = pre;
  P.post = post;
  P.r0 = static_cast<const T*>(r0);
  P.x0 = static_cast<const T*>(x0);
  P.tol = static_cast<const T*>(tol);
  P.x = static_cast<T*>(x);
  P.work = static_cast<T*>(work);
  P.red = static_cast<T*>(red);
  P.iters = static_cast<int*>(iters);
  P.rnorm = static_cast<T*>(rnorm);
  P.conv = static_cast<int*>(conv);
  P.maxiter = maxiter;
  P.vcycle_only = vcycle_only;
  return coop_launch(ell_pcg_amg_kernel<T>, P, n0, red_smem<T>(), max_blocks, stream);
}

}  // namespace

extern "C" {

// The ELL operators of K14-K17: vals (K, n), cols (K, n) int32, widths
// (ceil(n / 32)) int32: the slots that slice's rows read (graph.slice_widths;
// a width past K reads K slots, one short of a row's length drops entries).

// y (nb, n) = A x for x (nb, nin), cols < nin.
int oasisx_ell_matvec(const void* vals, const void* cols, const void* widths, const void* x,
                      void* y, int K, long long n, long long nin, int nb, int is_f64,
                      void* stream) {
  if (!nb_ok(nb) || !ell_fits(K, n)) return (int)cudaErrorInvalidValue;
  return is_f64 ? matvec_launch<double>(ell_op<double>(vals, cols, widths, K, n), x, y, n, nin, nb,
                                        stream)
                : matvec_launch<float>(ell_op<float>(vals, cols, widths, K, n), x, y, n, nin, nb,
                                       stream);
}

// Batched BiCGStab on an ELL operator with zero-masked rows, from
// r0 = zmask (b - A x0) and x0 (nb, n); invd (n); tol (nb).  work: 6 * nb * n;
// red: 2 * 8 * max_blocks.  Writes x, iters (int32, nb) and rnorm (nb).
int oasisx_ell_bicgstab(const void* vals, const void* cols, const void* widths, const void* r0,
                        const void* x0, const void* zmask, const void* invd, const void* tol,
                        void* x, void* work, void* red, int max_blocks, void* iters,
                        void* rnorm, int is_f64, int K, long long n, int nb, int maxiter,
                        void* stream) {
  if (!nb_ok(nb) || !ell_fits(K, n)) return (int)cudaErrorInvalidValue;
  return is_f64 ? bicgstab_launch<double>(ell_op<double>(vals, cols, widths, K, n), r0, x0, zmask,
                                          invd, tol, x, work, red, max_blocks, iters, rnorm, n,
                                          nb, maxiter, stream)
                : bicgstab_launch<float>(ell_op<float>(vals, cols, widths, K, n), r0, x0, zmask,
                                         invd, tol, x, work, red, max_blocks, iters, rnorm, n,
                                         nb, maxiter, stream);
}

// Batched Jacobi-PCG on an ELL operator from r0 = b - A x0 and x0 (nb, n);
// invd (n); tol (nb).  work: 3 * nb * n; red: 2 * 8 * max_blocks.
int oasisx_ell_cg(const void* vals, const void* cols, const void* widths, const void* r0,
                  const void* x0, const void* invd, const void* tol, void* x, void* work,
                  void* red, int max_blocks, void* iters, void* rnorm, int is_f64, int K,
                  long long n, int nb, int maxiter, void* stream) {
  if (!nb_ok(nb) || !ell_fits(K, n)) return (int)cudaErrorInvalidValue;
  return is_f64 ? cg_launch<double>(ell_op<double>(vals, cols, widths, K, n), r0, x0, invd, tol, x,
                                    work, red, max_blocks, iters, rnorm, n, nb, maxiter, stream)
                : cg_launch<float>(ell_op<float>(vals, cols, widths, K, n), r0, x0, invd, tol, x,
                                   work, red, max_blocks, iters, rnorm, n, nb, maxiter, stream);
}

// AMG-PCG: lvl_ptrs holds 10 pointers per level (Av, Ac, Aw, sm, Pv, Pc, Pw,
// Rv, Rc, Rw: each table's values, columns and slice widths, int32, one per
// 32 rows), lvl_dims 5 numbers per level (n, nc, KA, KP, KR), both host
// arrays; cinvT (cn, cn); nullv and mask (n0) or null; the fine operator
// vals0/cols0 (K0, n0) with its widths0; r0, x0 (n0), tol (1).  work:
// 4 * (sum of the level sizes and cn) + 2 * n0; red: 2 * 8 * max_blocks.
// Writes x, iters (the loop count), rnorm and conv (int32).
int oasisx_ell_pcg_amg(const void* const* lvl_ptrs, const long long* lvl_dims, int L,
                       long long cn, const void* cinvT, const void* nullv, const void* mask,
                       const void* vals0, const void* cols0, const void* widths0, int K0,
                       long long n0, int pre, int post, const void* r0, const void* x0,
                       const void* tol, void* x, void* work, void* red, int max_blocks,
                       void* iters, void* rnorm, void* conv, int maxiter, int is_f64,
                       void* stream) {
  if (K0 < 1 || vals0 == nullptr || x0 == nullptr || tol == nullptr)
    return (int)cudaErrorInvalidValue;
  return is_f64 ? ell_amg_launch<double>(lvl_ptrs, lvl_dims, L, cn, cinvT, nullv, mask, vals0,
                                         cols0, widths0, K0, n0, pre, post, r0, x0, tol, x, work,
                                         red, max_blocks, iters, rnorm, conv, maxiter, 0, stream)
                : ell_amg_launch<float>(lvl_ptrs, lvl_dims, L, cn, cinvT, nullv, mask, vals0,
                                        cols0, widths0, K0, n0, pre, post, r0, x0, tol, x, work,
                                        red, max_blocks, iters, rnorm, conv, maxiter, 0, stream);
}

// K17's V-cycle alone: x = M r0 (projected with a nullspace); the same
// arguments as oasisx_ell_pcg_amg, the fine operator, x0 and tol unused.
int oasisx_ell_vcycle(const void* const* lvl_ptrs, const long long* lvl_dims, int L,
                      long long cn, const void* cinvT, const void* nullv, const void* mask,
                      const void* vals0, const void* cols0, const void* widths0, int K0,
                      long long n0, int pre, int post, const void* r0, const void* x0,
                      const void* tol, void* x, void* work, void* red, int max_blocks,
                      void* iters, void* rnorm, void* conv, int maxiter, int is_f64,
                      void* stream) {
  return is_f64 ? ell_amg_launch<double>(lvl_ptrs, lvl_dims, L, cn, cinvT, nullv, mask, vals0,
                                         cols0, widths0, K0, n0, pre, post, r0, x0, tol, x, work,
                                         red, max_blocks, iters, rnorm, conv, maxiter, 1, stream)
                : ell_amg_launch<float>(lvl_ptrs, lvl_dims, L, cn, cinvT, nullv, mask, vals0,
                                        cols0, widths0, K0, n0, pre, post, r0, x0, tol, x, work,
                                        red, max_blocks, iters, rnorm, conv, maxiter, 1, stream);
}

// The table width from which K17 reads a row by a warp (kWarpRowK).
int oasisx_ell_warp_row_k() { return kWarpRowK; }

// K18, the band-ELL layout as pair tables: vals (P, 128), tile_ptr (R + 1)
// int32, pair_shift (P) int32, lanes (P, 128) uint8, the rows in RCM order;
// every pair's source tile lies in [0, R), and the source has Rc == R tiles.

// y (nb, R * 128) = A x for x (nb, Rc * 128), Rc == R.
int oasisx_band_matvec(const void* vals, const void* tile_ptr, const void* pair_shift,
                       const void* lanes, const void* x, void* y, int P, int R, int Rc, int nb,
                       int is_f64, void* stream) {
  if (!nb_ok(nb) || !band_ok(P, R, Rc)) return (int)cudaErrorInvalidValue;
  const int64_t n = (int64_t)R * kLane, nin = (int64_t)Rc * kLane;
  return is_f64 ? matvec_launch<double>(band_op<double>(vals, tile_ptr, pair_shift, lanes), x,
                                        y, n, nin, nb, stream)
                : matvec_launch<float>(band_op<float>(vals, tile_ptr, pair_shift, lanes), x, y,
                                       n, nin, nb, stream);
}

// Batched BiCGStab on a band-ELL operator with zero-masked rows, from
// r0 = zmask (b - A x0) and x0 (nb, R * 128); invd (R * 128); tol (nb).
// work: 6 * nb * R * 128; red: 2 * 8 * max_blocks.  As oasisx_ell_bicgstab.
int oasisx_band_bicgstab(const void* vals, const void* tile_ptr, const void* pair_shift,
                         const void* lanes, const void* r0, const void* x0, const void* zmask,
                         const void* invd, const void* tol, void* x, void* work, void* red,
                         int max_blocks, void* iters, void* rnorm, int is_f64, int P, int R,
                         int nb, int maxiter, void* stream) {
  if (!nb_ok(nb) || !band_ok(P, R, R)) return (int)cudaErrorInvalidValue;
  const int64_t n = (int64_t)R * kLane;
  return is_f64 ? bicgstab_launch<double>(band_op<double>(vals, tile_ptr, pair_shift, lanes), r0,
                                          x0, zmask, invd, tol, x, work, red, max_blocks, iters,
                                          rnorm, n, nb, maxiter, stream)
                : bicgstab_launch<float>(band_op<float>(vals, tile_ptr, pair_shift, lanes), r0,
                                         x0, zmask, invd, tol, x, work, red, max_blocks, iters,
                                         rnorm, n, nb, maxiter, stream);
}

// Batched Jacobi-PCG on a band-ELL operator from r0 = b - A x0 and x0
// (nb, R * 128); invd (R * 128); tol (nb).  work: 3 * nb * R * 128.  As
// oasisx_ell_cg.
int oasisx_band_cg(const void* vals, const void* tile_ptr, const void* pair_shift,
                   const void* lanes, const void* r0, const void* x0, const void* invd,
                   const void* tol, void* x, void* work, void* red, int max_blocks, void* iters,
                   void* rnorm, int is_f64, int P, int R, int nb, int maxiter, void* stream) {
  if (!nb_ok(nb) || !band_ok(P, R, R)) return (int)cudaErrorInvalidValue;
  const int64_t n = (int64_t)R * kLane;
  return is_f64 ? cg_launch<double>(band_op<double>(vals, tile_ptr, pair_shift, lanes), r0, x0,
                                    invd, tol, x, work, red, max_blocks, iters, rnorm, n, nb,
                                    maxiter, stream)
                : cg_launch<float>(band_op<float>(vals, tile_ptr, pair_shift, lanes), r0, x0,
                                   invd, tol, x, work, red, max_blocks, iters, rnorm, n, nb,
                                   maxiter, stream);
}

}  // extern "C"
