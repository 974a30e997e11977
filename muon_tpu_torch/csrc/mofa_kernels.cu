// Kernels of the MOFA+ coordinate-ascent sweeps, for Hopper (sm_90a).
//
//   T17 mofa_col_dot       <- muon_tpu/models/mofa.py _make_step / _make_svi_step:
//                             zk @ E in w_body, (E * E).sum(0) in the tau update
//   T18 mofa_w_posterior   <- w_body's elementwise posterior of one factor's weights
//   T19 mofa_row_dot       <- z_body's Es[m] @ tsw (masked: also B @ tSWW[:, k] and
//                             B @ tSW2[:, k])
//   T20 mofa_rank1_update  <- the rank-1 corrections of E in w_body and z_body
//
// The reference runs the loop over the K factors inside one compiled
// program, and its compiler fuses each factor's reduction, posterior and
// rank-1 correction around the residual E (N x D float32, row-major, one
// per view; a masked view has a 0/1 or per-entry-precision B of E's shape).
// Here each of those passes over E is one kernel.
//
// Bound: all four are bound by bytes. T17 and T19 read E once (T19 also B
// where masked), T20 reads and writes E once (and reads B), T18 touches a few
// vectors of D floats. At the bench's 10,000 x 3000 a pass over E is 120 MB,
// 36 us at 3.35 TB/s; E does not fit the 50 MB L2, so every pass comes from
// device memory. The simple designs here read with one 4-byte load a thread,
// neighbouring threads on neighbouring columns; T20, which a sweep launches
// most, takes 16 bytes a thread where the shapes allow.
//
// Order of sums: T17 sums each tile of kTileRows rows by 8 row lanes and a
// tree, then the tiles in index order; T19 gives a row to a warp, each lane
// summing every 32nd column in order, then a butterfly. No atomics: the same
// inputs give the same bits in every run.
//
// Vectors may be strided views (column k of a row-major (N, K) or (D, K)
// array): every vector argument comes with its stride in elements, and a
// stride of 0 broadcasts one value.
//
// Interface: plain C functions (loaded with ctypes), as in
// sparse_kernels.cu. Each launches on the stream it is given, allocates
// nothing, and returns cudaGetLastError(). Outputs and scratch are
// allocated by the caller.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTileRows = 256;  // rows per partial sum of T17; ops/mofa.py
constexpr int kColLanes = 32;   // columns per pass-1 block of T17
constexpr int kRowLanes = 8;    // row lanes per column in pass 1 of T17
constexpr int kThreads = 256;
constexpr int kWarp = 32;
constexpr int kWarpsPerBlock = 8;
constexpr unsigned kFull = 0xffffffffu;

// T17 pass 1: partial[tile, c] = sum over the tile's rows of z[r] E[r, c]
// (z given) or of E[r, c]^2 (z null)
__global__ void __launch_bounds__(kColLanes * kRowLanes)
col_dot_partial_kernel(const float* __restrict__ E, const float* __restrict__ z,
                       int64_t z_stride, int n, int d, float* __restrict__ partial) {
  __shared__ float acc[kRowLanes][kColLanes];
  const int c = blockIdx.y * kColLanes + threadIdx.x;
  const int r0 = blockIdx.x * kTileRows;
  const int r1 = min(r0 + kTileRows, n);
  float s = 0.f;
  if (c < d) {
    if (z != nullptr) {
      for (int r = r0 + threadIdx.y; r < r1; r += kRowLanes)
        s = fmaf(z[(int64_t)r * z_stride], E[(int64_t)r * d + c], s);
    } else {
      for (int r = r0 + threadIdx.y; r < r1; r += kRowLanes) {
        const float e = E[(int64_t)r * d + c];
        s = fmaf(e, e, s);
      }
    }
  }
  acc[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
#pragma unroll
  for (int h = kRowLanes / 2; h > 0; h >>= 1) {
    if (threadIdx.y < h)
      acc[threadIdx.y][threadIdx.x] =
          __fadd_rn(acc[threadIdx.y][threadIdx.x], acc[threadIdx.y + h][threadIdx.x]);
    __syncthreads();
  }
  if (threadIdx.y == 0 && c < d) partial[(int64_t)blockIdx.x * d + c] = acc[0][threadIdx.x];
}

// T17 pass 2: u[c] = the tiles' partials in index order
__global__ void __launch_bounds__(kThreads)
col_dot_finish_kernel(const float* __restrict__ partial, int n_tiles, int d,
                      float* __restrict__ u) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= d) return;
  float s = 0.f;
  for (int t = 0; t < n_tiles; ++t) s = __fadd_rn(s, partial[(int64_t)t * d + c]);
  u[c] = s;
}

// T18: the posterior of column k of one view's weights, a thread per feature
__global__ void __launch_bounds__(kThreads)
w_posterior_kernel(const float* __restrict__ u, const float* __restrict__ tau,
                   const float* __restrict__ z2, int64_t z2_stride,
                   const float* __restrict__ zz, int64_t zz_stride,
                   const float* __restrict__ alpha, const float* __restrict__ ln_alpha,
                   const float* __restrict__ theta_ln,
                   const float* __restrict__ theta_ln1m, float scale, int scaled,
                   int spikeslab, int d, int K, int k, float* __restrict__ W_hat,
                   float* __restrict__ W_var, float* __restrict__ S,
                   float* __restrict__ SW, float* __restrict__ delta) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= d) return;
  const int64_t at = (int64_t)c * K + k;
  const float t = tau[c];
  const float sw_old = SW[at];
  const float a = __fadd_rn(__fmul_rn(t, z2[(int64_t)c * z2_stride]), alpha[0]);
  const float zzc = zz[(int64_t)c * zz_stride];
  // full batch: tau (u + sw zz); stochastic: tau scale u + tau sw zz, with
  // zz (and z2) already scaled by the caller, as the reference writes them
  const float b = scaled
      ? __fadd_rn(__fmul_rn(__fmul_rn(t, scale), u[c]),
                  __fmul_rn(__fmul_rn(t, sw_old), zzc))
      : __fmul_rn(t, __fadd_rn(u[c], __fmul_rn(sw_old, zzc)));
  const float w = __fdiv_rn(b, a);
  const float v = __fdiv_rn(1.f, a);
  float s = 1.f;
  if (spikeslab) {
    float lam = __fsub_rn(theta_ln[0], theta_ln1m[0]);
    lam = __fadd_rn(lam, __fmul_rn(0.5f, ln_alpha[0]));
    lam = __fsub_rn(lam, __fmul_rn(0.5f, logf(a)));
    lam = __fadd_rn(lam, __fdiv_rn(__fmul_rn(__fmul_rn(0.5f, b), b), a));
    s = __fdiv_rn(1.f, __fadd_rn(1.f, expf(-lam)));
  }
  const float sw_new = __fmul_rn(s, w);
  W_hat[at] = w;
  W_var[at] = v;
  S[at] = s;
  SW[at] = sw_new;
  delta[c] = __fsub_rn(sw_old, sw_new);
}

// T19: a warp per row; r[row] = sum_c E[row, c] t[c], and with B also
// pb[row] = sum_c B[row, c] t1[c] and qb[row] = sum_c B[row, c] t2[c]
__global__ void __launch_bounds__(kWarp * kWarpsPerBlock)
row_dot_kernel(const float* __restrict__ E, const float* __restrict__ t,
               int64_t t_stride, const float* __restrict__ B,
               const float* __restrict__ t1, const float* __restrict__ t2,
               int64_t tb_stride, int n, int d, float* __restrict__ r,
               float* __restrict__ pb, float* __restrict__ qb) {
  const int row = blockIdx.x * kWarpsPerBlock + threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  if (row >= n) return;  // whole warps leave together
  const float* e = E + (int64_t)row * d;
  float s = 0.f, p = 0.f, q = 0.f;
  if (B == nullptr) {
    for (int c = lane; c < d; c += kWarp) s = fmaf(e[c], t[(int64_t)c * t_stride], s);
  } else {
    const float* b = B + (int64_t)row * d;
    for (int c = lane; c < d; c += kWarp) {
      const float bc = b[c];
      s = fmaf(e[c], t[(int64_t)c * t_stride], s);
      p = fmaf(bc, t1[(int64_t)c * tb_stride], p);
      q = fmaf(bc, t2[(int64_t)c * tb_stride], q);
    }
  }
#pragma unroll
  for (int o = kWarp / 2; o > 0; o >>= 1) {
    s = __fadd_rn(s, __shfl_xor_sync(kFull, s, o));
    p = __fadd_rn(p, __shfl_xor_sync(kFull, p, o));
    q = __fadd_rn(q, __shfl_xor_sync(kFull, q, o));
  }
  if (lane == 0) {
    r[row] = s;
    if (B != nullptr) {
      pb[row] = p;
      qb[row] = q;
    }
  }
}

// T20: E[r, c] += x[r] y[c] (times B[r, c] where masked), in place. A block
// of 64 x 4 threads takes 64 groups of V columns of 4 x rows_per_thread rows;
// V = 4 (one 16-byte load and store a thread) where the row length and the
// pointers allow it, else 1. A thread's rows are independent, so its loads
// are in flight together.
constexpr int kR1Cols = 64;
constexpr int kR1Rows = 4;

template <int V>
__global__ void __launch_bounds__(kR1Cols * kR1Rows)
rank1_update_kernel(float* __restrict__ E, const float* __restrict__ x,
                    int64_t x_stride, const float* __restrict__ y, int64_t y_stride,
                    const float* __restrict__ B, int n, int d, int rows_per_thread) {
  const int c = (blockIdx.x * kR1Cols + threadIdx.x) * V;
  if (c >= d) return;
  float yc[V];
#pragma unroll
  for (int v = 0; v < V; ++v) yc[v] = y[(int64_t)(c + v) * y_stride];
  const int r0 = blockIdx.y * (kR1Rows * rows_per_thread) + threadIdx.y;
#pragma unroll 4
  for (int i = 0; i < rows_per_thread; ++i) {
    const int r = r0 + i * kR1Rows;
    if (r >= n) return;
    const int64_t at = (int64_t)r * d + c;
    const float xr = x[(int64_t)r * x_stride];
    __align__(16) float e[V];
    __align__(16) float b[V] = {};
    if (V == 4) {
      *reinterpret_cast<float4*>(e) = *reinterpret_cast<const float4*>(E + at);
      if (B != nullptr) *reinterpret_cast<float4*>(b) = *reinterpret_cast<const float4*>(B + at);
    } else {
      e[0] = E[at];
      if (B != nullptr) b[0] = B[at];
    }
#pragma unroll
    for (int v = 0; v < V; ++v) {
      float upd = __fmul_rn(xr, yc[v]);
      if (B != nullptr) upd = __fmul_rn(upd, b[v]);
      e[v] = __fadd_rn(e[v], upd);
    }
    if (V == 4) {
      *reinterpret_cast<float4*>(E + at) = *reinterpret_cast<const float4*>(e);
    } else {
      E[at] = e[0];
    }
  }
}

}  // namespace

extern "C" {

// T17. E (n x d) f32; z (n) f32 with stride z_stride, or null for the column
// sums of E^2; partial (ceil(n / 256) x d) f32 scratch; u (d) f32 out.
int mt_mofa_col_dot(const float* E, const float* z, long long z_stride, int n, int d,
                    float* partial, float* u, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (d <= 0) return (int)cudaGetLastError();
  const int n_tiles = (n + kTileRows - 1) / kTileRows;
  if (n_tiles > 0) {
    const dim3 grid(n_tiles, (d + kColLanes - 1) / kColLanes);
    if (grid.y > 65535) return (int)cudaErrorInvalidValue;
    col_dot_partial_kernel<<<grid, dim3(kColLanes, kRowLanes), 0, s>>>(E, z, z_stride, n, d,
                                                                      partial);
  }
  col_dot_finish_kernel<<<(d + kThreads - 1) / kThreads, kThreads, 0, s>>>(partial, n_tiles,
                                                                           d, u);
  return (int)cudaGetLastError();
}

// T18. u, tau (d) f32; z2 and zz (d) f32 with their strides (0: one value);
// alpha, ln_alpha, theta_ln, theta_ln1m point at the (view, factor) entry;
// scaled selects the stochastic form with `scale`; W_hat, W_var, S, SW
// (d x K) f32, column k updated in place; delta (d) f32 out = SW_old - SW_new.
int mt_mofa_w_posterior(const float* u, const float* tau, const float* z2,
                        long long z2_stride, const float* zz, long long zz_stride,
                        const float* alpha, const float* ln_alpha, const float* theta_ln,
                        const float* theta_ln1m, float scale, int scaled, int spikeslab,
                        int d, int K, int k, float* W_hat, float* W_var, float* S,
                        float* SW, float* delta, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (d <= 0) return (int)cudaGetLastError();
  if (k < 0 || k >= K) return (int)cudaErrorInvalidValue;
  w_posterior_kernel<<<(d + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      u, tau, z2, z2_stride, zz, zz_stride, alpha, ln_alpha, theta_ln, theta_ln1m, scale,
      scaled, spikeslab, d, K, k, W_hat, W_var, S, SW, delta);
  return (int)cudaGetLastError();
}

// T19. E (n x d) f32; t (d) f32 with stride t_stride; B (n x d) f32 or null;
// with B, t1 and t2 (d) f32 with stride tb_stride; r (n) out, and with B also
// pb, qb (n) out.
int mt_mofa_row_dot(const float* E, const float* t, long long t_stride, const float* B,
                    const float* t1, const float* t2, long long tb_stride, int n, int d,
                    float* r, float* pb, float* qb, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n <= 0) return (int)cudaGetLastError();
  const int blocks = (n + kWarpsPerBlock - 1) / kWarpsPerBlock;
  row_dot_kernel<<<blocks, kWarp * kWarpsPerBlock, 0, s>>>(E, t, t_stride, B, t1, t2,
                                                           tb_stride, n, d, r, pb, qb);
  return (int)cudaGetLastError();
}

// T20. E (n x d) f32, updated in place; x (n) and y (d) f32 with their
// strides; B (n x d) f32 or null.
int mt_mofa_rank1_update(float* E, const float* x, long long x_stride, const float* y,
                         long long y_stride, const float* B, int n, int d, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n <= 0 || d <= 0) return (int)cudaGetLastError();
  int rows_per_thread = 8;
  while ((n + kR1Rows * rows_per_thread - 1) / (kR1Rows * rows_per_thread) > 65535)
    rows_per_thread *= 2;
  const bool vec4 = d % 4 == 0 && (uintptr_t)E % 16 == 0 && (B == nullptr || (uintptr_t)B % 16 == 0);
  const int groups = vec4 ? d / 4 : d;
  const dim3 grid((groups + kR1Cols - 1) / kR1Cols,
                  (n + kR1Rows * rows_per_thread - 1) / (kR1Rows * rows_per_thread));
  const dim3 block(kR1Cols, kR1Rows);
  if (vec4)
    rank1_update_kernel<4><<<grid, block, 0, s>>>(E, x, x_stride, y, y_stride, B, n, d,
                                                  rows_per_thread);
  else
    rank1_update_kernel<1><<<grid, block, 0, s>>>(E, x, x_stride, y, y_stride, B, n, d,
                                                  rows_per_thread);
  return (int)cudaGetLastError();
}

}  // extern "C"
