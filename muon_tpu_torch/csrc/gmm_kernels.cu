// DSB's per-cell background fit, for Hopper (sm_90a).
//
//   T21 gmm_background_means  <- muon_tpu/ops/gmm.py _background_means_fn
//                                (:101) and _em_1d (:32)
//
// For every cell (a row of X, n x d f32): the 0.25 and 0.85 quantiles of the
// row; the initial responsibilities 0.95/0.05 by |x - q_lo| <= |x - q_hi|,
// +- 0.02 u (u the uniforms handed in, one per fit and value), clipped to
// [0.01, 0.99] and renormalised; two 2-component 1-D EM fits, tied and full
// variance, each until |ll - ll_prev| < tol or n_iter iterations; BIC
// -2 d ll + p ln d (p = 4 tied, 5 full), the tied fit winning only when its
// BIC is strictly lower; out the lower component mean of the winner, which
// fit won, and the iterations each ran.
//
// The reference vmaps a fixed-length fori_loop over the cells, each fit
// frozen once converged, so every cell pays n_iter iterations. Here a warp
// owns a cell and breaks out of its loop at convergence. The freeze of the
// reference tests the old `done`, so the converging iteration's M-step is
// applied and the ll returned is that of its E-step: here an iteration runs
// its E-step and its M-step and then tests, which is the same.
//
// Layout: one warp per cell, 8 cells per block. A cell's row x and its two
// responsibility vectors (12 bytes a value) sit in shared memory up to
// kSmemValues values a row (fewer warps a block as d grows), beyond that in
// a scratch tensor in global memory. The lanes walk the row with stride 32;
// every sum a lane keeps is finished by a butterfly, so all lanes hold the
// same bits and take the same branch. The quantiles sort the row by a
// bitonic network over the next power of two >= d (padded with +inf), in the
// responsibilities' space before they are written.
//
// An iteration is two passes over the row: the E-step (two log-densities,
// logsumexp, the responsibilities, stored) also sums r, r x and the
// log-norms; the second pass sums r (x - m)^2 with the new means. Every
// operation rounds as the reference's float32 program does, one at a time:
// the intrinsics __f*_rn keep nvcc from contracting a product and a sum into
// one FMA. The sums run in another order than XLA's, so ll can differ by an
// ulp, which now and then stops a fit one iteration apart.
//
// Bound: per value and iteration about 30 float32 operations and 5 of the
// special-function unit (4 exp, 1 log), in two fits; X is read once. At
// 100k x 140 and 20-40 iterations that is 1.3e10 operations of the special
// functions, about 2-3 ms at their rate, far above the 56 MB of X at the
// memory rate (0.02 ms). The cells stop at different iterations, so a
// warp's cell finishes early and its block waits for the slowest of 8.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kMaxWarps = 8;
constexpr int kSmemValues = 16384;  // ops/gmm.py SMEM_VALUES
constexpr int kSmemBudget = 200 * 1024;
constexpr float kRegCovar = 1e-6f;
constexpr float kLog2Pi = 1.8378770664093453f;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = kWarp / 2; o > 0; o >>= 1) v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

struct Params {
  float w0, w1, m0, m1, v0, v1;
};

// the M-step's second pass and the parameters, from the sums of the first:
// nk = sum r + 1e-10, m = sum r x / nk, variances (tied: one, over d)
__device__ void m_step(const float* x, const float* r0, const float* r1, int d, bool tied,
                       int lane, float s_r0, float s_r1, float s_r0x, float s_r1x,
                       Params& p) {
  const float nk0 = __fadd_rn(s_r0, 1e-10f), nk1 = __fadd_rn(s_r1, 1e-10f);
  p.m0 = __fdiv_rn(s_r0x, nk0);
  p.m1 = __fdiv_rn(s_r1x, nk1);
  float a0 = 0.f, a1 = 0.f;
  for (int i = lane; i < d; i += kWarp) {
    const float e0 = __fsub_rn(x[i], p.m0), e1 = __fsub_rn(x[i], p.m1);
    a0 = __fadd_rn(a0, __fmul_rn(r0[i], __fmul_rn(e0, e0)));
    a1 = __fadd_rn(a1, __fmul_rn(r1[i], __fmul_rn(e1, e1)));
  }
  a0 = warp_sum(a0);
  a1 = warp_sum(a1);
  if (tied) {
    p.v0 = p.v1 = __fadd_rn(__fdiv_rn(__fadd_rn(a0, a1), (float)d), kRegCovar);
  } else {
    p.v0 = __fadd_rn(__fdiv_rn(a0, nk0), kRegCovar);
    p.v1 = __fadd_rn(__fdiv_rn(a1, nk1), kRegCovar);
  }
  p.w0 = __fdiv_rn(nk0, (float)d);
  p.w1 = __fdiv_rn(nk1, (float)d);
}

// the first pass over given responsibilities: sum r, sum r x
__device__ void first_sums(const float* x, const float* r0, const float* r1, int d,
                           int lane, float& s_r0, float& s_r1, float& s_r0x,
                           float& s_r1x) {
  s_r0 = s_r1 = s_r0x = s_r1x = 0.f;
  for (int i = lane; i < d; i += kWarp) {
    s_r0 = __fadd_rn(s_r0, r0[i]);
    s_r1 = __fadd_rn(s_r1, r1[i]);
    s_r0x = __fadd_rn(s_r0x, __fmul_rn(r0[i], x[i]));
    s_r1x = __fadd_rn(s_r1x, __fmul_rn(r1[i], x[i]));
  }
  s_r0 = warp_sum(s_r0);
  s_r1 = warp_sum(s_r1);
  s_r0x = warp_sum(s_r0x);
  s_r1x = warp_sum(s_r1x);
}

// one fit from the responsibilities in r0/r1: (lower mean, ll, iterations)
__device__ void em_fit(const float* x, float* r0, float* r1, int d, bool tied, int n_iter,
                       float tol, int lane, float& m_lo, float& ll, int& iters) {
  Params p;
  float s_r0, s_r1, s_r0x, s_r1x;
  first_sums(x, r0, r1, d, lane, s_r0, s_r1, s_r0x, s_r1x);
  __syncwarp();
  m_step(x, r0, r1, d, tied, lane, s_r0, s_r1, s_r0x, s_r1x, p);
  float ll_prev = -INFINITY;
  ll = -INFINITY;
  iters = 0;
  while (iters < n_iter) {
    const float a0 = __fmul_rn(-0.5f, __fadd_rn(kLog2Pi, logf(p.v0)));
    const float a1 = __fmul_rn(-0.5f, __fadd_rn(kLog2Pi, logf(p.v1)));
    const float lw0 = logf(p.w0), lw1 = logf(p.w1);
    float s_norm = 0.f;
    s_r0 = s_r1 = s_r0x = s_r1x = 0.f;
    __syncwarp();  // the last pass's readers of r are done
    for (int i = lane; i < d; i += kWarp) {
      const float xi = x[i];
      const float e0 = __fsub_rn(xi, p.m0), e1 = __fsub_rn(xi, p.m1);
      const float lp0 =
          __fadd_rn(__fsub_rn(a0, __fdiv_rn(__fmul_rn(0.5f, __fmul_rn(e0, e0)), p.v0)), lw0);
      const float lp1 =
          __fadd_rn(__fsub_rn(a1, __fdiv_rn(__fmul_rn(0.5f, __fmul_rn(e1, e1)), p.v1)), lw1);
      float amax = fmaxf(lp0, lp1);
      if (!isfinite(amax)) amax = 0.f;
      const float norm = __fadd_rn(
          logf(__fadd_rn(expf(__fsub_rn(lp0, amax)), expf(__fsub_rn(lp1, amax)))), amax);
      const float q0 = expf(__fsub_rn(lp0, norm)), q1 = expf(__fsub_rn(lp1, norm));
      r0[i] = q0;
      r1[i] = q1;
      s_norm = __fadd_rn(s_norm, norm);
      s_r0 = __fadd_rn(s_r0, q0);
      s_r1 = __fadd_rn(s_r1, q1);
      s_r0x = __fadd_rn(s_r0x, __fmul_rn(q0, xi));
      s_r1x = __fadd_rn(s_r1x, __fmul_rn(q1, xi));
    }
    const float ll_new = __fdiv_rn(warp_sum(s_norm), (float)d);
    s_r0 = warp_sum(s_r0);
    s_r1 = warp_sum(s_r1);
    s_r0x = warp_sum(s_r0x);
    s_r1x = warp_sum(s_r1x);
    __syncwarp();  // r is whole
    m_step(x, r0, r1, d, tied, lane, s_r0, s_r1, s_r0x, s_r1x, p);
    ++iters;
    ll = ll_new;
    if (fabsf(__fsub_rn(ll_new, ll_prev)) < tol) break;
    ll_prev = ll_new;
  }
  m_lo = fminf(p.m0, p.m1);
}

// the initial responsibilities of one fit from the quantiles and its uniforms
__device__ void init_resp(const float* x, const float* u, int d, float q_lo, float q_hi,
                          int lane, float* r0, float* r1) {
  for (int i = lane; i < d; i += kWarp) {
    const bool near = fabsf(__fsub_rn(x[i], q_lo)) <= fabsf(__fsub_rn(x[i], q_hi));
    const float nz = __fmul_rn(0.02f, u[i]);
    const float a = fminf(fmaxf(__fadd_rn(near ? 0.95f : 0.05f, nz), 0.01f), 0.99f);
    const float b = fminf(fmaxf(__fsub_rn(near ? 0.05f : 0.95f, nz), 0.01f), 0.99f);
    const float s = __fadd_rn(a, b);
    r0[i] = __fdiv_rn(a, s);
    r1[i] = __fdiv_rn(b, s);
  }
}

// jnp.quantile's linear rule on the sorted row s: q (d - 1), then
// low_value * low_weight + high_value * high_weight, the first product and
// the sum contracted into one FMA as XLA compiles it
__device__ __forceinline__ float quantile_sorted(const float* s, int d, float q) {
  const float pos = __fmul_rn(q, (float)(d - 1));
  const float lo = floorf(pos), hi = ceilf(pos);
  const float w_hi = __fsub_rn(pos, lo), w_lo = __fsub_rn(1.0f, w_hi);
  const int li = min(max((int)lo, 0), d - 1), hj = min(max((int)hi, 0), d - 1);
  return __fmaf_rn(s[li], w_lo, __fmul_rn(s[hj], w_hi));
}

__global__ void gmm_background_means_kernel(const float* __restrict__ X,
                                            const float* __restrict__ noise, int n, int d,
                                            int n_iter, float tol, float* __restrict__ scratch,
                                            float* __restrict__ means, int* __restrict__ tied,
                                            int* __restrict__ iters) {
  extern __shared__ float smem[];
  const int warps = blockDim.x / kWarp, warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int c = blockIdx.x * warps + warp;
  if (c >= n) return;  // no block-wide barrier below
  float* buf = scratch ? scratch + (int64_t)c * 3 * d : smem + (int64_t)warp * 3 * d;
  float* x = buf;
  float* r0 = buf + d;
  float* r1 = buf + 2 * d;
  const float* row = X + (int64_t)c * d;
  for (int i = lane; i < d; i += kWarp) x[i] = row[i];

  // the quantiles: a bitonic sort of the row (+inf padded to a power of two)
  // in r0 | r1, which hold 2d >= that many floats
  int p2 = 1;
  while (p2 < d) p2 <<= 1;
  float* s = r0;
  for (int i = lane; i < p2; i += kWarp) s[i] = i < d ? row[i] : INFINITY;
  __syncwarp();
  for (int k = 2; k <= p2; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = lane; i < p2; i += kWarp) {
        const int q = i ^ j;
        if (q > i) {
          const float a = s[i], b = s[q];
          if ((a > b) == ((i & k) == 0)) {
            s[i] = b;
            s[q] = a;
          }
        }
      }
      __syncwarp();
    }
  }
  const float q_lo = quantile_sorted(s, d, 0.25f), q_hi = quantile_sorted(s, d, 0.85f);
  __syncwarp();  // every lane has read the sorted row

  float m_lo[2], ll[2];
  int it[2];
  for (int f = 0; f < 2; ++f) {
    init_resp(x, noise + ((int64_t)f * n + c) * d, d, q_lo, q_hi, lane, r0, r1);
    __syncwarp();
    em_fit(x, r0, r1, d, f == 0, n_iter, tol, lane, m_lo[f], ll[f], it[f]);
    __syncwarp();  // the next fit overwrites r0, r1
  }
  if (lane == 0) {
    const float log_d = logf((float)d);
    const float bic_t = __fadd_rn(__fmul_rn(-2.0f * (float)d, ll[0]), __fmul_rn(4.0f, log_d));
    const float bic_f = __fadd_rn(__fmul_rn(-2.0f * (float)d, ll[1]), __fmul_rn(5.0f, log_d));
    const bool t = bic_t < bic_f;
    means[c] = t ? m_lo[0] : m_lo[1];
    tied[c] = t;
    iters[c] = it[0];
    iters[(int64_t)n + c] = it[1];
  }
}

}  // namespace

extern "C" {

// T21. X (n x d) f32; noise (2 x n x d) f32 uniforms, the tied fit's first;
// scratch (n x 3d) f32 when d > kSmemValues, else null; means (n) f32, tied
// (n) int32 (1 where the tied fit won) and iters (2 x n) int32 out.
int mt_gmm_background_means(const float* X, const float* noise, int n, int d, int n_iter,
                            float tol, float* scratch, float* means, int* tied, int* iters,
                            void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (n <= 0) return (int)cudaGetLastError();
  if (d < 1 || n_iter < 0 || (d > kSmemValues && scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  int warps = kMaxWarps;
  size_t smem = 0;
  if (d <= kSmemValues) {
    const size_t per_warp = (size_t)12 * d;
    warps = (int)(kSmemBudget / per_warp);
    warps = warps < 1 ? 1 : (warps > kMaxWarps ? kMaxWarps : warps);
    smem = per_warp * warps;
    scratch = nullptr;
    cudaError_t e = cudaFuncSetAttribute(gmm_background_means_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int blocks = (n + warps - 1) / warps;
  gmm_background_means_kernel<<<blocks, warps * kWarp, smem, st>>>(
      X, noise, n, d, n_iter, tol, scratch, means, tied, iters);
  return (int)cudaGetLastError();
}

}  // extern "C"
