// Kernels of MEFISTO's smooth factors (GP priors on Z over a covariate), for
// Hopper (sm_90a).
//
//   T24 gp_rbf_kernel  <- muon_tpu/models/mofa.py _rbf_kernel (:604), _gp_kmat_fn
//                         (:716) and the in-step Kmm / Knm of the sparse GP (:311-326)
//   T25 gp_kg_grad     <- the gradient with respect to Kg that jax.grad takes through
//                         the kernel matrix in _gp_group_fn (:636)
//
// T24 writes, for factors f and point sets a (na x p) and b (nb x p),
//   K[f, i, j] = s_f exp(-|a_i - b_j|^2 / (2 l_f^2)) fac_f(g_i, g_j)
//                + [same point set and i == j] (1 - s_f + 1e-4)
// with fac_f = Kg[f, g_i, g_j] when a learned group correlation is given,
// else [g_i == g_j] (1 without group labels). It reads a few covariates and
// writes F na nb floats: bound by its writes (400 MB for the sparse path's
// 100,000 x 1,000 Knm, 0.12 ms at 3.35 TB/s). A thread writes four rows of
// four neighbouring columns with one 16-byte store each (one column where the
// row length is not a multiple of 4), neighbouring threads neighbouring
// columns, so each warp's stores are 512 contiguous bytes.
//
// T25 is T24's backward with respect to Kg:
//   dKg[f, g, h] = s_f sum over i with g_i = g, j with g_j = h of
//                  dK[f, i, j] exp(-|a_i - b_j|^2 / (2 l_f^2)).
// It reads dK once (bound by bytes). Pass 1 gives each thread a column j and
// a chunk of kKgChunk rows, and sums the chunk's rows in index order into one
// bin per row group (G <= kMaxGroups, in registers / local memory); pass 2
// gives each (f, g, h) one block, which sums the bins in a fixed order and a
// tree. No atomics: the same input gives the same bits.
//
// Interface: plain C functions loaded with ctypes (sparse_kernels.cu). Each
// launches on the stream it is given, allocates nothing, and returns
// cudaGetLastError(). Scratch and outputs are allocated by the caller.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kCols = 64;   // T24: columns per block
constexpr int kLanes = 4;   // T24: row lanes per block
constexpr int kRowsPer = 4; // T24: rows a thread writes
constexpr int kGridY = 65535;
constexpr int kKgThreads = 256;
constexpr int kKgChunk = 128;  // T25: rows per pass-1 partial
constexpr int kMaxGroups = 32;

__device__ __forceinline__ float sq_dist(const float* __restrict__ a, const float* __restrict__ b,
                                         int p) {
  float d2 = 0.f;
  for (int q = 0; q < p; ++q) {
    const float t = __fsub_rn(a[q], b[q]);
    d2 = __fadd_rn(d2, __fmul_rn(t, t));
  }
  return d2;
}

// exp(-0.5 d2 / l^2), in the reference's order of roundings
__device__ __forceinline__ float rbf(float d2, float ell) {
  return expf(__fdiv_rn(__fmul_rn(-0.5f, d2), __fmul_rn(ell, ell)));
}

template <int V>
__global__ void __launch_bounds__(kCols * kLanes)
rbf_kernel(const float* __restrict__ a, const float* __restrict__ b, int na, int nb, int p,
           const float* __restrict__ ell, const float* __restrict__ scale,
           const float* __restrict__ ga, const float* __restrict__ gb,
           const float* __restrict__ Kg, int G, int same, float* __restrict__ out) {
  const int f = blockIdx.z;
  const int j0 = (blockIdx.x * kCols + threadIdx.x) * V;
  if (j0 >= nb) return;
  const float l = ell[f];
  const float s = scale[f];
  const float diag = __fadd_rn(__fsub_rn(1.f, s), 1e-4f);
  float gj[V];
#pragma unroll
  for (int u = 0; u < V; ++u) gj[u] = gb != nullptr ? gb[j0 + u] : 0.f;
  const float* kg = Kg != nullptr ? Kg + (int64_t)f * G * G : nullptr;
  float* o = out + (int64_t)f * na * nb;
  for (int rb = blockIdx.y; (int64_t)rb * kLanes * kRowsPer < na; rb += gridDim.y) {
#pragma unroll
    for (int t = 0; t < kRowsPer; ++t) {
      const int i = (rb * kRowsPer + t) * kLanes + threadIdx.y;
      if (i >= na) break;
      const float* ai = a + (int64_t)i * p;
      const float gi = ga != nullptr ? ga[i] : 0.f;
      __align__(16) float v[V];
#pragma unroll
      for (int u = 0; u < V; ++u) {
        float x = __fmul_rn(s, rbf(sq_dist(ai, b + (int64_t)(j0 + u) * p, p), l));
        if (ga != nullptr)
          x = __fmul_rn(x, kg != nullptr ? kg[(int)gi * G + (int)gj[u]]
                                         : (gi == gj[u] ? 1.f : 0.f));
        if (same && i == j0 + u) x = __fadd_rn(x, diag);
        v[u] = x;
      }
      if constexpr (V == 4) {
        *reinterpret_cast<float4*>(o + (int64_t)i * nb + j0) = *reinterpret_cast<const float4*>(v);
      } else {
        o[(int64_t)i * nb + j0] = v[0];
      }
    }
  }
}

// T25 pass 1: partial[f, chunk, j, g] = sum over the chunk's rows i with
// g_i = g of dK[f, i, j] exp(-d2 / 2 l^2), rows in index order
__global__ void __launch_bounds__(kKgThreads)
kg_grad_partial_kernel(const float* __restrict__ dK, const float* __restrict__ a,
                       const float* __restrict__ b, int na, int nb, int p,
                       const float* __restrict__ ell, const float* __restrict__ ga, int G,
                       int chunks,
                       float* __restrict__ partial) {
  const int f = blockIdx.z;
  const int chunk = blockIdx.y;
  const int j = blockIdx.x * kKgThreads + threadIdx.x;
  if (j >= nb) return;
  const float l = ell[f];
  const float* bj = b + (int64_t)j * p;
  float acc[kMaxGroups];
#pragma unroll
  for (int g = 0; g < kMaxGroups; ++g) acc[g] = 0.f;
  const float* dk = dK + (int64_t)f * na * nb;
  const int i1 = min(na, (chunk + 1) * kKgChunk);
  for (int i = chunk * kKgChunk; i < i1; ++i) {
    const float w = __fmul_rn(dk[(int64_t)i * nb + j], rbf(sq_dist(a + (int64_t)i * p, bj, p), l));
    const int g = (int)ga[i];
    acc[g] = __fadd_rn(acc[g], w);
  }
  float* out = partial + (((int64_t)f * chunks + chunk) * nb + j) * G;
  for (int g = 0; g < G; ++g) out[g] = acc[g];
}

// T25 pass 2: one block per (f, g, h); each thread sums every 256th column of
// group h over the chunks in order, then a tree over the threads
__global__ void __launch_bounds__(kKgThreads)
kg_grad_finish_kernel(const float* __restrict__ partial, const float* __restrict__ gb, int nb,
                      const float* __restrict__ scale, int G, int chunks,
                      float* __restrict__ dKg) {
  __shared__ float red[kKgThreads];
  const int f = blockIdx.x / (G * G);
  const int g = (blockIdx.x / G) % G;
  const int h = blockIdx.x % G;
  float s = 0.f;
  for (int j = threadIdx.x; j < nb; j += kKgThreads) {
    if ((int)gb[j] != h) continue;
    for (int c = 0; c < chunks; ++c)
      s = __fadd_rn(s, partial[(((int64_t)f * chunks + c) * nb + j) * G + g]);
  }
  red[threadIdx.x] = s;
  __syncthreads();
  for (int o = kKgThreads / 2; o > 0; o >>= 1) {
    if (threadIdx.x < o) red[threadIdx.x] = __fadd_rn(red[threadIdx.x], red[threadIdx.x + o]);
    __syncthreads();
  }
  if (threadIdx.x == 0) dKg[blockIdx.x] = __fmul_rn(scale[f], red[0]);
}

}  // namespace

extern "C" {

// T24. a (na x p), b (nb x p) f32; ell, scale (F) f32; ga (na), gb (nb) f32
// group labels (whole numbers) or both null; Kg (F x G x G) f32 or null;
// same = 1 when a and b are one point set (adds the diagonal term); out
// (F x na x nb) f32.
int mt_gp_rbf_kernel(const float* a, const float* b, int na, int nb, int p, const float* ell,
                     const float* scale, int F, const float* ga,
                     const float* gb, const float* Kg, int G, int same, float* out,
                     void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (na <= 0 || nb <= 0 || F <= 0) return (int)cudaGetLastError();
  if (F > 65535 || p <= 0 || (ga == nullptr) != (gb == nullptr)) return (int)cudaErrorInvalidValue;
  if (Kg != nullptr && (ga == nullptr || G <= 0)) return (int)cudaErrorInvalidValue;
  const int64_t row_blocks = ((int64_t)na + kLanes * kRowsPer - 1) / (kLanes * kRowsPer);
  // four columns and one 16-byte store a thread where the rows allow it
  const bool vec4 = nb % 4 == 0 && (uintptr_t)out % 16 == 0;
  const int groups = vec4 ? nb / 4 : nb;
  const dim3 grid((groups + kCols - 1) / kCols,
                  (unsigned)(row_blocks < kGridY ? row_blocks : kGridY), F);
  if (vec4)
    rbf_kernel<4><<<grid, dim3(kCols, kLanes), 0, s>>>(a, b, na, nb, p, ell, scale, ga, gb, Kg,
                                                       G, same, out);
  else
    rbf_kernel<1><<<grid, dim3(kCols, kLanes), 0, s>>>(a, b, na, nb, p, ell, scale, ga, gb, Kg,
                                                       G, same, out);
  return (int)cudaGetLastError();
}

// T25. dK (F x na x nb) f32, contiguous; a, b, ell, scale, ga, gb
// as for T24 (labels required, G <= 32 groups); partial (F x chunks x nb x G)
// f32 scratch with chunks = ceil(na / 128); dKg (F x G x G) f32 out.
int mt_gp_kg_grad(const float* dK, const float* a, const float* b, int na, int nb, int p,
                  const float* ell, const float* scale, int F,
                  const float* ga, const float* gb, int G, float* partial, float* dKg,
                  void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (F <= 0 || G <= 0) return (int)cudaGetLastError();
  if (G > kMaxGroups || F > 65535 || p <= 0 || ga == nullptr || gb == nullptr)
    return (int)cudaErrorInvalidValue;
  const int chunks = na > 0 ? (na + kKgChunk - 1) / kKgChunk : 0;
  if (chunks > 65535) return (int)cudaErrorInvalidValue;
  if (chunks > 0 && nb > 0)
    kg_grad_partial_kernel<<<dim3((nb + kKgThreads - 1) / kKgThreads, chunks, F), kKgThreads, 0,
                             s>>>(dK, a, b, na, nb, p, ell, ga, G, chunks, partial);
  kg_grad_finish_kernel<<<F * G * G, kKgThreads, 0, s>>>(partial, gb, nb, scale, G, chunks, dKg);
  return (int)cudaGetLastError();
}

}  // extern "C"
