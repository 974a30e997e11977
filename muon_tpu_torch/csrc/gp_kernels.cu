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
// 100,000 x 1,000 Knm, 0.12 ms at 3.35 TB/s). Each entry costs an exp on the
// special-function units (1e8 of them, 0.03 ms at their rate), a division
// and about a dozen other instructions, so the design keeps an entry's
// arithmetic under its write:
// - A thread owns four neighbouring columns (one where the row length is not
//   a multiple of 4 or the output is not 16-byte aligned), neighbouring
//   threads neighbouring columns, and writes each row's four entries with one
//   streaming 16-byte store (st.global.cs: the matrix is not read back here),
//   so a warp's stores are 512 contiguous bytes.
// - What does not change along a column stays in registers: the columns'
//   covariates (p = 1, 2, 3 in registers; from 4 on the run-time loop reads
//   them), their labels and Kg rows' offsets, the factor's l^2, s_f and the
//   diagonal term. A row's covariates and label are one broadcast load. A
//   learned Kg of up to 32 groups sits in shared memory.
// - The division by l^2 stays the IEEE __fdiv_rn: with l^2 fixed in a thread
//   the compiler hoists div.rn's reciprocal out of the loops, so an entry pays
//   the product with it, the fma corrections and one range check (FCHK). The
//   same product and two corrections written out, with their own range check
//   (exact for |x|, l^2 in [2^-60, 2^60] by Markstein's theorem), ran slower:
//   0.1750 ms against 0.1481 at the sparse path's Knm (exp_t24_variants.py).
// - The grid follows the output: a thread walks 16 rows when the output fills
//   two waves of the card with that, and fewer (down to 1) when it is small,
//   as the sparse path's 1,000 x 1,000 Kmm.
// Every entry is the first design's bits: the same operations in the same
// order.
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

constexpr int kCols = 64;   // T24: column threads per block
constexpr int kLanes = 4;   // T24: row lanes per block
constexpr int kMaxRowsPer = 16;  // T24: the most rows a thread walks
constexpr int kGridY = 65535;
constexpr int kSharedKg = 32;  // T24: a learned Kg of up to 32 groups in shared memory
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

// T24. P = 1, 2, 3 covariates in registers, P = 0 any p at run time; V
// columns a thread (4: one 16-byte store a row, or 1)
template <int P, int V>
__global__ void __launch_bounds__(kCols * kLanes)
rbf_kernel(const float* __restrict__ a, const float* __restrict__ b, int na, int nb, int p,
           const float* __restrict__ ell, const float* __restrict__ scale,
           const float* __restrict__ ga, const float* __restrict__ gb,
           const float* __restrict__ Kg, int G, int same, int rows_per,
           float* __restrict__ out) {
  __shared__ float skg[kSharedKg * kSharedKg];
  const int f = blockIdx.z;
  const float* kg = Kg != nullptr ? Kg + (int64_t)f * G * G : nullptr;
  if (kg != nullptr && G <= kSharedKg) {
    for (int t = threadIdx.y * kCols + threadIdx.x; t < G * G; t += kCols * kLanes)
      skg[t] = kg[t];
    __syncthreads();
    kg = skg;
  }
  const int j0 = (blockIdx.x * kCols + threadIdx.x) * V;
  if (j0 >= nb) return;
  const float l = ell[f];
  const float s = scale[f];
  const float diag = __fadd_rn(__fsub_rn(1.f, s), 1e-4f);
  const float y = __fmul_rn(l, l);
  float bj[V][P > 0 ? P : 1];
  float gj[V];
  int kj[V];  // the columns' rows of Kg
#pragma unroll
  for (int u = 0; u < V; ++u) {
    gj[u] = gb != nullptr ? gb[j0 + u] : 0.f;
    kj[u] = (int)gj[u];
    if constexpr (P > 0) {
#pragma unroll
      for (int q = 0; q < P; ++q) bj[u][q] = b[(int64_t)(j0 + u) * P + q];
    }
  }
  float* o = out + (int64_t)f * na * nb;
  const int64_t rows_blk = (int64_t)kLanes * rows_per;
  for (int64_t rb = blockIdx.y; rb * rows_blk < na; rb += gridDim.y) {
    for (int t = 0; t < rows_per; ++t) {
      const int64_t i = (rb * rows_per + t) * kLanes + threadIdx.y;
      if (i >= na) break;
      float ai[P > 0 ? P : 1];
      if constexpr (P > 0) {
#pragma unroll
        for (int q = 0; q < P; ++q) ai[q] = a[i * P + q];
      }
      const float gi = ga != nullptr ? ga[i] : 0.f;
      const int ki = (int)gi * G;
      __align__(16) float v[V];
#pragma unroll
      for (int u = 0; u < V; ++u) {
        float d2;
        if constexpr (P > 0) {
          // 0 + t^2 is t^2 (t^2 is never -0), so the first term starts the sum
          const float d0 = __fsub_rn(ai[0], bj[u][0]);
          d2 = __fmul_rn(d0, d0);
#pragma unroll
          for (int q = 1; q < P; ++q) {
            const float dq = __fsub_rn(ai[q], bj[u][q]);
            d2 = __fadd_rn(d2, __fmul_rn(dq, dq));
          }
        } else {
          d2 = sq_dist(a + i * p, b + (int64_t)(j0 + u) * p, p);
        }
        const float x = __fmul_rn(-0.5f, d2);
        float e = expf(__fdiv_rn(x, y));
        e = __fmul_rn(s, e);
        if (ga != nullptr)
          e = __fmul_rn(e, kg != nullptr ? kg[ki + kj[u]] : (gi == gj[u] ? 1.f : 0.f));
        if (same && i == j0 + u) e = __fadd_rn(e, diag);
        v[u] = e;
      }
      float* dst = o + i * nb + j0;
      if constexpr (V == 4) {
        __stcs(reinterpret_cast<float4*>(dst), *reinterpret_cast<const float4*>(v));
      } else {
        __stcs(dst, v[0]);
      }
    }
  }
}

template <int P>
void launch_rbf(bool vec4, dim3 grid, const float* a, const float* b, int na, int nb, int p,
                const float* ell, const float* scale, const float* ga, const float* gb,
                const float* Kg, int G, int same, int rows_per, float* out, cudaStream_t s) {
  if (vec4)
    rbf_kernel<P, 4><<<grid, dim3(kCols, kLanes), 0, s>>>(a, b, na, nb, p, ell, scale, ga, gb,
                                                          Kg, G, same, rows_per, out);
  else
    rbf_kernel<P, 1><<<grid, dim3(kCols, kLanes), 0, s>>>(a, b, na, nb, p, ell, scale, ga, gb,
                                                          Kg, G, same, rows_per, out);
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
  // four columns and one 16-byte store a thread where the rows allow it
  const bool vec4 = nb % 4 == 0 && (uintptr_t)out % 16 == 0;
  const int groups = vec4 ? nb / 4 : nb;
  const int64_t col_blocks = (groups + kCols - 1) / kCols;
  // the most rows a thread (up to kMaxRowsPer) that still gives two waves
  // of full blocks: 132 SMs x 8 blocks of 256 threads, twice
  int rows_per = kMaxRowsPer;
  while (rows_per > 1 &&
         F * col_blocks * ((na + (int64_t)kLanes * rows_per - 1) / (kLanes * rows_per)) < 2112)
    rows_per /= 2;
  const int64_t row_blocks = (na + (int64_t)kLanes * rows_per - 1) / (kLanes * rows_per);
  const dim3 grid((unsigned)col_blocks, (unsigned)(row_blocks < kGridY ? row_blocks : kGridY), F);
#define MT_RBF(PP)                                                                     \
  launch_rbf<PP>(vec4, grid, a, b, na, nb, p, ell, scale, ga, gb, Kg, G, same, rows_per, \
                 out, s)
  switch (p) {
    case 1: MT_RBF(1); break;
    case 2: MT_RBF(2); break;
    case 3: MT_RBF(3); break;
    default: MT_RBF(0); break;
  }
#undef MT_RBF
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
