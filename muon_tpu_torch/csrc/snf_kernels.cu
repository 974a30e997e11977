// Kernels of similarity network fusion (tl.snf), for Hopper (sm_90a).
//
//   T29 snf_affinity      <- muon_tpu/_core/tools_graph.py _affinity_matrix (:78)
//   T30 snf_normalize     <- _snf_diffusion_fn (:35): normalize
//   T31 snf_dominate_set  <- _snf_diffusion_fn (:35): dominateset
//
// All three work on dense (n x n) f32 matrices, row-major; the diffusion's
// products S x other x S^T stay dense torch.matmul in float32, as the
// reference computes them.
//
// T29, the local-scale Gaussian affinity of a kNN distance matrix `dist`
// and its known-mask (uint8): the mask made symmetric, the symmetric
// distance S_ij = (d_ij + d_ji) / 2 where known (inf elsewhere, 0 on the
// diagonal), then
//   pass 1 (a block of 64 threads per row): each thread keeps the k + 1
//     smallest finite S_ij of its share of the row in a max-heap
//     (topk_heap.cuh, ordered by (value, column)), the block merges the 64
//     sorted lists pairwise, and means_i is the mean of the 2nd through
//     (k+1)-th smallest finite values + eps (the reference sorts whole rows);
//   pass 2 (32 x 32 tiles): a tile of dist and of the mask and their
//     transposed tiles through shared memory give S_ij and S_ji, and
//       sig = (m_i + m_j) / 3 + S / 3 + eps,  scale = sigma sig,
//       dens = exp(-0.5 (S / scale)^2) / (scale sqrt(2 pi))
//     (0 where S is infinite, 0 on the diagonal); out = (dens + dens^T) / 2,
//     each operation rounded in the reference's order.
// Pass 1 reads a row and (strided) a column of dist and the mask; pass 2
// reads both once more and writes the result: bound by bytes.
//
// T30, normalize: row_i = sum_j x_ij - x_ii (1 where that is 0), one block per
// row summing in a fixed order and a tree; then over 32 x 32 tiles
// y_ij = x_ij / (2 row_i) (0.5 on the diagonal) and out = (y + y^T) / 2, the
// transposed tile through shared memory. Two reads and one write: bytes.
//
// T31, dominate set: per row the k-th largest value counted with its
// repeats (lax.top_k's k-th value: a heap of the k smallest (-x, column) per
// thread, merged as in T29), every entry >= it kept, the rest 0, and the kept
// row divided by its sum (summed in a fixed order and a tree). Bytes.
//
// Interface: plain C functions loaded with ctypes (sparse_kernels.cu). Each
// launches on the stream it is given, allocates nothing, and returns
// cudaGetLastError(). Scratch and outputs are allocated by the caller.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "topk_heap.cuh"

namespace {

constexpr int kSel = 64;        // threads per row in the selections
constexpr int kTile = 32;       // tile side of the tiled passes
constexpr int kTileRows = 8;    // thread rows of a tile block
constexpr int kRowThreads = 256;
constexpr float kSqrt2Pi = 2.5066282746310002f;  // sqrt(2 pi), rounded to f32

size_t select_shm(int cap) {
  // four (kSel x cap) arrays (values, columns, and the merge's buffers) + counts
  return (size_t)kSel * cap * (2 * sizeof(float) + 2 * sizeof(int)) + kSel * sizeof(int);
}

// Each thread of the block has an ascending list of up to cap entries at
// hd/hi + t*cap, of length cnt[t]. Merge them pairwise, in log2(kSel) rounds,
// into thread 0's slot: the cap smallest (d, i) of them all, ascending.
__device__ void merge_lists(float* hd, int* hi, int* cnt, float* td, int* ti,
                            int cap) {
  const int t = threadIdx.x;
  for (int stride = 1; stride < kSel; stride <<= 1) {
    __syncthreads();
    if (t % (2 * stride) == 0) {
      float* ad = hd + t * cap;
      int* ai = hi + t * cap;
      const float* bd = hd + (t + stride) * cap;
      const int* bi = hi + (t + stride) * cap;
      const int na = cnt[t], nb = cnt[t + stride];
      float* od = td + t * cap;
      int* oi = ti + t * cap;
      int a = 0, b = 0, m = 0;
      for (; m < cap && (a < na || b < nb); ++m) {
        if (b >= nb || (a < na && before(ad[a], ai[a], bd[b], bi[b]))) {
          od[m] = ad[a];
          oi[m] = ai[a];
          ++a;
        } else {
          od[m] = bd[b];
          oi[m] = bi[b];
          ++b;
        }
      }
      for (int e = 0; e < m; ++e) {
        ad[e] = od[e];
        ai[e] = oi[e];
      }
      cnt[t] = m;
    }
  }
  __syncthreads();
}

// offer (d, j) to the thread's heap of m of at most cap entries; returns m
__device__ __forceinline__ int offer(float* hd, int* hi, int m, int cap, float d,
                                     int j) {
  if (m < cap) return heap_push(hd, hi, m, d, j);
  if (before(d, j, hd[0], hi[0])) {
    hd[0] = d;
    hi[0] = j;
    sift_down(hd, hi, m, 0);
  }
  return m;
}

__device__ __forceinline__ float sym_dist(float dij, float dji, bool known) {
  return known ? __fdiv_rn(__fadd_rn(dij, dji), 2.f) : INFINITY;
}

// T29 pass 1: means_i = mean of the 2nd .. (k+1)-th smallest finite S_ij + eps
__global__ void __launch_bounds__(kSel)
snf_affinity_means_kernel(const float* __restrict__ dist,
                          const unsigned char* __restrict__ known, int n, int cap,
                          float eps, float* __restrict__ means) {
  extern __shared__ unsigned char smem[];
  float* hd = (float*)smem;
  int* hi = (int*)(hd + kSel * cap);
  float* td = (float*)(hi + kSel * cap);
  int* ti = (int*)(td + kSel * cap);
  int* cnt = ti + kSel * cap;
  const int i = blockIdx.x;
  float* myd = hd + threadIdx.x * cap;
  int* myi = hi + threadIdx.x * cap;
  int m = 0;
  for (int j = threadIdx.x; j < n; j += kSel) {
    const int64_t ij = (int64_t)i * n + j, ji = (int64_t)j * n + i;
    const float d = i == j ? 0.f : sym_dist(dist[ij], dist[ji], known[ij] || known[ji]);
    if (isfinite(d)) m = offer(myd, myi, m, cap, d, j);
  }
  heap_sort(myd, myi, m);
  cnt[threadIdx.x] = m;
  merge_lists(hd, hi, cnt, td, ti, cap);
  if (threadIdx.x == 0) {
    float s = 0.f;
    for (int e = 1; e < cnt[0]; ++e) s = __fadd_rn(s, hd[e]);
    means[i] = __fadd_rn(__fdiv_rn(s, (float)max(cnt[0] - 1, 1)), eps);
  }
}

__device__ __forceinline__ float density(float dij, float dji, bool known, bool diag,
                                         float mi, float mj, float sigma, float eps) {
  const float S = diag ? 0.f : sym_dist(dij, dji, known);
  if (diag || !isfinite(S)) return 0.f;
  const float sig = __fadd_rn(__fadd_rn(__fdiv_rn(__fadd_rn(mi, mj), 3.f), __fdiv_rn(S, 3.f)),
                              eps);
  const float scale = __fmul_rn(sigma, sig);
  const float q = __fdiv_rn(S, scale);
  return __fdiv_rn(expf(__fmul_rn(-0.5f, __fmul_rn(q, q))), __fmul_rn(scale, kSqrt2Pi));
}

// T29 pass 2: out over 32 x 32 tiles, the transposed tile through shared memory
__global__ void __launch_bounds__(kTile * kTileRows)
snf_affinity_tile_kernel(const float* __restrict__ dist,
                         const unsigned char* __restrict__ known,
                         const float* __restrict__ means, int n, float sigma,
                         float eps, float* __restrict__ out) {
  __shared__ float dA[kTile][kTile + 1], dB[kTile][kTile + 1];
  __shared__ unsigned char kA[kTile][kTile + 1], kB[kTile][kTile + 1];
  const int i0 = blockIdx.y * kTile, j0 = blockIdx.x * kTile;
  for (int r = threadIdx.y; r < kTile; r += kTileRows) {
    const int ia = i0 + r, ja = j0 + threadIdx.x;  // tile (i0, j0)
    const int ib = j0 + r, jb = i0 + threadIdx.x;  // tile (j0, i0)
    const bool okA = ia < n && ja < n, okB = ib < n && jb < n;
    dA[r][threadIdx.x] = okA ? dist[(int64_t)ia * n + ja] : 0.f;
    kA[r][threadIdx.x] = okA ? known[(int64_t)ia * n + ja] : 0;
    dB[r][threadIdx.x] = okB ? dist[(int64_t)ib * n + jb] : 0.f;
    kB[r][threadIdx.x] = okB ? known[(int64_t)ib * n + jb] : 0;
  }
  __syncthreads();
  const int c = threadIdx.x, j = j0 + c;
  if (j >= n) return;
  const float mj = means[j];
  for (int r = threadIdx.y; r < kTile; r += kTileRows) {
    const int i = i0 + r;
    if (i >= n) break;
    const float mi = means[i];
    const float dij = dA[r][c], dji = dB[c][r];
    const bool kn = kA[r][c] || kB[c][r];
    const float fij = density(dij, dji, kn, i == j, mi, mj, sigma, eps);
    const float fji = density(dji, dij, kn, i == j, mj, mi, sigma, eps);
    out[(int64_t)i * n + j] = __fdiv_rn(__fadd_rn(fij, fji), 2.f);
  }
}

// T30 pass 1: row_i = sum_j x_ij - x_ii, 1 where that is 0
__global__ void __launch_bounds__(kRowThreads)
snf_row_sums_kernel(const float* __restrict__ x, int n, float* __restrict__ row) {
  __shared__ float acc[kRowThreads];
  const int i = blockIdx.x;
  const float* xi = x + (int64_t)i * n;
  float s = 0.f;
  for (int j = threadIdx.x; j < n; j += kRowThreads) s = __fadd_rn(s, xi[j]);
  acc[threadIdx.x] = s;
  __syncthreads();
  for (int h = kRowThreads / 2; h > 0; h >>= 1) {
    if (threadIdx.x < h) acc[threadIdx.x] = __fadd_rn(acc[threadIdx.x], acc[threadIdx.x + h]);
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    const float r = __fsub_rn(acc[0], xi[i]);
    row[i] = r == 0.f ? 1.f : r;
  }
}

// T30 pass 2: out = (y + y^T) / 2, y = x / (2 row) with 0.5 on the diagonal
__global__ void __launch_bounds__(kTile * kTileRows)
snf_normalize_tile_kernel(const float* __restrict__ x, const float* __restrict__ row,
                          int n, float* __restrict__ out) {
  __shared__ float tB[kTile][kTile + 1];
  const int i0 = blockIdx.y * kTile, j0 = blockIdx.x * kTile;
  for (int r = threadIdx.y; r < kTile; r += kTileRows) {
    const int ib = j0 + r, jb = i0 + threadIdx.x;  // tile (j0, i0): y_ji
    tB[r][threadIdx.x] = (ib < n && jb < n)
        ? (ib == jb ? 0.5f : __fdiv_rn(x[(int64_t)ib * n + jb], __fmul_rn(2.f, row[ib])))
        : 0.f;
  }
  __syncthreads();
  const int c = threadIdx.x, j = j0 + c;
  if (j >= n) return;
  for (int r = threadIdx.y; r < kTile; r += kTileRows) {
    const int i = i0 + r;
    if (i >= n) break;
    const float yij = i == j ? 0.5f
                             : __fdiv_rn(x[(int64_t)i * n + j], __fmul_rn(2.f, row[i]));
    out[(int64_t)i * n + j] = __fdiv_rn(__fadd_rn(yij, tB[c][r]), 2.f);
  }
}

// T31: a block of 64 threads per row
__global__ void __launch_bounds__(kSel)
snf_dominate_set_kernel(const float* __restrict__ x, int n, int k,
                        float* __restrict__ out) {
  extern __shared__ unsigned char smem[];
  float* hd = (float*)smem;
  int* hi = (int*)(hd + kSel * k);
  float* td = (float*)(hi + kSel * k);
  int* ti = (int*)(td + kSel * k);
  int* cnt = ti + kSel * k;
  __shared__ float acc[kSel];
  __shared__ float thresh;
  const int i = blockIdx.x;
  const float* xi = x + (int64_t)i * n;
  float* myd = hd + threadIdx.x * k;
  int* myi = hi + threadIdx.x * k;
  int m = 0;
  for (int j = threadIdx.x; j < n; j += kSel) m = offer(myd, myi, m, k, -xi[j], j);
  heap_sort(myd, myi, m);
  cnt[threadIdx.x] = m;
  merge_lists(hd, hi, cnt, td, ti, k);
  if (threadIdx.x == 0) thresh = -hd[k - 1];
  __syncthreads();
  const float th = thresh;
  float s = 0.f;
  for (int j = threadIdx.x; j < n; j += kSel) s = __fadd_rn(s, xi[j] >= th ? xi[j] : 0.f);
  acc[threadIdx.x] = s;
  __syncthreads();
  for (int h = kSel / 2; h > 0; h >>= 1) {
    if (threadIdx.x < h) acc[threadIdx.x] = __fadd_rn(acc[threadIdx.x], acc[threadIdx.x + h]);
    __syncthreads();
  }
  const float total = acc[0];
  float* oi = out + (int64_t)i * n;
  for (int j = threadIdx.x; j < n; j += kSel)
    oi[j] = __fdiv_rn(xi[j] >= th ? xi[j] : 0.f, total);
}

cudaError_t allow_shm(const void* kernel, size_t shm) {
  if (shm <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)shm);
}

dim3 tiles(int n) {
  return dim3((n + kTile - 1) / kTile, (n + kTile - 1) / kTile);
}

}  // namespace

extern "C" {

// T29. dist (n x n) f32 and known (n x n) uint8; k the neighbours of the
// local scale; means (n,) f32 scratch; out (n x n) f32.
int mt_snf_affinity(const float* dist, const unsigned char* known, int n, int k,
                    float sigma, float eps, float* means, float* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n <= 0) return (int)cudaGetLastError();
  const size_t shm = select_shm(k + 1);
  cudaError_t e = allow_shm((const void*)snf_affinity_means_kernel, shm);
  if (e != cudaSuccess) return (int)e;
  snf_affinity_means_kernel<<<n, kSel, shm, s>>>(dist, known, n, k + 1, eps, means);
  snf_affinity_tile_kernel<<<tiles(n), dim3(kTile, kTileRows), 0, s>>>(
      dist, known, means, n, sigma, eps, out);
  return (int)cudaGetLastError();
}

// T30. x (n x n) f32; row (n,) f32 scratch; out (n x n) f32.
int mt_snf_normalize(const float* x, int n, float* row, float* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n <= 0) return (int)cudaGetLastError();
  snf_row_sums_kernel<<<n, kRowThreads, 0, s>>>(x, n, row);
  snf_normalize_tile_kernel<<<tiles(n), dim3(kTile, kTileRows), 0, s>>>(x, row, n, out);
  return (int)cudaGetLastError();
}

// T31. x (n x n) f32, 1 <= k <= n; out (n x n) f32.
int mt_snf_dominate_set(const float* x, int n, int k, float* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n <= 0) return (int)cudaGetLastError();
  const size_t shm = select_shm(k);
  cudaError_t e = allow_shm((const void*)snf_dominate_set_kernel, shm);
  if (e != cudaSuccess) return (int)e;
  snf_dominate_set_kernel<<<n, kSel, shm, s>>>(x, n, k, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
