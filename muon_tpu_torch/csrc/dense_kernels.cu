// Dense normalisation kernels, for Hopper (sm_90a).
//
//   T12 clr_dense     <- muon_tpu/ops/dense.py _clr_dense_fn, and the inline
//                        seurat CLR of muon_tpu/prot/preproc.py clr (dense X)
//   T34 tfidf_dense   <- muon_tpu/ops/dense.py _tfidf_dense_fn
//   T35 l2norm_dense  <- muon_tpu/ops/dense.py _l2norm_fn
//
// T12. X is (n x d) f32, row-major. gm = mean(log1p(X), axis), then one of two
// forms, both of the reference:
//   seurat = 0: out = log1p(x) - gm            (clr_dense)
//   seurat = 1: out = log1p(x / exp(gm))       (prot.pp.clr, flavor seurat)
// The division is the reference's x / exp(gm), not x * exp(-gm).
//
// The work is one read of X, a reduction, and one read and one write of X:
// at the e2e's 100,000 x 120 that is 48 MB read and 48 MB written at least,
// about 29 us at 3.35 TB/s, so the kernel is bound by bytes. The simple
// design here reads X twice (the reduction, then the elementwise pass; the
// second read partly hits the 50 MB L2) and spends nothing on arithmetic.
//   axis 0 (a mean per column over n rows): pass 1, a block per tile of
//     kTileRows rows and 32 columns, 8 row lanes per column, each summing
//     every 8th row of the tile, then a tree over the 8 lanes in shared
//     memory: one partial per (tile, column); pass 2, a block per column
//     sums the tiles' partials by a tree: gm; pass 3, the elementwise form.
//     No atomics, so the sums are the same in every run, and every sum is a
//     short sequence or a tree (float32 throughout, as the reference).
//   axis 1 (a mean per row over d columns): a warp per row sums its row by
//     lanes and a butterfly, then writes the row.
//
// T34. The reference's dense TF-IDF in float32: rs = row sums, tf = x / rs
// (non-finite to 0), times scale (when given), log1p under log_tf; idf =
// n / column sums, log1p under log_idf; out = tf idf, log1p under log_tfidf,
// non-finite to 0 (an all-zero row gives 0/0, an all-zero column n/0 = inf:
// both end as 0, as jnp.where(jnp.isfinite(...)) gives them). It needs both
// sums before it writes, so it reads X twice and writes once: 30 GB at the
// smoke's 100,000 x 25,000 against the bound's 20 GB (6.0 ms). Pass 1 reads
// each tile of kSumRows rows x 256 columns once for both sums: a warp per
// row of the tile, 8 columns a lane, the lane's 8 values summed and then a
// butterfly over the lanes gives a partial row sum per (column tile, row);
// each lane's 8 column sums over its warp's rows, then a tree over the 8
// warps, give a partial column sum per (row tile, column). Pass 2 adds the
// partials in tile order (no atomics: the same sums in every run) and forms
// the idf vector; pass 3 writes the values, an element a thread.
//
// T35. rows to unit L2 norm, x / sqrt(sum x^2), a zero norm taken as 1. The
// bound is the bytes (X read and the result written once); a row is read
// twice, the second time from L1. A warp per row up to kWarpRowMax columns
// (an X_pca), a block per row beyond (a dense X).
//
// Interface: plain C functions (loaded with ctypes), as in
// sparse_kernels.cu. Each launches on the stream it is given, allocates
// nothing, and returns cudaGetLastError(). Outputs and scratch are
// allocated by the caller.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTileRows = 256;  // rows per partial sum (axis 0); ops/dense.py
constexpr int kColLanes = 32;   // columns per pass-1 block
constexpr int kRowLanes = 8;    // row lanes per column in pass 1
constexpr int kFinishThreads = 256;
constexpr int kWarp = 32;
constexpr int kWarpsPerBlock = 8;
constexpr int kSumRows = 256;    // rows per T34 sums tile; ops/dense.py
constexpr int kSumCols = 256;    // columns per T34 sums tile (8 per lane)
constexpr int kWarpRowMax = 1024;  // T35: a warp per row up to this width

__device__ __forceinline__ float clr_value(float x, float gm, int seurat) {
  return seurat ? log1pf(__fdiv_rn(x, expf(gm))) : __fsub_rn(log1pf(x), gm);
}

// pass 1 (axis 0): partial[tile, c] = sum of log1p(X[r, c]) over the tile
__global__ void __launch_bounds__(kColLanes * kRowLanes)
clr_col_partial_kernel(const float* __restrict__ X, int n, int d,
                       float* __restrict__ partial) {
  __shared__ float acc[kRowLanes][kColLanes];
  const int c = blockIdx.y * kColLanes + threadIdx.x;
  const int r0 = blockIdx.x * kTileRows;
  const int r1 = min(r0 + kTileRows, n);
  float s = 0.f;
  if (c < d)
    for (int r = r0 + threadIdx.y; r < r1; r += kRowLanes)
      s = __fadd_rn(s, log1pf(X[(int64_t)r * d + c]));
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

// pass 2 (axis 0): gm[c] = (sum over tiles of partial[tile, c]) / n
__global__ void __launch_bounds__(kFinishThreads)
clr_col_finish_kernel(const float* __restrict__ partial, int n_tiles, int n,
                      int d, float* __restrict__ gm) {
  __shared__ float acc[kFinishThreads];
  const int c = blockIdx.x;
  float s = 0.f;
  for (int t = threadIdx.x; t < n_tiles; t += kFinishThreads)
    s = __fadd_rn(s, partial[(int64_t)t * d + c]);
  acc[threadIdx.x] = s;
  __syncthreads();
  for (int h = kFinishThreads / 2; h > 0; h >>= 1) {
    if (threadIdx.x < h) acc[threadIdx.x] = __fadd_rn(acc[threadIdx.x], acc[threadIdx.x + h]);
    __syncthreads();
  }
  if (threadIdx.x == 0) gm[c] = __fdiv_rn(acc[0], (float)n);
}

// pass 3 (axis 0): the elementwise form, gm per column
__global__ void clr_col_apply_kernel(const float* __restrict__ X, int64_t total,
                                     int d, const float* __restrict__ gm,
                                     int seurat, float* __restrict__ out) {
  for (int64_t e = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; e < total;
       e += (int64_t)gridDim.x * blockDim.x)
    out[e] = clr_value(X[e], gm[e % d], seurat);
}

// axis 1: a warp per row
__global__ void __launch_bounds__(kWarp * kWarpsPerBlock)
clr_row_kernel(const float* __restrict__ X, int n, int d, int seurat,
               float* __restrict__ gm, float* __restrict__ out) {
  const int row = blockIdx.x * kWarpsPerBlock + threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  if (row >= n) return;
  const float* x = X + (int64_t)row * d;
  float s = 0.f;
  for (int c = lane; c < d; c += kWarp) s = __fadd_rn(s, log1pf(x[c]));
#pragma unroll
  for (int o = kWarp / 2; o > 0; o >>= 1)
    s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, o));
  const float g = __fdiv_rn(s, (float)d);
  if (lane == 0) gm[row] = g;
  float* y = out + (int64_t)row * d;
  for (int c = lane; c < d; c += kWarp) y[c] = clr_value(x[c], g, seurat);
}

// T34 pass 1: rowpart[ct, r] = sum of X[r, tile ct]; colpart[rt, c] = sum of
// X[tile rt, c]
__global__ void __launch_bounds__(kWarp * kWarpsPerBlock)
tfidf_sums_kernel(const float* __restrict__ X, int n, int d,
                  float* __restrict__ rowpart, float* __restrict__ colpart) {
  __shared__ float acc[kWarpsPerBlock][kSumCols];
  constexpr int kPer = kSumCols / kWarp;
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  const int c0 = blockIdx.x * kSumCols, r0 = blockIdx.y * kSumRows;
  const int r1 = min(r0 + kSumRows, n);
  float col[kPer] = {};
  for (int r = r0 + warp; r < r1; r += kWarpsPerBlock) {
    const float* x = X + (int64_t)r * d;
    float s = 0.f;
#pragma unroll
    for (int p = 0; p < kPer; ++p) {
      const int c = c0 + lane + kWarp * p;
      const float v = c < d ? x[c] : 0.f;
      col[p] = __fadd_rn(col[p], v);
      s = __fadd_rn(s, v);
    }
#pragma unroll
    for (int o = kWarp / 2; o > 0; o >>= 1)
      s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, o));
    if (lane == 0) rowpart[(int64_t)blockIdx.x * n + r] = s;
  }
#pragma unroll
  for (int p = 0; p < kPer; ++p) acc[warp][lane + kWarp * p] = col[p];
  __syncthreads();
  for (int h = kWarpsPerBlock / 2; h > 0; h >>= 1) {
    if (warp < h)
#pragma unroll
      for (int p = 0; p < kPer; ++p)
        acc[warp][lane + kWarp * p] =
            __fadd_rn(acc[warp][lane + kWarp * p], acc[warp + h][lane + kWarp * p]);
    __syncthreads();
  }
  if (warp == 0)
#pragma unroll
    for (int p = 0; p < kPer; ++p) {
      const int c = c0 + lane + kWarp * p;
      if (c < d) colpart[(int64_t)blockIdx.y * d + c] = acc[0][lane + kWarp * p];
    }
}

// T34 pass 2: rs[r] over the column tiles; idf[c] = n / (sum over the row
// tiles), log1p under log_idf
__global__ void tfidf_finish_kernel(const float* __restrict__ rowpart,
                                    const float* __restrict__ colpart, int n, int d,
                                    int n_col_tiles, int n_row_tiles, int log_idf,
                                    float* __restrict__ rs, float* __restrict__ idf) {
  const int64_t e = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (e < n) {
    float s = 0.f;
    for (int t = 0; t < n_col_tiles; ++t) s = __fadd_rn(s, rowpart[(int64_t)t * n + e]);
    rs[e] = s;
  } else if (e < (int64_t)n + d) {
    const int64_t c = e - n;
    float s = 0.f;
    for (int t = 0; t < n_row_tiles; ++t) s = __fadd_rn(s, colpart[(int64_t)t * d + c]);
    const float v = __fdiv_rn((float)n, s);
    idf[c] = log_idf ? log1pf(v) : v;
  }
}

// T34 pass 3: the values
__global__ void tfidf_apply_kernel(const float* __restrict__ X, int64_t total, int d,
                                   const float* __restrict__ rs,
                                   const float* __restrict__ idf, int log_tf,
                                   int log_tfidf, int has_scale, float scale,
                                   float* __restrict__ out) {
  for (int64_t e = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; e < total;
       e += (int64_t)gridDim.x * blockDim.x) {
    float tf = __fdiv_rn(X[e], rs[e / d]);
    if (!isfinite(tf)) tf = 0.f;
    if (has_scale) tf = __fmul_rn(tf, scale);
    if (log_tf) tf = log1pf(tf);
    float v = __fmul_rn(tf, idf[e % d]);
    if (log_tfidf) v = log1pf(v);
    out[e] = isfinite(v) ? v : 0.f;
  }
}

__device__ __forceinline__ float unit_norm(float sq) {
  const float norm = sqrtf(sq);
  return norm == 0.f ? 1.f : norm;
}

// T35, rows up to kWarpRowMax wide: a warp per row
__global__ void __launch_bounds__(kWarp * kWarpsPerBlock)
l2norm_warp_kernel(const float* __restrict__ X, int n, int d, float* __restrict__ out) {
  const int row = blockIdx.x * kWarpsPerBlock + threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  if (row >= n) return;
  const float* x = X + (int64_t)row * d;
  float s = 0.f;
  for (int c = lane; c < d; c += kWarp) s = fmaf(x[c], x[c], s);
#pragma unroll
  for (int o = kWarp / 2; o > 0; o >>= 1)
    s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, o));
  const float norm = unit_norm(s);
  float* y = out + (int64_t)row * d;
  for (int c = lane; c < d; c += kWarp) y[c] = __fdiv_rn(x[c], norm);
}

// T35, wider rows: a block per row, a tree over its threads
__global__ void __launch_bounds__(kFinishThreads)
l2norm_block_kernel(const float* __restrict__ X, int d, float* __restrict__ out) {
  __shared__ float acc[kFinishThreads];
  const float* x = X + (int64_t)blockIdx.x * d;
  float s = 0.f;
  for (int c = threadIdx.x; c < d; c += kFinishThreads) s = fmaf(x[c], x[c], s);
  acc[threadIdx.x] = s;
  __syncthreads();
  for (int h = kFinishThreads / 2; h > 0; h >>= 1) {
    if (threadIdx.x < h) acc[threadIdx.x] = __fadd_rn(acc[threadIdx.x], acc[threadIdx.x + h]);
    __syncthreads();
  }
  const float norm = unit_norm(acc[0]);
  float* y = out + (int64_t)blockIdx.x * d;
  for (int c = threadIdx.x; c < d; c += kFinishThreads) y[c] = __fdiv_rn(x[c], norm);
}

}  // namespace

extern "C" {

// T12. X (n x d) f32; axis 0 or 1; seurat selects the form; partial
// (ceil(n / 256) x d) f32 scratch for axis 0 (unused for axis 1); gm (d,)
// for axis 0 or (n,) for axis 1, and out (n x d), f32 out.
int mt_clr_dense(const float* X, int n, int d, int axis, int seurat,
                 float* partial, float* gm, float* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n <= 0 || d <= 0) return (int)cudaGetLastError();
  if (axis == 0) {
    const int n_tiles = (n + kTileRows - 1) / kTileRows;
    const dim3 grid(n_tiles, (d + kColLanes - 1) / kColLanes);
    clr_col_partial_kernel<<<grid, dim3(kColLanes, kRowLanes), 0, s>>>(X, n, d, partial);
    clr_col_finish_kernel<<<d, kFinishThreads, 0, s>>>(partial, n_tiles, n, d, gm);
    const int64_t total = (int64_t)n * d;
    int64_t blocks = (total + 255) / 256;
    if (blocks > 132 * 16) blocks = 132 * 16;  // grid-stride beyond 16 per SM
    clr_col_apply_kernel<<<(int)blocks, 256, 0, s>>>(X, total, d, gm, seurat, out);
  } else {
    const int blocks = (n + kWarpsPerBlock - 1) / kWarpsPerBlock;
    clr_row_kernel<<<blocks, kWarp * kWarpsPerBlock, 0, s>>>(X, n, d, seurat, gm, out);
  }
  return (int)cudaGetLastError();
}

// T34. X (n x d) f32; rowpart (ceil(d / 256) x n) and colpart (ceil(n / 256)
// x d) f32 scratch; rs (n,) and idf (d,) f32 out (the row sums and the idf
// vector); out (n x d) f32. has_scale: multiply tf by scale.
int mt_tfidf_dense(const float* X, int n, int d, int log_tf, int log_idf, int log_tfidf,
                   int has_scale, float scale, float* rowpart, float* colpart, float* rs,
                   float* idf, float* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n <= 0 || d <= 0) return (int)cudaGetLastError();
  const int n_col_tiles = (d + kSumCols - 1) / kSumCols;
  const int n_row_tiles = (n + kSumRows - 1) / kSumRows;
  tfidf_sums_kernel<<<dim3(n_col_tiles, n_row_tiles), kWarp * kWarpsPerBlock, 0, s>>>(
      X, n, d, rowpart, colpart);
  const int64_t both = (int64_t)n + d;
  tfidf_finish_kernel<<<(unsigned)((both + 255) / 256), 256, 0, s>>>(
      rowpart, colpart, n, d, n_col_tiles, n_row_tiles, log_idf, rs, idf);
  const int64_t total = (int64_t)n * d;
  int64_t blocks = (total + 255) / 256;
  if (blocks > 132 * 16) blocks = 132 * 16;  // grid-stride beyond 16 per SM
  tfidf_apply_kernel<<<(int)blocks, 256, 0, s>>>(X, total, d, rs, idf, log_tf, log_tfidf,
                                                 has_scale, scale, out);
  return (int)cudaGetLastError();
}

// T35. X (n x d) f32; out (n x d) f32.
int mt_l2norm_dense(const float* X, int n, int d, float* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n <= 0 || d <= 0) return (int)cudaGetLastError();
  if (d <= kWarpRowMax) {
    const int blocks = (n + kWarpsPerBlock - 1) / kWarpsPerBlock;
    l2norm_warp_kernel<<<blocks, kWarp * kWarpsPerBlock, 0, s>>>(X, n, d, out);
  } else {
    l2norm_block_kernel<<<n, kFinishThreads, 0, s>>>(X, d, out);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
