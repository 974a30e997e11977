// Dense normalisation kernel of the protein path, for Hopper (sm_90a).
//
//   T12 clr_dense  <- muon_tpu/ops/dense.py _clr_dense_fn, and the inline
//                     seurat CLR of muon_tpu/prot/preproc.py clr (dense X)
//
// X is (n x d) f32, row-major. gm = mean(log1p(X), axis), then one of two
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

}  // extern "C"
