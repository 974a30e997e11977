// Sparse kernels of the TF-IDF -> LSI path, for Hopper (sm_90a).
//
// Four kernels over a CSR matrix X (n_rows x n_cols; values f32, indptr and
// indices int32, column indices need not be sorted within a row):
//
//   T1 tfidf_values      <- muon_tpu/ops/sparse.py _tfidf_fn
//   T2 csr_spmm          <- muon_tpu/ops/sparse.py _spmm_fn (transpose=False)
//                           and the final f32 X.V of _rsvd_blocks_fn
//   T3 csr_spmm_t        <- muon_tpu/ops/sparse.py _spmm_fn (transpose=True)
//   T4 csr_gram_matmul   <- the XtX.V product of muon_tpu/ops/linalg.py
//                           _rsvd_blocks_fn
//
// All of them give one warp to one row of X. The TF-IDF path's dense
// operands are skinny (l = k + 10 = 60 columns), so every product is bound by
// memory, not by arithmetic: each stored x_ij touches one row of l values of
// the dense operand (240 B in f32, 120 B in bf16), gathered by column index.
// The simple design here reads those rows with the warp's lanes on
// neighbouring columns, so each gathered row is one coalesced transaction,
// and keeps all per-row partial sums in registers. The (n_cols x l) f32
// outputs of T3 and T4 are 6 MB at the main path's shapes and stay in the
// 50 MB L2, where the atomics resolve.
//
// Not done yet (later work): balancing the work of long rows and hot columns
// (the benchmark's peak popularity is Pareto-skewed, so a few columns take a
// large share of the atomics of T3/T4), staging the row's indices through
// shared memory instead of broadcast loads, and wgmma for the Gram product.
//
// Interface: plain C functions (loaded with ctypes). Each launches on the
// stream it is given, allocates nothing, and returns cudaGetLastError().
// Output and scratch buffers are allocated and zeroed by the caller.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = kWarp * kWarpsPerBlock;
// Each lane holds kChunk accumulators, one per 32-column group, so a pass
// over a row covers kCols output columns. l <= kCols (l = 60 on the main
// path) takes one pass; wider operands loop over column groups.
constexpr int kChunk = 4;
constexpr int kCols = kWarp * kChunk;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
// Round a float to the nearest bf16 (ties to even), as jnp's astype does.
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = kWarp / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__host__ __device__ __forceinline__ int row_blocks(int n_rows) {
  return (n_rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
}

// ---------------------------------------------------------------------------
// T1: TF-IDF over the value vector.
// Launch 1 sums every column with atomics; launch 2 gives each row a warp,
// which reduces the row sum in registers and rewrites the row's values.
// Bound by bytes: it reads the values twice and the indices twice and
// writes the values once (about 20 B per stored entry).
// Non-finite handling matches _tfidf_fn: tf of an empty or all-zero row
// becomes 0 before scaling, and a non-finite result (a column whose stored
// entries sum to 0) becomes 0.
// ---------------------------------------------------------------------------

__global__ void col_sums_kernel(const float* __restrict__ data,
                                const int* __restrict__ indices, int64_t nnz,
                                float* __restrict__ cs) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < nnz;
       i += stride)
    atomicAdd(cs + indices[i], data[i]);
}

__global__ void tfidf_rows_kernel(const float* __restrict__ data,
                                  const int* __restrict__ indptr,
                                  const int* __restrict__ indices,
                                  const float* __restrict__ cs, int n_rows,
                                  int log_tf, int log_idf, int log_tfidf,
                                  int apply_scale, float scale,
                                  float* __restrict__ out) {
  const int row = blockIdx.x * kWarpsPerBlock + threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  if (row >= n_rows) return;  // uniform across the warp
  const int start = indptr[row], end = indptr[row + 1];
  float rs = 0.f;
  for (int j = start + lane; j < end; j += kWarp) rs += data[j];
  rs = warp_sum(rs);
  const float n = (float)n_rows;
  for (int j = start + lane; j < end; j += kWarp) {
    float tf = data[j] / rs;
    if (!isfinite(tf)) tf = 0.f;
    if (apply_scale) tf *= scale;
    if (log_tf) tf = log1pf(tf);
    float idf = n / cs[indices[j]];
    if (log_idf) idf = log1pf(idf);
    float v = tf * idf;
    if (log_tfidf) v = log1pf(v);
    out[j] = isfinite(v) ? v : 0.f;
  }
}

// ---------------------------------------------------------------------------
// T2: out = X . B, B (n_cols x l) f32 or bf16, out (n_rows x l) f32.
// One warp per row; lane c accumulates output columns c, c+32, ... in f32.
// Bound by the gather of B's rows: l * sizeof(TB) bytes per stored entry.
// ---------------------------------------------------------------------------

template <typename TB>
__global__ void csr_spmm_kernel(const float* __restrict__ data,
                                const int* __restrict__ indptr,
                                const int* __restrict__ indices,
                                const TB* __restrict__ B, int n_rows, int l,
                                float* __restrict__ out) {
  const int row = blockIdx.x * kWarpsPerBlock + threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  if (row >= n_rows) return;
  const int start = indptr[row], end = indptr[row + 1];
  float* o = out + (int64_t)row * l;
  for (int c0 = 0; c0 < l; c0 += kCols) {
    float acc[kChunk];
#pragma unroll
    for (int q = 0; q < kChunk; ++q) acc[q] = 0.f;
    for (int j = start; j < end; ++j) {
      const float x = data[j];
      const TB* b = B + (int64_t)indices[j] * l;
#pragma unroll
      for (int q = 0; q < kChunk; ++q) {
        const int c = c0 + q * kWarp + lane;
        if (c < l) acc[q] += x * to_f32(b[c]);
      }
    }
#pragma unroll
    for (int q = 0; q < kChunk; ++q) {
      const int c = c0 + q * kWarp + lane;
      if (c < l) o[c] = acc[q];
    }
  }
}

// ---------------------------------------------------------------------------
// T3: out += X^T . B, B (n_rows x l) f32 or bf16, out (n_cols x l) f32,
// zeroed by the caller. One warp per row i holds B[i, :] in registers and
// adds x_ij * B[i, :] into out[j, :] with atomics, so the order of the sum
// changes from run to run. Bound by the atomics into out (l per stored
// entry); hot columns contend.
// ---------------------------------------------------------------------------

template <typename TB>
__global__ void csr_spmm_t_kernel(const float* __restrict__ data,
                                  const int* __restrict__ indptr,
                                  const int* __restrict__ indices,
                                  const TB* __restrict__ B, int n_rows, int l,
                                  float* __restrict__ out) {
  const int row = blockIdx.x * kWarpsPerBlock + threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  if (row >= n_rows) return;
  const int start = indptr[row], end = indptr[row + 1];
  const TB* brow = B + (int64_t)row * l;
  for (int c0 = 0; c0 < l; c0 += kCols) {
    float b[kChunk];
#pragma unroll
    for (int q = 0; q < kChunk; ++q) {
      const int c = c0 + q * kWarp + lane;
      b[q] = c < l ? to_f32(brow[c]) : 0.f;
    }
    for (int j = start; j < end; ++j) {
      const float x = data[j];
      float* o = out + (int64_t)indices[j] * l;
#pragma unroll
      for (int q = 0; q < kChunk; ++q) {
        const int c = c0 + q * kWarp + lane;
        if (c < l) atomicAdd(o + c, x * b[q]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// T4: acc += X^T (X . V) with the rounding points of _rsvd_blocks_fn: the
// values of X and V are bf16, z_i = X_i . V is summed in f32 and rounded to
// bf16, and acc (n_cols x l) f32 is zeroed by the caller.
// XtX.V = sum_i x_i (x_i^T V): every row is independent, so one warp per row
// computes its z_i in registers, rounds it, and scatters x_ij * z_i into
// acc[j, :] with atomics. z never goes to device memory and no block of X is
// densified (the TPU program densified row blocks because Mosaic could not
// gather). Bound by the bf16 gather of V (2 l B per stored entry) and the f32
// atomics into acc (l per stored entry).
// ---------------------------------------------------------------------------

__global__ void csr_gram_matmul_kernel(const float* __restrict__ data,
                                       const int* __restrict__ indptr,
                                       const int* __restrict__ indices,
                                       const __nv_bfloat16* __restrict__ V,
                                       int n_rows, int l,
                                       float* __restrict__ acc) {
  const int row = blockIdx.x * kWarpsPerBlock + threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  if (row >= n_rows) return;
  const int start = indptr[row], end = indptr[row + 1];
  for (int c0 = 0; c0 < l; c0 += kCols) {
    float z[kChunk];
#pragma unroll
    for (int q = 0; q < kChunk; ++q) z[q] = 0.f;
    for (int j = start; j < end; ++j) {
      const float x = round_bf16(data[j]);
      const __nv_bfloat16* v = V + (int64_t)indices[j] * l;
#pragma unroll
      for (int q = 0; q < kChunk; ++q) {
        const int c = c0 + q * kWarp + lane;
        if (c < l) z[q] += x * __bfloat162float(v[c]);
      }
    }
#pragma unroll
    for (int q = 0; q < kChunk; ++q) z[q] = round_bf16(z[q]);
    for (int j = start; j < end; ++j) {
      const float x = round_bf16(data[j]);
      float* a = acc + (int64_t)indices[j] * l;
#pragma unroll
      for (int q = 0; q < kChunk; ++q) {
        const int c = c0 + q * kWarp + lane;
        if (c < l) atomicAdd(a + c, x * z[q]);
      }
    }
  }
}

}  // namespace

// ---------------------------------------------------------------------------
// C interface. Pointers are device pointers; `stream` is a cudaStream_t.
// Kernels launch on the calling thread's current device, which the caller
// sets to the operands' device.
// `b_bf16` selects the bf16 instantiation (1) or the f32 one (0).
// ---------------------------------------------------------------------------

extern "C" {

int mt_tfidf_values(const float* data, const int* indptr, const int* indices,
                    int n_rows, long long nnz, float* col_sums, int log_tf,
                    int log_idf, int log_tfidf, int apply_scale, float scale,
                    float* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (nnz > 0) {
    long long blocks = (nnz + kThreads - 1) / kThreads;
    if (blocks > (1LL << 20)) blocks = 1LL << 20;  // grid-stride beyond
    col_sums_kernel<<<(unsigned)blocks, kThreads, 0, s>>>(data, indices, nnz,
                                                          col_sums);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (n_rows > 0) {
    tfidf_rows_kernel<<<row_blocks(n_rows), kThreads, 0, s>>>(
        data, indptr, indices, col_sums, n_rows, log_tf, log_idf, log_tfidf,
        apply_scale, scale, out);
  }
  return (int)cudaGetLastError();
}

int mt_csr_spmm(const float* data, const int* indptr, const int* indices,
                const void* B, int b_bf16, int n_rows, int l, float* out,
                void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n_rows > 0 && l > 0) {
    if (b_bf16)
      csr_spmm_kernel<__nv_bfloat16><<<row_blocks(n_rows), kThreads, 0, s>>>(
          data, indptr, indices, (const __nv_bfloat16*)B, n_rows, l, out);
    else
      csr_spmm_kernel<float><<<row_blocks(n_rows), kThreads, 0, s>>>(
          data, indptr, indices, (const float*)B, n_rows, l, out);
  }
  return (int)cudaGetLastError();
}

int mt_csr_spmm_t(const float* data, const int* indptr, const int* indices,
                  const void* B, int b_bf16, int n_rows, int l, float* out,
                  void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n_rows > 0 && l > 0) {
    if (b_bf16)
      csr_spmm_t_kernel<__nv_bfloat16><<<row_blocks(n_rows), kThreads, 0, s>>>(
          data, indptr, indices, (const __nv_bfloat16*)B, n_rows, l, out);
    else
      csr_spmm_t_kernel<float><<<row_blocks(n_rows), kThreads, 0, s>>>(
          data, indptr, indices, (const float*)B, n_rows, l, out);
  }
  return (int)cudaGetLastError();
}

int mt_csr_gram_matmul(const float* data, const int* indptr,
                       const int* indices, const void* V, int n_rows, int l,
                       float* acc, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n_rows > 0 && l > 0) {
    csr_gram_matmul_kernel<<<row_blocks(n_rows), kThreads, 0, s>>>(
        data, indptr, indices, (const __nv_bfloat16*)V, n_rows, l, acc);
  }
  return (int)cudaGetLastError();
}

const char* mt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
