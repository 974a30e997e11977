// Sparse kernels of the TF-IDF -> LSI path and of the RNA normalisation,
// for Hopper (sm_90a).
//
// Six kernels over a CSR matrix X (n_rows x n_cols; values f32, indptr and
// indices int32, column indices need not be sorted within a row):
//
//   T1 tfidf_values      <- muon_tpu/ops/sparse.py _tfidf_fn; its two modes
//                           tfidf_col_sums and tfidf_values_global <- the
//                           bodies of muon_tpu/parallel/pipeline.py
//                           _colsums_fn (:155) and _tfidf_fn (:209)
//   T2 csr_spmm          <- muon_tpu/ops/sparse.py _spmm_fn (transpose=False)
//                           and the final f32 X.V of _rsvd_blocks_fn
//      csr_spmm_split    <- T2 for rows of very different lengths: the
//                           products W^T X and X H^T of muon_tpu/ops/nmf.py
//                           _nmf_fn
//   T3 csr_spmm_t        <- muon_tpu/ops/sparse.py _spmm_fn (transpose=True),
//                           over the CSR of X^T (its entries sorted by column as
//                           the reference's perm_bycol, with_col_perm)
//   T4 csr_gram_matmul   <- the XtX.V product of muon_tpu/ops/linalg.py
//                           _rsvd_blocks_fn
//   T7 csr_row_sums      <- muon_tpu/ops/sparse.py _row_sums_fn
//   T8 csr_scale_rows    <- muon_tpu/ops/sparse.py _scale_rows_fn
//
// and two elementwise passes over a value vector, with no CSR structure:
//
//   T38 wire_decode      <- muon_tpu/ops/sparse.py _ingest_block_fn (one
//                           streamed block, spliced in at an offset) and
//                           _decode_wire_fn (one block at offset 0)
//   T39 binarize_values  <- muon_tpu/ops/sparse.py _binarize_fn
//
// T1, T2, T4, T7 and T8 give one warp to one row of X. The TF-IDF path's
// dense operands are skinny (l = k + 10 = 60 columns), so every product is
// bound by memory, not by arithmetic: each stored x_ij touches one row of l
// values of the dense operand (240 B in f32, 120 B in bf16), gathered by
// column index. The simple design here reads those rows with the warp's
// lanes on neighbouring columns, so each gathered row is one coalesced
// transaction, and keeps all per-row partial sums in registers. The
// (n_cols x l) f32 output of T4 is 6 MB at the main path's shapes and stays
// in the 50 MB L2, where its atomics resolve.
//
// T3 (X^T . B) gathers instead of scattering: it runs over the CSR of X^T
// (ops/sparse.py transpose, built once per matrix), cuts each of its rows
// into pieces so that the Pareto-popular peaks (tens of thousands of cells)
// spread over many warps, loads B's rows 16 bytes a lane where their
// alignment allows, several rows a warp in flight, and adds a row's pieces
// in index order: no atomics, so it repeats bit for bit. T2's split
// variant is the same piece scheme on X's rows.
//
// Not done yet (later work): T4 still scatters with float atomics (its
// order changes from run to run; T3's gather design carries over to it),
// staging a row's indices through shared memory instead of broadcast loads
// in T2, and wgmma for the Gram product.
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
constexpr unsigned kFull = 0xffffffffu;

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
// Modes: 0 runs both launches, the IDF from this matrix's column sums and
// row count; 1 runs launch 1 alone (a row block's column sums, which the
// sharded pipeline all-reduces: parallel/pipeline.py _colsums_fn); 2 runs
// launch 2 alone from column sums and a row count given for the whole
// matrix (_tfidf_fn's body on a row block).
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
                                  float n, int log_tf, int log_idf, int log_tfidf,
                                  int apply_scale, float scale,
                                  float* __restrict__ out) {
  const int row = blockIdx.x * kWarpsPerBlock + threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  if (row >= n_rows) return;  // uniform across the warp
  const int start = indptr[row], end = indptr[row + 1];
  float rs = 0.f;
  for (int j = start + lane; j < end; j += kWarp) rs += data[j];
  rs = warp_sum(rs);
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
// T2, split: out = X . B, B (n_cols x l) f32, for rows of very different
// lengths (scOpen's peaks: Pareto-popular, up to tens of thousands of cells
// a peak, where one warp a row leaves the longest rows to a few warps).
// Each row's stored entries are cut into pieces of at most `piece`;
// row_first[r] is the index of row r's first piece (an exclusive prefix sum
// of max(1, ceil(len / piece)), so an empty row has one empty piece). A warp
// sums one piece as T2 sums a row, into part (pieces x l); a second kernel
// adds a row's pieces in order. No atomics: the product repeats bit for
// bit, and a row of one piece sums as T2 sums it. Bound as T2's, plus part's
// write and read (l floats a piece).
// ---------------------------------------------------------------------------

__global__ void csr_spmm_pieces_kernel(const float* __restrict__ data,
                                       const int* __restrict__ indptr,
                                       const int* __restrict__ indices,
                                       const float* __restrict__ B,
                                       const int* __restrict__ row_first,
                                       int n_rows, int max_pieces, int l,
                                       int piece, float* __restrict__ part) {
  const int p = blockIdx.x * kWarpsPerBlock + threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  if (p >= max_pieces || p >= row_first[n_rows]) return;  // uniform across the warp
  int lo = 0, hi = n_rows - 1;  // the last row r with row_first[r] <= p
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (row_first[mid] <= p) lo = mid; else hi = mid - 1;
  }
  const int start = indptr[lo] + (p - row_first[lo]) * piece;
  const int end = min(start + piece, indptr[lo + 1]);
  float* o = part + (int64_t)p * l;
  for (int c0 = 0; c0 < l; c0 += kCols) {
    float acc[kChunk];
#pragma unroll
    for (int q = 0; q < kChunk; ++q) acc[q] = 0.f;
    for (int j = start; j < end; ++j) {
      const float x = data[j];
      const float* b = B + (int64_t)indices[j] * l;
#pragma unroll
      for (int q = 0; q < kChunk; ++q) {
        const int c = c0 + q * kWarp + lane;
        if (c < l) acc[q] += x * b[c];
      }
    }
#pragma unroll
    for (int q = 0; q < kChunk; ++q) {
      const int c = c0 + q * kWarp + lane;
      if (c < l) o[c] = acc[q];
    }
  }
}

// out[r, :] = the sum of row r's pieces in index order. kSkipWhole: rows of
// one piece were written to out by the pieces kernel and are left alone.
template <bool kSkipWhole>
__global__ void csr_spmm_add_pieces_kernel(const float* __restrict__ part,
                                           const int* __restrict__ row_first,
                                           int n_rows, int l,
                                           float* __restrict__ out) {
  const int64_t total = (int64_t)n_rows * l;
  for (int64_t e = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; e < total;
       e += (int64_t)gridDim.x * blockDim.x) {
    const int r = (int)(e / l);
    const int c = (int)(e - (int64_t)r * l);
    const int a = row_first[r], b = row_first[r + 1];
    if (kSkipWhole && b - a == 1) continue;
    float acc = part[(int64_t)a * l + c];
    for (int q = a + 1; q < b; ++q) acc += part[(int64_t)q * l + c];
    out[e] = acc;
  }
}

// ---------------------------------------------------------------------------
// T3: out = X^T . B for B (n x l) f32 or bf16, out (d x l) f32, over the CSR
// of X^T (d rows, n columns): out[j, :] = sum_e Xt.data[e] B[Xt.indices[e], :]
// over row j of X^T, summed in f32.
//
// Pieces: each row of X^T is cut into pieces of at most `piece` stored
// entries; row_first[j] is the index of row j's first piece (the exclusive
// prefix sum of max(1, ceil(len / piece)), built once with the transpose).
// A warp sums one piece. A row of one piece writes out directly; a longer
// row's pieces go to part (pieces x l) and a second kernel adds them in
// index order. No float atomics: the same inputs give the same bits.
//
// Gathers: a warp splits into 32 / group lane groups, each taking one
// stored entry at a time; within a group, lane s loads VW values of B's row
// at column c0 + s VW as one vector (VW = 4: 16 bytes in f32, 8 in bf16,
// where l % 4 == 0 and B's base is aligned to four values, as on every path
// of the port; else VW = 1), so a warp has 32 / group rows of B
// in flight per step and kT3Unroll steps issued before their FMAs (at l = 60
// f32: group 16, two rows a step, eight in flight; at l = 20: four a step).
// The entry ids and values are read 32 at a time, one coalesced load each,
// and broadcast by shuffles. Wider l loops over column groups of group * VW.
// The lane groups' sums meet by a fixed butterfly, so the order of every
// sum depends on the structure of X^T and on l alone.
//
// Bound: by bytes, X^T's CSR, B and out each once (at 100,000 x 25,000,
// 2.19e7 entries and l = 60 f32: 175 MB + 24 MB + 6 MB, 0.061 ms at 3.35
// TB/s). The gathers themselves read 240 B of B per stored entry (5.3 GB),
// which B (24 MB f32, 12 MB bf16) serves from the 50 MB L2.
// ---------------------------------------------------------------------------

constexpr int kT3Unroll = 4;

// VW consecutive values of a row of B at p (aligned to VW * sizeof(TB)) as
// f32, from one vector load into registers (bf16 widened by its bits)
__device__ __forceinline__ void bf16x2(unsigned w, float& lo, float& hi) {
  lo = __uint_as_float(w << 16);
  hi = __uint_as_float(w & 0xffff0000u);
}

template <typename TB, int VW> struct RowLoad;
template <> struct RowLoad<float, 4> {
  static __device__ __forceinline__ void run(const float* p, float (&v)[4]) {
    const float4 f = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = f.x; v[1] = f.y; v[2] = f.z; v[3] = f.w;
  }
};
template <> struct RowLoad<float, 1> {
  static __device__ __forceinline__ void run(const float* p, float (&v)[1]) { v[0] = __ldg(p); }
};
template <> struct RowLoad<__nv_bfloat16, 4> {
  static __device__ __forceinline__ void run(const __nv_bfloat16* p, float (&v)[4]) {
    const uint2 w = __ldg(reinterpret_cast<const uint2*>(p));
    bf16x2(w.x, v[0], v[1]); bf16x2(w.y, v[2], v[3]);
  }
};
template <> struct RowLoad<__nv_bfloat16, 1> {
  static __device__ __forceinline__ void run(const __nv_bfloat16* p, float (&v)[1]) {
    v[0] = __uint_as_float((unsigned)__ldg(reinterpret_cast<const unsigned short*>(p)) << 16);
  }
};

template <typename TB, int VW>
__global__ void __launch_bounds__(kThreads)
csr_spmm_t_pieces_kernel(const float* __restrict__ data, const int* __restrict__ indptr,
                         const int* __restrict__ indices, const int* __restrict__ row_first,
                         int n_rows, int n_pieces, int piece, const TB* __restrict__ B,
                         int l, int group, float* __restrict__ part,
                         float* __restrict__ out) {
  const int p = blockIdx.x * kWarpsPerBlock + threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  if (p >= n_pieces) return;  // uniform across the warp
  int lo = 0, hi = n_rows - 1;  // the last row r with row_first[r] <= p
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (row_first[mid] <= p) lo = mid; else hi = mid - 1;
  }
  const int first = row_first[lo];
  const int start = indptr[lo] + (p - first) * piece;
  const int end = min(start + piece, indptr[lo + 1]);
  float* dst = row_first[lo + 1] - first == 1 ? out + (int64_t)lo * l
                                              : part + (int64_t)p * l;
  const int per = kWarp / group;  // entries a warp step: one a lane group
  const int g = lane / group;
  for (int c0 = 0; c0 < l; c0 += group * VW) {
    const int c = c0 + (lane % group) * VW;
    const bool col_in = c < l;  // l % VW == 0, so the whole vector is in
    float acc[VW];
#pragma unroll
    for (int q = 0; q < VW; ++q) acc[q] = 0.f;
    for (int base = start; base < end; base += kWarp) {
      const int cnt = min(kWarp, end - base);
      const int my_id = lane < cnt ? indices[base + lane] : 0;
      const float my_x = lane < cnt ? data[base + lane] : 0.f;
      for (int k = 0; k < cnt; k += per * kT3Unroll) {
        float x[kT3Unroll], b[kT3Unroll][VW];
#pragma unroll
        for (int u = 0; u < kT3Unroll; ++u) {
          const int src = k + u * per;  // uniform across the warp
          int id = 0;
          x[u] = 0.f;
          if (src < kWarp) {  // src + g < 32: per divides src
            id = __shfl_sync(kFull, my_id, src + g);
            x[u] = __shfl_sync(kFull, my_x, src + g);
          }
          if (src + g < cnt && col_in) {
            RowLoad<TB, VW>::run(B + (int64_t)id * l + c, b[u]);
          } else {
#pragma unroll
            for (int q = 0; q < VW; ++q) b[u][q] = 0.f;
          }
        }
#pragma unroll
        for (int u = 0; u < kT3Unroll; ++u)
#pragma unroll
          for (int q = 0; q < VW; ++q) acc[q] = fmaf(x[u], b[u][q], acc[q]);
      }
    }
    for (int o = group; o < kWarp; o <<= 1)
#pragma unroll
      for (int q = 0; q < VW; ++q) acc[q] = __fadd_rn(acc[q], __shfl_xor_sync(kFull, acc[q], o));
    if (g == 0 && col_in)
#pragma unroll
      for (int q = 0; q < VW; ++q) dst[c + q] = acc[q];
  }
}

template <typename TB, int VW>
void launch_spmm_t_pieces(const float* data, const int* indptr, const int* indices,
                          const int* row_first, int n_rows, int n_pieces, int piece,
                          const TB* B, int l, float* part, float* out, cudaStream_t s) {
  int group = 1;  // lanes on one row of B: the power of two that covers l, at most 32
  while (group < kWarp && group * VW < l) group <<= 1;
  const int blocks = (n_pieces + kWarpsPerBlock - 1) / kWarpsPerBlock;
  csr_spmm_t_pieces_kernel<TB, VW><<<blocks, kThreads, 0, s>>>(
      data, indptr, indices, row_first, n_rows, n_pieces, piece, B, l, group, part, out);
}

// T3 on B of element type TB: four values a lane where l and B's base allow
template <typename TB>
cudaError_t launch_spmm_t(const float* data, const int* indptr, const int* indices,
                          const int* row_first, int n_rows, int n_pieces, int piece,
                          const TB* B, int l, float* part, float* out, cudaStream_t s) {
  if (l % 4 == 0 && (uintptr_t)B % (4 * sizeof(TB)) == 0)
    launch_spmm_t_pieces<TB, 4>(data, indptr, indices, row_first, n_rows, n_pieces, piece, B,
                                l, part, out, s);
  else
    launch_spmm_t_pieces<TB, 1>(data, indptr, indices, row_first, n_rows, n_pieces, piece, B,
                                l, part, out, s);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_pieces <= n_rows) return err;  // every row one piece
  int64_t blocks = ((int64_t)n_rows * l + kThreads - 1) / kThreads;
  if (blocks > 132 * 16) blocks = 132 * 16;  // grid-stride beyond 16 per SM
  csr_spmm_add_pieces_kernel<true><<<(int)blocks, kThreads, 0, s>>>(part, row_first, n_rows,
                                                                    l, out);
  return cudaGetLastError();
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

// ---------------------------------------------------------------------------
// T7: out[i] = sum of row i's values (0 for an empty row); T8: out[e] =
// data[e] * s[row(e)]. The RNA library-size normalisation of the e2e
// (inv = 1e4 / max(rs, 1), then log1p of the scaled values). The reference
// segment-sums over the padded COO's row ids and gathers s by row id; on CSR
// one warp per row needs neither. Both are bound by bytes: T7 reads 4 B per
// stored entry, T8 reads 4 and writes 4, with coalesced lanes within a row.
// ---------------------------------------------------------------------------

__global__ void csr_row_sums_kernel(const float* __restrict__ data,
                                    const int* __restrict__ indptr,
                                    int n_rows, float* __restrict__ out) {
  const int row = blockIdx.x * kWarpsPerBlock + threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  if (row >= n_rows) return;
  float s = 0.f;
  for (int j = indptr[row] + lane; j < indptr[row + 1]; j += kWarp) s += data[j];
  s = warp_sum(s);
  if (lane == 0) out[row] = s;
}

__global__ void csr_scale_rows_kernel(const float* __restrict__ data,
                                      const int* __restrict__ indptr,
                                      const float* __restrict__ scale,
                                      int n_rows, float* __restrict__ out) {
  const int row = blockIdx.x * kWarpsPerBlock + threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  if (row >= n_rows) return;
  const float s = scale[row];
  for (int j = indptr[row] + lane; j < indptr[row + 1]; j += kWarp)
    out[j] = data[j] * s;
}

// ---------------------------------------------------------------------------
// T38: decode one block of the out-of-core ingest's wire format into the
// device CSR at an offset: data[i] = float(val[i]), indices[i] = int(col[i]).
// The reference also derives row ids and pads the tail (_ingest_block_fn);
// the port's CSR takes its indptr from the file as it is and has no pad, so
// a block is the cast of bn values and bn column ids and nothing else.
// Bound by bytes: 1, 2 or 4 B of value and 2 or 4 B of column read, 8 B
// written per entry. One thread per 4 entries, the 4 a block-stride apart so
// that each of the 4 loads and stores of a warp is coalesced. 32-bit
// indexing within the block (bn < 2^31); the caller offsets the outputs.
// ---------------------------------------------------------------------------

constexpr int kPer = 4;  // entries a thread

template <typename V, typename C>
__global__ void wire_decode_kernel(const V* __restrict__ val,
                                   const C* __restrict__ col, unsigned bn,
                                   float* __restrict__ data,
                                   int* __restrict__ indices) {
  const unsigned base = blockIdx.x * (kThreads * kPer) + threadIdx.x;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const unsigned i = base + k * kThreads;
    if (i < bn) {
      data[i] = (float)val[i];
      indices[i] = (int)col[i];
    }
  }
}

template <typename V>
cudaError_t launch_wire_decode(const V* val, const void* col, int col16,
                               unsigned bn, float* data, int* indices,
                               cudaStream_t s) {
  const unsigned blocks = (bn + kThreads * kPer - 1) / (kThreads * kPer);
  if (col16)
    wire_decode_kernel<V, int16_t><<<blocks, kThreads, 0, s>>>(
        val, (const int16_t*)col, bn, data, indices);
  else
    wire_decode_kernel<V, int><<<blocks, kThreads, 0, s>>>(
        val, (const int*)col, bn, data, indices);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// T39: out[i] = x[i] != 0 ? 1 : 0 over a float32 value vector (NaN != 0, so
// NaN gives 1, as jnp.where does). Bound by bytes: 4 B read and 4 B written
// per entry; the same thread layout as T38.
// ---------------------------------------------------------------------------

__global__ void binarize_values_kernel(const float* __restrict__ x, unsigned n,
                                       float* __restrict__ out) {
  const unsigned base = blockIdx.x * (kThreads * kPer) + threadIdx.x;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const unsigned i = base + k * kThreads;
    if (i < n) out[i] = x[i] != 0.f ? 1.f : 0.f;
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

// mode 0: col_sums (zeroed by the caller) gets this matrix's column sums,
// then out the values with n = n_total (its row count); mode 1: the column
// sums only; mode 2: the values only, from the col_sums and n_total given.
int mt_tfidf_values(const float* data, const int* indptr, const int* indices,
                    int n_rows, long long nnz, float* col_sums, int mode,
                    float n_total, int log_tf, int log_idf, int log_tfidf,
                    int apply_scale, float scale, float* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (mode < 0 || mode > 2) return (int)cudaErrorInvalidValue;
  if (mode != 2 && nnz > 0) {
    long long blocks = (nnz + kThreads - 1) / kThreads;
    if (blocks > (1LL << 20)) blocks = 1LL << 20;  // grid-stride beyond
    col_sums_kernel<<<(unsigned)blocks, kThreads, 0, s>>>(data, indices, nnz,
                                                          col_sums);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (mode != 1 && n_rows > 0) {
    tfidf_rows_kernel<<<row_blocks(n_rows), kThreads, 0, s>>>(
        data, indptr, indices, col_sums, n_rows, n_total, log_tf, log_idf, log_tfidf,
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

// T2, split. B (n_cols x l) f32; row_first (n_rows + 1) int32; part
// (max_pieces x l) f32 scratch, max_pieces >= row_first[n_rows]; out
// (n_rows x l) f32.
int mt_csr_spmm_split(const float* data, const int* indptr, const int* indices,
                      const float* B, const int* row_first, int n_rows,
                      int max_pieces, int l, int piece, float* part, float* out,
                      void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n_rows <= 0 || l <= 0) return (int)cudaGetLastError();
  csr_spmm_pieces_kernel<<<row_blocks(max_pieces), kThreads, 0, s>>>(
      data, indptr, indices, B, row_first, n_rows, max_pieces, l, piece, part);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  int64_t blocks = ((int64_t)n_rows * l + kThreads - 1) / kThreads;
  if (blocks > 132 * 16) blocks = 132 * 16;  // grid-stride beyond 16 per SM
  csr_spmm_add_pieces_kernel<false><<<(int)blocks, kThreads, 0, s>>>(part, row_first, n_rows,
                                                                     l, out);
  return (int)cudaGetLastError();
}

// T3 over the CSR of X^T (n_rows = X's columns): row_first (n_rows + 1)
// int32 its piece table, n_pieces = row_first[n_rows]; B (X's rows x l) f32
// or bf16; part (n_pieces x l) f32 scratch, read only where a row has
// several pieces; out (n_rows x l) f32.
int mt_csr_spmm_t(const float* data, const int* indptr, const int* indices,
                  const int* row_first, int n_rows, int n_pieces, int piece,
                  const void* B, int b_bf16, int l, float* part, float* out,
                  void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n_rows <= 0 || l <= 0) return (int)cudaGetLastError();
  if (n_pieces < n_rows || piece <= 0) return (int)cudaErrorInvalidValue;
  if (b_bf16)
    return (int)launch_spmm_t(data, indptr, indices, row_first, n_rows, n_pieces, piece,
                              (const __nv_bfloat16*)B, l, part, out, s);
  return (int)launch_spmm_t(data, indptr, indices, row_first, n_rows, n_pieces, piece,
                            (const float*)B, l, part, out, s);
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

int mt_csr_row_sums(const float* data, const int* indptr, int n_rows,
                    float* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n_rows > 0)
    csr_row_sums_kernel<<<row_blocks(n_rows), kThreads, 0, s>>>(data, indptr,
                                                               n_rows, out);
  return (int)cudaGetLastError();
}

int mt_csr_scale_rows(const float* data, const int* indptr,
                      const float* scale, int n_rows, float* out,
                      void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n_rows > 0)
    csr_scale_rows_kernel<<<row_blocks(n_rows), kThreads, 0, s>>>(
        data, indptr, scale, n_rows, out);
  return (int)cudaGetLastError();
}

// T38. val (bn) of val_kind 0 uint8, 1 uint16, 2 float32; col (bn) int16
// when col16 else int32; data (f32) and indices (int32) are the whole CSR
// tensors, written at [offset, offset + bn). Nothing is launched for bn 0.
int mt_wire_decode(const void* val, int val_kind, const void* col, int col16,
                   int bn, long long offset, float* data, int* indices,
                   void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (bn <= 0) return (int)cudaGetLastError();
  float* d = data + offset;
  int* ix = indices + offset;
  switch (val_kind) {
    case 0:
      return (int)launch_wire_decode((const uint8_t*)val, col, col16, (unsigned)bn, d, ix, s);
    case 1:
      return (int)launch_wire_decode((const uint16_t*)val, col, col16, (unsigned)bn, d, ix, s);
    case 2:
      return (int)launch_wire_decode((const float*)val, col, col16, (unsigned)bn, d, ix, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// T39. x and out (n) float32.
int mt_binarize_values(const float* x, int n, float* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n > 0) {
    const unsigned blocks = ((unsigned)n + kThreads * kPer - 1) / (kThreads * kPer);
    binarize_values_kernel<<<blocks, kThreads, 0, s>>>(x, (unsigned)n, out);
  }
  return (int)cudaGetLastError();
}

const char* mt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
