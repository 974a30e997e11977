// Dense kernels of the per-modality neighbors path, for Hopper (sm_90a).
//
//   T5 knn_topk               <- muon_tpu/ops/knn.py _knn_fn + _topk2
//   T6 smooth_knn_membership  <- muon_tpu/ops/fuzzy.py _smooth_knn_fn +
//                                _membership_fn
//
// Interface: plain C functions (loaded with ctypes), as in
// sparse_kernels.cu. Each launches on the stream it is given, allocates
// nothing, and returns cudaGetLastError(). Outputs are allocated by the
// caller.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "topk_heap.cuh"

namespace {

// ---------------------------------------------------------------------------
// T5: exact self-kNN over the rows of X (n x d, f32, row-major).
//
// The reference forms every (query, candidate) distance in a (block, n) tile
// in device memory and selects with a two-stage top-k. Here no distance ever
// leaves the SM: a block of kQ threads owns kQ queries (one each) and streams
// the candidates through shared memory in tiles of kC rows x kD dimensions.
// A query of d <= kD (the PCA and LSI reps, d = 50) stays in registers for
// the whole stream; a wider one (use_rep="X") is reloaded chunk by chunk,
// so any d works. Each thread keeps its kC cross terms in registers, forms
// the distance exactly as the reference does, and keeps its best k
// candidates in a max-heap on (distance, index): a candidate enters only if
// it beats the root, so after the first tiles almost none do, and an
// insertion costs O(log k). The kernel is bound by the FMAs of the cross
// terms (n^2 d; 5e11 at n = 1e5, d = 50, padded to 64) and the shared-memory
// loads feeding them (one 16-byte broadcast load per 4 FMAs). The heap lives
// in a per-thread array (local memory, cached in L1), touched only on an
// insertion; it is sorted once at the end. Lists longer than 256 (k >= 256)
// keep the heap in the query's own row of the outputs instead (KMAX = 0):
// global memory, read and written only on an insertion, sorted in place, so
// any k up to n - 1 runs with no array sized at compile time.
//
// Distance, with the reference's rounding points:
//   one_minus = 0: d2 = max((|q|^2 + |c|^2) - 2 cross, 0), norms given in f32
//                  (euclidean, sqeuclidean);
//   one_minus = 1: 1 - cross, on rows normalised beforehand (cosine,
//                  correlation).
// The approx path hands in X rounded to bf16 (held as f32) and the norms of
// the unrounded rows; the products are exact in f32 and sum in f32. The
// cross term stays f32, as in the reference as it runs: under jit, XLA folds
// the f32 convert of the bf16 matmul into the dot, whose result is then f32
// (its compiled HLO is a dot of two bf16-rounded f32 operands into f32).
// Order: self first whatever its distance (the reference's -inf mask), then
// the k best others by (distance, index) ascending, so ties go to the lower
// index as lax.top_k does. Candidates arrive in index order, so an equal
// distance never displaces an entry of the heap.
// Not done yet (later work): a register-tiled or wgmma cross term, and a
// split of the candidate stream over several blocks for small n.
// ---------------------------------------------------------------------------

constexpr int kQ = 128;  // queries per block, one per thread
constexpr int kC = 32;   // candidates per shared-memory tile
constexpr int kD = 64;   // dimensions per chunk
// lists (k + 1 places, self included) up to this long keep the heap in a
// per-thread array; ops/knn.py LOCAL_LIST
constexpr int kLocalList = 256;

template <int KMAX>
__global__ void __launch_bounds__(kQ)
    knn_topk_kernel(const float* __restrict__ X, const float* __restrict__ sq,
                    int n, int d, int k, int one_minus, int take_sqrt,
                    int* __restrict__ out_idx, float* __restrict__ out_dist) {
  __shared__ __align__(16) float tile[kC][kD];
  __shared__ float tile_sq[kC];
  const int i = blockIdx.x * kQ + threadIdx.x;
  const bool active = i < n;
  const float* q = X + (int64_t)(active ? i : 0) * d;
  const float qsq = (active && !one_minus) ? sq[i] : 0.f;
  const bool one_chunk = d <= kD;

  float qv[kD];
#pragma unroll
  for (int u = 0; u < kD; ++u) qv[u] = (active && u < d) ? q[u] : 0.f;

  float local_d[KMAX > 0 ? KMAX : 1];
  int local_i[KMAX > 0 ? KMAX : 1];
  const int64_t o = (int64_t)(active ? i : 0) * (k + 1);
  float* heap_d = KMAX > 0 ? local_d : out_dist + o + 1;
  int* heap_i = KMAX > 0 ? local_i : out_idx + o + 1;
  int cnt = 0;

  for (int c0 = 0; c0 < n; c0 += kC) {
    float acc[kC];
#pragma unroll
    for (int c = 0; c < kC; ++c) acc[c] = 0.f;
    for (int u0 = 0; u0 < d; u0 += kD) {
      __syncthreads();  // the previous chunk's readers are done
      for (int t = threadIdx.x; t < kC * kD; t += kQ) {
        const int c = t / kD, u = t % kD, j = c0 + c, col = u0 + u;
        tile[c][u] = (j < n && col < d) ? X[(int64_t)j * d + col] : 0.f;
      }
      if (u0 == 0 && threadIdx.x < kC) {
        const int j = c0 + threadIdx.x;
        tile_sq[threadIdx.x] = (!one_minus && j < n) ? sq[j] : 0.f;
      }
      if (!one_chunk) {
#pragma unroll
        for (int u = 0; u < kD; ++u)
          qv[u] = (active && u0 + u < d) ? q[u0 + u] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int c = 0; c < kC; ++c) {
#pragma unroll
        for (int u = 0; u < kD; u += 4) {
          const float4 v = *reinterpret_cast<const float4*>(&tile[c][u]);
          acc[c] = fmaf(qv[u], v.x, acc[c]);
          acc[c] = fmaf(qv[u + 1], v.y, acc[c]);
          acc[c] = fmaf(qv[u + 2], v.z, acc[c]);
          acc[c] = fmaf(qv[u + 3], v.w, acc[c]);
        }
      }
    }
    if (!active || k == 0) continue;  // no __syncthreads below this point
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      const int j = c0 + c;
      if (j >= n || j == i) continue;
      const float dist = one_minus
                             ? 1.f - acc[c]
                             : fmaxf((qsq + tile_sq[c]) - 2.f * acc[c], 0.f);
      if (cnt < k) {  // filling: append and sift up
        cnt = heap_push(heap_d, heap_i, cnt, dist, j);
      } else if (dist < heap_d[0]) {  // j is the largest index so far
        heap_d[0] = dist;
        heap_i[0] = j;
        sift_down(heap_d, heap_i, k, 0);
      }
    }
  }
  if (!active) return;
  heap_sort(heap_d, heap_i, k);
  out_idx[o] = i;
  out_dist[o] = 0.f;
  for (int r = 0; r < k; ++r) {
    if (KMAX > 0) out_idx[o + 1 + r] = heap_i[r];
    out_dist[o + 1 + r] = take_sqrt ? sqrtf(fmaxf(heap_d[r], 0.f)) : heap_d[r];
  }
}

// ---------------------------------------------------------------------------
// T6: per row of the kNN distances (n x k, f32), rho (local connectivity),
// sigma (64-step bisection with umap-learn's lower bounds) and the
// membership values exp(-max(d - rho, 0) / sigma), in one pass.
// One thread per row: the reference vectorises the bisection over all rows,
// and every row here is independent too. Bound by the n_iter * k exp() of the
// bisection; the row (80 B at k = 20) stays in L1 across the iterations.
// The reference sorts each row's nonzero distances for rho. A row from T5 is
// already sorted, so its positive values are a suffix and the m-th of them is
// read directly; an unsorted row takes an O(k^2) rank selection instead.
// mean_all, the mean over the whole (n, k) matrix, is a global reduction
// taken by the caller on the device and read here through a pointer, so the
// host does not wait for it.
// ---------------------------------------------------------------------------

// the m-th smallest positive value of row r (0-based; duplicates counted)
__device__ float nth_positive(const float* r, int k, bool sorted, int nnz,
                              int m) {
  if (sorted) return r[k - nnz + m];
  for (int j = 0; j < k; ++j) {
    const float x = r[j];
    if (!(x > 0.f)) continue;
    int rank = 0;
    for (int t = 0; t < k; ++t) {
      const float y = r[t];
      if (y > 0.f && (y < x || (y == x && t < j))) ++rank;
    }
    if (rank == m) return x;
  }
  return 0.f;  // unreachable for 0 <= m < nnz
}

// max(x, 0) that keeps a NaN, as jnp.maximum and torch.clamp do (fmaxf
// would return 0): a NaN distance (a WNN score rounded above 1) then gives
// the NaN membership of the reference
__device__ __forceinline__ float max0_keep_nan(float x) {
  return (x > 0.f || x != x) ? x : 0.f;
}

__global__ void smooth_knn_kernel(const float* __restrict__ dists, int n,
                                  int k, float local_connectivity,
                                  float target,
                                  const float* __restrict__ mean_all,
                                  int n_iter,
                                  float min_k_dist_scale,
                                  float* __restrict__ sigma,
                                  float* __restrict__ rho,
                                  float* __restrict__ vals) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float* r = dists + (int64_t)i * k;

  int nnz = 0;
  float sum_nz = 0.f, max_nz = 0.f;
  bool sorted = true;
  for (int j = 0; j < k; ++j) {
    const float x = r[j];
    if (x > 0.f) {
      ++nnz;
      sum_nz += x;
      max_nz = fmaxf(max_nz, x);
    }
    if (j > 0 && !(r[j - 1] <= x)) sorted = false;
  }
  const int li = (int)floorf(local_connectivity);
  const float frac = local_connectivity - (float)li;
  float rh = 0.f;
  if (nnz > 0) {
    if (nnz > li) {
      if (li >= 1) {
        const float lo = nth_positive(r, k, sorted, nnz, li - 1);
        const float hi = nth_positive(r, k, sorted, nnz, min(li, k - 1));
        rh = lo + frac * (hi - lo);
      } else {
        rh = frac * nth_positive(r, k, sorted, nnz, 0);
      }
    } else {
      rh = max_nz;
    }
  }

  float lo = 0.f, hi = INFINITY, mid = 1.f;
  for (int it = 0; it < n_iter; ++it) {
    float val = 0.f;
    for (int j = 0; j < k; ++j) val += expf(-max0_keep_nan(r[j] - rh) / mid);
    if (val > target) {
      hi = mid;
      mid = (lo + hi) / 2.f;
    } else {
      lo = mid;
      mid = isinf(hi) ? lo * 2.f : (lo + hi) / 2.f;
    }
  }
  const float mean_d = nnz > 0 ? sum_nz / (float)max(nnz, 1) : 0.f;
  const float floor_ = min_k_dist_scale * (rh > 0.f ? mean_d : *mean_all);
  const float sg = floor_ != floor_ ? floor_ : fmaxf(mid, floor_);  // torch.maximum
  sigma[i] = sg;
  rho[i] = rh;
  float* v = vals + (int64_t)i * k;
  for (int j = 0; j < k; ++j) v[j] = expf(-max0_keep_nan(r[j] - rh) / sg);
}

}  // namespace

extern "C" {

// T5. X (n x d) f32; sq (n,) f32 squared row norms (unused when
// one_minus); 0 <= k <= n - 1 neighbours besides self (from k = 256 on the
// heap lives in the outputs); idx (n x (k+1)) int32 and dist (n x (k+1)) f32
// out.
int mt_knn_topk(const float* X, const float* sq, int n, int d, int k,
                int one_minus, int take_sqrt, int* idx, float* dist,
                void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n > 0) {
    const int blocks = (n + kQ - 1) / kQ;
    if (k <= 32)
      knn_topk_kernel<32><<<blocks, kQ, 0, s>>>(X, sq, n, d, k, one_minus,
                                                take_sqrt, idx, dist);
    else if (k < kLocalList)
      knn_topk_kernel<kLocalList><<<blocks, kQ, 0, s>>>(X, sq, n, d, k, one_minus,
                                                        take_sqrt, idx, dist);
    else
      knn_topk_kernel<0><<<blocks, kQ, 0, s>>>(X, sq, n, d, k, one_minus,
                                               take_sqrt, idx, dist);
  }
  return (int)cudaGetLastError();
}

// T6. dists (n x k) f32; mean_all a device pointer to one f32; sigma, rho
// (n,) and vals (n x k) f32 out.
int mt_smooth_knn(const float* dists, int n, int k, float local_connectivity,
                  float target, const float* mean_all, int n_iter,
                  float min_k_dist_scale, float* sigma, float* rho,
                  float* vals, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n > 0 && k > 0) {
    constexpr int threads = 128;
    smooth_knn_kernel<<<(n + threads - 1) / threads, threads, 0, s>>>(
        dists, n, k, local_connectivity, target, mean_all, n_iter,
        min_k_dist_scale, sigma, rho, vals);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
