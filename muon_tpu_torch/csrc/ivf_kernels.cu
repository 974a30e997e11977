// Kernels of the IVF (inverted-file) kNN index, for Hopper (sm_90a).
//
//   T14 ivf_search     <- muon_tpu/ops/ivf.py _search_fn
//   T15 kmeans_assign  <- muon_tpu/ops/ivf.py _kmeans_fn (its assign step)
//
// Interface: plain C functions (loaded with ctypes), as in
// sparse_kernels.cu. Each launches on the stream it is given, allocates
// nothing, and returns cudaGetLastError(). Outputs are allocated by the
// caller.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "topk_heap.cuh"

namespace {

constexpr int kQ = 128;  // queries per block, one per thread
constexpr int kC = 32;   // candidates per shared-memory tile
constexpr int kD = 64;   // dimensions per chunk
constexpr int kWarp = 32;

// ---------------------------------------------------------------------------
// T14: for every work item (QB queries of one chunk of the cluster-sorted
// points Xs, and the item's probe list of P chunks), each query's k+1
// nearest candidates among the probed chunks.
//
// The reference gathers the item's P x L padded candidate grid into device
// memory, forms the (QB, P L) distance tile there and selects from it. Here
// a block owns kQ queries of one item (one per thread) and walks the item's
// probe list chunk by chunk: kC candidate rows at a time go through shared
// memory, centred on the item's mean mu as they are loaded, and no distance
// leaves the SM. Slots beyond a chunk's length and probe entries of -1 are
// never loaded (the reference scores them as +inf).
//
// Distance, at the reference's rounding points, all float32 (no bfloat16,
// no TF32: the neighbours' gaps lie below bfloat16's resolution of the
// local scale): with qc = q - mu and cc = c - mu,
//   d2 = max((|qc|^2 + |cc|^2) - 2 qc.cc, 0), halved when `half` (unit rows:
//   1 - cos = |q - c|^2 / 2).
// |cc|^2 of a tile is summed as the tile is loaded: each warp loads half a
// row per step and reduces its squares by a butterfly, then the two halves
// add; no atomics, so a run repeats bit for bit.
//
// Selection: T5's max-heap of k+1 entries on (distance, slot), where slot =
// p L + l is the candidate's place in the item's probe list. Candidates
// arrive in slot order, so an equal distance never displaces an entry: ties
// go to the earlier slot, as lax.top_k over the reference's grid. The query
// itself (found by position) enters at -inf and so comes out first. A query
// with fewer than k+1 candidates gets +inf and position 0 in the free
// places, as do the padded query slots (qid < 0); the caller maps +inf to
// index -1.
//
// Bound: the cross terms (queries x probed candidates x d multiply-adds;
// about 1e12 operations at 1M x 50 with 8 probes) at the float32 rate; the
// bytes (Xs once, the results) are far below that. Not done yet (later
// work): a register-tiled or tensor-core cross term in split float32, and
// sharing a tile between the query tiles of one item.
// ---------------------------------------------------------------------------

template <int KMAX>
__global__ void __launch_bounds__(kQ)
    ivf_search_kernel(const float* __restrict__ Xs, const int* __restrict__ qids,
                      const int* __restrict__ probe_pos,
                      const int* __restrict__ probe_cnt,
                      const float* __restrict__ mu, int n, int d, int QB, int P,
                      int L, int k1, int half, int* __restrict__ out_pos,
                      float* __restrict__ out_dist) {
  __shared__ __align__(16) float tile[kC][kD];
  __shared__ float part[kC][2];
  __shared__ float tile_sq[kC];
  const int tiles = (QB + kQ - 1) / kQ;  // query tiles per item
  const int item = blockIdx.x / tiles;
  const int slot_q = (blockIdx.x % tiles) * kQ + threadIdx.x;
  const int qid = slot_q < QB ? qids[(int64_t)item * QB + slot_q] : -1;
  const bool active = qid >= 0;
  // a tile of queries that holds only padding has nothing to do
  if (__syncthreads_or(active) == 0) {
    if (slot_q < QB) {
      const int64_t o = ((int64_t)item * QB + slot_q) * k1;
      for (int r = 0; r < k1; ++r) {
        out_pos[o + r] = 0;
        out_dist[o + r] = INFINITY;
      }
    }
    return;
  }
  const float* q = Xs + (int64_t)(active ? qid : 0) * d;
  const float* m = mu + (int64_t)item * d;
  const bool one_chunk = d <= kD;
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;

  float qv[kD];
  float qsq = 0.f;
  for (int u0 = 0; u0 < d; u0 += kD) {
#pragma unroll
    for (int u = 0; u < kD; ++u) {
      qv[u] = (active && u0 + u < d) ? q[u0 + u] - m[u0 + u] : 0.f;
      qsq = fmaf(qv[u], qv[u], qsq);
    }
  }
  // qv now holds the last chunk; with one chunk that is the whole query

  float heap_d[KMAX];
  int heap_i[KMAX];
  int cnt = 0;

  for (int p = 0; p < P; ++p) {
    const int ppos = probe_pos[(int64_t)item * P + p];
    if (ppos < 0) continue;  // the same for the whole block
    const int len = min(probe_cnt[(int64_t)item * P + p], n - ppos);
    for (int c0 = 0; c0 < len; c0 += kC) {
      float acc[kC];
#pragma unroll
      for (int c = 0; c < kC; ++c) acc[c] = 0.f;
      for (int u0 = 0; u0 < d; u0 += kD) {
        __syncthreads();  // the previous tile's readers are done
        // kQ threads load two rows of kD per step: a warp half a row
        for (int t = threadIdx.x; t < kC * kD; t += kQ) {
          const int c = t / kD, u = t % kD, col = u0 + u;
          const bool ok = c0 + c < len && col < d;
          const float v = ok ? Xs[(int64_t)(ppos + c0 + c) * d + col] - m[col] : 0.f;
          tile[c][u] = v;
          float s = v * v;
#pragma unroll
          for (int o = kWarp / 2; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
          if (lane == 0) part[c][warp % 2] = s;
        }
        if (!one_chunk) {
#pragma unroll
          for (int u = 0; u < kD; ++u)
            qv[u] = (active && u0 + u < d) ? q[u0 + u] - m[u0 + u] : 0.f;
        }
        __syncthreads();
        if (threadIdx.x < kC)
          tile_sq[threadIdx.x] = (u0 == 0 ? 0.f : tile_sq[threadIdx.x]) +
                                 (part[threadIdx.x][0] + part[threadIdx.x][1]);
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
      __syncthreads();  // tile_sq is whole
      if (!active) continue;
#pragma unroll
      for (int c = 0; c < kC; ++c) {
        if (c0 + c >= len) continue;
        float dist = fmaxf((qsq + tile_sq[c]) - 2.f * acc[c], 0.f);
        if (half) dist *= 0.5f;
        if (ppos + c0 + c == qid) dist = -INFINITY;  // self first
        const int slot = p * L + c0 + c;
        if (cnt < k1) {  // filling: append and sift up
          cnt = heap_push(heap_d, heap_i, cnt, dist, slot);
        } else if (dist < heap_d[0]) {  // slot is the largest so far
          heap_d[0] = dist;
          heap_i[0] = slot;
          sift_down(heap_d, heap_i, k1, 0);
        }
      }
    }
  }
  if (slot_q >= QB) return;
  const int64_t o = ((int64_t)item * QB + slot_q) * k1;
  if (active) heap_sort(heap_d, heap_i, cnt);
  for (int r = 0; r < k1; ++r) {
    if (active && r < cnt) {
      const int slot = heap_i[r];
      out_pos[o + r] = probe_pos[(int64_t)item * P + slot / L] + slot % L;
      out_dist[o + r] = heap_d[r];
    } else {
      out_pos[o + r] = 0;
      out_dist[o + r] = INFINITY;
    }
  }
}

// ---------------------------------------------------------------------------
// T15: the nearest centroid of every row, the assign step of Lloyd's
// k-means: argmin over c of |cent_c|^2 - 2 x.cent_c (the row's own norm is
// the same for every c). The reference forms the (block, C) score tile in
// device memory and takes an argmin over it; here the product has the
// argmin as its epilogue and the tile never exists. As in the reference as
// it runs (under jit XLA folds the float32 convert of the bfloat16 matmul
// into the dot: the compiled HLO is a float32 dot of two bfloat16-rounded
// operands), the operands are rounded to bfloat16 as they are loaded, their
// products are exact in float32 and sum in float32, and |cent_c|^2 is the
// float32 norm of the unrounded centroid. Ties go to the lower cluster:
// centroids arrive in order and only a smaller score replaces the best.
//
// A block owns kQ rows, one per thread, the row in registers; the centroids
// stream through shared memory kC at a time. Bound: n C d multiply-adds of
// bfloat16 operands (1e11 operations at 1M x 50, C = 1024) at the bfloat16
// rate, or X read once (200 MB), whichever is larger; this simple version
// multiplies in the float32 pipe and leaves the tensor cores for later work.
// ---------------------------------------------------------------------------

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__global__ void __launch_bounds__(kQ)
    kmeans_assign_kernel(const float* __restrict__ X, const float* __restrict__ cent,
                         const float* __restrict__ csq, int n, int d, int C,
                         int* __restrict__ assign) {
  __shared__ __align__(16) float tile[kC][kD];
  __shared__ float tile_sq[kC];
  const int i = blockIdx.x * kQ + threadIdx.x;
  const bool active = i < n;
  const float* q = X + (int64_t)(active ? i : 0) * d;
  const bool one_chunk = d <= kD;

  float qv[kD];
#pragma unroll
  for (int u = 0; u < kD; ++u) qv[u] = (active && u < d) ? bf16_round(q[u]) : 0.f;

  float best = INFINITY;
  int best_c = 0;
  for (int c0 = 0; c0 < C; c0 += kC) {
    float acc[kC];
#pragma unroll
    for (int c = 0; c < kC; ++c) acc[c] = 0.f;
    for (int u0 = 0; u0 < d; u0 += kD) {
      __syncthreads();  // the previous chunk's readers are done
      for (int t = threadIdx.x; t < kC * kD; t += kQ) {
        const int c = t / kD, u = t % kD, j = c0 + c, col = u0 + u;
        tile[c][u] = (j < C && col < d) ? bf16_round(cent[(int64_t)j * d + col]) : 0.f;
      }
      if (u0 == 0 && threadIdx.x < kC) {
        const int j = c0 + threadIdx.x;
        tile_sq[threadIdx.x] = j < C ? csq[j] : 0.f;
      }
      if (!one_chunk) {
#pragma unroll
        for (int u = 0; u < kD; ++u)
          qv[u] = (active && u0 + u < d) ? bf16_round(q[u0 + u]) : 0.f;
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
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      const float score = tile_sq[c] - 2.f * acc[c];
      if (c0 + c < C && score < best) {
        best = score;
        best_c = c0 + c;
      }
    }
  }
  if (active) assign[i] = best_c;
}

}  // namespace

extern "C" {

// T14. Xs (n x d) f32, sorted by cluster; qids (I x QB) int32 positions into
// Xs, -1 padded; probe_pos, probe_cnt (I x P) int32 chunk starts (-1 padded)
// and lengths, every length <= L; mu (I x d) f32; k1 = k + 1 <= 256 places
// per query; pos (I x QB x k1) int32 and dist (I x QB x k1) f32 out.
int mt_ivf_search(const float* Xs, const int* qids, const int* probe_pos,
                  const int* probe_cnt, const float* mu, int n, int d, int I,
                  int QB, int P, int L, int k1, int half, int* pos, float* dist,
                  void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (I <= 0 || QB <= 0) return (int)cudaGetLastError();
  const int64_t blocks = (int64_t)((QB + kQ - 1) / kQ) * I;
  if (k1 < 1 || k1 > 256 || blocks > INT32_MAX) return (int)cudaErrorInvalidValue;
  const unsigned grid = (unsigned)blocks;
  if (k1 <= 32)
    ivf_search_kernel<32><<<grid, kQ, 0, s>>>(Xs, qids, probe_pos, probe_cnt, mu,
                                              n, d, QB, P, L, k1, half, pos, dist);
  else
    ivf_search_kernel<256><<<grid, kQ, 0, s>>>(Xs, qids, probe_pos, probe_cnt, mu,
                                               n, d, QB, P, L, k1, half, pos, dist);
  return (int)cudaGetLastError();
}

// T15. X (n x d) f32; cent (C x d) f32; csq (C,) f32 squared norms of the
// centroids; assign (n,) int32 out.
int mt_kmeans_assign(const float* X, const float* cent, const float* csq, int n,
                     int d, int C, int* assign, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n > 0 && C > 0)
    kmeans_assign_kernel<<<(n + kQ - 1) / kQ, kQ, 0, s>>>(X, cent, csq, n, d, C,
                                                         assign);
  return (int)cudaGetLastError();
}

}  // extern "C"
