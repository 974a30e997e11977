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

#include "knn_tile.cuh"

namespace {

constexpr int kQ = 128;  // T15: rows per block, one per thread
constexpr int kC = 32;   // T15: centroids per shared-memory tile
constexpr int kD = 64;   // T15: dimensions per chunk
constexpr int kWarp = 32;

// ---------------------------------------------------------------------------
// T14: for every work item (QB queries of one chunk of the cluster-sorted
// points Xs, and the item's probe list of P chunks), each query's k+1
// nearest candidates among the probed chunks.
//
// The reference gathers the item's P x L padded candidate grid into device
// memory, forms the (QB, P L) distance tile there and selects from it. Here
// a block owns 256 queries of one item (knn_tile.cuh's float32 tile), staged
// once, centred on the item's mean mu; it walks the item's probe list chunk
// by chunk, 32 candidate rows at a time through shared memory, centred on mu
// as they are loaded (the next chunk into registers while this one is
// multiplied); each warp forms its 32 queries' distances to the tile in 8 x
// 4 micro-tiles, filters them against the queries' heaps in registers, and
// writes only those that pass to shared memory, where their queries take
// them (knn_tile.cuh). No distance leaves the SM, and a staged
// candidate tile serves 256 of the item's queries (an item of QB = 1024
// takes four blocks). Slots beyond a chunk's length and probe entries of -1
// are never offered (the reference scores them as +inf).
//
// Distance, at the reference's rounding points, all float32 (no bfloat16,
// no TF32: the neighbours' gaps lie below bfloat16's resolution of the
// local scale): with qc = q - mu and cc = c - mu,
//   d2 = max((|qc|^2 + |cc|^2) - 2 qc.cc, 0), halved when `half` (unit rows:
//   1 - cos = |q - c|^2 / 2).
// |qc|^2 is the query's fma chain over u in order. |cc|^2 of a tile is
// summed as the tile is loaded: each warp loads half a row of a 64-wide
// chunk per step and reduces its squares by a butterfly, then the two halves
// add, chunk after chunk; no atomics, so a run repeats bit for bit. The
// cross term of each pair is the fma chain over u in order. This
// arithmetic fixes the positions and distances bit for bit, which the
// port's T14 keeps (a ROADMAP invariant; exp_compare_trees.py holds two
// trees to it).
//
// Selection: a max-heap of k+1 entries on (distance, slot) (knn_tile.cuh),
// where slot = p L + l is the candidate's place in the item's probe list,
// kept in the query's own row of the outputs, the slots turned into
// positions in place at the end; the counters ivf_search and
// ivf_search_global (lists longer than 256) name the same kernel.
// Candidates are scanned in slot order, so an equal distance never displaces
// an entry: ties go to the earlier slot, as lax.top_k over the reference's
// grid. The query itself (found by position) enters at -inf and so comes out
// first. A query with fewer than k+1 candidates gets +inf and position 0 in
// the free places, as do the padded query slots (qid < 0); the caller maps
// +inf to index -1.
//
// Bound: the cross terms (queries x probed candidates x d multiply-adds;
// about 1e12 operations at 1M x 50 with 8 probes) at the float32 rate; the
// bytes (Xs once, the results) are far below that. The micro-tile's
// shared-memory loads and, for long lists, the heaps' insertions hold it
// above the bound.
// ---------------------------------------------------------------------------

// shared memory of T14: a query chunk, a candidate chunk, the distance
// tile, the queries' norms and ids, the halves of the tile's norms
__host__ __device__ constexpr size_t ivf_shared_bytes() {
  return 4 * ((size_t)f32t::kDK * f32t::kLdQ + (size_t)f32t::kDK * f32t::kLdC +
              (size_t)f32t::kCT * f32t::kLdQ + 2 * f32t::kQT + 2 * f32t::kCT);
}

// A block's walk over its item's probe list: probe p (at ppos, len rows),
// candidate tile c0, chunk of d u0. p = P when the walk is over.
struct Walk {
  int p, ppos, len, c0, u0;

  // the first tile of the first probe from p on that holds a row
  __device__ static Walk from(const int* pp, const int* pc, int P, int n, int p) {
    for (; p < P; ++p) {
      const int ppos = pp[p];
      if (ppos < 0) continue;
      const int len = min(pc[p], n - ppos);
      if (len > 0) return Walk{p, ppos, len, 0, 0};
    }
    return Walk{P, 0, 0, 0, 0};
  }
  __device__ Walk next(const int* pp, const int* pc, int P, int n, int d) const {
    if (p >= P) return *this;
    if (u0 + f32t::kDK < d) return Walk{p, ppos, len, c0, u0 + f32t::kDK};
    if (c0 + f32t::kCT < len) return Walk{p, ppos, len, c0 + f32t::kCT, 0};
    return from(pp, pc, P, n, p + 1);
  }
};

// the block's queries, centred: columns [u0, u0 + kDK) of Xs[qid] - mu
// transposed into sQ[u * kLdQ + r]; padded slots and columns >= d as zeros
__device__ __forceinline__ void stage_queries(float* sQ, const int* sQid,
                                              const float* __restrict__ Xs,
                                              const float* __restrict__ m, int d, int u0) {
  for (int t = threadIdx.x; t < f32t::kQT * f32t::kDK; t += f32t::kThreads) {
    const int r = t / f32t::kDK, u = t % f32t::kDK, col = u0 + u, qid = sQid[r];
    sQ[u * f32t::kLdQ + r] = (qid >= 0 && col < d) ? Xs[(int64_t)qid * d + col] - m[col] : 0.f;
  }
}

__global__ void __launch_bounds__(f32t::kThreads, 2)
    ivf_search_kernel(const float* __restrict__ Xs, const int* __restrict__ qids,
                      const int* __restrict__ probe_pos,
                      const int* __restrict__ probe_cnt,
                      const float* __restrict__ mu, int n, int d, int QB, int P,
                      int L, int k1, int half, int* __restrict__ out_pos,
                      float* __restrict__ out_dist, hkey* __restrict__ heaps) {
  using namespace f32t;
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;
  float* sC = sQ + kDK * kLdQ;
  float* sD = sC + kDK * kLdC;
  float* sQsq = sD + kCT * kLdQ;
  int* sQid = reinterpret_cast<int*>(sQsq + kQT);
  float(*part)[2] = reinterpret_cast<float(*)[2]>(sQid + kQT);

  const int tid = threadIdx.x;
  const int tiles = (QB + kQT - 1) / kQT;  // query tiles per item
  const int item = blockIdx.x / tiles;
  const int slot_q = (blockIdx.x % tiles) * kQT + tid;
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
  const int warp = tid / kWarp, lane = tid % kWarp;
  const int mq = micro_q(tid), mc = micro_c(tid);
  const bool resident = d <= kDK;

  float qsq = 0.f;
  for (int u = 0; u < d; ++u) {
    const float v = active ? q[u] - m[u] : 0.f;
    qsq = fmaf(v, v, qsq);
  }
  sQsq[tid] = qsq;
  sQid[tid] = qid;
  __syncthreads();
  if (resident) stage_queries(sQ, sQid, Xs, m, d, 0);

  const int64_t o = ((int64_t)item * QB + (slot_q < QB ? slot_q : 0)) * k1;
  TopK h = make_topk(heaps + ((int64_t)item * QB + (slot_q < QB ? slot_q : 0)) * knn_heap_row(k1),
                     active ? k1 : 0);
  Pending pend;
  pend.n = 0;

  // stages: (probe, candidate tile, 64-wide chunk of d) in order, probes of
  // -1 and empty chunks skipped; a stage's candidate chunk is loaded into
  // registers while the one before it is multiplied, kPer values a thread
  constexpr int kPer = kCT * kDK / kThreads;
  const int u = tid % kDK;  // this thread's column of every chunk it loads
  const int* pp = probe_pos + (int64_t)item * P;
  const int* pc = probe_cnt + (int64_t)item * P;
  Walk cur = Walk::from(pp, pc, P, n, 0), next = cur.next(pp, pc, P, n, d);
  float pre[kPer];
  auto fetch = [&](const Walk& w) {
    const int col = w.u0 + u;
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
      const int c = (tid + e * kThreads) / kDK;
      pre[e] = (w.c0 + c < w.len && col < d) ? Xs[(int64_t)(w.ppos + w.c0 + c) * d + col] : 0.f;
    }
  };
  if (cur.p < P) fetch(cur);
  float acc[kTM][kTN], tile_sq[kTN];  // tile_sq: |cc|^2 of this thread's candidates
  for (; cur.p < P; cur = next, next = next.next(pp, pc, P, n, d)) {
    const int ppos = cur.ppos, len = cur.len, c0 = cur.c0, u0 = cur.u0;
    // the previous stage's readers are done; the block inserts its pending
    // candidates together
    if (__syncthreads_or(pend.n >= kFlushAt)) pend.flush(h);
    // a warp holds half a row of the chunk: its squares go through a
    // butterfly, the two halves add below
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
      const int c = (tid + e * kThreads) / kDK, col = u0 + u;
      const bool ok = c0 + c < len && col < d;
      const float v = ok ? pre[e] - m[col] : 0.f;
      sC[u * kLdC + c] = v;
      float s = v * v;
#pragma unroll
      for (int w = kWarp / 2; w > 0; w >>= 1) s += __shfl_xor_sync(0xffffffffu, s, w);
      if (lane == 0) part[c][warp % 2] = s;
    }
    if (!resident) stage_queries(sQ, sQid, Xs, m, d, u0);
    __syncthreads();
#pragma unroll
    for (int b = 0; b < kTN; ++b)
      tile_sq[b] = (u0 == 0 ? 0.f : tile_sq[b]) + (part[mc + b][0] + part[mc + b][1]);
    if (next.p < P) fetch(next);
    if (u0 == 0) {
#pragma unroll
      for (int a = 0; a < kTM; ++a)
#pragma unroll
        for (int b = 0; b < kTN; ++b) acc[a][b] = 0.f;
    }
    fma_microtile<kTM, kTN>(acc, sQ + mq, kLdQ, sC + mc, kLdC, min(kDK, (d - u0 + 3) & ~3));
    if (u0 + kDK < d) continue;
    // the tile's distances, filtered in the warp that owns their queries
#pragma unroll
    for (int a = 0; a < kTM; ++a)
#pragma unroll
      for (int b = 0; b < kTN; ++b) {
        float dist = fmaxf((sQsq[mq + a] + tile_sq[b]) - 2.f * acc[a][b], 0.f);
        if (half) dist *= 0.5f;
        if (ppos + c0 + mc + b == sQid[mq + a]) dist = -INFINITY;  // self first
        acc[a][b] = dist;
      }
    f32_tile_select(h, pend, acc, sD, mq, mc, tid, min(kCT, len - c0), cur.p * L + c0, -1);
  }
  pend.flush(h);
  if (slot_q >= QB) return;
  if (active) sort8(h.H, h.cnt);
  // the heap's slots become positions
  for (int r = 0; r < k1; ++r) {
    if (active && r < h.cnt) {
      const hkey key = h.node(r);
      const int slot = key_index(key);
      out_pos[o + r] = probe_pos[(int64_t)item * P + slot / L] + slot % L;
      out_dist[o + r] = key_dist(key);
    } else {
      out_pos[o + r] = 0;
      out_dist[o + r] = INFINITY;
    }
  }
}

// T14's launch, its shared memory allowed first (above 48 KB it must be
// asked for)
cudaError_t launch_ivf_search(unsigned grid, const float* Xs, const int* qids,
                              const int* probe_pos, const int* probe_cnt, const float* mu, int n,
                              int d, int QB, int P, int L, int k1, int half, int* pos,
                              float* dist, hkey* heaps, cudaStream_t s) {
  const size_t shm = ivf_shared_bytes();
  cudaError_t e = cudaFuncSetAttribute(ivf_search_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shm);
  if (e != cudaSuccess) return e;
  ivf_search_kernel<<<grid, f32t::kThreads, shm, s>>>(Xs, qids, probe_pos, probe_cnt, mu, n, d,
                                                      QB, P, L, k1, half, pos, dist, heaps);
  return cudaGetLastError();
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
// and lengths, every length <= L; mu (I x d) f32; k1 = k + 1 >= 1 places per
// query; pos (I x QB x k1) int32 and dist (I x QB x k1) f32 out; heaps
// scratch of I x QB x knn_heap_row(k1) 64-bit words (knn_tile.cuh).
int mt_ivf_search(const float* Xs, const int* qids, const int* probe_pos,
                  const int* probe_cnt, const float* mu, int n, int d, int I,
                  int QB, int P, int L, int k1, int half, int* pos, float* dist,
                  void* heaps, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (I <= 0 || QB <= 0) return (int)cudaGetLastError();
  const int64_t blocks = (int64_t)((QB + f32t::kQT - 1) / f32t::kQT) * I;
  if (k1 < 1 || blocks > INT32_MAX) return (int)cudaErrorInvalidValue;
  return (int)launch_ivf_search((unsigned)blocks, Xs, qids, probe_pos, probe_cnt, mu, n, d, QB,
                                P, L, k1, half, pos, dist, (hkey*)heaps, s);
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
