// Kernels of the IVF (inverted-file) kNN index, for Hopper (sm_90a).
//
//   T14 ivf_search     <- muon_tpu/ops/ivf.py _search_fn
//   T15 kmeans_assign  <- muon_tpu/ops/ivf.py _kmeans_fn (its assign step): a
//                         bf16 tensor-core screen decided by the float32 chain
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
#include "mma_bf16.cuh"

namespace {

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
// operands), the operands are bfloat16, their products exact in float32,
// and |cent_c|^2 is the float32 norm of the unrounded centroid.
//
// The port's arithmetic, whose bits T15 keeps (the parent kernel's, a
// ROADMAP invariant; ops/ivf.kmeans_assign_chain is its plain twin): the
// cross term is the float32 fma chain over u in order, acc = fma(x~_u,
// c~_u, acc); the score is csq_c - 2 acc; only a strictly smaller score
// replaces the best, centroids in ascending order, so ties go to the lower
// cluster.
//
// The tensor cores screen, the chain decides. The wrapper hands over X and
// the centroids rounded to bfloat16 once a call, each row padded with zeros
// to ld, a multiple of 16 (ops/knn._bf16_rows), with csq and ct = |c~|^2.
// A block of 8 warps owns 256 rows a tile (warp w rows 32 w + [0, 32), a
// lane each), staged by cp.async. While the whole centroid table fits in
// shared memory beside them (ld <= 64, C up to 1280: 1024 x 64 bf16 is
// 144 KB), it is loaded once a block and the blocks walk the row tiles (one
// block an SM, the grid over the SMs); each warp's row fragments stay in
// registers for every tile of the table, which the warps walk without a
// barrier. Otherwise tiles of 64 centroids, and chunks of 64 dimensions of
// rows wider than 64, come in double-buffered through cp.async as in T5.
// Each warp forms its 32 x 64 cross terms of a tile with
// mma.sync.m16n8k16 (bf16 products, float32 sums in the tensor cores' own
// order), and for each pair the screened score s_c = csq_c - 2 x~.c~ and
// its margin D_c = K (|x~|^2 + |c~|^2). A row keeps M = min over the
// centroids seen of (s_c + D_c); a centroid with s_c - D_c <= M is rescored
// by the chain (from shared memory when the rows are one chunk, else from
// the global rows), at once, in ascending order, and only the chain
// decides.
//
// Why the chain's argmin c* is always rescored. Let chain_c be its score
// and P_c = sum_u |x~_u c~_u| <= (|x~|^2 + |c~|^2) / 2. Products are exact.
// The chain's d float32 adds stray from the exact dot by at most
// d 2^-24 P_c; the tensor cores' k-steps (ld / 16 of them), each adding 16
// exact products to the float32 sum with at most 2 units in the last place
// of the largest magnitude involved (their alignment and truncation), by
// at most (ld / 16) 2^-22 P_c. So for ld <= 1024 the two cross terms lie
// within 2^-14 P_c + 2^-16 P_c of each other, the two scores (twice that,
// plus one rounding of csq - 2 x each, at most 2^-23 (|c|^2 + 2 P_c)) within
// 2^-13.5 (|x~|^2 + |c~|^2) < D_c with K = 2^-13 (ld / 1024 times that for
// wider rows): |s_c - chain_c| < D_c for every c. Then for every c,
// s_c* - D_c* < chain_c* <= chain_c < s_c + D_c, so s_c* - D_c* lies below
// M at the end, and below every M before it (M only falls): c* is rescored.
// A centroid tied with c* on the chain passes the same way, so the lowest
// of them wins as in the parent. The margin's own roundings (|x~|^2 and
// |c~|^2 summed in float32, D_c, s_c +- D_c) move it by far less than the
// slack between 2^-13.5 and 2^-13. (Scores that overflow or are NaN are out
// of this proof; the parent skips a NaN score, and so does the screen.)
//
// Bound: n C ld multiply-adds of bfloat16 operands at the bfloat16 rate,
// or X read once, whichever is larger; the time goes to mma.sync's
// latency-bound chains and the screen's epilogue, a few operations a pair.
// ---------------------------------------------------------------------------

namespace km {
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kRT = kThreads;      // rows a tile, a lane each
constexpr int kCT = 64;            // centroids a tile
constexpr int kDK = 64;            // dimensions a chunk
constexpr int kLdA = kDK + 8;      // bf16 a staged row: ldmatrix's 8 rows in 8 bank groups
constexpr int kOpBytes = kLdA * 2;
constexpr int kMaxShared = 232448;  // 227 KB
}  // namespace km

// shared memory: the rows' staging buffer (two when the rows are chunked),
// then the centroid slots (the whole table, or two tiles) with csq and K ct
__host__ __device__ inline size_t km_shared_bytes(int nchunks, int slots) {
  return (size_t)(nchunks == 1 ? 1 : 2) * km::kRT * km::kOpBytes +
         (size_t)slots * (km::kOpBytes + 8);
}

// rows [r0, r0 + rows) x columns [u0, u0 + cw) of a padded bf16 matrix (row
// stride ld) into dst (row stride kLdA) by cp.async; rows >= n as zeros
__device__ __forceinline__ void km_stage(bf16_bits* dst, const bf16_bits* X, int ld, int r0,
                                         int rows, int n, int u0, int cw) {
  const int segs = cw / 8;  // 16-byte pieces a row
  for (int t = threadIdx.x; t < rows * segs; t += km::kThreads) {
    const int r = t / segs, s = t % segs;
    const bool ok = r0 + r < n;
    cp_async16(dst + r * km::kLdA + s * 8,
               ok ? (const void*)(X + (int64_t)(r0 + r) * ld + u0 + s * 8) : (const void*)X, ok);
  }
}

// |x~|^2 of a staged or padded bf16 row of ld values
__device__ __forceinline__ float bf16_sq(const bf16_bits* row, int ld) {
  float s = 0.f;
  for (int u = 0; u < ld; u += 2) {
    const unsigned w = *reinterpret_cast<const unsigned*>(row + u);
    const float a = __uint_as_float(w << 16), b = __uint_as_float(w & 0xffff0000u);
    s = fmaf(a, a, fmaf(b, b, s));
  }
  return s;
}

// acc += the warp's 32 rows (A fragments a) x the tile's 64 centroids (B in
// shared memory, row stride kLdA) over the 16 dimensions from kk
__device__ __forceinline__ void km_mma_step(float (&acc)[2][8][4], const unsigned (&a)[2][4],
                                            const bf16_bits* B, int kk, int lane) {
#pragma unroll
  for (int np = 0; np < 4; ++np) {
    unsigned b[4];  // b0, b1 of n-tile 2 np, then of 2 np + 1
    const int m = lane >> 3;
    ldmatrix_x4(b, B + (np * 16 + (m >> 1) * 8 + (lane & 7)) * km::kLdA + kk + (m & 1) * 8);
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      mma_bf16(acc[mi][2 * np], a[mi], b[0], b[1]);
      mma_bf16(acc[mi][2 * np + 1], a[mi], b[2], b[3]);
    }
  }
}

// the A fragments of 32 staged rows (A: the warp's first, row stride kLdA)
__device__ __forceinline__ void km_load_a(unsigned (&a)[2][4], const bf16_bits* A, int kk,
                                          int lane) {
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
    ldmatrix_x4(a[mi], A + (mi * 16 + (lane & 15)) * km::kLdA + kk + (lane >> 4) * 8);
}

// The screen of one tile: row mi 16 + r 8 + lane / 4 of the warp holds
// centroids ni 8 + (lane % 4) 2 + e of the tile in this lane, its 4 lanes
// a quad. Per fragment row Mc is the min over the centroids seen of s_c +
// K |c~|^2 and xk2 = 2 K |x~|^2; a centroid passes when s_c - K |c~|^2 <=
// Mc + xk2, i.e. s_c - D_c <= min (s + D). Returns, in the lane that owns
// each row (row lane of the warp), the row's 64-bit mask of passing
// centroids; 0 in every lane when none passes in the warp.
__device__ __forceinline__ unsigned long long km_screen(const float (&acc)[2][8][4],
                                                        const float* csq, const float* ck_,
                                                        float (&Mc)[2][2],
                                                        const float (&xk2)[2][2], int lane) {
  float cs[8][2], ck[8][2];
#pragma unroll
  for (int ni = 0; ni < 8; ++ni)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = ni * 8 + (lane & 3) * 2 + e;
      cs[ni][e] = csq[c];
      ck[ni][e] = ck_[c];
    }
  unsigned long long bits[2][2];
  bool any = false;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float sc[8][2], m = INFINITY;
#pragma unroll
      for (int ni = 0; ni < 8; ++ni)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          sc[ni][e] = cs[ni][e] - 2.f * acc[mi][ni][r * 2 + e];
          m = fminf(m, sc[ni][e] + ck[ni][e]);
        }
      m = fminf(m, __shfl_xor_sync(0xffffffffu, m, 1));
      m = fminf(m, __shfl_xor_sync(0xffffffffu, m, 2));
      Mc[mi][r] = fminf(Mc[mi][r], m);
      const float thr = Mc[mi][r] + xk2[mi][r];
      unsigned long long mm = 0;
#pragma unroll
      for (int ni = 0; ni < 8; ++ni)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (sc[ni][e] - ck[ni][e] <= thr) mm |= 1ull << (ni * 8 + e);
      bits[mi][r] = mm << ((lane & 3) * 2);
      any |= mm != 0;
    }
  if (!__any_sync(0xffffffffu, any)) return 0;
  // row (mi, r) = (lane / 16, lane / 8 % 2) in quad lane % 8 is row lane
  unsigned long long mine = 0;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      unsigned long long mm = bits[mi][r];
      mm |= __shfl_xor_sync(0xffffffffu, mm, 1);
      mm |= __shfl_xor_sync(0xffffffffu, mm, 2);
      const unsigned long long v = __shfl_sync(0xffffffffu, mm, (lane & 7) * 4);
      if ((lane >> 3) == mi * 2 + r) mine = v;
    }
  return mine;
}

__device__ __forceinline__ void km_zero(float (&acc)[2][8][4]) {
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;
}

// 2 K |x~|^2 of the fragment rows, from the norm of row lane of the warp
__device__ __forceinline__ void km_row_margins(float (&xk2)[2][2], float xsq, float K, int lane) {
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      xk2[mi][r] = 2.f * K * __shfl_sync(0xffffffffu, xsq, mi * 16 + r * 8 + (lane >> 2));
}

__global__ void __launch_bounds__(km::kThreads, 1)
    kmeans_assign_kernel(const bf16_bits* __restrict__ X, const bf16_bits* __restrict__ Ct,
                         const float* __restrict__ csq, const float* __restrict__ ct, int n,
                         int ld, int C, float K, int resident, int* __restrict__ assign) {
  using namespace km;
  extern __shared__ __align__(16) unsigned char km_smem[];
  const int nchunks = (ld + kDK - 1) / kDK;
  const int ntiles = (C + kCT - 1) / kCT;
  const int slots = resident ? ntiles * kCT : 2 * kCT;
  bf16_bits* sQ = reinterpret_cast<bf16_bits*>(km_smem);
  bf16_bits* sC = sQ + (nchunks == 1 ? 1 : 2) * kRT * kLdA;
  float* sCsq = reinterpret_cast<float*>(sC + slots * kLdA);
  float* sCt = sCsq + slots;  // K |c~|^2
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  // a slot past the last centroid scores +inf: never the row's bound, never taken on
  auto norms = [&](int slot, int j) {
    sCsq[slot] = j < C ? csq[j] : INFINITY;
    sCt[slot] = j < C ? K * ct[j] : 0.f;
  };
  if (resident) {  // the whole table, once a block
    km_stage(sC, Ct, ld, 0, slots, C, 0, ld);
    cp_async_commit();
    for (int c = tid; c < slots; c += kThreads) norms(c, c);
  }
  const int stages = ntiles * nchunks;  // (tile, chunk) in order
  const int nrt = (n + kRT - 1) / kRT;
  float acc[2][8][4];
  for (int rt = blockIdx.x; rt < nrt; rt += gridDim.x) {
    const int r0 = rt * kRT, i = r0 + tid;
    float best = INFINITY;
    int best_c = 0;
    float xk2[2][2], Mc[2][2] = {{INFINITY, INFINITY}, {INFINITY, INFINITY}};
    auto chain = [&](const unsigned long long bits, int t, const bf16_bits* B, int tslot) {
      unsigned long long mine = bits;
      while (i < n && mine) {
        const int c = __ffsll((long long)mine) - 1;
        mine &= mine - 1;
        const float x = nchunks == 1
                            ? dot_bf16_chain(sQ + tid * kLdA, B + c * kLdA, ld)
                            : dot_bf16_chain(X + (int64_t)i * ld, Ct + (int64_t)(t * kCT + c) * ld,
                                             ld);
        const float score = sCsq[tslot + c] - 2.f * x;
        if (score < best) {
          best = score;
          best_c = t * kCT + c;
        }
      }
      __syncwarp();  // the warp together again before its next ldmatrix
    };

    if (resident) {
      // the rows once; each warp's fragments stay in registers for every
      // tile of the table, which the warps walk without a barrier
      km_stage(sQ, X, ld, r0, kRT, n, 0, ld);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
      km_row_margins(xk2, bf16_sq(sQ + tid * kLdA, ld), K, lane);
      unsigned a[4][2][4];
#pragma unroll
      for (int kq = 0; kq < 4; ++kq)
        if (kq * 16 < ld) km_load_a(a[kq], sQ + warp * 32 * kLdA, kq * 16, lane);
      for (int t = 0; t < ntiles; ++t) {
        const bf16_bits* B = sC + t * kCT * kLdA;
        km_zero(acc);
#pragma unroll
        for (int kq = 0; kq < 4; ++kq)
          if (kq * 16 < ld) km_mma_step(acc, a[kq], B, kq * 16, lane);
        chain(km_screen(acc, sCsq + t * kCT, sCt + t * kCT, Mc, xk2, lane), t, B, t * kCT);
      }
      __syncthreads();  // the rows' buffer is free again
    } else {
      // tiles of 64 centroids (and chunks of 64 dimensions of rows wider
      // than that) double-buffered through cp.async, as in T5
      auto issue = [&](int s) {
        const int t = s / nchunks, ch = s % nchunks, u0 = ch * kDK;
        const int cw = min(kDK, ld - u0);
        km_stage(sC + (s & 1) * kCT * kLdA, Ct, ld, t * kCT, kCT, C, u0, cw);
        if (ch == 0 && tid < kCT) norms((t & 1) * kCT + tid, t * kCT + tid);
        if (nchunks > 1) km_stage(sQ + (s & 1) * kRT * kLdA, X, ld, r0, kRT, n, u0, cw);
        cp_async_commit();
      };
      if (nchunks == 1) km_stage(sQ, X, ld, r0, kRT, n, 0, ld);  // in stage 0's group
      issue(0);
      for (int s = 0; s < stages; ++s) {
        if (s + 1 < stages) {
          issue(s + 1);
          cp_async_wait<1>();
        } else {
          cp_async_wait<0>();
        }
        __syncthreads();
        if (s == 0)
          km_row_margins(xk2, bf16_sq(nchunks == 1 ? sQ + tid * kLdA
                                                   : X + (int64_t)(i < n ? i : 0) * ld, ld),
                         K, lane);
        const int t = s / nchunks, ch = s % nchunks;
        const int cw = min(kDK, ld - ch * kDK);
        const bf16_bits* A = sQ + ((nchunks == 1 ? 0 : (s & 1)) * kRT + warp * 32) * kLdA;
        const bf16_bits* B = sC + (s & 1) * kCT * kLdA;
        if (ch == 0) km_zero(acc);
        for (int kk = 0; kk < cw; kk += 16) {
          unsigned a[2][4];
          km_load_a(a, A, kk, lane);
          km_mma_step(acc, a, B, kk, lane);
        }
        if (ch == nchunks - 1) {
          const int tslot = (t & 1) * kCT;
          chain(km_screen(acc, sCsq + tslot, sCt + tslot, Mc, xk2, lane), t, B, tslot);
        }
        __syncthreads();  // stage s's buffers are free again
      }
    }
    if (i < n) assign[i] = best_c;
  }
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

// T15. Xb (n x ld) and Cb (C x ld) bf16: the rows and the centroids rounded
// once and padded with zeros to ld, a multiple of 16; csq (C,) f32 the
// squared norms of the unrounded centroids, ct (C,) f32 those of the
// rounded ones; K the screen's margin factor; assign (n,) int32 out.
int mt_kmeans_assign(const void* Xb, const void* Cb, const float* csq, const float* ct, int n,
                     int ld, int C, float K, int* assign, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n <= 0 || C <= 0) return (int)cudaGetLastError();
  if (ld <= 0 || ld % 16 != 0) return (int)cudaErrorInvalidValue;
  const int nchunks = (ld + km::kDK - 1) / km::kDK, ntiles = (C + km::kCT - 1) / km::kCT;
  const int resident =
      nchunks == 1 && km_shared_bytes(1, ntiles * km::kCT) <= (size_t)km::kMaxShared;
  const size_t shm = km_shared_bytes(nchunks, resident ? ntiles * km::kCT : 2 * km::kCT);
  cudaError_t e = cudaFuncSetAttribute(kmeans_assign_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shm);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0, per = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, kmeans_assign_kernel, km::kThreads,
                                                    shm);
  if (e != cudaSuccess) return (int)e;
  const int64_t row_tiles = ((int64_t)n + km::kRT - 1) / km::kRT;
  const int64_t grid = row_tiles < (int64_t)sms * (per > 0 ? per : 1)
                           ? row_tiles : (int64_t)sms * (per > 0 ? per : 1);
  kmeans_assign_kernel<<<(unsigned)grid, km::kThreads, shm, s>>>(
      (const bf16_bits*)Xb, (const bf16_bits*)Cb, csq, ct, n, ld, C, K, resident, assign);
  return (int)cudaGetLastError();
}

}  // extern "C"
