// Dense kernels of the per-modality neighbors path, for Hopper (sm_90a).
//
//   T5 knn_topk               <- muon_tpu/ops/knn.py _knn_fn + _topk2
//   T6 smooth_knn_membership  <- muon_tpu/ops/fuzzy.py _smooth_knn_fn +
//                                _membership_fn
//   T40 knn_ring_merge        <- muon_tpu/parallel/pipeline.py _knn_ring_fn
//                                (:374), one round of its ring
//
// Interface: plain C functions (loaded with ctypes), as in
// sparse_kernels.cu. Each launches on the stream it is given, allocates
// nothing, and returns cudaGetLastError(). Outputs are allocated by the
// caller.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "knn_tile.cuh"
#include "mma_bf16.cuh"

namespace {

// ---------------------------------------------------------------------------
// T5: exact self-kNN over the rows of X (n x d, row-major).
//
// The reference forms every (query, candidate) distance in a (block, n) tile
// in device memory and selects with a two-stage top-k. Here no distance ever
// leaves the SM: a block stages its queries once and streams the candidates
// through shared memory in tiles. Each warp owns 32 of the block's queries
// (a lane each, with its heap) and forms their distances to the whole tile
// in registers; each distance is compared with the bar of its query (the
// root of its heap; all pass while it fills), and each query takes the
// candidates that pass in ascending candidate order (knn_tile.cuh). Two
// products feed the tile:
//
//   bf16 (the approx path, n > 20,000 on the main path): the operand rows
//   are bfloat16 values, handed over as bfloat16 with each row padded with
//   zeros to a multiple of 16. A block of 4 warps owns 128 queries, staged
//   once (d <= 64; wider rows go in 64-wide chunks, the query chunk
//   double-buffered with the candidates'); candidate tiles of 64 rows come
//   in through cp.async, double-buffered, and each warp forms its 32 x 64
//   cross terms with mma.sync.m16n8k16 (bf16 products, float32 sums; both
//   operands by ldmatrix: candidate rows stored along d are B in the "col"
//   layout). The products are exact and sum in float32, but in the tensor
//   cores' own order: a distance there may differ from a float32 fma
//   chain's in its last bits, enough to swap near ties against the plain
//   version's float32 product. So the tensor cores only screen: a
//   candidate whose distance lies within an error margin of its query's bar
//   or below is taken on, and its distance recomputed as the fma chain over
//   its bfloat16 values in order (from the staged rows); the chain's
//   distance decides. The results are the float32 mode's bits on the same
//   rows held as float32 (a ROADMAP invariant). Bound: the
//   tensor cores' 2 n^2 d (d padded to 16) at the bf16 rate; the time goes
//   to the screen's epilogue and the selection.
//
//   f32 (exact mode, and the non-approx metrics): a block of 256 threads
//   owns 256 queries; candidate tiles of 32 rows x 64 dimensions are staged
//   transposed (the next one loaded into registers while this one is
//   multiplied), and each thread carries an 8 x 4 micro-tile of sums
//   (knn_tile.cuh fma_microtile). Each pair's sum is the fma chain over u
//   in order, whose bits the port's T5 keeps (a ROADMAP invariant;
//   exp_compare_trees.py holds two trees to it). Bound: the n^2 d fmas at
//   the float32 rate; the micro-tile's shared-memory loads (3 of 16 bytes a
//   32 fmas) hold it below that.
//
// Distance, with the reference's rounding points:
//   one_minus = 0: d2 = max((|q|^2 + |c|^2) - 2 cross, 0), norms given in f32
//                  (euclidean, sqeuclidean);
//   one_minus = 1: 1 - cross, on rows normalised beforehand (cosine,
//                  correlation).
// The approx path's norms are those of the unrounded rows. The cross term
// stays f32, as in the reference as it runs: under jit, XLA folds the f32
// convert of the bf16 matmul into the dot, whose result is then f32 (its
// compiled HLO is a dot of two bf16-rounded f32 operands into f32).
// Order: self first whatever its distance (the reference's -inf mask), then
// the k best others by (distance, index) ascending, so ties go to the lower
// index as lax.top_k does. Candidates are offered in index order, so an
// equal distance never displaces an entry of the heap. Every query's heap
// lives in its own row of the outputs (places 1..k), sorted there at the
// end, so any k up to n - 1 runs; the counters knn_topk and knn_topk_global
// (lists longer than 256) name the same kernels.
// ---------------------------------------------------------------------------

// The tensor cores' sums run in their own order and precision, a few ulps of
// sum |q_u c_u| <= (|q|^2 + |c|^2) / 2 from the chain's. A candidate is taken
// on to its chain when its tensor-core distance lies below the bar by less
// than kScreen (|q|^2 + |c|^2), far above that error (d2 = s - 2 cross moves
// by twice the cross term's), so every candidate whose chain distance
// beats the bar is among those taken on.
constexpr float kScreen = 1.f / 16384.f;

// the final list of query i: self, then its heap sorted ascending
__device__ __forceinline__ void write_list(TopK& h, int i, int64_t o, int k, int take_sqrt,
                                           int* out_idx, float* out_dist) {
  sort8(h.H, k);
  out_idx[o] = i;
  out_dist[o] = 0.f;
  for (int r = 0; r < k; ++r) {
    const hkey key = h.node(r);
    const float d = key_dist(key);
    out_idx[o + 1 + r] = key_index(key);
    out_dist[o + 1 + r] = take_sqrt ? sqrtf(fmaxf(d, 0.f)) : d;
  }
}

namespace mma {
constexpr int kThreads = 128;  // 4 warps
constexpr int kQT = 128;       // queries per block: warp w owns 32 w + [0, 32), a lane each
constexpr int kCT = 64;        // candidates per tile
constexpr int kDK = 64;        // dimensions per chunk
constexpr int kLdA = kDK + 8;  // bf16 per staged row: 144 bytes, so the 8 rows of an
                               // ldmatrix fall in 8 distinct bank groups
constexpr int kOpBytes = kLdA * 2;
}  // namespace mma

// shared memory of the bf16 kernel: the query chunk (two when the rows are
// wider than one chunk), two candidate chunks, two tiles' norms
__host__ __device__ constexpr size_t mma_shared_bytes(bool resident) {
  return (size_t)(resident ? 1 : 2) * mma::kQT * mma::kOpBytes +
         2 * (size_t)mma::kCT * mma::kOpBytes + 2 * mma::kCT * 4;
}

// rows [r0, r0 + rows) x columns [u0, u0 + cw) of the padded bf16 matrix
// (row stride ld) into dst (row stride kLdA) by cp.async; rows >= n as zeros
__device__ __forceinline__ void stage_bf16(bf16_bits* dst, const bf16_bits* X, int ld, int r0,
                                           int rows, int n, int u0, int cw) {
  const int segs = cw / 8;  // 16-byte pieces a row
  for (int t = threadIdx.x; t < rows * segs; t += mma::kThreads) {
    const int r = t / segs, s = t % segs;
    const bool ok = r0 + r < n;
    cp_async16(dst + r * mma::kLdA + s * 8,
               ok ? (const void*)(X + (int64_t)(r0 + r) * ld + u0 + s * 8) : (const void*)X, ok);
  }
}

__global__ void __launch_bounds__(mma::kThreads, 3)
    knn_topk_mma_kernel(const bf16_bits* __restrict__ X, const float* __restrict__ sq, int n,
                        int d, int k, int one_minus, int take_sqrt, int* __restrict__ out_idx,
                        float* __restrict__ out_dist, hkey* __restrict__ heaps) {
  using namespace mma;
  extern __shared__ __align__(16) unsigned char smem[];
  const int ld = (d + 15) & ~15;
  const int nchunks = (ld + kDK - 1) / kDK;
  const bool resident = nchunks == 1;
  bf16_bits* sQ = reinterpret_cast<bf16_bits*>(smem);
  bf16_bits* sC = sQ + (resident ? 1 : 2) * kQT * kLdA;
  float* sCsq = reinterpret_cast<float*>(sC + 2 * kCT * kLdA);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int q0 = blockIdx.x * kQT, i = q0 + tid;
  const bool active = i < n;
  // the accumulator fragments' rows of this lane: 32 warp + 16 mi + 8 r + lane / 4
  float qsq[2][2];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qi = q0 + warp * 32 + mi * 16 + r * 8 + (lane >> 2);
      qsq[mi][r] = (!one_minus && qi < n) ? sq[qi] : 0.f;
    }

  const float my_sq = (active && !one_minus) ? sq[i] : 0.f;
  const int64_t o = (int64_t)(active ? i : 0) * (k + 1);
  TopK h = make_topk(heaps + (int64_t)(active ? i : 0) * knn_heap_row(k), active ? k : 0);
  Pending pend;
  pend.n = 0;

  const int ntiles = (n + kCT - 1) / kCT;
  const int stages = ntiles * nchunks;  // (tile, chunk) in order
  auto issue = [&](int s) {
    const int t = s / nchunks, ch = s % nchunks, u0 = ch * kDK;
    const int cw = min(kDK, ld - u0);
    stage_bf16(sC + (s & 1) * kCT * kLdA, X, ld, t * kCT, kCT, n, u0, cw);
    if (!resident) stage_bf16(sQ + (s & 1) * kQT * kLdA, X, ld, q0, kQT, n, u0, cw);
    if (ch == 0 && tid < kCT) {
      const int j = t * kCT + tid;
      sCsq[(t & 1) * kCT + tid] = (!one_minus && j < n) ? sq[j] : 0.f;
    }
    cp_async_commit();
  };
  if (resident) stage_bf16(sQ, X, ld, q0, kQT, n, 0, ld);  // in stage 0's group
  issue(0);

  float acc[2][8][4];
  for (int s = 0; s < stages; ++s) {
    if (s + 1 < stages) {
      issue(s + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    // stage s has landed for every thread; the block inserts its pending
    // candidates together
    if (__syncthreads_or(pend.n >= kFlushAt)) pend.flush(h);
    const int t = s / nchunks, ch = s % nchunks;
    const int cw = min(kDK, ld - ch * kDK);
    const bf16_bits* A = sQ + (resident ? 0 : (s & 1)) * kQT * kLdA;
    const bf16_bits* B = sC + (s & 1) * kCT * kLdA;
    if (ch == 0) {
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 8; ++ni)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;
    }
    for (int kk = 0; kk < cw; kk += 16) {
      unsigned a[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        ldmatrix_x4(a[mi], A + (warp * 32 + mi * 16 + (lane & 15)) * kLdA + kk + (lane >> 4) * 8);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        unsigned b[4];  // b0, b1 of n-tile 2 np, then of 2 np + 1
        const int m = lane >> 3;
        ldmatrix_x4(b, B + (np * 16 + (m >> 1) * 8 + (lane & 7)) * kLdA + kk + (m & 1) * 8);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          mma_bf16(acc[mi][2 * np], a[mi], b[0], b[1]);
          mma_bf16(acc[mi][2 * np + 1], a[mi], b[2], b[3]);
        }
      }
    }
    if (ch == nchunks - 1) {
      // The tile's tensor-core distances, in the registers of the warp that
      // owns their queries, screened against each query's bar (from the lane
      // that owns it); each query takes the candidates of its row that pass
      // the screen, in ascending order, at the distance of their float32
      // chain. Row mi 16 + r 8 + lane / 4 of the warp holds candidates
      // ni 8 + (lane % 4) 2 + e of this lane.
      const int c0 = t * kCT, nvalid = min(kCT, n - c0);
      const float* csq = sCsq + (t & 1) * kCT;
      float cs[8][2];  // the norms of this lane's candidates
#pragma unroll
      for (int ni = 0; ni < 8; ++ni)
#pragma unroll
        for (int e = 0; e < 2; ++e) cs[ni][e] = csq[ni * 8 + (lane & 3) * 2 + e];
      const float bar = shared_bar(h);
      unsigned long long bits[2][2];  // bit c: candidate c passes the row's screen
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float rb = __shfl_sync(0xffffffffu, bar, mi * 16 + r * 8 + (lane >> 2));
          unsigned m16 = 0;  // bit 2 ni + e
#pragma unroll
          for (int ni = 0; ni < 8; ++ni)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float x = acc[mi][ni][r * 2 + e];
              const float sc = one_minus ? 2.f : qsq[mi][r] + cs[ni][e];
              const float dv = one_minus ? 1.f - x : fmaxf(sc - 2.f * x, 0.f);
              if (!(dv - kScreen * sc >= rb) && ni * 8 + (lane & 3) * 2 + e < nvalid)
                m16 |= 1u << (ni * 2 + e);
            }
          unsigned long long m = 0;
#pragma unroll
          for (int ni = 0; ni < 8; ++ni) m |= (unsigned long long)((m16 >> (2 * ni)) & 3u) << (ni * 8);
          bits[mi][r] = m << ((lane & 3) * 2);
        }
      if (__any_sync(0xffffffffu, (bits[0][0] | bits[0][1] | bits[1][0] | bits[1][1]) != 0)) {
        // a row's 64 candidates lie in the 4 lanes of a quad; this lane's
        // query is row lane of the warp: (mi, r) = (lane / 16, lane / 8 % 2)
        // in quad lane % 8
        unsigned long long mine = 0;
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            unsigned long long m = bits[mi][r];
            m |= __shfl_xor_sync(0xffffffffu, m, 1);
            m |= __shfl_xor_sync(0xffffffffu, m, 2);
            const unsigned long long v = __shfl_sync(0xffffffffu, m, (lane & 7) * 4);
            if ((lane >> 3) == mi * 2 + r) mine = v;
          }
        if (i >= c0 && i < c0 + kCT) mine &= ~(1ull << (i - c0));  // self
        // the rows of the chain: the staged ones when a row is one chunk
        const bf16_bits* qrow = resident ? A + tid * kLdA : X + (int64_t)(active ? i : 0) * ld;
        const bf16_bits* crow = resident ? B : X + (int64_t)c0 * ld;
        const int cstride = resident ? kLdA : ld;
        scan_bits(h, pend, mine, c0, [&](int c) {
          const float x = dot_bf16_chain(qrow, crow + (int64_t)c * cstride, ld);
          return one_minus ? 1.f - x : fmaxf((my_sq + csq[c]) - 2.f * x, 0.f);
        });
      }
    }
    __syncthreads();  // stage s's buffers are free again
  }
  pend.flush(h);
  if (active) write_list(h, i, o, k, take_sqrt, out_idx, out_dist);
}

// shared memory of the float32 kernel: a query chunk, a candidate chunk,
// the distance tile, the queries' and the tile's norms
__host__ __device__ constexpr size_t f32_shared_bytes() {
  return 4 * ((size_t)f32t::kDK * f32t::kLdQ + (size_t)f32t::kDK * f32t::kLdC +
              (size_t)f32t::kCT * f32t::kLdQ + f32t::kQT + f32t::kCT);
}

// rows [r0, r0 + rows) x columns [u0, u0 + kDK) of X (n x d) transposed into
// dst[u * ld + r]; rows >= n and columns >= d as zeros
__device__ __forceinline__ void stage_f32_t(float* dst, int ld, const float* X, int n, int d,
                                            int r0, int rows, int u0) {
  for (int t = threadIdx.x; t < rows * f32t::kDK; t += f32t::kThreads) {
    const int r = t / f32t::kDK, u = t % f32t::kDK, col = u0 + u;
    dst[u * ld + r] = (r0 + r < n && col < d) ? X[(int64_t)(r0 + r) * d + col] : 0.f;
  }
}

__global__ void __launch_bounds__(f32t::kThreads, 2)
    knn_topk_f32_kernel(const float* __restrict__ X, const float* __restrict__ sq, int n, int d,
                        int k, int one_minus, int take_sqrt, int* __restrict__ out_idx,
                        float* __restrict__ out_dist, hkey* __restrict__ heaps) {
  using namespace f32t;
  extern __shared__ __align__(16) float fsmem[];
  float* sQ = fsmem;
  float* sC = sQ + kDK * kLdQ;
  float* sD = sC + kDK * kLdC;
  float* sQsq = sD + kCT * kLdQ;
  float* sCsq = sQsq + kQT;

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * kQT, i = q0 + tid;
  const bool active = i < n;
  const int mq = micro_q(tid), mc = micro_c(tid);
  const bool resident = d <= kDK;
  sQsq[tid] = (active && !one_minus) ? sq[i] : 0.f;
  if (resident) stage_f32_t(sQ, kLdQ, X, n, d, q0, kQT, 0);

  const int64_t o = (int64_t)(active ? i : 0) * (k + 1);
  TopK h = make_topk(heaps + (int64_t)(active ? i : 0) * knn_heap_row(k), active ? k : 0);
  Pending pend;
  pend.n = 0;

  // stages: (candidate tile, 64-wide chunk of d) in order; a stage's
  // candidate chunk is loaded into registers while the one before it is
  // multiplied, kPer values a thread
  const int nch = (d + kDK - 1) / kDK;
  const int stages = (n + kCT - 1) / kCT * nch;
  constexpr int kPer = kCT * kDK / kThreads;
  const int u = tid % kDK;  // this thread's column of every chunk it loads
  float pre[kPer];
  auto fetch = [&](int s) {
    const int c0 = s / nch * kCT, col = s % nch * kDK + u;
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
      const int r = (tid + e * kThreads) / kDK;
      pre[e] = (c0 + r < n && col < d) ? X[(int64_t)(c0 + r) * d + col] : 0.f;
    }
  };
  fetch(0);
  float acc[kTM][kTN];
  for (int s = 0; s < stages; ++s) {
    const int c0 = s / nch * kCT, ch = s % nch, u0 = ch * kDK;
    // the previous stage's readers are done; the block inserts its pending
    // candidates together
    if (__syncthreads_or(pend.n >= kFlushAt)) pend.flush(h);
#pragma unroll
    for (int e = 0; e < kPer; ++e) sC[u * kLdC + (tid + e * kThreads) / kDK] = pre[e];
    if (!resident) stage_f32_t(sQ, kLdQ, X, n, d, q0, kQT, u0);
    if (ch == 0 && tid < kCT) sCsq[tid] = (!one_minus && c0 + tid < n) ? sq[c0 + tid] : 0.f;
    __syncthreads();
    if (s + 1 < stages) fetch(s + 1);
    if (ch == 0) {
#pragma unroll
      for (int a = 0; a < kTM; ++a)
#pragma unroll
        for (int b = 0; b < kTN; ++b) acc[a][b] = 0.f;
    }
    fma_microtile<kTM, kTN>(acc, sQ + mq, kLdQ, sC + mc, kLdC, min(kDK, (d - u0 + 3) & ~3));
    if (ch < nch - 1) continue;
    // the tile's distances, filtered in the warp that owns their queries
    // (as in the bf16 kernel); sCsq stays until the next stage's barrier
    float cs[kTN];
#pragma unroll
    for (int b = 0; b < kTN; ++b) cs[b] = sCsq[mc + b];
#pragma unroll
    for (int a = 0; a < kTM; ++a)
#pragma unroll
      for (int b = 0; b < kTN; ++b)
        acc[a][b] = one_minus ? 1.f - acc[a][b]
                              : fmaxf((sQsq[mq + a] + cs[b]) - 2.f * acc[a][b], 0.f);
    f32_tile_select(h, pend, acc, sD, mq, mc, tid, min(kCT, n - c0), c0,
                    (i >= c0 && i < c0 + kCT) ? i - c0 : -1);
  }
  pend.flush(h);
  if (active) write_list(h, i, o, k, take_sqrt, out_idx, out_dist);
}

// ---------------------------------------------------------------------------
// T40: one round of the sharded exact kNN's ring. A rank holds its query
// rows Q (nq x d) and, this round, one database block B (nb x d) that came
// round the ring from the rank at offset `off`; B's row j is the point
// off + j, and rows with off + j >= n are padding (valid = min(nb, n - off)
// rows are points). Each query merges the block's candidates into its
// carried (k+1)-list (cd, ci: ascending, from the last round) and writes
// the new list to (od, oi).
//
// The reference forms the (R, R) distance tile of every round in device
// memory, takes the block's top-kk with lax.top_k and then the top-(k+1) of
// concat([carried, block's kk]). Here no distance leaves the SM: the
// kernel is T5's float32 kernel on knn_tile.cuh's tile (256 queries a
// block, 8 x 4 micro-tiles, candidate tiles of 32 rows x 64 dimensions
// staged transposed, the filter against the heap roots, the register
// buffers, the packed 8-ary heaps), with T40's own epilogue:
//
// - The distance is the reference's, (|q|^2 - 2 cross) + |b|^2 in float32,
//   unclamped, the cross term the tile's fma chain over u in order.
// - A key is make_key(distance, tag): the tag is the carried position
//   0..k, then k+1+j for block row j. That is the reference's tie rule:
//   its second top_k ranks equal distances by position in the
//   concatenation, the carried list first, then the block's top-kk, which
//   lax.top_k ordered by (distance, block row); and one merged selection
//   equals the reference's two, because the block's top-kk holds every row
//   that can enter.
// - The heap starts full: the carried list, ascending, written in reverse
//   into the heap's places is already a max-heap (every parent lies before
//   its children). A row then enters only when it beats the root (tags
//   rise, so an equal distance never does), and padding rows are skipped.
//
// Filling the card: a block owns 256 queries, so a [mesh4] round's 25,000
// queries make 98 blocks for 132 SMs (two blocks each). The block's rows
// are then cut into `parts` contiguous ranges (grid.y): each part selects
// over its range from the carried list in a heap row of its own, sorted in
// place, and a second kernel merges a query's part lists in key order,
// taking a carried entry (in every list that kept it, with the same key)
// once. Each part's list is the top-(k+1) of the carried list and its
// range, so the first k+1 distinct keys of the merge are the top-(k+1) of
// the whole round: one exact selection, the same list as with one part.
// The wrapper picks `parts` (ops/knn.py ring_parts): lists of up to 32
// places take enough parts to fill the card's block slots once (4 at
// 25,000 queries); longer ones one part, since each part fills and sorts a
// heap of its own, which costs more there than idle SMs (PERF.md §6).
// With one part the kernel writes the list itself. The tags become point ids when the list
// is written; a carried entry keeps its carried distance's bits.
// Bound: by the fmas of the cross terms, nq * valid * d a round.
// ---------------------------------------------------------------------------

// the most parts a query's rows are cut into (ops/knn.py RING_MAX_PARTS)
constexpr int kRingMaxParts = 8;

// entry r of query row o's merged list from its key
__device__ __forceinline__ void write_ring_entry(hkey key, int64_t o, int r, int k1, int off,
                                                 const float* cd, const int* ci, float* od,
                                                 int* oi) {
  const int tag = key_index(key);
  od[o + r] = tag < k1 ? cd[o + tag] : key_dist(key);
  oi[o + r] = tag < k1 ? ci[o + tag] : off + (tag - k1);
}

__global__ void __launch_bounds__(f32t::kThreads, 2)
    knn_ring_merge_kernel(const float* __restrict__ Q, const float* __restrict__ sq_q, int nq,
                          int d, const float* __restrict__ B, const float* __restrict__ sq_b,
                          int valid, int part_rows, int off, int k1,
                          const float* __restrict__ cd, const int* __restrict__ ci,
                          float* __restrict__ od, int* __restrict__ oi,
                          hkey* __restrict__ heaps) {
  using namespace f32t;
  extern __shared__ __align__(16) float fsmem[];
  float* sQ = fsmem;
  float* sC = sQ + kDK * kLdQ;
  float* sD = sC + kDK * kLdC;
  float* sQsq = sD + kCT * kLdQ;
  float* sCsq = sQsq + kQT;

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * kQT, i = q0 + tid;
  const bool active = i < nq;
  const int mq = micro_q(tid), mc = micro_c(tid);
  const bool resident = d <= kDK;
  sQsq[tid] = active ? sq_q[i] : 0.f;
  if (resident) stage_f32_t(sQ, kLdQ, Q, nq, d, q0, kQT, 0);

  // this part's rows of B: [r0, r1)
  const int r0 = (int)min((int64_t)valid, (int64_t)blockIdx.y * part_rows);
  const int r1 = (int)min((int64_t)valid, (int64_t)r0 + part_rows);
  const int64_t o = (int64_t)(active ? i : 0) * k1;
  hkey* H = heaps + ((int64_t)blockIdx.y * nq + (active ? i : 0)) * knn_heap_row(k1);
  TopK h = make_topk(H, 0);  // an inactive lane's is full and admits nothing
  if (active) {
    for (int r = 0; r < k1; ++r) H[kHeapOff + r] = make_key(cd[o + k1 - 1 - r], k1 - 1 - r);
    h.cnt = h.k = k1;
    h.thr = cd[o + k1 - 1];
  }
  Pending pend;
  pend.n = 0;

  // stages: (candidate tile, 64-wide chunk of d) in order, the next
  // stage's candidate chunk loaded into registers while this one is
  // multiplied, kPer values a thread (as in T5's float32 kernel)
  const int nch = (d + kDK - 1) / kDK;
  const int stages = (r1 - r0 + kCT - 1) / kCT * nch;
  constexpr int kPer = kCT * kDK / kThreads;
  const int u = tid % kDK;
  float pre[kPer];
  auto fetch = [&](int s) {
    const int c0 = r0 + s / nch * kCT, col = s % nch * kDK + u;
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
      const int r = (tid + e * kThreads) / kDK;
      pre[e] = (c0 + r < r1 && col < d) ? B[(int64_t)(c0 + r) * d + col] : 0.f;
    }
  };
  if (stages > 0) fetch(0);
  float acc[kTM][kTN];
  for (int s = 0; s < stages; ++s) {
    const int c0 = r0 + s / nch * kCT, ch = s % nch, u0 = ch * kDK;
    if (__syncthreads_or(pend.n >= kFlushAt)) pend.flush(h);
#pragma unroll
    for (int e = 0; e < kPer; ++e) sC[u * kLdC + (tid + e * kThreads) / kDK] = pre[e];
    if (!resident) stage_f32_t(sQ, kLdQ, Q, nq, d, q0, kQT, u0);
    if (ch == 0 && tid < kCT) sCsq[tid] = c0 + tid < r1 ? sq_b[c0 + tid] : 0.f;
    __syncthreads();
    if (s + 1 < stages) fetch(s + 1);
    if (ch == 0) {
#pragma unroll
      for (int a = 0; a < kTM; ++a)
#pragma unroll
        for (int b = 0; b < kTN; ++b) acc[a][b] = 0.f;
    }
    fma_microtile<kTM, kTN>(acc, sQ + mq, kLdQ, sC + mc, kLdC, min(kDK, (d - u0 + 3) & ~3));
    if (ch < nch - 1) continue;
    float cs[kTN];
#pragma unroll
    for (int b = 0; b < kTN; ++b) cs[b] = sCsq[mc + b];
#pragma unroll
    for (int a = 0; a < kTM; ++a)
#pragma unroll
      for (int b = 0; b < kTN; ++b)
        acc[a][b] = __fadd_rn(__fsub_rn(sQsq[mq + a], __fmul_rn(2.f, acc[a][b])), cs[b]);
    f32_tile_select(h, pend, acc, sD, mq, mc, tid, min(kCT, r1 - c0), k1 + c0, -1);
  }
  pend.flush(h);
  if (!active) return;
  sort8(H, k1);
  if (gridDim.y == 1)
    for (int r = 0; r < k1; ++r) write_ring_entry(h.node(r), o, r, k1, off, cd, ci, od, oi);
}

// the parts' sorted lists of each query merged by key, a carried entry
// taken once: a thread a query
__global__ void knn_ring_merge_parts_kernel(const hkey* __restrict__ heaps, int nq, int k1,
                                            int parts, int off, const float* __restrict__ cd,
                                            const int* __restrict__ ci, float* __restrict__ od,
                                            int* __restrict__ oi) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= nq) return;
  const int64_t row = knn_heap_row(k1), o = (int64_t)i * k1;
  const hkey* L[kRingMaxParts];
  int pos[kRingMaxParts];
  hkey head[kRingMaxParts];
#pragma unroll
  for (int s = 0; s < kRingMaxParts; ++s) {
    L[s] = heaps + ((int64_t)s * nq + i) * row + kHeapOff;
    pos[s] = 0;
    head[s] = s < parts ? L[s][0] : ~0ull;  // ~0: no key (a list ends only past k1)
  }
  for (int r = 0; r < k1; ++r) {
    hkey m = head[0];
#pragma unroll
    for (int s = 1; s < kRingMaxParts; ++s) m = head[s] < m ? head[s] : m;
#pragma unroll
    for (int s = 0; s < kRingMaxParts; ++s)
      if (head[s] == m) head[s] = ++pos[s] < k1 ? L[s][pos[s]] : ~0ull;
    write_ring_entry(m, o, r, k1, off, cd, ci, od, oi);
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

// T5's launch: the bf16 or the float32 kernel, its shared memory allowed
// first (above 48 KB it must be asked for)
cudaError_t launch_knn_topk(const void* X, const float* sq, int n, int d, int k, int one_minus,
                            int take_sqrt, int bf16, int* idx, float* dist, hkey* heaps,
                            cudaStream_t s) {
  if (bf16) {
    const size_t shm = mma_shared_bytes(((d + 15) & ~15) <= mma::kDK);
    cudaError_t e = cudaFuncSetAttribute(knn_topk_mma_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shm);
    if (e != cudaSuccess) return e;
    knn_topk_mma_kernel<<<(n + mma::kQT - 1) / mma::kQT, mma::kThreads, shm, s>>>(
        (const bf16_bits*)X, sq, n, d, k, one_minus, take_sqrt, idx, dist, heaps);
  } else {
    const size_t shm = f32_shared_bytes();
    cudaError_t e = cudaFuncSetAttribute(knn_topk_f32_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shm);
    if (e != cudaSuccess) return e;
    knn_topk_f32_kernel<<<(n + f32t::kQT - 1) / f32t::kQT, f32t::kThreads, shm, s>>>(
        (const float*)X, sq, n, d, k, one_minus, take_sqrt, idx, dist, heaps);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// T5. X (n x d): f32, or with bf16 set bfloat16 with each row padded with
// zeros to a multiple of 16 (the tensor-core product); sq (n,) f32 squared
// row norms (unused when one_minus); 0 <= k <= n - 1 neighbours besides
// self; idx (n x (k+1)) int32 and dist (n x (k+1)) f32 out; heaps scratch
// of n x knn_heap_row(k) 64-bit words (knn_tile.cuh).
int mt_knn_topk(const void* X, const float* sq, int n, int d, int k, int one_minus,
                int take_sqrt, int bf16, int* idx, float* dist, void* heaps, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  return (int)launch_knn_topk(X, sq, n, d, k, one_minus, take_sqrt, bf16, idx, dist,
                              (hkey*)heaps, (cudaStream_t)stream);
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


// T40. Q (nq x d) f32 with sq_q (nq,) its squared row norms; B (nb x d) f32
// with sq_b (nb,), its row j the point off + j, rows with off + j >= n
// skipped; cd (nq x k1) f32 and ci (nq x k1) int32 the carried lists
// (ascending); od, oi (nq x k1) the merged lists out, not aliasing cd, ci;
// 1 <= parts <= 8 ranges of B's rows selected apart and merged; heaps
// scratch of parts x nq x knn_heap_row(k1) 64-bit words (knn_tile.cuh).
int mt_knn_ring_merge(const float* Q, const float* sq_q, int nq, int d, const float* B,
                      const float* sq_b, int nb, int off, int n, int k1, int parts,
                      const float* cd, const int* ci, float* od, int* oi, void* heaps,
                      void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (nq <= 0 || k1 <= 0) return (int)cudaGetLastError();
  if (parts < 1 || parts > kRingMaxParts) return (int)cudaErrorInvalidValue;
  const int valid = max(0, min(nb, n - off));  // rows of B that are points
  // each part a whole number of candidate tiles
  const int part_rows =
      (int)(((int64_t)valid + parts - 1) / parts + f32t::kCT - 1) / f32t::kCT * f32t::kCT;
  const size_t shm = f32_shared_bytes();
  cudaError_t e = cudaFuncSetAttribute(knn_ring_merge_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shm);
  if (e != cudaSuccess) return (int)e;
  knn_ring_merge_kernel<<<dim3((nq + f32t::kQT - 1) / f32t::kQT, parts), f32t::kThreads, shm,
                          s>>>(Q, sq_q, nq, d, B, sq_b, valid, part_rows, off, k1, cd, ci, od,
                               oi, (hkey*)heaps);
  if (parts == 1) return (int)cudaGetLastError();
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  constexpr int threads = 128;
  knn_ring_merge_parts_kernel<<<(nq + threads - 1) / threads, threads, 0, s>>>(
      (const hkey*)heaps, nq, k1, parts, off, cd, ci, od, oi);
  return (int)cudaGetLastError();
}

}  // extern "C"
