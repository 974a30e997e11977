// Kernels of the WNN multimodal neighbors path, for Hopper (sm_90a).
//
//   T9  wnn_bandwidth      <- muon_tpu/ops/wnn.py _bandwidth_fn +
//                             _bandwidth_block_math
//   T10 wnn_theta          <- muon_tpu/ops/wnn.py _theta_fn + _theta_block_math
//   T11 wnn_fusion_scores  <- muon_tpu/ops/wnn.py _fusion_all_fn +
//                             _fusion_block_math
//
// Over a device mesh (muon_tpu/parallel/pipeline.py _wnn_bandwidth_fn,
// _wnn_theta_fn, _wnn_score_fn) each rank runs T9 and T11 on a window of
// query rows over the whole, replicated tables, and T10 on its share of the
// work items.
//
// Interface: plain C functions (loaded with ctypes), as in knn_kernels.cu.
// Each launches on the stream it is given, allocates nothing, and returns
// cudaGetLastError(). Outputs are allocated by the caller.
//
// Rounding: the reference's float32 arithmetic is kept operation by
// operation. Where nvcc would contract a multiply and an add into one fma
// (which rounds once instead of twice), the _rn intrinsics pin the
// reference's two roundings. Products of two bfloat16 values are exact in
// float32, so the bf16 cross terms may use fmaf. Sums over a row (cross
// terms, the neighbour mean) run in index order; XLA may sum in another
// order, so they agree with the reference to float32 rounding.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;

// an int that orders as the float does (-0 counted as +0); NaN above +inf
__device__ __forceinline__ int ordered(float x) {
  const int b = __float_as_int(x + 0.f);
  return b < 0 ? b ^ 0x7fffffff : b;
}

// ---------------------------------------------------------------------------
// T9: per cell, the kernel bandwidth sigma. The candidates are the cell's kk
// neighbours, then every stride-th neighbour of each of them
// (C = kk + kk * ceil(kk / stride)). Each candidate c is scored by
//   (N - jac * N) + (bbox - eucl) / bbox
// with jac the Jaccard distance between the neighbour sets of the cell and
// of c, and eucl the euclidean distance of bf16-rounded reps (f32 cross
// term, f32 norms). Pads, self and jac >= 1 score N + 1. The first
// osz = min(C, 4 n_bw) candidates by (score, position) are walked in order;
// bad entries and later duplicates are dropped, and sigma is the mean eucl
// of the first n_bw left, or, when none is left, the mean eucl of the first
// kk slots (a pad there measures cell 0, as in the reference).
//
// One block per cell. The cell's neighbour set is sorted into shared memory
// (rank sort), so each Jaccard intersection is kk binary searches (each the
// first equal entry, then the run of equal ones). The selection of the
// first osz candidates by (score, position) is exact and linear in C:
//   1. the osz-th smallest ordered score s*, by a radix select of its four
//      8-bit digits, each a 256-bin histogram in shared memory built with
//      integer atomics (one a warp and digit), so the counts, and s*, do
//      not depend on the order of the adds;
//   2. the survivors: every candidate below s*, and of those equal to s*
//      the lowest positions, by a block-wide prefix count in position
//      order, compacted into the osz slots of `drop`;
//   3. their order by (score, position): a rank count over osz^2 (6,400 at
//      osz = 80).
// That is O(4 C + osz^2) a cell where a rank count over all C candidates
// was O(C^2) (1.09e9 comparisons a cell at kk = 256, 44k at kk = 19), and
// it gives the same top[] as any exact sort of the keys (the plain
// version's torch.topk of (ordered score, position)). The Jaccard searches
// then set the time: C kk binary searches a cell (1.4e8 shared-memory steps
// at kk = 256, stride 2), with the candidates' neighbour rows gathered from
// L2, and the distances' d-wide bf16 rows. The gathers (neighbour rows,
// bf16 reps) stay in L2 at 100k cells (NI 7.6 MB, reps 10 MB).
// ---------------------------------------------------------------------------

constexpr int kBwThreads = 256;

// the number of entries of the sorted sx[0, kk) equal to y: the first
// entry not below y, then the run of entries equal to it
__device__ __forceinline__ int count_equal(const int* sx, int kk, int y) {
  int lo = 0, hi = kk;
  while (lo < hi) {  // first >= y
    const int mid = (lo + hi) >> 1;
    if (sx[mid] < y) lo = mid + 1; else hi = mid;
  }
  int run = 0;
  while (lo + run < kk && sx[lo + run] == y) ++run;
  return run;
}

// an unsigned key that orders as ordered(x), so as the score does
__device__ __forceinline__ unsigned score_key(float x) {
  return (unsigned)ordered(x) ^ 0x80000000u;
}

// the kernel's static shared memory, in ints: the radix histogram, the
// per-warp tie counts and four scalars (ops/wnn.py BANDWIDTH_STATIC_SMEM)
constexpr int kBins = 256;
constexpr int kBwWarps = kBwThreads / 32;
constexpr int kBwStatic = kBins + kBwWarps + 4;

// The candidates' tables (ids, scores, distances, the top-osz order) live in
// the block's shared memory, or, when `scratch` is given, in global memory:
// 3 C + 2 osz words per block. C grows as kk^2, so from kk of about 195 (at
// stride 2) the tables and the selection's 1 KB of static shared memory
// pass the 227 KB a block may take; the global variant
// then runs a fixed grid whose blocks walk the cells in turn, each block
// with its own slice of the scratch. The arithmetic and every order are the
// same in both variants. The sorted set and the cell's rep stay in shared
// memory in both (the set is searched kk times per candidate).
__global__ void __launch_bounds__(kBwThreads)
    wnn_bandwidth_kernel(const int* __restrict__ NI,
                         const int* __restrict__ set_sizes,
                         const __nv_bfloat16* __restrict__ rep16,
                         const float* __restrict__ sq, int row0, int rows, int kk,
                         int d, int stride, int n_bw, float n_total, float bbox,
                         int* __restrict__ scratch, float* __restrict__ sigma) {
  extern __shared__ int smem[];
  const int s = (kk + stride - 1) / stride;
  const int C = kk + kk * s;
  const int osz = min(C, 4 * n_bw);
  int* sx = smem;                                   // kk: the cell's set, sorted
  float* q = reinterpret_cast<float*>(sx + kk);     // d: the cell's bf16 rep, as f32
  int* tables = scratch != nullptr
      ? scratch + (int64_t)blockIdx.x * (3 * (int64_t)C + 2 * osz)
      : reinterpret_cast<int*>(q + d);
  int* cand = tables;                 // C
  int* top = cand + C;                // osz: positions, in (score, pos) order
  int* drop = top + osz;              // osz: bad or duplicate
  float* score = reinterpret_cast<float*>(drop + osz);  // C
  float* eucl = score + C;            // C
  __shared__ int sel[kBwStatic];
  int* hist = sel;                               // kBins
  int* warp_ties = hist + kBins;                 // kBwWarps
  int& digit_at = warp_ties[kBwWarps];           // the radix pass's digit
  int& digit_below = warp_ties[kBwWarps + 1];    // keys of the prefix below it
  int& taken = warp_ties[kBwWarps + 2];          // survivors compacted
  int& fallback_bits = warp_ties[kBwWarps + 3];  // the first kk distances' sum

  const int t = threadIdx.x;
  for (int w = blockIdx.x; w < rows; w += gridDim.x) {
    const int i = row0 + w;  // the cell: a row of the whole tables
    const int* nrow = NI + (int64_t)i * kk;
    for (int p = t; p < kk; p += blockDim.x) cand[p] = nrow[p];
    for (int u = t; u < d; u += blockDim.x)
      q[u] = __bfloat162float(rep16[(int64_t)i * d + u]);
    __syncthreads();
    // sx: the set with pads as -2 (they match no neighbour id), rank-sorted
    for (int p = t; p < kk; p += blockDim.x) {
      const int v = cand[p] < 0 ? -2 : cand[p];
      int rank = 0;
      for (int j = 0; j < kk; ++j) {
        const int w = cand[j] < 0 ? -2 : cand[j];
        rank += (w < v) || (w == v && j < p);
      }
      sx[rank] = v;
    }
    // the 2-hop candidates: NI[j, ::stride] of each neighbour j, -1 under a pad
    for (int p = kk + t; p < C; p += blockDim.x) {
      const int j = cand[(p - kk) / s];
      cand[p] = j < 0 ? -1 : NI[(int64_t)j * kk + ((p - kk) % s) * stride];
    }
    __syncthreads();

    const int sx_size = set_sizes[i];
    const float bad_score = __fadd_rn(n_total, 1.f);
    for (int p = t; p < C; p += blockDim.x) {
      const int c = cand[p];
      const int cs = c < 0 ? 0 : c;
      const int* yrow = NI + (int64_t)cs * kk;
      int inter = 0;
      for (int b = 0; b < kk; ++b) {
        const int y = yrow[b];
        if (y >= 0) inter += count_equal(sx, kk, y);
      }
      const int uni = max(sx_size + set_sizes[cs] - inter, 1);
      const float jac = __fsub_rn(1.f, __fdiv_rn((float)inter, (float)uni));
      const __nv_bfloat16* crow = rep16 + (int64_t)cs * d;
      float cross = 0.f;
      for (int u = 0; u < d; ++u) cross = fmaf(q[u], __bfloat162float(crow[u]), cross);
      const float e = sqrtf(fmaxf(
          __fsub_rn(__fadd_rn(sq[i], sq[cs]), __fmul_rn(2.f, cross)), 0.f));
      float sc = __fadd_rn(__fsub_rn(n_total, __fmul_rn(jac, n_total)),
                           __fdiv_rn(__fsub_rn(bbox, e), bbox));
      if (c < 0 || c == i || jac >= 1.f) sc = bad_score;
      score[p] = sc;
      eucl[p] = e;
    }
    __syncthreads();

    // the first osz by (score, position), in three steps (above). `drop`
    // holds the survivors' positions until the walk needs it.
    const int lane = t % 32, warp = t / 32;
    int* surv = drop;
    if (osz < C) {
      unsigned prefix = 0u, known = 0u;  // s*'s digits found so far, and their bits
      int want = osz;                    // s*'s rank among the keys with that prefix
      for (int shift = 24; shift >= 0; shift -= 8) {
        for (int h = t; h < kBins; h += blockDim.x) hist[h] = 0;
        __syncthreads();
        for (int p0 = 0; p0 < C; p0 += blockDim.x) {  // whole warps, for the match
          const int p = p0 + t;
          const unsigned key = p < C ? score_key(score[p]) : 0u;
          const bool in = p < C && (key & known) == prefix;
          const int digit = in ? (int)((key >> shift) & 255u) : kBins;
          const unsigned peers = __match_any_sync(kFull, digit);
          if (in && lane == __ffs(peers) - 1) atomicAdd(&hist[digit], __popc(peers));
        }
        __syncthreads();
        if (warp == 0) {  // the digit where the count of keys reaches want
          int cnt[kBins / 32], sum = 0;
#pragma unroll
          for (int i = 0; i < kBins / 32; ++i) sum += cnt[i] = hist[lane * (kBins / 32) + i];
          int incl = sum;
#pragma unroll
          for (int o = 1; o < 32; o <<= 1) {
            const int v = __shfl_up_sync(kFull, incl, o);
            if (lane >= o) incl += v;
          }
          int below = incl - sum;
          const unsigned hit = __ballot_sync(kFull, below < want && want <= incl);
          if (lane == __ffs(hit) - 1) {
            int i = 0;
            while (below + cnt[i] < want) below += cnt[i++];
            digit_at = lane * (kBins / 32) + i;
            digit_below = below;
          }
        }
        __syncthreads();
        prefix |= (unsigned)digit_at << shift;
        known |= 255u << shift;
        want -= digit_below;
      }
      // prefix is s*: keep every key below it and the `want` lowest
      // positions of the keys equal to it
      if (t == 0) taken = 0;
      int ties_before = 0;  // keys equal to s* at positions of earlier chunks
      for (int p0 = 0; p0 < C; p0 += blockDim.x) {
        const int p = p0 + t;
        const unsigned key = p < C ? score_key(score[p]) : 0u;
        const bool tie = p < C && key == prefix;
        const unsigned ties = __ballot_sync(kFull, tie);
        if (lane == 0) warp_ties[warp] = __popc(ties);
        __syncthreads();
        int rank = ties_before + __popc(ties & ((1u << lane) - 1u));
        for (int v = 0; v < warp; ++v) rank += warp_ties[v];
        for (int v = 0; v < kBwWarps; ++v) ties_before += warp_ties[v];
        if ((p < C && key < prefix) || (tie && rank < want)) surv[atomicAdd(&taken, 1)] = p;
        __syncthreads();  // warp_ties is read before the next chunk writes it
      }
    } else {
      for (int p = t; p < C; p += blockDim.x) surv[p] = p;
    }
    __syncthreads();
    // the survivors in (score, position) order: a rank count, ranks distinct
    for (int i = t; i < osz; i += blockDim.x) {
      const int p = surv[i];
      const unsigned key = score_key(score[p]);
      int rank = 0;
      for (int j = 0; j < osz; ++j) {
        const int q = surv[j];
        const unsigned kq = score_key(score[q]);
        rank += (kq < key) || (kq == key && q < p);
      }
      top[rank] = p;
    }
    __syncthreads();  // top is whole before `drop` is overwritten
    for (int r = t; r < osz; r += blockDim.x) {
      const int c = cand[top[r]];
      bool bad = score[top[r]] >= bad_score;
      for (int j = 0; j < r && !bad; ++j) bad = cand[top[j]] == c;
      drop[r] = bad;
    }
    if (t == 0) {
      float f = 0.f;
      for (int p = 0; p < kk; ++p) f += eucl[p];
      fallback_bits = __float_as_int(f);
    }
    __syncthreads();
    if (t == 0) {
      float sum = 0.f;
      int cnt = 0;
      for (int r = 0; r < osz && cnt < n_bw; ++r) {
        if (drop[r]) continue;
        sum += eucl[top[r]];
        ++cnt;
      }
      sigma[w] = cnt > 0 ? __fdiv_rn(sum, (float)cnt)
                         : __fdiv_rn(__int_as_float(fallback_bits), (float)kk);
    }
    __syncthreads();  // the tables are reused by the block's next cell
  }
}

// ---------------------------------------------------------------------------
// T10: the affinity ratio theta of one modality pair, per row r of rows1:
//   rv    = mean of rep[conv[NI2[rows2[r], j]]] over the neighbours j whose
//           remapped id is valid (mod2-local -> mod1-local, -1 absent),
//   theta = exp(-max(|rep[rows1[r]] - rv| - nnd, 0) / max(sigma - nnd, 1e-12))
// with nnd and sigma of the mod1 row. One warp per row; lane u holds
// dimensions u, u + 32, ...; the remapped ids are read 32 at a time, one
// per lane, and broadcast by shuffles. Bound by the gather of kk f32 rows
// per row (100k x 19 x 200 B = 380 MB at the e2e's size, mostly from L2).
// ---------------------------------------------------------------------------

constexpr int kThetaThreads = 256;

__global__ void __launch_bounds__(kThetaThreads)
    wnn_theta_kernel(const float* __restrict__ rep, const int* __restrict__ rows1,
                     const int* __restrict__ rows2, const int* __restrict__ NI2,
                     const int* __restrict__ conv, const float* __restrict__ nnd,
                     const float* __restrict__ sigma, int m, int d, int kk,
                     float* __restrict__ theta) {
  const int r = (int)(((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5);
  const int lane = threadIdx.x & 31;
  if (r >= m) return;  // whole warps leave together
  const int i1 = rows1[r];
  const int* nb = NI2 + (int64_t)rows2[r] * kk;
  const float* qrow = rep + (int64_t)i1 * d;

  int cnt = 0;
  for (int j0 = 0; j0 < kk; j0 += 32) {
    const int j = j0 + lane;
    int mp = -1;
    if (j < kk && nb[j] >= 0) mp = conv[nb[j]];
    cnt += __popc(__ballot_sync(kFull, mp >= 0));
  }
  const float wsum = fmaxf((float)cnt, 1.f);

  float part = 0.f;
  for (int u0 = 0; u0 < d; u0 += 32) {
    const int u = u0 + lane;
    float acc = 0.f;
    for (int j0 = 0; j0 < kk; j0 += 32) {
      const int j = j0 + lane;
      int mp = -1;
      if (j < kk && nb[j] >= 0) mp = conv[nb[j]];
      const int lim = min(32, kk - j0);
      for (int l = 0; l < lim; ++l) {
        const int mt = __shfl_sync(kFull, mp, l);
        if (mt >= 0 && u < d) acc = __fadd_rn(acc, rep[(int64_t)mt * d + u]);
      }
    }
    if (u < d) {
      const float diff = __fsub_rn(qrow[u], __fdiv_rn(acc, wsum));
      part = __fadd_rn(part, __fmul_rn(diff, diff));
    }
  }
  for (int off = 16; off > 0; off >>= 1) part += __shfl_xor_sync(kFull, part, off);
  if (lane == 0) {
    const float dist = sqrtf(fmaxf(part, 0.f));
    const float nd = nnd[i1];
    theta[r] = expf(__fdiv_rn(-fmaxf(__fsub_rn(dist, nd), 0.f),
                              fmaxf(__fsub_rn(sigma[i1], nd), 1e-12f)));
  }
}

// ---------------------------------------------------------------------------
// T11: the fused WNN score of every candidate of every cell,
//   out[i, p] = sum_m w_m[i] exp(-dist_m(i, c) / max(sigma_m[i], 1e-12))
//                     * present_m[i] * present_m[c]      (c = cand[i, p] >= 0)
// over the modality slices [offs[m], offs[m+1]) of one concatenated bf16
// table, with dist_m = sqrt(max(|x|^2_i + |x|^2_c - 2 cross, 0)), or
// 1 - cross for cosine (unit rows, norms 1); out is 0 where c < 0.
// aux = [|x|^2_m | present_m] and sigw = [sigma_m | w_m], (n, 2M) each.
//
// One warp per cell, its candidates in tiles of 32, a lane each. The first
// design had each lane walk its own candidate's row two bytes at a time, so
// every load instruction of the warp touched 32 rows and each 32-byte sector
// brought 2 useful bytes (28 ms at 100,000 cells x 600 candidates, D = 130).
// Here the warp first stages the tile's rows into shared memory with
// cp.async: a row is cut into 16-byte pieces (the table's row stride `ld` is
// a multiple of 8 bf16: ops/wnn.py padded_table), consecutive lanes take
// consecutive pieces of a row, so every load moves whole sectors. A row
// goes in chunks of at most `chunk` pieces, and a tile's aux rows go with
// its first chunk. Two buffers: the next chunk's gather is in flight while
// the lanes run the current one, and the candidate ids are loaded two tiles
// ahead. Each lane then runs its candidate's chains out of shared memory in
// the first design's order (per slice an fmaf chain from +0 in column order,
// then the same __f*_rn operations, sqrtf and expf), so every score is that
// kernel's bits. A lane reads its row 16 bytes at a time and a staged row
// takes an odd number of 16-byte units, so the 8 lanes of a quarter warp
// hit distinct banks; an aux row takes an odd number of words. A tile of -1
// candidates (cand_dedup puts them last) gathers nothing and writes its
// zeros. What sets the time (exp_t11_variants.py, an H100): the staging
// alone takes 4.3-5.2 ms at 100,000 x 600 (2.9-3.5 TB/s of candidate rows
// from L2) and the chains alone 6.1; together, overlapped, 5.6-5.8, at any
// of 8-28 warps an SM. Two candidates a lane (their chains interleaved, the
// cell's row loads shared), a deeper ring of units, and the rows copied by
// the TMA unit (cp.async.bulk, a row a lane) each ran as fast or slower.
// Bound: the gather of the candidates' rows from L2 (the table, 26 MB at
// 100,000 x 130, stays there): 15.6 GB at 100,000 x 600 x 260 bytes, where
// the inputs read once are 0.5 GB; the cross terms are 2 C D float32
// operations a cell (0.23 ms at that size).
// ---------------------------------------------------------------------------

constexpr int kFusionPer = 1;                  // candidates a lane
constexpr int kFusionTile = 32 * kFusionPer;   // candidates a tile
constexpr int kFusionMaxWarps = 8;             // warps (cells) a block at most

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// the two bf16 values of a 32-bit word (low half first) as float32
__device__ __forceinline__ float bf16_lo(unsigned w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(unsigned w) { return __uint_as_float(w & 0xffff0000u); }

// a warp's shared memory (ops/wnn.py _fusion_warp_bytes mirrors it): two
// buffers of a unit's staged rows, the cell's row as float32, two buffers of
// a tile's aux rows, the cell's aux and sigw rows and the slice bounds
struct FusionShape {
  int pieces;  // 16-byte pieces of a row: ceil(D / 8)
  int kc;      // pieces a chunk
  int nch;     // chunks a row
  int srow;    // a staged row's 16-byte units: kc, made odd
  int arow;    // a staged aux row's words: 2M, made odd
  __host__ __device__ FusionShape(int D, int M, int chunk) {
    pieces = (D + 7) / 8;
    kc = pieces < chunk ? pieces : chunk;
    if (kc < 1) kc = 1;
    nch = pieces > 0 ? (pieces + kc - 1) / kc : 1;
    srow = kc | 1;
    arow = (2 * M) | 1;
  }
  __host__ __device__ int warp_bytes(int M) const {
    const int b = 2 * kFusionTile * srow * 16 + 4 * 8 * pieces + 2 * kFusionTile * arow * 4 +
                  4 * (5 * M + 1);
    return (b + 15) / 16 * 16;
  }
};

// slice mm's term of a candidate's score, its cross term whole: the first
// design's operations in its order
__device__ __forceinline__ float fusion_term(float cross, int mm, int M, int cosine,
                                             const float* aq, const float* ac,
                                             const float* sw) {
  const float dist =
      cosine ? __fsub_rn(1.f, cross)
             : sqrtf(fmaxf(__fsub_rn(__fadd_rn(aq[mm], ac[mm]), __fmul_rn(2.f, cross)), 0.f));
  const float pres = __fmul_rn(ac[M + mm], aq[M + mm]);
  const float sig = fmaxf(sw[mm], 1e-12f);
  const float contrib = __fmul_rn(expf(__fdiv_rn(-dist, sig)), sw[M + mm]);
  return __fmul_rn(contrib, pres);
}

// the lane's candidates of tile t (-1 past the row's end)
__device__ __forceinline__ void fusion_ids(int (&c)[kFusionPer], const int* __restrict__ crow,
                                           int t, int C, int lane) {
#pragma unroll
  for (int h = 0; h < kFusionPer; ++h) {
    const int p = t * kFusionTile + 32 * h + lane;
    c[h] = p < C ? crow[p] : -1;
  }
}

// unit v = (tile t, chunk j): chunk j of tile t's rows into row buffer v & 1
// and, with its first chunk, the tile's aux rows into aux buffer t & 1. Row
// r of the tile holds lane r % 32's candidate c[r / 32]. Piece f of the unit
// is piece k of row r, f = r kn + k; lane l copies f = l, l + 32, ...
__device__ __forceinline__ void fusion_stage(const int (&c)[kFusionPer], int v, int lane,
                                             const FusionShape& sh, int A,
                                             const __nv_bfloat16* __restrict__ cat16, int ld,
                                             const float* __restrict__ aux, uint4* rbuf,
                                             float* abuf) {
  const int t = v / sh.nch, j = v - t * sh.nch;
  bool any = false;
#pragma unroll
  for (int h = 0; h < kFusionPer; ++h) any |= c[h] >= 0;
  if (__any_sync(kFull, any)) {
    uint4* dst = rbuf + (v & 1) * kFusionTile * sh.srow;
    const int k0 = j * sh.kc;
    const int kn = min(sh.kc, sh.pieces - k0);
    if (kn > 0) {
      const int dr = 32 / kn, dk = 32 % kn;
      int r = lane / kn, k = lane % kn;
      for (int f = lane; f < kFusionTile * kn; f += 32) {
        int cr = -1;
#pragma unroll
        for (int h = 0; h < kFusionPer; ++h) {
          const int x = __shfl_sync(kFull, c[h], r & 31);
          if ((r >> 5) == h) cr = x;
        }
        if (cr >= 0) cp_async16(dst + r * sh.srow + k, cat16 + (int64_t)cr * ld + 8 * (k0 + k));
        r += dr;
        k += dk;
        if (k >= kn) { k -= kn; ++r; }
      }
    }
    if (j == 0 && A > 0) {
      float* adst = abuf + (t & 1) * kFusionTile * sh.arow;
      const int dr = 32 / A, dk = 32 % A;
      int r = lane / A, k = lane % A;
      for (int f = lane; f < kFusionTile * A; f += 32) {
        int cr = -1;
#pragma unroll
        for (int h = 0; h < kFusionPer; ++h) {
          const int x = __shfl_sync(kFull, c[h], r & 31);
          if ((r >> 5) == h) cr = x;
        }
        if (cr >= 0) cp_async4(adst + r * sh.arow + k, aux + (int64_t)cr * A + k);
        r += dr;
        k += dk;
        if (k >= A) { k -= A; ++r; }
      }
    }
  }
  cp_async_commit();
}

__global__ void __launch_bounds__(kFusionMaxWarps * 32)
    wnn_fusion_kernel(const int* __restrict__ cand,
                      const __nv_bfloat16* __restrict__ cat16, int ld,
                      const float* __restrict__ aux,
                      const float* __restrict__ sigw,
                      const int* __restrict__ offs, int row0, int rows, int C,
                      int D, int M, int cosine, int chunk, float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char fsm[];
  const FusionShape sh(D, M, chunk);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int w = blockIdx.x * (blockDim.x >> 5) + warp;  // the window's row
  if (w >= rows) return;  // no block-wide barrier below
  const int i = row0 + w;  // the cell: a row of the whole tables
  const int A = 2 * M;
  unsigned char* base = fsm + (size_t)warp * sh.warp_bytes(M);
  uint4* rbuf = reinterpret_cast<uint4*>(base);                           // 2 x tile x srow
  float* q = reinterpret_cast<float*>(rbuf + 2 * kFusionTile * sh.srow);  // 8 pieces
  float* abuf = q + 8 * sh.pieces;                                        // 2 x tile x arow
  float* aq = abuf + 2 * kFusionTile * sh.arow;                           // 2M: the cell's aux
  float* sw = aq + A;                                                     // 2M: its sigw
  int* bounds = reinterpret_cast<int*>(sw + A);                           // M + 1: offs
  const int* crow = cand + (int64_t)w * C;
  const int tiles = (C + kFusionTile - 1) / kFusionTile;
  const int units = tiles * sh.nch;  // (tile, chunk)

  // the candidate ids run two tiles ahead of the tile computed: cid its ids,
  // sid the next tile's, pid the one after's (their loads in flight)
  int cid[kFusionPer], sid[kFusionPer], pid[kFusionPer];
  fusion_ids(cid, crow, 0, C, lane);
  fusion_ids(sid, crow, 1, C, lane);
  fusion_ids(pid, crow, 2, C, lane);
  for (int u = lane; u < 8 * sh.pieces; u += 32)
    q[u] = u < D ? __bfloat162float(cat16[(int64_t)i * ld + u]) : 0.f;
  for (int u = lane; u < A; u += 32) {
    aq[u] = aux[(int64_t)i * A + u];
    sw[u] = sigw[(int64_t)i * A + u];
  }
  for (int u = lane; u <= M; u += 32) bounds[u] = offs[u];
  fusion_stage(cid, 0, lane, sh, A, cat16, ld, aux, rbuf, abuf);
  __syncwarp();  // q and the constants are whole
  int mm = 0, end = -1;
  float total[kFusionPer], cross[kFusionPer];
  for (int v = 0; v < units; ++v) {
    const int t = v / sh.nch, j = v - t * sh.nch;
    const bool last = j == sh.nch - 1;  // the tile's last chunk
    if (v + 1 < units) {
      int nid[kFusionPer];  // the ids of unit v + 1's tile
#pragma unroll
      for (int h = 0; h < kFusionPer; ++h) nid[h] = last ? sid[h] : cid[h];
      fusion_stage(nid, v + 1, lane, sh, A, cat16, ld, aux, rbuf, abuf);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncwarp();  // unit v has landed for every lane
    if (j == 0) {
      mm = 0;
      end = M > 0 ? bounds[1] : -1;
#pragma unroll
      for (int h = 0; h < kFusionPer; ++h) total[h] = cross[h] = 0.f;
    }
    bool any = false;
#pragma unroll
    for (int h = 0; h < kFusionPer; ++h) any |= cid[h] >= 0;
    if (any) {
      const uint4* row = rbuf + (v & 1) * kFusionTile * sh.srow + lane * sh.srow;
      const float* ac = abuf + (t & 1) * kFusionTile * sh.arow + lane * sh.arow;
      const int k0 = j * sh.kc;
      const int kn = min(sh.kc, sh.pieces - k0);
      for (int k = 0; k < kn; ++k) {
        const int u0 = 8 * (k0 + k);
        if (end >= u0 + 8) {  // no slice ends inside this piece
          const float4 qa = *reinterpret_cast<const float4*>(q + u0);
          const float4 qb = *reinterpret_cast<const float4*>(q + u0 + 4);
#pragma unroll
          for (int h = 0; h < kFusionPer; ++h) {
            const uint4 raw = row[h * 32 * sh.srow + k];
            float x = cross[h];
            x = fmaf(qa.x, bf16_lo(raw.x), x);
            x = fmaf(qa.y, bf16_hi(raw.x), x);
            x = fmaf(qa.z, bf16_lo(raw.y), x);
            x = fmaf(qa.w, bf16_hi(raw.y), x);
            x = fmaf(qb.x, bf16_lo(raw.z), x);
            x = fmaf(qb.y, bf16_hi(raw.z), x);
            x = fmaf(qb.z, bf16_lo(raw.w), x);
            x = fmaf(qb.w, bf16_hi(raw.w), x);
            cross[h] = x;
          }
        } else {  // a slice ends before some of these columns
#pragma unroll 1
          for (int e = 0; e < 8; ++e) {
            const int u = u0 + e;
            while (mm < M && u == end) {
#pragma unroll
              for (int h = 0; h < kFusionPer; ++h) {
                total[h] = __fadd_rn(total[h], fusion_term(cross[h], mm, M, cosine, aq,
                                                           ac + h * 32 * sh.arow, sw));
                cross[h] = 0.f;
              }
              ++mm;
              end = mm < M ? bounds[mm + 1] : -1;
            }
            if (u < D) {
#pragma unroll
              for (int h = 0; h < kFusionPer; ++h) {
                const unsigned short b =
                    reinterpret_cast<const unsigned short*>(row + h * 32 * sh.srow + k)[e];
                cross[h] = fmaf(q[u], __uint_as_float((unsigned)b << 16), cross[h]);
              }
            }
          }
        }
      }
      if (last) {
        while (mm < M) {
#pragma unroll
          for (int h = 0; h < kFusionPer; ++h) {
            total[h] = __fadd_rn(total[h], fusion_term(cross[h], mm, M, cosine, aq,
                                                       ac + h * 32 * sh.arow, sw));
            cross[h] = 0.f;
          }
          ++mm;
        }
      }
    }
    if (last) {
#pragma unroll
      for (int h = 0; h < kFusionPer; ++h) {
        const int p = t * kFusionTile + 32 * h + lane;
        if (p < C) out[(int64_t)w * C + p] = cid[h] >= 0 ? total[h] : 0.f;
        cid[h] = sid[h];
        sid[h] = pid[h];
      }
      fusion_ids(pid, crow, t + 3, C, lane);
    }
    __syncwarp();  // buffer v & 1 is read before unit v + 2 lands there
  }
}

}  // namespace

extern "C" {

// T9. NI (n x kk) int32, pad -1; set_sizes (n,) int32 = valid entries per
// row; rep16 (n x d) bf16; sq (n,) f32 squared norms of the unrounded rep;
// the cells are the window [row0, row0 + rows) of those whole tables (a
// rank's rows; the single-device path passes 0, n); scratch null (the
// candidates' tables in shared memory, a block per cell) or
// (scratch_blocks x (3 C + 2 osz)) int32 in global memory, for a grid of
// min(rows, scratch_blocks) blocks; sigma (rows,) f32 out, the window's.
int mt_wnn_bandwidth(const int* NI, const int* set_sizes, const void* rep16,
                     const float* sq, int n, int row0, int rows, int kk, int d,
                     int stride, int n_bw, float n_total, float bbox,
                     int* scratch, int scratch_blocks, float* sigma,
                     void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (row0 < 0 || rows < 0 || row0 > n - rows) return (int)cudaErrorInvalidValue;
  if (rows > 0 && kk > 0) {
    const int s = (kk + stride - 1) / stride;
    const int64_t C = kk + (int64_t)kk * s;
    const int64_t osz = C < 4 * (int64_t)n_bw ? C : 4 * (int64_t)n_bw;
    size_t bytes = sizeof(int) * kk + sizeof(float) * d;
    int blocks = rows;
    if (scratch == nullptr) {
      bytes += sizeof(int) * (C + 2 * osz) + sizeof(float) * 2 * C;
    } else {
      if (scratch_blocks < 1) return (int)cudaErrorInvalidValue;
      blocks = rows < scratch_blocks ? rows : scratch_blocks;
    }
    cudaError_t e = cudaFuncSetAttribute(
        wnn_bandwidth_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
    wnn_bandwidth_kernel<<<blocks, kBwThreads, bytes, st>>>(
        NI, set_sizes, reinterpret_cast<const __nv_bfloat16*>(rep16), sq, row0, rows,
        kk, d, stride, n_bw, n_total, bbox, scratch, sigma);
  }
  return (int)cudaGetLastError();
}

// T10. rep (n1 x d) f32; rows1, rows2 (m,) int32; NI2 (n2 x kk) int32;
// conv (n2,) int32 mod2-local -> mod1-local or -1; nnd, sigma (n1,) f32;
// theta (m,) f32 out.
int mt_wnn_theta(const float* rep, const int* rows1, const int* rows2,
                 const int* NI2, const int* conv, const float* nnd,
                 const float* sigma, int m, int d, int kk, float* theta,
                 void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (m > 0) {
    const int64_t threads = (int64_t)m * 32;
    const int blocks = (int)((threads + kThetaThreads - 1) / kThetaThreads);
    wnn_theta_kernel<<<blocks, kThetaThreads, 0, st>>>(
        rep, rows1, rows2, NI2, conv, nnd, sigma, m, d, kk, theta);
  }
  return (int)cudaGetLastError();
}

// T11. cat16 (n x D) bf16 with row stride ld (a multiple of 8, the
// pointer 16-byte aligned, and ceil(D / 8) * 8 <= ld: the columns past D are
// read and never used); aux, sigw (n x 2M) f32: the whole tables; the cells
// are the window [row0, row0 + rows) of them, cand (rows x C) int32 their
// candidates (global ids, -1 absent); offs (M+1,) int32 slice bounds; warps
// cells a block (1 to 8); chunk 16-byte pieces a staged chunk of a row (>=
// 1); out (rows x C) f32. The single-device path passes 0, n.
int mt_wnn_fusion_scores(const int* cand, const void* cat16, int ld, const float* aux,
                         const float* sigw, const int* offs, int n, int row0, int rows,
                         int C, int D, int M, int cosine, int warps, int chunk, float* out,
                         void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (row0 < 0 || rows < 0 || row0 > n - rows) return (int)cudaErrorInvalidValue;
  if (warps < 1 || warps > kFusionMaxWarps || chunk < 1 || M < 1 || D < 0 || ld % 8 != 0 ||
      ld < (D + 7) / 8 * 8 || ((uintptr_t)cat16 & 15u) != 0)
    return (int)cudaErrorInvalidValue;
  if (rows > 0 && C > 0) {
    const size_t bytes = (size_t)warps * FusionShape(D, M, chunk).warp_bytes(M);
    cudaError_t e = cudaFuncSetAttribute(
        wnn_fusion_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
    wnn_fusion_kernel<<<(rows + warps - 1) / warps, warps * 32, bytes, st>>>(
        cand, reinterpret_cast<const __nv_bfloat16*>(cat16), ld, aux, sigw, offs, row0,
        rows, C, D, M, cosine, chunk, out);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
