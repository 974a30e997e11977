// PWM motif scan, for Hopper (sm_90a).
//
//   T36 pwm_scan  <- muon_tpu/ops/pwm.py _conv_fn (:114), and the comparison
//                    with each motif's threshold in find_hits (:166)
//
// A window's score under a motif of width w is the float32 sum, in column
// order j = 0..w-1 from 0.f and with plain adds, of lo[off + j][code[pos +
// j]] (the chain). The reference forms the same w terms as a one-hot
// convolution (the other three products of a column are exact zeros),
// perhaps in another order. A window with a code of 4 (not ACGT, or
// padding) is no hit and scores -inf, as the reference's mask convolution
// makes it.
//
// Operands: the sequences as uint8 codes (n x L, row-major); every motif's
// log-odds packed as float32 rows of 4 (A, C, G, T), motif m at rows
// off[m] .. off[m] + width[m] - 1; one float32 threshold per motif (the
// least float32 not below the float64 threshold, so `score >= t` admits
// the reference's hits exactly).
//
// Modes:
//   0 count:  counts[s * M + m] += the hits of the pair (s, m) (counts
//             zeroed by the caller);
//   1 write:  the hits, written from cursor[s * M + m] on (the exclusive
//             scan of counts in (sequence, motif) order, so the hits come
//             out in the reference's lexsorted order with no sort; each
//             cursor is left at its pair's end);
//   2 scores: scores[(s * P + p) * M + m] for every window, -inf where
//             invalid (all M motifs of one width; a launch writes its own
//             motifs' columns).
//
// Count and write: a screen on the tensor cores, decided by the chain.
// The score of 16 windows under 8 motifs is a product: A (16 x 16) holds
// the one-hot of 4 consecutive positions x 4 bases of each window, exactly
// 0 or 1 (a code of 4 a zero row), B (16 x 8) the log-odds of 4 columns of
// each motif rounded to fp16, and mma.sync.m16n8k16 (fp16 operands,
// float32 sums) adds them up, one k-step per 4 columns. The host packs B
// once per motif set (ops/pwm.pack_screen): motifs sorted by width in
// groups of 16 (two n8 tiles), each padded with zero columns to its
// group's widest, rounded up to 4, every lane's two fragments in place (16
// bytes a lane and k-step: JASPAR's 746 motifs are 47 groups, 160 k-steps,
// 80 KiB). A window is a candidate when its screened score reaches the
// motif's bar, thr minus a margin proven on the host
// (ops/pwm.screen_margins), and it lies in the sequence and holds no code
// of 4; a candidate is rescored by the chain, which alone decides: every
// hit, its score and every count are the scores mode's bits. The margin
// bounds |screen - chain| for any window of the motif (w columns, k-steps S
// of its group):
//   - fp16: the screen sums lo16 = fp16(lo); per column at most e_j =
//     max_b |lo_j,b - lo16_j,b|, so |sum lo16 - sum lo| <= E = sum_j e_j;
//   - tensor cores: the products of 0/1 with fp16 are exact; each k-step's
//     d = c + sum of 16 products is assumed to land within 2^-20 of its
//     running magnitude, which is at most M16 = sum_j max_b |lo16_j,b|
//     (a window takes one entry a column), so at most S 2^-20 M16 in all;
//   - the chain: w - 1 float32 adds (the first, onto 0, is exact), each
//     within 2^-24 of a result bounded by M32 = sum_j max_b |lo_j,b| (to
//     first order; 2^-23 leaves room), so at most (w - 1) 2^-23 M32.
// The margin is their sum, in float64 from the packed float32 rows and
// raised by 2^-20 of itself for the float64 sums' own rounding; the bar is
// thr - margin, lowered by 2^-50 of itself and rounded down to float32. So
// a window whose chain reaches thr screens at or above the bar: the screen
// never decides, and never loses a hit. On JASPAR at p = 1e-4 the margins
// run 0.002-0.070 and the candidates are 1.04 times the hits on uniform
// sequences, so one fp16 term serves (no hi/lo split).
//
// Work of the screen: a block of 16 warps on each SM stages the fragments
// and the motif tables of its launch in shared memory; a warp takes a
// whole sequence (so it alone counts or writes that sequence's pairs, with
// no atomics), a strip of 32 windows (2 m16 tiles) at a time. The tiles' A
// fragments overlap: tile t at k-step s is k-step s + 4 t of tile 0, and a
// fragment's rows 8-15 are its rows 0-7 two k-steps on, so 2 x 14
// registers of fp16 pairs built once a strip from the codes serve every
// group of motifs up to 32 columns (wider groups build theirs from the
// codes as they go). Per group a lane loads one 16-byte pair of B
// fragments a k-step for 4 independent mma, in a loop of the group's own
// k-steps (a switch, so no mma is issued predicated off); the epilogue
// takes the largest of its scores per motif against the bar, and only when
// a lane of the warp finds one does it queue the group's candidates in
// shared memory (position order within each motif, by ballots; a window
// with a code of 4 or past the end is dropped by a ballot mask of the
// strip's invalid positions: a run of N scores 0 on the screen, above the
// bar of JASPAR's 32 motifs whose threshold at p = 1e-4 is not positive).
// At the end of the sequence (or when the queue fills) the lanes rescore
// the candidates 32 at a time, 8 columns' loads in flight, from the codes
// and the float32 rows in global memory (the hits ranked within their pair
// by match_any). The count pass marks, per sequence, the (group, strip)
// units in which it found a hit (32 words of bits; a whole group a bit
// where the units would not fit), and the write pass screens only those:
// the same screen and the same decisions there, so the same hits. Measured
// on an H100 (exp_t36_variants.py): 16 warps of 2 tiles beat 12 warps of 2
// or 4 tiles and 16 of 1; groups of 16 beat groups of 8 (one 8-byte load
// for 4 mma), deciding a sequence's candidates together beat deciding a
// strip's. Bound: at 100,000 x 500 bp x 746 motifs the chain would be
// 4.4e11 float32 adds; the screen is 1.0e9 mma (4.2e12 flops, padding
// included, 4.2 ms at the fp16 dense rate) and the decisions about 1.1e-4
// of the windows.
//
// Scores mode: the parent kernel's loop, kept bit for bit as the card
// tests' ground truth for the screen. A warp per (sequence, motif) pair,
// its lanes over consecutive positions (kWin windows a lane, 32 positions
// apart, summed side by side so that their loads overlap), the motifs'
// float32 rows in shared memory (JASPAR's 8,983 rows, 140 KiB, under the
// 227 KB a block may opt into; the wrapper cuts a larger set into chunks
// that fit, one launch each). Blocks of 32 warps walk the pairs with a
// grid stride, consecutive warps on consecutive motifs of one sequence.
//
// Interface: plain C functions (loaded with ctypes), as in
// sparse_kernels.cu. Each launches on the stream it is given, allocates
// nothing, and returns cudaGetLastError(). Outputs are allocated by the
// caller.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kInvalid = 4;

// scores mode
constexpr int kThreads = 1024;  // 32 warps a block
constexpr int kWin = 4;         // windows a lane keeps in flight

// screen
constexpr int kSWarps = 16;  // warps a block, one block an SM
constexpr int kSThreads = kSWarps * kWarp;
constexpr int kNTiles = 2;     // n8 tiles of motifs a group: 8 motifs each
constexpr int kGroup = 8 * kNTiles;  // motifs a group
static_assert(kNTiles == 2, "a k-step's 16-byte load holds the B fragments of two n8 tiles");
constexpr int kTiles = 2;      // m16 tiles of windows a warp carries
constexpr int kStrip = 16 * kTiles;
constexpr int kRegSteps = 8;   // k-steps served from registers: groups up to 32 columns
constexpr int kHalves = 4 * (kTiles - 1) + kRegSteps + 2;
constexpr int kBadWords = (kStrip + 64 + 31) / 32;  // a strip's invalid positions, 64 past it
constexpr int kQueue = 256;    // candidates a warp holds before it decides them
constexpr int kPosBits = 20;   // a queued candidate's position past the queue's base
constexpr int kSlotTables = 5;  // ints a slot: bar, width, motif, first row, threshold
constexpr int kMaxGroups = 256;  // groups a launch (ops/pwm.py)
constexpr int kUnitWords = 32;   // a sequence's bits of (group, strip) units with a hit
static_assert(kMaxGroups <= kUnitWords * 32, "every group has a unit bit of its own");
constexpr unsigned kOne = 0x3C00u;  // fp16 1.0

__global__ void __launch_bounds__(kThreads)
pwm_scores_kernel(const uint8_t* __restrict__ codes, int n, int L, const float* __restrict__ lo,
                  const int* __restrict__ off, const int* __restrict__ width, int n_motifs,
                  int m0, int m1, int row0, int rows, float* __restrict__ scores, int P_out) {
  extern __shared__ float4 lo_rows[];
  const float* lo_s = reinterpret_cast<const float*>(lo_rows);
  const float4* lo4 = reinterpret_cast<const float4*>(lo) + row0;
  for (int i = threadIdx.x; i < rows; i += blockDim.x) lo_rows[i] = lo4[i];
  __syncthreads();

  const int lane = threadIdx.x % kWarp;
  const int mc = m1 - m0;
  const long long n_tasks = (long long)n * mc;
  const long long warps = (long long)gridDim.x * (kThreads / kWarp);
  for (long long task = (long long)blockIdx.x * (kThreads / kWarp) + threadIdx.x / kWarp;
       task < n_tasks; task += warps) {
    const int s = (int)(task / mc);
    const int m = m0 + (int)(task % mc);
    const int w = width[m];
    const int o = off[m] - row0;
    const uint8_t* cs = codes + (long long)s * L;
    const int P = L - w + 1;  // may be <= 0: no window
    for (int p0 = 0; p0 < P; p0 += kWarp * kWin) {
      // kWin windows a lane, kWarp apart: independent sums in flight. A
      // window past the end reads the last window's bytes (in bounds) and
      // is masked after; a code of 4 marks the window bad and reads the
      // column's A entry, so the loop has no branch
      int at_p[kWin];
      float score[kWin];
      bool bad[kWin];
#pragma unroll
      for (int k = 0; k < kWin; ++k) {
        at_p[k] = min(p0 + k * kWarp + lane, P - 1);
        score[k] = 0.f;
        bad[k] = p0 + k * kWarp + lane >= P;
      }
      for (int j = 0; j < w; ++j) {
        const float* col = lo_s + (o + j) * 4;
#pragma unroll
        for (int k = 0; k < kWin; ++k) {
          const int c = __ldg(cs + at_p[k] + j);
          bad[k] |= c >= kInvalid;
          score[k] = __fadd_rn(score[k], col[c & 3]);
        }
      }
#pragma unroll
      for (int k = 0; k < kWin; ++k) {
        const int p = p0 + k * kWarp + lane;
        if (p < P)
          scores[((long long)s * P_out + p) * n_motifs + m] = bad[k] ? -INFINITY : score[k];
      }
    }
  }
}

// the fp16 pair (bases b0 low, b0 + 1 high) of the one-hot row of code c
__device__ __forceinline__ unsigned onehot_pair(int c, int b0) {
  const unsigned d = (unsigned)(c - b0);
  return d < 2u ? kOne << (16 * d) : 0u;
}

__device__ __forceinline__ int code_at(const uint8_t* cs, int L, int pos) {
  return pos < L ? (int)__ldg(cs + pos) : kInvalid;
}

// Whether the window at offset 32 k + sh (sh < 32) of a strip, w columns
// wide, may be valid: none of its positions invalid in the strip's mask
// (bit i of bad[i / 32]: position p0 + i holds a code of 4 or lies past L)
// where w <= 64; a wider window need only end inside the sequence (left is
// L - p0), the chain deciding the rest. The callers' k is a constant once
// their loops are unrolled, so bad stays in registers.
__device__ __forceinline__ bool window_valid(const unsigned (&bad)[kBadWords], int k, int sh,
                                             int w, int left) {
  if (w > 64) return 32 * k + sh + w <= left;
  unsigned long long seg = (bad[k] | (unsigned long long)bad[k + 1] << 32) >> sh;
  if (sh) seg |= (unsigned long long)bad[k + 2] << (64 - sh);
  const unsigned long long span = w == 64 ? ~0ull : (1ull << w) - 1ull;
  return (seg & span) == 0ull;
}

// c += a b: a 16 x 16 (row), b 16 x 8 (col), fp16 products, f32 sums
__device__ __forceinline__ void mma_f16(float (&c)[4], unsigned a0, unsigned a1, unsigned a2,
                                        unsigned a3, unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// The first S k-steps of a group for the warp's kTiles tiles: per k-step one
// 16-byte load of the lane's B fragments of the group's two n8 tiles, and
// 2 kTiles mma on the A fragments in registers (k-step q of tile 0 is
// {h0[q], h0[q + 2], h2[q], h2[q + 2]}; tile t at k-step s is k-step s + 4 t
// of tile 0)
template <int S>
__device__ __forceinline__ void screen_steps(float (&acc)[kNTiles][kTiles][4], const uint4* fb,
                                             const unsigned (&h0)[kHalves],
                                             const unsigned (&h2)[kHalves]) {
  static_assert(S <= kRegSteps, "the A fragments in registers serve kRegSteps k-steps");
#pragma unroll
  for (int st = 0; st < S; ++st) {
    const uint4 b = fb[st * kWarp];
#pragma unroll
    for (int t = 0; t < kTiles; ++t) {
      const int q = st + 4 * t;
      mma_f16(acc[0][t], h0[q], h0[q + 2], h2[q], h2[q + 2], b.x, b.y);
      mma_f16(acc[1][t], h0[q], h0[q + 2], h2[q], h2[q + 2], b.z, b.w);
    }
  }
}

// The queued candidates of sequence s (entries slot << kPosBits |
// position - p_base), 32 at a time, a lane each: the chain decides, and the
// hits are counted (mode 0) or written at their pair's cursor in queue
// order (mode 1), which is position order within each motif. The chain
// loads 8 columns' codes, then their 8 log-odds, then adds them in order.
// Slot tables in shared memory: m_s the motif, w_s its width, o_s its first
// row of lo, t_s its threshold.
template <int kMode>
__device__ __noinline__ void decide(const unsigned* queue, int qn, int lane, long long s,
                                    int p_base, const uint8_t* cs, const float* lo,
                                    int n_motifs, const int* m_s, const int* w_s,
                                    const int* o_s, const float* t_s, int* counts,
                                    long long* cursor, int* hit_seq, int* hit_motif,
                                    int* hit_pos, float* hit_score,
                                    unsigned long long* candidates, unsigned* unit_row,
                                    int unit_strips) {
  __syncwarp();  // the queue's entries are written
  if (kMode == 0 && candidates != nullptr && lane == 0)
    atomicAdd(candidates, (unsigned long long)qn);
  for (int i0 = 0; i0 < qn; i0 += kWarp) {
    const int i = i0 + lane;
    bool hit = false;
    int m = -1, p = 0;
    float score = 0.f;
    if (i < qn) {
      const unsigned e = queue[i];
      const int slot = (int)(e >> kPosBits);
      p = p_base + (int)(e & ((1u << kPosBits) - 1u));
      m = m_s[slot];
      const int w = w_s[slot];
      const float* rows = lo + 4LL * o_s[slot];
      bool bad = false;
      for (int j0 = 0; j0 < w; j0 += 8) {  // the scores mode's chain
        int c[8];
        float v[8];
#pragma unroll
        for (int k = 0; k < 8; ++k) c[k] = j0 + k < w ? (int)__ldg(cs + p + j0 + k) : 0;
#pragma unroll
        for (int k = 0; k < 8; ++k) v[k] = j0 + k < w ? __ldg(rows + 4 * (j0 + k) + (c[k] & 3)) : 0.f;
#pragma unroll
        for (int k = 0; k < 8; ++k)
          if (j0 + k < w) {
            bad |= c[k] >= kInvalid;
            score = __fadd_rn(score, v[k]);
          }
      }
      hit = !bad && score >= t_s[slot];
    }
    const unsigned hits = __ballot_sync(kFull, hit);
    if (hits == 0u) continue;
    const unsigned mine = __match_any_sync(kFull, hit ? m : -1) & hits;
    const long long pair = s * n_motifs + m;
    const bool leader = hit && lane == __ffs(mine) - 1;
    if (kMode == 0) {
      if (leader) counts[pair] += __popc(mine);
      if (hit) {  // the hit's unit, for the write pass
        const int g = (int)(queue[i] >> kPosBits) / kGroup;
        const int u = unit_strips ? g * unit_strips + p / kStrip : g;
        atomicOr(unit_row + (u >> 5), 1u << (u & 31));
      }
    } else if (hit) {
      const long long at = cursor[pair] + __popc(mine & ((1u << lane) - 1u));
      hit_seq[at] = (int)s;
      hit_motif[at] = m;
      hit_pos[at] = p;
      hit_score[at] = score;
    }
    __syncwarp();  // every lane has read its pair's cursor
    if (kMode == 1 && leader) cursor[pair] += __popc(mine);
    __syncwarp();  // the next 32 see the counts and cursors moved
  }
}

template <int kMode>
__global__ void __launch_bounds__(kSThreads, 1)
pwm_screen_kernel(const uint8_t* __restrict__ codes, int n, int L, const float* __restrict__ lo,
                  const int* __restrict__ off, const float* __restrict__ thr, int n_motifs,
                  const uint4* __restrict__ frag, const int2* __restrict__ groups,
                  const int* __restrict__ slot_motif, const float* __restrict__ slot_thr,
                  const int* __restrict__ slot_width, int g0, int ng, int frag0, int frag_steps,
                  int* counts, long long* cursor, int* __restrict__ hit_seq,
                  int* __restrict__ hit_motif, int* __restrict__ hit_pos,
                  float* __restrict__ hit_score, unsigned long long* candidates,
                  unsigned* units) {
  extern __shared__ uint4 smem[];
  uint4* f_s = smem;
  int2* g_s = reinterpret_cast<int2*>(f_s + frag_steps * kWarp);
  float* thr_s = reinterpret_cast<float*>(g_s + ng);
  int* w_s = reinterpret_cast<int*>(thr_s + ng * kGroup);
  int* m_s = w_s + ng * kGroup;
  int* o_s = m_s + ng * kGroup;
  float* t_s = reinterpret_cast<float*>(o_s + ng * kGroup);
  unsigned* queues = reinterpret_cast<unsigned*>(t_s + ng * kGroup);
  unsigned* unit_s = queues + kSWarps * kQueue;
  for (int i = threadIdx.x; i < frag_steps * kWarp; i += blockDim.x)
    f_s[i] = frag[(int64_t)frag0 * kWarp + i];
  for (int i = threadIdx.x; i < ng; i += blockDim.x) {
    int2 gi = groups[g0 + i];
    gi.x -= frag0;
    g_s[i] = gi;
  }
  for (int i = threadIdx.x; i < ng * kGroup; i += blockDim.x) {
    thr_s[i] = slot_thr[(int64_t)g0 * kGroup + i];
    w_s[i] = slot_width[(int64_t)g0 * kGroup + i];
    const int m = slot_motif[(int64_t)g0 * kGroup + i];
    m_s[i] = m;
    o_s[i] = m >= 0 ? off[m] : 0;
    t_s[i] = m >= 0 ? thr[m] : INFINITY;
  }
  __syncthreads();

  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int gid = lane >> 2, tig = lane & 3;
  const int b0 = 2 * (tig & 1);
  const unsigned below = (1u << lane) - 1u;
  unsigned* queue = queues + warp * kQueue;
  unsigned* active = unit_s + warp * kUnitWords;
  // slot 0 holds the launch's narrowest motif (sorted; pads come last)
  const int p_end = L - w_s[0] + 1;
  // a unit is a (group, strip) where the launch's groups times the strips
  // fit the sequence's kUnitWords words of bits, else a whole group
  const int n_strips = (p_end + kStrip - 1) / kStrip;
  const int unit_strips = (long long)ng * n_strips <= kUnitWords * 32 ? n_strips : 0;
  const long long warps = (long long)gridDim.x * kSWarps;
  for (long long s = (long long)blockIdx.x * kSWarps + warp; s < n && p_end > 0; s += warps) {
    const uint8_t* cs = codes + s * L;
    unsigned* unit_row = units + s * kUnitWords;
    if (kMode == 1) {  // the units in which the count pass found a hit
      if (lane < kUnitWords) active[lane] = unit_row[lane];
      __syncwarp();
    }
    int qn = 0;      // queued candidates, the same in every lane
    int p_base = 0;  // the position the queued entries count from
    for (int p0 = 0; p0 < p_end; p0 += kStrip) {
      if (p0 + kStrip - p_base > (1 << kPosBits)) {  // keep the entries' positions in range
        if (qn > 0)
          decide<kMode>(queue, qn, lane, s, p_base, cs, lo, n_motifs, m_s, w_s, o_s, t_s,
                        counts, cursor, hit_seq, hit_motif, hit_pos, hit_score, candidates,
                        unit_row, unit_strips);
        qn = 0;
        p_base = p0;
      }
      // the A fragments: h0[i] (h2[i]) is the pair of position base + 4 i (+ 2)
      const int base = p0 + gid + (tig >> 1);
      unsigned h0[kHalves], h2[kHalves];
#pragma unroll
      for (int i = 0; i < kHalves; ++i) {
        h0[i] = onehot_pair(code_at(cs, L, base + 4 * i), b0);
        h2[i] = onehot_pair(code_at(cs, L, base + 4 * i + 2), b0);
      }
      // the invalid positions of the strip and 64 past it (a code of 4, or
      // past L), the same bits in every lane
      unsigned bad[kBadWords];
#pragma unroll
      for (int k = 0; k < kBadWords; ++k)
        bad[k] = __ballot_sync(kFull, code_at(cs, L, p0 + 32 * k + lane) >= kInvalid);
      for (int g = 0; g < ng; ++g) {
        if (kMode == 1) {
          const int u = unit_strips ? g * unit_strips + p0 / kStrip : g;
          if (!((active[u >> 5] >> (u & 31)) & 1u)) continue;
        }
        if (p0 > L - w_s[g * kGroup]) continue;  // no window of the group here
        const int2 gi = g_s[g];  // first k-step, k-steps
        const uint4* fb = f_s + gi.x * kWarp + lane;
        float acc[kNTiles][kTiles][4];
#pragma unroll
        for (int h = 0; h < kNTiles; ++h)
#pragma unroll
          for (int t = 0; t < kTiles; ++t)
            acc[h][t][0] = acc[h][t][1] = acc[h][t][2] = acc[h][t][3] = 0.f;
        switch (min(gi.y, kRegSteps)) {  // a loop of the group's own length, no predicated mma
          case 1: screen_steps<1>(acc, fb, h0, h2); break;
          case 2: screen_steps<2>(acc, fb, h0, h2); break;
          case 3: screen_steps<3>(acc, fb, h0, h2); break;
          case 4: screen_steps<4>(acc, fb, h0, h2); break;
          case 5: screen_steps<5>(acc, fb, h0, h2); break;
          case 6: screen_steps<6>(acc, fb, h0, h2); break;
          case 7: screen_steps<7>(acc, fb, h0, h2); break;
          default: screen_steps<kRegSteps>(acc, fb, h0, h2); break;
        }
        for (int st = kRegSteps; st < gi.y; ++st) {  // wider groups: from the codes
          const uint4 b = fb[st * kWarp];
#pragma unroll
          for (int t = 0; t < kTiles; ++t) {
            const int pos = base + 4 * (st + 4 * t);
            const unsigned a0 = onehot_pair(code_at(cs, L, pos), b0);
            const unsigned a1 = onehot_pair(code_at(cs, L, pos + 8), b0);
            const unsigned a2 = onehot_pair(code_at(cs, L, pos + 2), b0);
            const unsigned a3 = onehot_pair(code_at(cs, L, pos + 10), b0);
            mma_f16(acc[0][t], a0, a1, a2, a3, b.x, b.y);
            mma_f16(acc[1][t], a0, a1, a2, a3, b.z, b.w);
          }
        }
        // per n8 tile h, columns 2 tig and 2 tig + 1: the largest score of
        // each against its bar first, the windows only where one reaches it
        const float* bars = thr_s + g * kGroup + 2 * tig;
        bool any = false;
#pragma unroll
        for (int h = 0; h < kNTiles; ++h) {
          const float2 bar = *reinterpret_cast<const float2*>(bars + 8 * h);
          float hi0 = fmaxf(acc[h][0][0], acc[h][0][2]), hi1 = fmaxf(acc[h][0][1], acc[h][0][3]);
#pragma unroll
          for (int t = 1; t < kTiles; ++t) {
            hi0 = fmaxf(hi0, fmaxf(acc[h][t][0], acc[h][t][2]));
            hi1 = fmaxf(hi1, fmaxf(acc[h][t][1], acc[h][t][3]));
          }
          any |= hi0 >= bar.x || hi1 >= bar.y;
        }
        if (!__any_sync(kFull, any)) continue;
#pragma unroll
        for (int h = 0; h < kNTiles; ++h) {
          const int col0 = g * kGroup + 8 * h + 2 * tig;  // the lane's two slots
          const float2 bar = *reinterpret_cast<const float2*>(thr_s + col0);
          const int2 wd = *reinterpret_cast<const int2*>(w_s + col0);
#pragma unroll
          for (int t = 0; t < kTiles; ++t) {
            if (qn > kQueue - 4 * kWarp) {
              decide<kMode>(queue, qn, lane, s, p_base, cs, lo, n_motifs, m_s, w_s, o_s, t_s,
                            counts, cursor, hit_seq, hit_motif, hit_pos, hit_score, candidates,
                            unit_row, unit_strips);
              qn = 0;
            }
            // fragment entries r: (row, column) = (gid, 2 tig), (gid, 2 tig + 1),
            // (gid + 8, 2 tig), (gid + 8, 2 tig + 1); taken in this order, each
            // motif's windows enter the queue in position order
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              const int wbase = 16 * t + (r >= 2 ? 8 : 0);  // wbase % 32 + gid < 32
              const int at = wbase + gid;
              const bool odd = r & 1;
              const bool c = acc[h][t][r] >= (odd ? bar.y : bar.x) &&
                             window_valid(bad, wbase / 32, (wbase & 31) + gid,
                                          odd ? wd.y : wd.x, L - p0);
              const unsigned bal = __ballot_sync(kFull, c);
              if (c)
                queue[qn + __popc(bal & below)] =
                    (unsigned)((col0 + (odd ? 1 : 0)) << kPosBits) | (unsigned)(p0 + at - p_base);
              qn += __popc(bal);
            }
          }
        }
      }
    }
    if (qn > 0)  // the sequence's candidates, decided together
      decide<kMode>(queue, qn, lane, s, p_base, cs, lo, n_motifs, m_s, w_s, o_s, t_s, counts,
                    cursor, hit_seq, hit_motif, hit_pos, hit_score, candidates, unit_row,
                    unit_strips);
  }
}

// the screen's dynamic shared memory: fragments, group and slot tables,
// and each warp's queue and group mask
size_t screen_shm(int ng, int frag_steps) {
  return (size_t)frag_steps * kWarp * sizeof(uint4) + (size_t)ng * sizeof(int2) +
         (size_t)ng * kGroup * kSlotTables * sizeof(int) +
         (size_t)kSWarps * (kQueue + kUnitWords) * sizeof(unsigned);
}

template <typename Kernel>
cudaError_t grid_for(Kernel kernel, int threads, size_t shm, long long work, int* blocks) {
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)shm);
  if (e != cudaSuccess) return e;
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return e;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, shm)) !=
      cudaSuccess)
    return e;
  if (per_sm < 1) per_sm = 1;
  long long b = (work + threads / kWarp - 1) / (threads / kWarp);
  if (b > (long long)sms * per_sm) b = (long long)sms * per_sm;
  *blocks = (int)b;
  return cudaSuccess;
}

template <int kMode>
cudaError_t launch_screen(const uint8_t* codes, int n, int L, const float* lo, const int* off,
                          const float* thr, int n_motifs, const int* frag, const int* groups,
                          const int* slot_motif, const float* slot_thr, const int* slot_width,
                          int g0, int g1, int frag0, int frag_steps, int* counts,
                          long long* cursor, int* hit_seq, int* hit_motif, int* hit_pos,
                          float* hit_score, unsigned long long* candidates, unsigned* units,
                          cudaStream_t s) {
  const int ng = g1 - g0;
  if (ng > kMaxGroups || frag == nullptr || groups == nullptr || units == nullptr)
    return cudaErrorInvalidValue;
  const size_t shm = screen_shm(ng, frag_steps);
  int blocks = 0;
  cudaError_t e = grid_for(pwm_screen_kernel<kMode>, kSThreads, shm, n, &blocks);
  if (e != cudaSuccess) return e;
  pwm_screen_kernel<kMode><<<blocks, kSThreads, shm, s>>>(
      codes, n, L, lo, off, thr, n_motifs, reinterpret_cast<const uint4*>(frag),
      reinterpret_cast<const int2*>(groups), slot_motif, slot_thr, slot_width, g0, ng, frag0,
      frag_steps, counts, cursor, hit_seq, hit_motif, hit_pos, hit_score, candidates, units);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// T36. codes (n x L) uint8; lo (rows x 4) f32; off, width (n_motifs,) int32;
// thr (n_motifs,) f32; mode 0 count, 1 write, 2 scores.
// Modes 0 and 1 (the screen): frag, groups, slot_motif, slot_thr,
// slot_width of ops/pwm.pack_screen (frag as int32 quadruples, groups as
// pairs), the groups [g0, g1) of this launch (at most 256) and their
// k-steps [frag0, frag0 + frag_steps) of frag (which, with the tables and
// the warps' queues, must fit the block's shared memory); counts (n x
// n_motifs) int32, zeroed before mode 0 and read in mode 1; offsets (n x
// n_motifs) int64, each pair's first place in mode 1, moved to its end;
// hit_seq, hit_motif, hit_pos int32 and hit_score f32, the hits (mode 1);
// candidates, if not null, one uint64 to which mode 0 adds the number of
// windows the screen passed on to the chain; units (n x 32) uint32, this
// launch's own, zeroed before mode 0, which sets the bits of the (group,
// strip) units holding a hit, and read in mode 1, which screens only them.
// Mode 2: the motifs [m0, m1) of this launch and their rows [row0, row0 +
// rows) of lo (which must fit the block's shared memory, 16 bytes a row);
// scores (n x P x n_motifs) f32.
int mt_pwm_scan(const unsigned char* codes, int n, int L, const float* lo, const int* off,
                const int* width, const float* thr, int n_motifs, int m0, int m1, int row0,
                int rows, int mode, int* counts, long long* offsets, int* hit_seq,
                int* hit_motif, int* hit_pos, float* hit_score, float* scores, int P,
                const int* frag, const int* groups, const int* slot_motif,
                const float* slot_thr, const int* slot_width, int g0, int g1, int frag0,
                int frag_steps, unsigned long long* candidates, unsigned* units,
                void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const uint8_t* c = reinterpret_cast<const uint8_t*>(codes);
  if (mode == 0 || mode == 1) {
    if (n <= 0 || g1 <= g0) return (int)cudaGetLastError();
    return mode == 0
               ? (int)launch_screen<0>(c, n, L, lo, off, thr, n_motifs, frag, groups, slot_motif,
                                       slot_thr, slot_width, g0, g1, frag0, frag_steps, counts,
                                       offsets, hit_seq, hit_motif, hit_pos, hit_score,
                                       candidates, units, s)
               : (int)launch_screen<1>(c, n, L, lo, off, thr, n_motifs, frag, groups, slot_motif,
                                       slot_thr, slot_width, g0, g1, frag0, frag_steps, counts,
                                       offsets, hit_seq, hit_motif, hit_pos, hit_score,
                                       nullptr, units, s);
  }
  if (mode != 2) return (int)cudaErrorInvalidValue;
  if (n <= 0 || m1 <= m0) return (int)cudaGetLastError();
  const size_t shm = (size_t)rows * sizeof(float4);
  int blocks = 0;
  cudaError_t e = grid_for(pwm_scores_kernel, kThreads, shm, (long long)n * (m1 - m0), &blocks);
  if (e != cudaSuccess) return (int)e;
  pwm_scores_kernel<<<blocks, kThreads, shm, s>>>(c, n, L, lo, off, width, n_motifs, m0, m1,
                                                   row0, rows, scores, P);
  return (int)cudaGetLastError();
}

}  // extern "C"
