// Kernels of the marker-gene tests (rank_genes_groups), for Hopper (sm_90a).
//
//   T26 wilcoxon_rank_sums   <- muon_tpu/_core/tools_de.py ranksum (:175), on a
//                               dense X whose column blocks torch.sort sorted
//   T26 wilcoxon_rank_sums_csc <- the same ranksum, from the CSR of X^T: the
//                               nonzeros sorted in the kernel, the zeros as one run
//   T27 logreg_softmax_grad  <- muon_tpu/_core/tools_de.py fit (:248): the
//                               gradient of the weighted cross entropy in the logits
//   T28 adam_update          <- the same fit: optax.adam's update of W and b,
//                               with the L2 term's gradient added to W's
//
// T26 takes one column block of X already sorted along the cells (torch.sort,
// stable, by the wrapper: a sort is no product and the reference sorts too),
// as `vals` (b x n, f32, a row per column) and the permutation `perm` (b x n,
// int64), and the group code of every cell (-1: no group; such a cell still
// takes part in the ranks, as in the reference). The reference's
// searchsorted bounds of an element's tie run are, with 0-based positions,
// lo = the run's first position and hi = one past its last; its average rank
// is (lo + 1 + hi) / 2. Each group's counter takes lo + 1 + hi of each of its
// cells, an integer: twice the rank sum, exact in any order of the adds, and
// each run adds t^3 - t (t = hi - lo: the reference's sum over elements of
// t^2 - 1) to its column's tie term. So the outputs are the same bits
// whatever the kernel's order.
// A block owns a column and walks it once, in tiles of 2048 cells, 8
// consecutive cells a thread: each input is read once (16-byte loads of vals
// and perm where the rows are aligned), each cell's code gathered once, and
// the two values beside a thread's cells read to mark the run starts and
// ends. A block-wide scan over the threads gives each cell its lo (the last
// start at or before it, or the start carried from earlier tiles) and its hi
// (the first end at or after it) where that end lies in the tile. Only the
// run still open at a tile's end carries over: its cells add lo + 1 now and
// count in a per-group table of the open run; when the run ends (in a later
// tile), each group it touched adds hi times its count, once: a column that
// is mostly zeros is one long run, settled once. Each cell adds its integer
// with one native 32-bit shared atomic on the low word of its group's 64-bit
// counter, the high word taking the carry (add_u64): summing a warp's adds
// by group first (__match_any_sync, __reduce_add_sync) made the block 3.6x
// slower, and a 64-bit shared atomic add (a compare-and-swap loop) 2.7x
// (exp_t26_variants.py). Shared memory: g int64 counters, g int32 open
// counts and the g groups the open run touched (48 KB at MAX_GROUPS = 3000).
// Bound: the sorted block is read once (12 bytes a cell) plus the codes, so
// T26 is bound by bytes; the sort before it moves more than T26 does.
//
// T27 is a row pass over the logits Z = X W (n x g, f32, from torch.matmul):
// v = z + b, the row max m, s = sum exp(v - m), and, as jax.grad forms it,
// dZ = (wv / s) exp(v - m) - wv [c == y]. A warp owns a run of rows; its lanes
// own the columns c = lane (mod 32) and sum their dZ into a per-warp partial
// of the bias gradient in shared memory, in row order. A second kernel sums
// the partials of every warp in warp order and a fixed tree: no float atomics,
// so a fit repeats bit for bit. Bound by bytes (Z read, dZ written).
//
// T28 is elementwise over W (D x g) and b (g): the gradient (W's with the L2
// term reg * (2 W), reg = 0.5 / C as jax.grad forms it), then optax's
//   mu = (1 - b1) g + b1 mu,  nu = (1 - b2) g^2 + b2 nu,
//   p += -lr * (mu / bc1) / (sqrt(nu / bc2) + eps)
// with bc = 1 - decay^count after the count's increment (from the host, in
// float64, rounded to f32 as the reference casts it). Every operation is
// rounded as written (__f*_rn: no contraction into fma). Bound by bytes.
//
// Interface: plain C functions loaded with ctypes (sparse_kernels.cu). Each
// launches on the stream it is given, allocates nothing, and returns
// cudaGetLastError(). Scratch and outputs are allocated by the caller.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kRankThreads = 256;  // T26: threads of a column's block
constexpr int kRankWarps = kRankThreads / kWarp;
constexpr int kRankPer = 8;        // T26: consecutive cells a thread, a tile 2048
constexpr int kGradWarps = 8;      // T27: warps per block
constexpr int kFinishThreads = 256;
constexpr int kAdamThreads = 256;

// adds v to the 64-bit counter at c with native 32-bit shared atomics: the
// low word, then the carry into the high word (a 64-bit shared atomic add is
// a compare-and-swap loop). Exact: each carry is seen by the one add that
// made it
__device__ __forceinline__ void add_u64(unsigned long long* c, unsigned v) {
  unsigned* w = reinterpret_cast<unsigned*>(c);
  const unsigned old = atomicAdd(w, v);
  if (old + v < old) atomicAdd(w + 1, 1u);
}

// T26: a block per column of the sorted block. kVec: the rows are 16-byte
// aligned (n a multiple of 4), so a thread's 8 cells load as 16-byte pieces
template <bool kVec>
__global__ void __launch_bounds__(kRankThreads)
wilcoxon_rank_sums_kernel(const float* __restrict__ vals,
                          const int64_t* __restrict__ perm,
                          const int* __restrict__ codes, int n, int b, int g,
                          double* __restrict__ rank_sums,
                          long long* __restrict__ tie_term) {
  extern __shared__ __align__(16) unsigned char rsm[];
  unsigned long long* acc = reinterpret_cast<unsigned long long*>(rsm);  // g: twice-rank sums
  unsigned* open_n = reinterpret_cast<unsigned*>(acc + g);  // g: the open run's cells a group
  int* touched = reinterpret_cast<int*>(open_n + g);        // the groups with open_n > 0
  // a tile's scan totals by warp, and its last cell's end flag, in two
  // copies by tile parity: a warp may write the next tile's while another
  // still reads this one's
  __shared__ int wlast[2][kRankWarps], wfirst[2][kRankWarps], tail_end[2];
  __shared__ int n_touched;
  __shared__ unsigned long long wtie[kRankWarps];
  constexpr int kTile = kRankThreads * kRankPer;
  constexpr int kNone = 0x7fffffff;
  const int tid = threadIdx.x, lane = tid % kWarp, warp = tid / kWarp;
  const int c = blockIdx.x;
  for (int k = tid; k < g; k += kRankThreads) {
    acc[k] = 0ull;
    open_n[k] = 0u;
  }
  if (tid == 0) n_touched = 0;
  __syncthreads();
  const float* s = vals + (int64_t)c * n;
  const int64_t* p = perm + (int64_t)c * n;

  int lo_carry = 0;         // the first place of the run open at the tile's start
  bool open_carry = false;  // a run goes on from the last tile
  unsigned long long tie = 0ull;
  for (int base = 0, it = 0; base < n; base += kTile, ++it) {
    const int par = it & 1;
    const int i0 = base + tid * kRankPer;
    float x[kRankPer];
    int code[kRankPer];
    if (kVec && i0 + kRankPer <= n) {
      const float4 a = *reinterpret_cast<const float4*>(s + i0);
      const float4 z = *reinterpret_cast<const float4*>(s + i0 + 4);
      x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
      x[4] = z.x; x[5] = z.y; x[6] = z.z; x[7] = z.w;
      int64_t q[kRankPer];
#pragma unroll
      for (int h = 0; h < kRankPer; h += 2) {
        const longlong2 v = *reinterpret_cast<const longlong2*>(p + i0 + h);
        q[h] = v.x;
        q[h + 1] = v.y;
      }
#pragma unroll
      for (int e = 0; e < kRankPer; ++e) code[e] = codes[q[e]];
    } else {
#pragma unroll
      for (int e = 0; e < kRankPer; ++e) {
        const bool in = i0 + e < n;
        x[e] = in ? s[i0 + e] : 0.f;
        code[e] = in ? codes[p[i0 + e]] : -1;
      }
    }
    const float before = i0 > 0 && i0 < n ? s[i0 - 1] : 0.f;
    const float after = i0 + kRankPer < n ? s[i0 + kRankPer] : 0.f;
    unsigned st = 0u, en = 0u;  // bit e: cell i0 + e starts / ends a run
#pragma unroll
    for (int e = 0; e < kRankPer; ++e) {
      const int i = i0 + e;
      if (i < n) {
        const float prev = e > 0 ? x[e - 1] : before;
        const float next = e + 1 < kRankPer ? x[e + 1] : after;
        st |= (unsigned)(i == 0 || x[e] != prev) << e;
        en |= (unsigned)(i == n - 1 || x[e] != next) << e;
      }
    }
    // the last start at or before each thread's cells, the first end (one
    // past it) at or after them: scans over the warp, then over the warps
    int smax = st ? i0 + 31 - __clz(st) : -1;
    int smin = en ? i0 + __ffs(en) : kNone;
#pragma unroll
    for (int o = 1; o < kWarp; o <<= 1) {
      const int a = __shfl_up_sync(kFull, smax, o);
      const int z = __shfl_down_sync(kFull, smin, o);
      if (lane >= o) smax = max(smax, a);
      if (lane + o < kWarp) smin = min(smin, z);
    }
    if (lane == kWarp - 1) wlast[par][warp] = smax;
    if (lane == 0) wfirst[par][warp] = smin;
    const int last = min(base + kTile, n) - 1;  // the tile's last cell
    if (i0 <= last && last < i0 + kRankPer) tail_end[par] = (en >> (last - i0)) & 1u;
    const int ex_max = __shfl_up_sync(kFull, smax, 1);
    const int ex_min = __shfl_down_sync(kFull, smin, 1);
    __syncthreads();
    int lo = lane > 0 ? max(lo_carry, ex_max) : lo_carry;
    int hi = lane < kWarp - 1 ? ex_min : kNone;
    int tile_max = lo_carry, tile_min = kNone;
#pragma unroll
    for (int v = 0; v < kRankWarps; ++v) {
      const int a = wlast[par][v], z = wfirst[par][v];
      tile_max = max(tile_max, a);
      tile_min = min(tile_min, z);
      if (v < warp) lo = max(lo, a);
      if (v > warp) hi = min(hi, z);
    }
    const bool tail_open = !tail_end[par];
    if (open_carry && tile_min != kNone) {
      // the run carried in ends in this tile, one before tile_min: each group
      // it touched in earlier tiles adds hi = tile_min per cell
      const int nt = n_touched;
      for (int j = tid; j < nt; j += kRankThreads) {
        const int k = touched[j];
        acc[k] += (unsigned long long)tile_min * open_n[k];
        open_n[k] = 0u;
      }
      __syncthreads();
      if (tid == 0) n_touched = 0;
      __syncthreads();
    }
    int lov[kRankPer], hiv[kRankPer];
#pragma unroll
    for (int e = 0; e < kRankPer; ++e) {
      if ((st >> e) & 1u) lo = i0 + e;
      lov[e] = lo;
    }
#pragma unroll
    for (int e = kRankPer - 1; e >= 0; --e) {
      if ((en >> e) & 1u) hi = i0 + e + 1;
      hiv[e] = hi;
    }
#pragma unroll
    for (int e = 0; e < kRankPer; ++e) {
      const bool in = i0 + e < n;
      const bool open = hiv[e] == kNone;  // its run goes on past the tile
      if (in && ((en >> e) & 1u)) {
        const unsigned long long t = (unsigned long long)(hiv[e] - lov[e]);
        tie += t * t * t - t;
      }
      const int cd = in ? code[e] : -1;
      if (cd >= 0) {
        add_u64(&acc[cd], (unsigned)(open ? lov[e] + 1 : lov[e] + 1 + hiv[e]));
        if (open && atomicAdd(&open_n[cd], 1u) == 0u) touched[atomicAdd(&n_touched, 1)] = cd;
      }
    }
    lo_carry = tile_max;
    open_carry = tail_open;
  }
#pragma unroll
  for (int o = kWarp / 2; o > 0; o >>= 1) tie += __shfl_xor_sync(kFull, tie, o);
  if (lane == 0) wtie[warp] = tie;
  __syncthreads();
  if (tid == 0) {
    unsigned long long total = 0ull;
    for (int v = 0; v < kRankWarps; ++v) total += wtie[v];
    tie_term[c] = (long long)total;
  }
  for (int k = tid; k < g; k += kRankThreads) rank_sums[(int64_t)k * b + c] = 0.5 * (double)acc[k];
}

// ---------------------------------------------------------------------------
// T26 over the nonzeros (wilcoxon_rank_sums_csc): the same rank sums and tie
// terms from the CSR of X^T (a row per column of X: float32 values and int32
// cells, the cells of a row ascending, no duplicates), never densified.
//
// Per column j with L stored entries of n cells: neg of them negative, zs
// stored zeros (+0 and -0), and n - L implicit zeros. The zeros form one tie
// run, at positions [neg, neg + z) with z = zs + n - L, so each has twice
// the rank Z2 = 2 neg + z + 1, and the run adds z^3 - z to the tie term.
// Every other entry's run lies among the sorted stored entries, shifted by
// n - L when it lies above zero. So group c's twice-rank sum is
//   n_c Z2 + sum over its stored entries of (lo + 1 + hi - Z2),
// with lo and hi of the dense route (0-based first position of the run and
// one past its last), and a stored zero adds 0. The integers are the dense
// route's (T26 above), so are the float64 rank sums and the tie terms.
// NaNs keep the dense route's order: after every number, each a run of its
// own, in cell order (torch.sort is stable there and T26 compares with !=).
//
// A block of 512 threads owns a column; the columns come longest first
// (the wrapper's order), so the few long ones start at once and the many
// short ones fill the card behind them. It loads the column's entries as
// (order-preserving 32-bit key, int16 group code) pairs, the codes
// gathered once, counting the four bytes' histograms as it goes, then sorts
// them by an LSD radix sort in four 8-bit passes (a pass whose byte is the
// same in every entry moves nothing and is skipped). Each pass goes tile by
// tile (512 entries, one a thread): a warp ranks its 32 entries among equal
// bytes (__match_any_sync), the per-warp counts are scanned per byte into
// the tile's offsets, and every entry is written to its place, stably.
// Why LSD and 8 bits: stability keeps NaNs (and nothing else needs it) in
// cell order without a second key; 8 bits keep the per-tile scan to 256
// digits x 16 warps in shared memory (11 bits would need 8 times that).
// A column of up to `cap` entries (csc_capacity: the two buffers in
// shared memory, two blocks an SM) sorts in shared memory; a longer one in
// the global scratch the wrapper allocates (12 bytes an entry, mostly in
// L2). Then one walk over the sorted keys: each entry finds its run's ends
// by galloping out from its own place (a run of one costs two loads), the
// run's first entry adds t^3 - t, and each warp adds lo + 1 + hi - Z2 into
// its groups' int64 counters in shared memory, equal codes summed first
// (__match_any_sync, __reduce_add_sync: |lo + 1 + hi - Z2| <= 2n + 1, so
// 32 of them fit an int). Integer adds only: a run repeats bit for bit.
// Bound: the column's values and cells read once, the codes gathered once
// (12 bytes an entry), the outputs written once; the radix passes' own
// traffic stays in shared memory (or L2) and is not counted.
// ---------------------------------------------------------------------------

namespace csc {
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / kWarp;
constexpr int kRadix = 256;
constexpr unsigned kZeroKey = 0x80000000u;  // +0 and -0
constexpr unsigned kNanKey = 0xffffffffu;   // every NaN, above +inf's key
constexpr int kEntryBytes = 12;             // two keys and two codes: the passes' buffers
constexpr int kSharedBytes = 113 * 1024;    // two blocks an SM
// the fixed part: g counters, four histograms, the tiles' offsets (uint32)
// and counts (uint16), the scan's warp sums and the column's scalars
__host__ __device__ constexpr int fixed_bytes(int g) {
  return g * 8 + 4 * kRadix * 4 + kWarps * kRadix * 4 + kWarps * kRadix * 2 + 64 * 4;
}
__host__ __device__ constexpr int capacity(int g) {
  return fixed_bytes(g) >= kSharedBytes ? 0 : ((kSharedBytes - fixed_bytes(g)) / kEntryBytes) & ~15;
}
}  // namespace csc

// float32 -> a 32-bit key that orders as the values do: -0 as +0, NaNs last
__device__ __forceinline__ unsigned rank_key(float x) {
  if (isnan(x)) return csc::kNanKey;
  const unsigned b = __float_as_uint(x + 0.f);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

// the first place of key k's run around place p of the sorted keys
__device__ __forceinline__ int run_first(const unsigned* keys, int p, unsigned k) {
  int lo = p, step = 1;
  while (lo >= step && keys[lo - step] == k) {
    lo -= step;
    step <<= 1;
  }
  int a = lo - step < -1 ? -1 : lo - step;  // keys[a] < k, or a = -1
  while (lo - a > 1) {
    const int m = (a + lo) >> 1;
    if (keys[m] == k) lo = m; else a = m;
  }
  return lo;
}

// one past the last place of key k's run around place p
__device__ __forceinline__ int run_end(const unsigned* keys, int p, unsigned k, int L) {
  int hi = p, step = 1;
  while (hi + step < L && keys[hi + step] == k) {
    hi += step;
    step <<= 1;
  }
  int b = hi + step > L ? L : hi + step;  // keys[b] > k, or b = L
  while (b - hi > 1) {
    const int m = (hi + b) >> 1;
    if (keys[m] == k) hi = m; else b = m;
  }
  return b;
}

struct CscShared {
  unsigned long long* acc;  // g: twice-rank sums minus Z2 a stored entry
  unsigned* hist;           // 4 x 256: each byte's counts, then its running offsets
  unsigned* off;            // kWarps x 256: a tile's offsets
  unsigned short* cnt;      // kWarps x 256: a tile's counts, zero between tiles
  unsigned* misc;           // [0] negatives, [1] stored zeros, [2] passes skipped,
                            // [4, 36) the scan's warp sums, [36] (64-bit) the tie term
};

// sort the column (n_in entries at vals, cells) by key with its codes, then
// walk it; leaves the counters in acc, the tie term of the stored runs at
// misc + 36, the counts at misc[0], misc[1]
template <bool kInShared>
__device__ __forceinline__ void rank_column(const CscShared& sh, unsigned* k0, unsigned* k1,
                                            short* c0, short* c1, const float* __restrict__ vals,
                                            const int* __restrict__ cells,
                                            const int* __restrict__ codes, int L, int n) {
  const int tid = threadIdx.x, warp = tid / kWarp, lane = tid % kWarp;
  const unsigned below_me = (1u << lane) - 1u;

  // the keys and codes, the four bytes' counts, negatives and stored zeros
  for (int base = 0; base < L; base += csc::kThreads) {
    const int i = base + tid;
    const bool in = i < L;
    unsigned key = 0u;
    if (in) {
      key = rank_key(vals[i]);
      k0[i] = key;
      c0[i] = (short)codes[cells[i]];
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const unsigned d = in ? (key >> (8 * r)) & 255u : 256u;
      const unsigned peers = __match_any_sync(kFull, d);
      if (in && (peers & below_me) == 0u)
        atomicAdd(&sh.hist[r * csc::kRadix + d], (unsigned)__popc(peers));
    }
    const unsigned negs = __ballot_sync(kFull, in && key < csc::kZeroKey);
    const unsigned zeros = __ballot_sync(kFull, in && key == csc::kZeroKey);
    if (lane == 0) {
      if (negs) atomicAdd(&sh.misc[0], (unsigned)__popc(negs));
      if (zeros) atomicAdd(&sh.misc[1], (unsigned)__popc(zeros));
    }
  }
  __syncthreads();

  // each byte's counts to the exclusive offsets of its buckets; a byte
  // whose one bucket holds every entry marks its pass as skipped
  unsigned v[4], own[4];
  if (tid < csc::kRadix) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      own[r] = v[r] = sh.hist[r * csc::kRadix + tid];
      if (own[r] == (unsigned)L) atomicOr(&sh.misc[2], 1u << r);
#pragma unroll
      for (int o = 1; o < kWarp; o <<= 1) {
        const unsigned t = __shfl_up_sync(kFull, v[r], o);
        if (lane >= o) v[r] += t;
      }
      if (lane == kWarp - 1) sh.misc[4 + r * 8 + warp] = v[r];
    }
  }
  __syncthreads();
  if (tid < csc::kRadix) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      unsigned pre = 0u;
      for (int w = 0; w < warp; ++w) pre += sh.misc[4 + r * 8 + w];
      sh.hist[r * csc::kRadix + tid] = pre + v[r] - own[r];
    }
  }
  __syncthreads();

  // the passes, stable, tile by tile
  const unsigned skip = sh.misc[2];
  unsigned *sk = k0, *dk = k1;
  short *sc = c0, *dc = c1;
  for (int r = 0; r < 4; ++r) {
    if ((skip >> r) & 1u) continue;
    unsigned* run = sh.hist + r * csc::kRadix;
    for (int base = 0; base < L; base += csc::kThreads) {
      const int i = base + tid;
      const bool in = i < L;
      const unsigned key = in ? sk[i] : 0u;
      const short code = in ? sc[i] : (short)0;
      const unsigned d = in ? (key >> (8 * r)) & 255u : 256u;
      const unsigned peers = __match_any_sync(kFull, d);
      const unsigned rank = __popc(peers & below_me);
      if (in && rank == 0u) sh.cnt[warp * csc::kRadix + d] = (unsigned short)__popc(peers);
      __syncthreads();
      if (tid < csc::kRadix) {  // the tile's offsets, warp by warp; the counts back to 0
        unsigned o = run[tid];
        for (int w = 0; w < csc::kWarps; ++w) {
          const unsigned c = sh.cnt[w * csc::kRadix + tid];
          sh.off[w * csc::kRadix + tid] = o;
          sh.cnt[w * csc::kRadix + tid] = 0;
          o += c;
        }
        run[tid] = o;
      }
      __syncthreads();
      if (in) {
        const unsigned p = sh.off[warp * csc::kRadix + d] + rank;
        dk[p] = key;
        dc[p] = code;
      }
    }
    __syncthreads();
    unsigned* tk = sk; sk = dk; dk = tk;
    short* tc = sc; sc = dc; dc = tc;
  }

  // the walk: each stored entry's run, its groups' sums, the runs' tie terms
  const int neg = (int)sh.misc[0];
  const int zimp = n - L;
  const int z = (int)sh.misc[1] + zimp;
  const int Z2 = 2 * neg + z + 1;
  unsigned long long tie = 0ull;
  for (int base = 0; base < L; base += csc::kThreads) {
    const int p = base + tid;
    int val = 0, code = -1;
    if (p < L) {
      const unsigned key = sk[p];
      if (key != csc::kZeroKey) {
        int lo = p, hi = p + 1;
        if (key != csc::kNanKey) {
          lo = run_first(sk, p, key);
          hi = run_end(sk, p, key, L);
          if (p == lo) {
            const unsigned long long t = (unsigned long long)(hi - lo);
            tie += t * t * t - t;
          }
        }
        const int shift = key > csc::kZeroKey ? zimp : 0;
        val = lo + hi + 1 + 2 * shift - Z2;
        code = sc[p];
      }
    }
    const unsigned peers = __match_any_sync(kFull, code);
    const int sum = __reduce_add_sync(peers, val);
    if (code >= 0 && (peers & below_me) == 0u)
      atomicAdd(&sh.acc[code], (unsigned long long)(long long)sum);
  }
#pragma unroll
  for (int o = kWarp / 2; o > 0; o >>= 1) tie += __shfl_xor_sync(kFull, tie, o);
  if (lane == 0 && tie) atomicAdd(reinterpret_cast<unsigned long long*>(sh.misc + 36), tie);
}

__global__ void __launch_bounds__(csc::kThreads, 2)
    wilcoxon_csc_kernel(const int* __restrict__ indptr, const int* __restrict__ cells,
                        const float* __restrict__ vals, const int* __restrict__ codes,
                        const long long* __restrict__ group_n, const int* __restrict__ order,
                        const long long* __restrict__ slot, int n, int D, int g, int cap,
                        unsigned* __restrict__ skeys, short* __restrict__ scodes,
                        double* __restrict__ rank_sums, long long* __restrict__ tie_term) {
  extern __shared__ __align__(16) unsigned char smem[];
  CscShared sh;
  sh.acc = reinterpret_cast<unsigned long long*>(smem);
  sh.hist = reinterpret_cast<unsigned*>(sh.acc + g);
  sh.off = sh.hist + 4 * csc::kRadix;
  sh.misc = sh.off + csc::kWarps * csc::kRadix;
  unsigned* keys = sh.misc + 64;
  sh.cnt = reinterpret_cast<unsigned short*>(keys + 2 * cap);
  short* cds = reinterpret_cast<short*>(sh.cnt + csc::kWarps * csc::kRadix);

  const int tid = threadIdx.x;
  const int j = order[blockIdx.x];
  const int s = indptr[j], L = indptr[j + 1] - s;
  for (int i = tid; i < g; i += csc::kThreads) sh.acc[i] = 0ull;
  for (int i = tid; i < 4 * csc::kRadix; i += csc::kThreads) sh.hist[i] = 0u;
  for (int i = tid; i < csc::kWarps * csc::kRadix; i += csc::kThreads) sh.cnt[i] = 0;
  if (tid < 64) sh.misc[tid] = 0u;
  __syncthreads();
  if (L <= cap) {
    rank_column<true>(sh, keys, keys + cap, cds, cds + cap, vals + s, cells + s, codes, L, n);
  } else {  // the long columns come first: block b's scratch starts at 2 slot[b]
    const long long o = 2 * slot[blockIdx.x];
    rank_column<false>(sh, skeys + o, skeys + o + L, scodes + o, scodes + o + L, vals + s,
                       cells + s, codes, L, n);
  }
  __syncthreads();
  const long long z = (long long)sh.misc[1] + (n - L);
  const long long Z2 = 2LL * sh.misc[0] + z + 1;
  for (int c = tid; c < g; c += csc::kThreads)
    rank_sums[(int64_t)c * D + j] = 0.5 * (double)((long long)sh.acc[c] + group_n[c] * Z2);
  if (tid == 0)
    tie_term[j] = (long long)(*reinterpret_cast<unsigned long long*>(sh.misc + 36) +
                              (unsigned long long)(z * z * z - z));
}

// T27 pass 1: dZ and one bias partial per warp
__global__ void __launch_bounds__(kWarp * kGradWarps)
logreg_grad_kernel(const float* __restrict__ Z, const float* __restrict__ bias,
                   const int* __restrict__ y, const float* __restrict__ wv,
                   int n, int g, int rows_per_warp, float* __restrict__ dZ,
                   float* __restrict__ partial) {
  extern __shared__ float part[];  // kGradWarps x g
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int64_t w = (int64_t)blockIdx.x * kGradWarps + warp;
  float* my = part + (int64_t)warp * g;
  for (int c = lane; c < g; c += kWarp) my[c] = 0.f;
  const int64_t r0 = w * rows_per_warp;
  const int64_t r1 = min(r0 + rows_per_warp, (int64_t)n);
  for (int64_t r = r0; r < r1; ++r) {
    const float* z = Z + r * g;
    float m = -INFINITY;
    for (int c = lane; c < g; c += kWarp) m = fmaxf(m, __fadd_rn(z[c], bias[c]));
#pragma unroll
    for (int o = kWarp / 2; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(kFull, m, o));
    float sum = 0.f;
    for (int c = lane; c < g; c += kWarp)
      sum = __fadd_rn(sum, expf(__fsub_rn(__fadd_rn(z[c], bias[c]), m)));
#pragma unroll
    for (int o = kWarp / 2; o > 0; o >>= 1)
      sum = __fadd_rn(sum, __shfl_xor_sync(kFull, sum, o));
    const float wr = wv[r];
    const float scale = __fdiv_rn(wr, sum);
    const int yr = y[r];
    float* d = dZ + r * g;
    for (int c = lane; c < g; c += kWarp) {
      float v = __fmul_rn(scale, expf(__fsub_rn(__fadd_rn(z[c], bias[c]), m)));
      if (c == yr) v = __fadd_rn(v, -wr);
      d[c] = v;
      my[c] = __fadd_rn(my[c], v);
    }
  }
  __syncwarp();
  for (int c = lane; c < g; c += kWarp) partial[w * g + c] = my[c];
}

// T27 pass 2: db[c] = the partials of column c summed in warp order and a tree
__global__ void __launch_bounds__(kFinishThreads)
logreg_bias_finish_kernel(const float* __restrict__ partial, int n_parts, int g,
                          float* __restrict__ db) {
  __shared__ float acc[kFinishThreads];
  const int c = blockIdx.x;
  float s = 0.f;
  for (int t = threadIdx.x; t < n_parts; t += kFinishThreads)
    s = __fadd_rn(s, partial[(int64_t)t * g + c]);
  acc[threadIdx.x] = s;
  __syncthreads();
  for (int h = kFinishThreads / 2; h > 0; h >>= 1) {
    if (threadIdx.x < h) acc[threadIdx.x] = __fadd_rn(acc[threadIdx.x], acc[threadIdx.x + h]);
    __syncthreads();
  }
  if (threadIdx.x == 0) db[c] = acc[0];
}

__device__ __forceinline__ void adam_one(float* p, float gr, float* m, float* v,
                                         float b1, float omb1, float b2, float omb2,
                                         float bc1, float bc2, float eps,
                                         float neg_lr) {
  const float mu = __fadd_rn(__fmul_rn(omb1, gr), __fmul_rn(b1, *m));
  const float nu = __fadd_rn(__fmul_rn(omb2, __fmul_rn(gr, gr)), __fmul_rn(b2, *v));
  const float u = __fdiv_rn(__fdiv_rn(mu, bc1),
                            __fadd_rn(__fsqrt_rn(__fdiv_rn(nu, bc2)), eps));
  *m = mu;
  *v = nu;
  *p = __fadd_rn(*p, __fmul_rn(u, neg_lr));
}

// T28: W's elements first, then b's, one thread each (grid-stride)
__global__ void __launch_bounds__(kAdamThreads)
adam_update_kernel(float* __restrict__ W, const float* __restrict__ gW,
                   float* __restrict__ mW, float* __restrict__ vW, int64_t nW,
                   float* __restrict__ b, const float* __restrict__ gb,
                   float* __restrict__ mb, float* __restrict__ vb, int nb,
                   float reg, float b1, float omb1, float b2, float omb2,
                   float bc1, float bc2, float eps, float neg_lr) {
  const int64_t total = nW + nb;
  for (int64_t e = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; e < total;
       e += (int64_t)gridDim.x * blockDim.x) {
    if (e < nW) {
      const float gr = __fadd_rn(gW[e], __fmul_rn(reg, __fmul_rn(2.f, W[e])));
      adam_one(W + e, gr, mW + e, vW + e, b1, omb1, b2, omb2, bc1, bc2, eps, neg_lr);
    } else {
      const int64_t j = e - nW;
      adam_one(b + j, gb[j], mb + j, vb + j, b1, omb1, b2, omb2, bc1, bc2, eps, neg_lr);
    }
  }
}

}  // namespace

extern "C" {

// T26. vals (b x n) f32 and perm (b x n) int64: a block of b columns sorted
// along the cells; codes (n,) int32 (-1: no group). Writes rank_sums (g x b)
// f64 and tie_term (b,) int64.
int mt_wilcoxon_rank_sums(const float* vals, const int64_t* perm, const int* codes,
                          int n, int b, int g, double* rank_sums, long long* tie_term,
                          void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n <= 0 || b <= 0) return (int)cudaGetLastError();
  if (g < 1) return (int)cudaErrorInvalidValue;
  const size_t shm = (size_t)g * (sizeof(unsigned long long) + sizeof(unsigned) + sizeof(int));
  const bool vec = n % 4 == 0 && ((uintptr_t)vals & 15u) == 0 && ((uintptr_t)perm & 15u) == 0;
  auto kernel = vec ? wilcoxon_rank_sums_kernel<true> : wilcoxon_rank_sums_kernel<false>;
  if (shm > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)shm);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<b, kRankThreads, shm, s>>>(vals, perm, codes, n, b, g, rank_sums, tie_term);
  return (int)cudaGetLastError();
}

// T26 over the nonzeros: the entries of a column sorted in shared memory,
// for g groups (longer columns go through the scratch)
int mt_wilcoxon_csc_capacity(int g) { return csc::capacity(g); }

// T26 over the CSR of X^T (D rows, one a column of X): indptr (D + 1,)
// int32; cells (nnz,) int32, ascending within a row, no duplicates; vals
// (nnz,) f32; codes (n,) int32 (-1: no group); group_n (g,) int64, the
// cells of each group; order (D,) int32, the columns longest first; slot
// int64, for each of the long columns (more than capacity(g) entries,
// first in order) the entries of the long columns before it; skeys (twice
// their entries) uint32 and scodes (the same) int16 scratch. Writes
// rank_sums (g x D) f64 and tie_term (D,) int64.
int mt_wilcoxon_rank_sums_csc(const int* indptr, const int* cells, const float* vals,
                              const int* codes, const long long* group_n, const int* order,
                              const long long* slot, int n, int D, int g, void* skeys,
                              void* scodes, double* rank_sums, long long* tie_term,
                              void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (D <= 0 || g <= 0) return (int)cudaGetLastError();
  const int cap = csc::capacity(g);
  if (cap <= 0) return (int)cudaErrorInvalidValue;
  const int shm = csc::fixed_bytes(g) + cap * csc::kEntryBytes;
  cudaError_t e = cudaFuncSetAttribute(wilcoxon_csc_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, shm);
  if (e != cudaSuccess) return (int)e;
  wilcoxon_csc_kernel<<<D, csc::kThreads, shm, s>>>(
      indptr, cells, vals, codes, group_n, order, slot, n, D, g, cap, (unsigned*)skeys,
      (short*)scodes, rank_sums, tie_term);
  return (int)cudaGetLastError();
}

// T27. Z (n x g) f32 logits without the bias, bias (g,), y (n,) int32 in
// [0, g), wv (n,) f32; rows_per_warp > 0; partial (ceil(n / rows_per_warp)
// rounded up to whole blocks of 8 warps, x g) f32 scratch. Writes dZ (n x g)
// and db (g,).
int mt_logreg_softmax_grad(const float* Z, const float* bias, const int* y,
                           const float* wv, int n, int g, int rows_per_warp,
                           float* partial, float* dZ, float* db, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n <= 0 || g <= 0) return (int)cudaGetLastError();
  const int warps = (n + rows_per_warp - 1) / rows_per_warp;
  const int blocks = (warps + kGradWarps - 1) / kGradWarps;
  const size_t shm = (size_t)kGradWarps * g * sizeof(float);
  if (shm > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(logreg_grad_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)shm);
    if (e != cudaSuccess) return (int)e;
  }
  logreg_grad_kernel<<<blocks, kWarp * kGradWarps, shm, s>>>(Z, bias, y, wv, n, g,
                                                            rows_per_warp, dZ, partial);
  logreg_bias_finish_kernel<<<g, kFinishThreads, 0, s>>>(partial, blocks * kGradWarps, g, db);
  return (int)cudaGetLastError();
}

// T28. W, gW, mW, vW (nW,) f32 and b, gb, mb, vb (nb,) f32, updated in
// place (W, mW, vW, b, mb, vb); reg = 0.5 / C; the constants of optax.adam
// and the step's bias corrections bc1, bc2; neg_lr = -lr.
int mt_adam_update(float* W, const float* gW, float* mW, float* vW, long long nW,
                   float* b, const float* gb, float* mb, float* vb, int nb,
                   float reg, float b1, float omb1, float b2, float omb2,
                   float bc1, float bc2, float eps, float neg_lr, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int64_t total = (int64_t)nW + nb;
  if (total <= 0) return (int)cudaGetLastError();
  int64_t blocks = (total + kAdamThreads - 1) / kAdamThreads;
  if (blocks > 132 * 16) blocks = 132 * 16;  // grid-stride beyond 16 per SM
  adam_update_kernel<<<(int)blocks, kAdamThreads, 0, s>>>(
      W, gW, mW, vW, (int64_t)nW, b, gb, mb, vb, nb, reg, b1, omb1, b2, omb2, bc1,
      bc2, eps, neg_lr);
  return (int)cudaGetLastError();
}

}  // extern "C"
