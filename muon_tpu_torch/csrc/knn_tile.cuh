// The distance tile that T5, T40 (knn_kernels.cu) and T14 (ivf_kernels.cu)
// share.
// A block stages its queries and streams candidate tiles through shared
// memory; each warp owns 32 queries (a lane each, with its heap) and forms
// their distances to the whole tile in registers. Each distance is compared
// there with its query's bar, the root of the query's heap (every distance
// passes while it fills), fetched from the owning lane by a shuffle. Only
// the distances that pass are written, to the warp's own columns of a
// candidate-major tile in shared memory (tile[c * ld + q]), and the lanes
// holding a row OR their pass bits into the row's mask by shuffles; each
// query then takes the set bits of its mask in ascending candidate order,
// keeping what beats its root in a register buffer that the warp or the
// block inserts together. After the first tiles almost no candidate
// passes, so most tiles cost the distances and a compare each.
//
// The f32 micro-tile: the float32 cross terms of all three. The block's queries
// and the tile's candidates lie transposed in shared memory (q[u * ldq + i],
// c[u * ldc + j]), and each thread owns a TM x TN block of (query,
// candidate) pairs, whose sums it carries in registers: a step over u loads
// TM + TN values (16-byte loads) for TM * TN fmas. Each pair's sum is one
// fma chain over u in order, so it is the same float32 value as a chain
// over the pair alone.
#pragma once

#include <math.h>

// The float32 tile's geometry (T5's f32 mode, T14, T40): a block of kThreads
// threads owns kQT queries and takes kCT candidates a tile, kDK dimensions a
// chunk. Warp w owns queries 32 w + [0, 32), one a lane, and forms their
// distances to the whole tile: lane l carries the kTM x kTN micro-tile of
// queries 32 w + 8 (l % 4) + [0, 8) and candidates 4 (l / 4) + [0, 4). So the
// distances a query's heap needs never leave its warp.
namespace f32t {
constexpr int kThreads = 256;
constexpr int kQT = 256;
constexpr int kCT = 32;
constexpr int kDK = 64;
constexpr int kTM = 8, kTN = 4;
constexpr int kLdQ = kQT + 4;  // floats per row of the staged queries and of the tile
constexpr int kLdC = kCT + 4;  // floats per row of the staged candidates

// this thread's first query and first candidate in the micro-tile
__device__ __forceinline__ int micro_q(int tid) { return (tid / 32) * 32 + (tid % 4) * kTM; }
__device__ __forceinline__ int micro_c(int tid) { return ((tid % 32) / 4) * kTN; }
}  // namespace f32t

// The selection's max-heap of a query, in a scratch row of global memory
// the caller allocates (knn_heap_row entries a query). An entry is one
// 64-bit key: the distance's bits mapped to an order-preserving unsigned
// word (-0 taken as +0) above the index, so keys order as (distance,
// index) do and one compare decides. 8 children a node (node p has
// children 8p + 1 .. 8p + 8), node p at place 7 + p, so that the 8 children
// of a node fill one 64-byte-aligned group: a sift takes log8 of the heap's
// size rounds (3 at 301 places, where topk_heap.cuh's binary heap on two
// arrays takes 9), each two 32-byte sectors. At long lists the heaps of the
// queries in flight pass L2's size, so the sectors a sift reads set the
// time.
typedef unsigned long long hkey;
constexpr int kArity = 8;
constexpr int kHeapOff = 7;  // place of node 0 in a query's row

// entries of a query's heap row for k places: a multiple of 8 (64 bytes)
__host__ __device__ constexpr int knn_heap_row(int k) { return (kHeapOff + k + 7) / 8 * 8; }

__device__ __forceinline__ hkey make_key(float d, int j) {
  const unsigned b = __float_as_uint(d + 0.f);  // -0 as +0, as d < e compares
  const unsigned o = (b & 0x80000000u) ? ~b : (b | 0x80000000u);
  return ((hkey)o << 32) | (unsigned)j;
}
__device__ __forceinline__ float key_dist(hkey key) {
  const unsigned o = (unsigned)(key >> 32);
  return __uint_as_float((o & 0x80000000u) ? (o & 0x7fffffffu) : ~o);
}
__device__ __forceinline__ int key_index(hkey key) { return (int)(unsigned)key; }

// restore the max-heap of m nodes (row H, node p at H[kHeapOff + p]) below p
__device__ __forceinline__ void sift_down8(hkey* H, int m, int p) {
  const hkey x = H[kHeapOff + p];
  for (int c0 = kArity * p + 1; c0 < m; c0 = kArity * p + 1) {
    const ulonglong2* g = reinterpret_cast<const ulonglong2*>(H + kHeapOff + c0);
    hkey ch[kArity];
#pragma unroll
    for (int t = 0; t < kArity / 2; ++t) {
      const ulonglong2 v = g[t];
      ch[2 * t] = v.x;
      ch[2 * t + 1] = v.y;
    }
    hkey best = ch[0];  // child c0 is present
    int bt = 0;
#pragma unroll
    for (int t = 1; t < kArity; ++t)
      if (c0 + t < m && ch[t] > best) {
        best = ch[t];
        bt = t;
      }
    if (!(x < best)) break;
    H[kHeapOff + p] = best;
    p = c0 + bt;
  }
  H[kHeapOff + p] = x;
}

// append key to the heap of m nodes and sift it up; returns m + 1
__device__ __forceinline__ int push8(hkey* H, int m, hkey key) {
  int p = m;
  while (p > 0) {
    const int par = (p - 1) / kArity;
    const hkey up = H[kHeapOff + par];
    if (!(up < key)) break;
    H[kHeapOff + p] = up;
    p = par;
  }
  H[kHeapOff + p] = key;
  return m + 1;
}

// heap sort of the m nodes: ascending keys, nodes 0 .. m-1
__device__ __forceinline__ void sort8(hkey* H, int m) {
  for (int e = m - 1; e > 0; --e) {
    const hkey top = H[kHeapOff];
    H[kHeapOff] = H[kHeapOff + e];
    H[kHeapOff + e] = top;
    sift_down8(H, e, 0);
  }
}

// A query's running selection: its max-heap (row H), cnt nodes of k. Once
// the heap is full, thr is its root's distance; before that it is not read.
// Candidates are offered in ascending index, so a candidate enters a full
// heap only when its distance is below the root's (an equal one comes after
// the root).
struct TopK {
  hkey* H;
  int cnt;
  int k;
  float thr;

  __device__ __forceinline__ bool filling() const { return cnt < k; }

  __device__ __forceinline__ void offer(float dist, int j) {
    if (cnt < k) {  // filling: append and sift up
      cnt = push8(H, cnt, make_key(dist, j));
      if (cnt == k) thr = key_dist(H[kHeapOff]);
    } else if (dist < thr) {  // j is the largest index so far
      H[kHeapOff] = make_key(dist, j);
      sift_down8(H, k, 0);
      thr = key_dist(H[kHeapOff]);
    }
  }
  // node r of the sorted heap
  __device__ __forceinline__ hkey node(int r) const { return H[kHeapOff + r]; }
};

__device__ __forceinline__ TopK make_topk(hkey* H, int k) {
  // with k = 0 the heap is full from the start and -inf admits nothing
  return TopK{H, 0, k, -INFINITY};
}

// A query's candidates that beat its root when scanned, held in registers
// (kPending at most, in scan order) until they are inserted together with
// those of the other lanes of the block. One lane's insertion stalls its
// warp, and a block waits for its slowest warp at every barrier: inserted as
// they come, the lanes' insertions would run one after another. So the block
// inserts when, at a stage's first barrier, some lane holds kFlushAt or
// more (__syncthreads_or), every lane at once, and a warp inserts while it
// scans when some lane's buffer could not take two more. An entry is
// offered to the heap again when it is inserted, against the root of that
// moment, so the result is the same.
constexpr int kPending = 8;
constexpr int kFlushAt = kPending / 2;

struct Pending {
  float d[kPending];
  int j[kPending];
  int n;

  __device__ __forceinline__ void add(float dist, int idx) {
#pragma unroll
    for (int s = 0; s < kPending; ++s)
      if (s == n) {
        d[s] = dist;
        j[s] = idx;
      }
    ++n;
  }
  __device__ __forceinline__ void flush(TopK& h) {
#pragma unroll
    for (int s = 0; s < kPending; ++s)
      if (s < n) h.offer(d[s], j[s]);
    n = 0;
  }
};

// The bar a distance must pass to be looked at, as the warp shares it: the
// root's distance of a full heap, NaN while the heap fills, so that
// !(dist >= bar) takes every distance then (NaN and +inf included), and
// below the root otherwise (a NaN distance passes and is then refused).
__device__ __forceinline__ float shared_bar(const TopK& h) {
  return h.filling() ? __int_as_float(0x7fffffff) : h.thr;
}

// Offer this lane's candidates of one tile, the set bits of `bits` in
// ascending order (bit c: candidate j0 + c at distance dist(c)). Every lane
// of the warp calls it; a heap that is filling takes its entries at once, a
// full one through the pending buffer, and the warp inserts together when a
// lane's buffer could not take two more.
template <class Dist>
__device__ __forceinline__ void scan_bits(TopK& h, Pending& pend, unsigned long long bits,
                                          int j0, const Dist& dist) {
  while (__any_sync(0xffffffffu, bits != 0)) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      if (bits == 0) break;
      const int c = __ffsll((long long)bits) - 1;
      bits &= bits - 1;
      const float v = dist(c);
      if (h.filling())
        h.offer(v, j0 + c);
      else if (v < h.thr)
        pend.add(v, j0 + c);
    }
    if (__any_sync(0xffffffffu, pend.n > kPending - 2)) pend.flush(h);
  }
}

// acc[i][j] += q[u][i] * c[u][j] for u in [0, ulen) in order, ulen a
// multiple of 4; q and c point at this thread's first query and candidate
// of row u = 0, TM and TN multiples of 4, both 16-byte aligned.
template <int TM, int TN>
__device__ __forceinline__ void fma_microtile(float (&acc)[TM][TN], const float* q, int ldq,
                                              const float* c, int ldc, int ulen) {
  for (int u0 = 0; u0 < ulen; u0 += 4) {
#pragma unroll
    for (int u = u0; u < u0 + 4; ++u) {
      float qv[TM], cv[TN];
#pragma unroll
      for (int i = 0; i < TM; i += 4) {
        const float4 v = *reinterpret_cast<const float4*>(q + u * ldq + i);
        qv[i] = v.x;
        qv[i + 1] = v.y;
        qv[i + 2] = v.z;
        qv[i + 3] = v.w;
      }
#pragma unroll
      for (int j = 0; j < TN; j += 4) {
        const float4 v = *reinterpret_cast<const float4*>(c + u * ldc + j);
        cv[j] = v.x;
        cv[j + 1] = v.y;
        cv[j + 2] = v.z;
        cv[j + 3] = v.w;
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(qv[i], cv[j], acc[i][j]);
    }
  }
}

// The float32 tile's epilogue, in the warp that owns the queries: dist holds
// this lane's micro-tile of distances (candidates >= nvalid not offered,
// entry skip never). Each is compared with its query's bar (from the lane
// that owns the query); only the distances that pass go to the warp's
// columns of the distance tile sD (candidate-major, kLdQ), and each query
// takes the candidates of its row that passed (tid its column).
__device__ __forceinline__ void f32_tile_select(TopK& h, Pending& pend,
                                                const float (&dist)[f32t::kTM][f32t::kTN],
                                                float* sD, int mq, int mc, int tid, int nvalid,
                                                int j0, int skip) {
  using namespace f32t;
  const int lane = tid % 32;
  const float bar = shared_bar(h);
  unsigned bits[kTM];  // bit c of bits[a]: candidate c passes the bar of row a
#pragma unroll
  for (int a = 0; a < kTM; ++a) {
    const float rb = __shfl_sync(0xffffffffu, bar, (lane % 4) * kTM + a);
    bits[a] = 0;
#pragma unroll
    for (int b = 0; b < kTN; ++b)
      if (mc + b < nvalid && !(dist[a][b] >= rb)) {
        sD[(mc + b) * kLdQ + mq + a] = dist[a][b];
        bits[a] |= 1u << (mc + b);
      }
  }
  unsigned any = 0;
#pragma unroll
  for (int a = 0; a < kTM; ++a) any |= bits[a];
  if (!__any_sync(0xffffffffu, any != 0)) return;
  // the lanes with the same lane % 4 hold the same rows; this lane's query
  // is row lane of the warp, held by lane / 8
  unsigned mine = 0;
#pragma unroll
  for (int a = 0; a < kTM; ++a) {
    bits[a] |= __shfl_xor_sync(0xffffffffu, bits[a], 4);
    bits[a] |= __shfl_xor_sync(0xffffffffu, bits[a], 8);
    bits[a] |= __shfl_xor_sync(0xffffffffu, bits[a], 16);
    const unsigned v = __shfl_sync(0xffffffffu, bits[a], lane / kTM);
    if (lane % kTM == a) mine = v;
  }
  if (skip >= 0) mine &= ~(1u << skip);
  __syncwarp();
  const float* col = sD + tid;
  scan_bits(h, pend, mine, j0, [col](int c) { return col[c * kLdQ]; });
  __syncwarp();
}
