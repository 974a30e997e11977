// UMAP on the device, for Hopper (sm_90a): one SGD epoch of the layout
// optimisation per launch, and the operator of the spectral seed.
//
//   T13 umap_epoch         <- muon_tpu/ops/umap.py _optimize_layout_bucketed_fn
//                             (with its reduction _segsum_sorted)
//   T16 membership_matvec  <- muon_tpu/ops/umap.py _spectral_membership_fn
//                             (its matvec)
//   T22 umap_epoch_asym    <- muon_tpu/ops/umap.py _optimize_fn (:407), with
//                             move_other and an asymmetric graph
//   T41 umap_epoch_block   <- muon_tpu/parallel/pipeline.py _umap_epochs_fn
//                             (:691), one epoch on a rank's vertex window
//
// T13:
// One epoch of the reference's symmetric-graph SGD, in one launch: the
// attraction of every due edge, summed per head vertex; the vertex-pooled
// negatives, scaled by the vertex's expected due rate dc_exp; the
// symmetric fold (the tail update equals the head update, so it is 2x the
// head sum); and the step emb_out = emb + alpha (2 upd_h + upd_neg). The
// epoch reads emb and writes emb_out (the caller swaps the two), so every
// update of the epoch is summed from the same layout before any is applied,
// as in the reference (it is not Hogwild).
//
// Edges arrive sorted by head as one CSR over vertices (indptr), with the
// tail, eps (epochs per sample), eons (epoch of next sample, updated here)
// and shift = log2 of the edge's stride: the reference processes bucket
// b = floor(log2 eps) (clipped) only on epochs divisible by 2^b, so an edge
// is due when epoch % 2^shift == 0 and eons <= epoch + 1. Each edge belongs
// to one head, so its eons write has no race.
//
// The sums. A vertex's attraction is summed in 32 chains, the edge at place
// q of its row into chain q mod 32 in increasing q, each chain from +0; the
// chains are then added by the xor butterfly 16, 8, 4, 2, 1 (the value lane
// 0 ends with). Its negatives (lane r holds negative r, the other lanes +0)
// are added by the same butterfly. This is the order of the first design (a
// warp per vertex, lane q mod 32 walking the row), kept bit for bit. The
// per-vertex sum is direct (the reference reduces a whole bucket by a float32
// prefix sum and a boundary difference, whose rounding grows with the
// bucket's size), so the two differ by that rounding.
//
// Bound: per epoch each edge's shift is read, its eons where its stride
// runs, and a due edge's tail and eps read and eons written (5 bytes an edge
// at epoch 0, 12 more a due edge); the layout (n x dim f32, 8 MB at 1M x 2)
// stays in L2. At 1M vertices and 25.2M edges that is about 190 MB, 56 us at
// 3.35 TB/s. Most edges are not due (6% at epoch 0), so an epoch is a
// stream over shift and eons with sparse work on top.
//
// Design (2..8 components, up to 8 negatives a vertex): a block of 256
// threads takes a run of consecutive vertices from a plan the host builds
// once a graph and dim (ops/umap.epoch_plan: each run's first vertex and
// first edge): at most 128 vertices whose rows form one range of at most C
// edges (C x dim <= 6144 floats of shared memory: C = 3072 at dim 2), or
// one vertex whose row is longer, which its block walks in chunks of C. So
// the time follows the edges: every thread scans the same number of edges
// whatever the rows' lengths, and no warp waits on a vertex's chain of
// dependent loads. Four blocks share an SM (64 registers, 43 KB of shared
// memory at dim 2).
// 1. Scan: the range's eons and shift bytes, its row starts and its rows of
//    emb are copied into shared memory by cp.async, all in flight together
//    and held in no register (the eons also of edges whose stride skips the
//    epoch: 4 bytes an edge for a round trip saved). Thread t decides edges
//    t, t + 256, ...; a prefix sum of the threads' counts places its due
//    edges in a list in shared memory (the list's order is free: each entry
//    writes its own slot), and it zeroes its edges' slots of the block's
//    attraction buffer.
// 2. Due edges: the list spread over all threads, two in flight a thread:
//    tail, eps and eons, then the tail's row; the head is found by a binary
//    search of the block's row starts in shared memory and its row read from
//    shared memory; the clipped attraction goes to the edge's slot and eons
//    advances.
// 3. Sums: rows longer than 64 edges first, a warp per vertex, lane c
//    taking chain c and then the butterfly by shuffles (the long-row
//    block's warp 0 carries its chains over the chunks). Then two
//    neighbouring threads per vertex (so at most 128 vertices a run), thread
//    h taking the dims k and the negatives r with k, r = h mod 2: it
//    computes its negatives, trades their values with its partner by
//    shuffles, and for each of its dims adds the negatives' tree over 32
//    lanes (+0 beyond neg_rate) and, for rows of up to 64 edges, the row's
//    slots (0 where not due; +0 leaves a chain unchanged, which never holds
//    -0) into 32 chains in registers and their tree, and writes the
//    coordinate.
// What sets the time (exp_t13_variants.py's per-block timeline, medians on
// an H100 at the smoke's 1M graph, epoch 0): a block spends about 4,000
// cycles on its staged scan, 3,600 on its due list, 4,400 on its due edges,
// 2,500 on the warps' rows and 9,500 on its vertices, four blocks to an SM
// sharing its issue slots. The epoch takes 0.24 ms against a bound of 0.056:
// the negatives' and attractions' powf and IEEE divisions are the most of
// the arithmetic, and at an epoch where half the edges are due (epoch 8)
// the due edges' phase takes 20,000 cycles.
// More than 8 negatives a vertex take the first design's kernel
// (umap_epoch_kernel: a warp per vertex), which gives the same bits.
// powf of d2 runs only on d2 > 0 (its exponent b - 1 is negative).
//
// Components: from 9 components on a second kernel takes the number of
// components at run time: it walks the coordinates in chunks of 8, and for
// each chunk walks the vertex's edges again (a warp per vertex), reading
// every coordinate from global memory for the distance. That is dim / 8
// times the work and is meant to be right, not fast. Every sum is taken in
// the same order as above, and eons advances in the last chunk's walk only,
// so every walk sees the same due edges.
//
// T41:
// T13's run kernel on a window of the vertices: [v0, v0 + nv), a rank's
// block of the sharded layout. The window's edges (heads in the window,
// sorted by head) arrive as a CSR over the window, with their tails, eps and
// eons; dc_exp and the negatives are the window's; emb is the whole layout
// (the tails and negatives lie anywhere) and emb_out receives the window's
// new rows. The plan is ops/umap.epoch_plan's runs over the window's CSR, so
// a block's vertices are local: vertex w's row of emb is v0 + w, and a self
// hit among its negatives is v0 + w. The sharded reference has no stride
// buckets: the kernel is built without the shift (no byte an edge read), and
// an edge is due when eons <= epoch + 1. The sums are T13's, in T13's lane
// order, so the outputs are the first design's bits (umap_epoch_kernel on the
// window, which still takes more than 8 negatives, and the run-time-dim
// kernel from 9 components on). Every update of the epoch is summed from emb
// before any is applied (the reference's sum-first order), and the caller
// gathers the windows into the next layout. Bound: 4 bytes an edge for eons,
// 12 more a due edge, the window's indptr, dc_exp, negatives and rows, and
// the layout once.
//
// Interface: plain C functions (loaded with ctypes), as in
// sparse_kernels.cu. Each launches on the stream it is given, allocates
// nothing, and returns cudaGetLastError(). Outputs are allocated by the
// caller.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kWarpsPerBlock = 8;
constexpr int kMaxDim = 8;

__device__ __forceinline__ float clip4(float x) { return fminf(fmaxf(x, -4.f), 4.f); }

template <int DIM>
__device__ __forceinline__ float sq_dist(const float* d) {
  float s = __fmul_rn(d[0], d[0]);
#pragma unroll
  for (int k = 1; k < DIM; ++k) s = __fadd_rn(s, __fmul_rn(d[k], d[k]));
  return s;
}

// The vertex window [v0, v0 + nv): a warp per vertex i = v0 + w; indptr,
// dc_exp, negs and emb_out are the window's (indexed by w), emb the whole
// layout. shift == nullptr: every edge has stride 1 (T41).
template <int DIM>
__global__ void __launch_bounds__(kWarp * kWarpsPerBlock)
umap_epoch_kernel(const float* __restrict__ emb, float* __restrict__ emb_out,
                  const int* __restrict__ indptr, const int* __restrict__ tails,
                  const float* __restrict__ eps, float* __restrict__ eons,
                  const signed char* __restrict__ shift,
                  const float* __restrict__ dc_exp, const int* __restrict__ negs,
                  int v0, int nv, int neg_rate, int epoch, float alpha, float a,
                  float b, float gamma) {
  const int w = blockIdx.x * kWarpsPerBlock + threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  if (w >= nv) return;
  const int i = v0 + w;
  float ei[DIM], up[DIM], un[DIM], diff[DIM];
#pragma unroll
  for (int k = 0; k < DIM; ++k) {
    ei[k] = emb[(int64_t)i * DIM + k];
    up[k] = 0.f;
    un[k] = 0.f;
  }
  const float due_by = (float)epoch + 1.0f;
  const float c_att = -2.0f * a * b;
  const int e1 = indptr[w + 1];
  for (int e = indptr[w] + lane; e < e1; e += kWarp) {
    if (shift && (epoch & ((1 << shift[e]) - 1))) continue;  // the bucket skips this epoch
    const float eo = eons[e];
    if (!(eo <= due_by)) continue;
    const int t = tails[e];
#pragma unroll
    for (int k = 0; k < DIM; ++k) diff[k] = __fsub_rn(ei[k], emb[(int64_t)t * DIM + k]);
    const float d2 = sq_dist<DIM>(diff);
    float coeff = 0.f;
    if (d2 > 0.f)
      coeff = __fdiv_rn(__fmul_rn(c_att, powf(d2, b - 1.0f)),
                        __fadd_rn(__fmul_rn(a, powf(d2, b)), 1.0f));
#pragma unroll
    for (int k = 0; k < DIM; ++k) up[k] = __fadd_rn(up[k], clip4(__fmul_rn(coeff, diff[k])));
    eons[e] = __fadd_rn(eo, eps[e]);
  }
  if (lane < neg_rate) {
    const int j = negs[(int64_t)w * neg_rate + lane];
    if (j != i) {
#pragma unroll
      for (int k = 0; k < DIM; ++k) diff[k] = __fsub_rn(ei[k], emb[(int64_t)j * DIM + k]);
      const float d2 = sq_dist<DIM>(diff);
      if (d2 > 0.f) {
        const float coeff = __fdiv_rn(
            2.0f * gamma * b,
            __fmul_rn(__fadd_rn(0.001f, d2),
                      __fadd_rn(__fmul_rn(a, powf(d2, b)), 1.0f)));
#pragma unroll
        for (int k = 0; k < DIM; ++k) un[k] = clip4(__fmul_rn(coeff, diff[k]));
      } else {
#pragma unroll
        for (int k = 0; k < DIM; ++k) un[k] = 4.0f;  // the reference's d2 == 0 branch
      }
    }
  }
#pragma unroll
  for (int k = 0; k < DIM; ++k) {
#pragma unroll
    for (int o = kWarp / 2; o > 0; o >>= 1) {
      up[k] = __fadd_rn(up[k], __shfl_xor_sync(0xffffffffu, up[k], o));
      un[k] = __fadd_rn(un[k], __shfl_xor_sync(0xffffffffu, un[k], o));
    }
  }
  if (lane == 0) {
    const float dc = dc_exp[w];
#pragma unroll
    for (int k = 0; k < DIM; ++k)
      emb_out[(int64_t)w * DIM + k] = __fadd_rn(
          ei[k], __fmul_rn(alpha, __fadd_rn(__fmul_rn(2.0f, up[k]), __fmul_rn(un[k], dc))));
  }
}

template <int DIM>
void launch_epoch(const float* emb, float* emb_out, const int* indptr,
                  const int* tails, const float* eps, float* eons,
                  const signed char* shift, const float* dc_exp, const int* negs,
                  int v0, int nv, int neg_rate, int epoch, float alpha, float a,
                  float b, float gamma, cudaStream_t s) {
  const int blocks = (nv + kWarpsPerBlock - 1) / kWarpsPerBlock;
  umap_epoch_kernel<DIM><<<blocks, kWarp * kWarpsPerBlock, 0, s>>>(
      emb, emb_out, indptr, tails, eps, eons, shift, dc_exp, negs, v0, nv, neg_rate,
      epoch, alpha, a, b, gamma);
}

// ---------------------------------------------------------------------------
// T13 over a plan of vertex runs (2..8 components, up to 8 negatives)
// ---------------------------------------------------------------------------

constexpr int kRunThreads = 256;  // threads of a block
constexpr int kRunVertices = kRunThreads / 2;  // the most vertices it takes: two threads each
constexpr int kRunWarps = kRunThreads / kWarp;
constexpr int kThreadRow = 64;    // rows up to this long: a thread's chains; longer: a warp's
constexpr int kMaxNegRun = 8;     // negatives a vertex
constexpr int kDueBatch = 2;      // due edges in flight a thread
constexpr int kRunBlocksPerSm = 4;  // blocks an SM holds: 64 registers, 43 KB of shared memory
constexpr int kGFloats = 6144;      // the attraction buffer: C x DIM floats

// The shared memory of a block at DIM components, in 4-byte words: the
// attraction buffer (C x DIM), the run's rows of emb and the warps' sums
// (128 x DIM each), a staging area, the run's row starts (129) and the
// warps' due counts (8). The staging area holds the range's eons and shift
// bytes for the scan, then the due list (C ushorts).
template <int DIM>
struct RunShape {
  static constexpr int kScan = (kGFloats / DIM) / kRunThreads;  // edges a thread scans
  static constexpr int kEdges = kScan * kRunThreads;            // C
  static constexpr int kStage = kEdges + kEdges / 4 + 2;        // eons, then shift words
  static constexpr int kWords =
      kEdges * DIM + 2 * kRunVertices * DIM + kStage + kRunVertices + 1 + kRunWarps;
  static constexpr int kBytes = kWords * 4;
};

// The butterfly 16, 8, 4, 2, 1 as lane 0 sees it, on 32 values in registers
// (each level written out, so every index is a constant)
template <int O>
__device__ __forceinline__ void tree_level(float (&v)[kWarp]) {
#pragma unroll
  for (int l = 0; l < O; ++l) v[l] = __fadd_rn(v[l], v[l + O]);
}

__device__ __forceinline__ float lane0_tree(float (&v)[kWarp]) {
  tree_level<16>(v);
  tree_level<8>(v);
  tree_level<4>(v);
  tree_level<2>(v);
  tree_level<1>(v);
  return v[0];
}

// the clipped attraction of one due edge: head row ei, tail row et
template <int DIM>
__device__ __forceinline__ void attraction_row(const float* ei, const float* et, float c_att,
                                               float a, float b, float* g) {
  float diff[DIM];
#pragma unroll
  for (int k = 0; k < DIM; ++k) diff[k] = __fsub_rn(ei[k], et[k]);
  const float d2 = sq_dist<DIM>(diff);
  float coeff = 0.f;
  if (d2 > 0.f)
    coeff = __fdiv_rn(__fmul_rn(c_att, powf(d2, b - 1.0f)),
                      __fadd_rn(__fmul_rn(a, powf(d2, b)), 1.0f));
#pragma unroll
  for (int k = 0; k < DIM; ++k) g[k] = clip4(__fmul_rn(coeff, diff[k]));
}

// 4 bytes from global to shared memory without a register (cp.async)
__device__ __forceinline__ void copy4(void* dst, const void* src) {
  __pipeline_memcpy_async(dst, src, 4);
}

// lane r's value of a negative j of vertex i at row ei: +0 for a self hit,
// 4 at d2 = 0, else the clipped repulsion
template <int DIM>
__device__ __forceinline__ void negative_row(const float* ei, const float* __restrict__ emb,
                                             int i, int j, float a, float b, float gamma,
                                             float* un) {
#pragma unroll
  for (int k = 0; k < DIM; ++k) un[k] = 0.f;
  if (j == i) return;
  float diff[DIM];
#pragma unroll
  for (int k = 0; k < DIM; ++k) diff[k] = __fsub_rn(ei[k], emb[(int64_t)j * DIM + k]);
  const float d2 = sq_dist<DIM>(diff);
  if (d2 > 0.f) {
    const float coeff = __fdiv_rn(
        2.0f * gamma * b,
        __fmul_rn(__fadd_rn(0.001f, d2), __fadd_rn(__fmul_rn(a, powf(d2, b)), 1.0f)));
#pragma unroll
    for (int k = 0; k < DIM; ++k) un[k] = clip4(__fmul_rn(coeff, diff[k]));
  } else {
#pragma unroll
    for (int k = 0; k < DIM; ++k) un[k] = 4.0f;  // the reference's d2 == 0 branch
  }
}

// The vertex window [v0, v0 + n): the plan, indptr, dc_exp, negs and
// emb_out are the window's (indexed by w), its vertex w is row v0 + w of emb
// (T13: v0 = 0, the whole layout). SHIFT: each edge's stride is read from
// shift; without it every edge has stride 1 (T41) and no shift is read.
template <int DIM, bool SHIFT = true>
__global__ void __launch_bounds__(kRunThreads, kRunBlocksPerSm)
umap_epoch_runs_kernel(const float* __restrict__ emb, float* __restrict__ emb_out,
                       const int* __restrict__ indptr, const int* __restrict__ tails,
                       const float* __restrict__ eps, float* __restrict__ eons,
                       const signed char* __restrict__ shift,
                       const float* __restrict__ dc_exp, const int* __restrict__ negs,
                       const int2* __restrict__ plan, int v0, int neg_rate, int epoch,
                       float alpha, float a, float b, float gamma) {
  using Shape = RunShape<DIM>;
  constexpr int C = Shape::kEdges;
  constexpr int kScan = Shape::kScan;
  extern __shared__ __align__(16) float smem[];
  float* s_g = smem;                                   // attractions, 0 where not due
  float* s_ei = s_g + C * DIM;                         // the run's rows of emb
  float* s_up = s_ei + kRunVertices * DIM;             // the warps' rows' sums
  float* s_stage = s_up + kRunVertices * DIM;
  float* s_eo = s_stage;                               // scan: the range's eons
  signed char* s_sh = reinterpret_cast<signed char*>(s_stage + C);  // scan: shift words
  unsigned short* s_due = reinterpret_cast<unsigned short*>(s_stage);  // the due list
  int* s_ptr = reinterpret_cast<int*>(s_stage + Shape::kStage);     // the run's row starts
  int* s_wdue = s_ptr + kRunVertices + 1;                            // the warps' due counts

  const int tid = threadIdx.x, lane = tid % kWarp, warp = tid / kWarp;
  const int2 p0 = plan[blockIdx.x], p1 = plan[blockIdx.x + 1];  // (first vertex, first edge)
  const int vb0 = p0.x, nv = p1.x - p0.x, E0 = p0.y, E1 = p1.y;
  const bool chunked = E1 - E0 > C;  // one vertex's row, walked in chunks of C
  if (nv < 0 || nv > kRunVertices || (chunked && nv != 1)) __trap();  // not a plan for DIM
  for (int t = tid; t <= nv; t += kRunThreads) copy4(s_ptr + t, indptr + vb0 + t);
  for (int t = tid; t < nv * DIM; t += kRunThreads)
    copy4(s_ei + t, emb + (int64_t)(v0 + vb0) * DIM + t);

  const float due_by = (float)epoch + 1.0f;
  const float c_att = -2.0f * a * b;
  float chain[DIM];  // a chunked row's chains (warp 0)
#pragma unroll
  for (int k = 0; k < DIM; ++k) chain[k] = 0.f;
  for (int c0 = E0; c0 < E1; c0 += C) {
    const int n = min(C, E1 - c0);
    // 1. scan: the range's eons and shift bytes staged in shared memory, all
    // in flight together (the shift as the aligned words around the range,
    // bytes past its end read one by one)
    const int w0 = c0 & ~3, nw = (c0 + n - w0 + 3) / 4;
    for (int off = tid; off < n; off += kRunThreads) copy4(s_eo + off, eons + c0 + off);
    for (int w = tid; SHIFT && w < nw; w += kRunThreads) {
      const int at = w0 + 4 * w;
      if (at + 4 <= c0 + n) {
        copy4(s_sh + 4 * w, shift + at);
      } else {
        for (int q = at; q < c0 + n; ++q) s_sh[4 * w + q - at] = shift[q];
      }
    }
    __pipeline_commit();
    __pipeline_wait_prior(0);
    __syncthreads();  // the staged range, s_ptr, s_ei; a chunked row's previous chains
    unsigned due = 0u;  // bit j: edge tid + 256 j runs this epoch and is due
#pragma unroll
    for (int j = 0; j < kScan; ++j) {
      const int off = tid + j * kRunThreads;
      if (off < n) {
        const bool runs = !SHIFT || !(epoch & ((1 << s_sh[c0 - w0 + off]) - 1));
        if (runs && s_eo[off] <= due_by) due |= 1u << j;
      }
    }
    // the due list by a prefix sum of the threads' counts (its order is free:
    // each entry writes its own slot)
    int before = __popc(due);
#pragma unroll
    for (int o = 1; o < kWarp; o <<= 1) {
      const int x = __shfl_up_sync(0xffffffffu, before, o);
      if (lane >= o) before += x;
    }
    if (lane == kWarp - 1) s_wdue[warp] = before;
    before -= __popc(due);
    __syncthreads();  // the staging area turns into the due list
    int nd = 0;
#pragma unroll
    for (int w = 0; w < kRunWarps; ++w) {
      const int c = s_wdue[w];
      before += w < warp ? c : 0;
      nd += c;
    }
#pragma unroll
    for (int j = 0; j < kScan; ++j) {
      const int off = tid + j * kRunThreads;
      if (off < n) {
#pragma unroll
        for (int k = 0; k < DIM; ++k) s_g[off * DIM + k] = 0.f;
      }
      if ((due >> j) & 1u) s_due[before++] = (unsigned short)off;
    }
    __syncthreads();
    // 2. the due edges, kDueBatch in flight a thread
    for (int q0 = tid; q0 < nd; q0 += kDueBatch * kRunThreads) {
      int off[kDueBatch], t[kDueBatch];
      float ep[kDueBatch], eq[kDueBatch], et[kDueBatch][DIM];
#pragma unroll
      for (int u = 0; u < kDueBatch; ++u) {
        const int q = q0 + u * kRunThreads;
        off[u] = q < nd ? (int)s_due[q] : -1;
        if (off[u] >= 0) {
          t[u] = tails[c0 + off[u]];
          ep[u] = eps[c0 + off[u]];
          eq[u] = eons[c0 + off[u]];
        }
      }
#pragma unroll
      for (int u = 0; u < kDueBatch; ++u) {
        if (off[u] >= 0) {
#pragma unroll
          for (int k = 0; k < DIM; ++k) et[u][k] = emb[(int64_t)t[u] * DIM + k];
        }
      }
#pragma unroll
      for (int u = 0; u < kDueBatch; ++u) {
        if (off[u] < 0) continue;
        const int e = c0 + off[u];
        int lo = 0, hi = nv;  // s_ptr[lo] <= e < s_ptr[hi]: the edge's head
        while (hi - lo > 1) {
          const int mid = (lo + hi) >> 1;
          if (s_ptr[mid] <= e) lo = mid; else hi = mid;
        }
        float g[DIM];
        attraction_row<DIM>(s_ei + lo * DIM, et[u], c_att, a, b, g);
#pragma unroll
        for (int k = 0; k < DIM; ++k) s_g[off[u] * DIM + k] = g[k];
        eons[e] = __fadd_rn(eq[u], ep[u]);
      }
    }
    __syncthreads();
    if (chunked && warp == 0) {  // chunks start at multiples of C, a multiple of 32
      for (int q = lane; q < n; q += kWarp) {
#pragma unroll
        for (int k = 0; k < DIM; ++k) chain[k] = __fadd_rn(chain[k], s_g[q * DIM + k]);
      }
    }
  }
  if (E0 == E1) {  // no edges: s_ptr and s_ei not waited for yet
    __pipeline_commit();
    __pipeline_wait_prior(0);
    __syncthreads();
  }

  // 3. rows longer than kThreadRow: a warp each, into s_up
  if (chunked) {
    if (warp == 0) {
#pragma unroll
      for (int k = 0; k < DIM; ++k) {
#pragma unroll
        for (int o = kWarp / 2; o > 0; o >>= 1)
          chain[k] = __fadd_rn(chain[k], __shfl_xor_sync(0xffffffffu, chain[k], o));
        if (lane == 0) s_up[k] = chain[k];
      }
    }
  } else {
    for (int v = warp; v < nv; v += kRunWarps) {
      const int r0 = s_ptr[v] - E0, L = s_ptr[v + 1] - s_ptr[v];
      if (L <= kThreadRow) continue;
      float c[DIM];
#pragma unroll
      for (int k = 0; k < DIM; ++k) c[k] = 0.f;
      for (int q = lane; q < L; q += kWarp) {
#pragma unroll
        for (int k = 0; k < DIM; ++k) c[k] = __fadd_rn(c[k], s_g[(r0 + q) * DIM + k]);
      }
#pragma unroll
      for (int k = 0; k < DIM; ++k) {
#pragma unroll
        for (int o = kWarp / 2; o > 0; o >>= 1)
          c[k] = __fadd_rn(c[k], __shfl_xor_sync(0xffffffffu, c[k], o));
        if (lane == 0) s_up[v * DIM + k] = c[k];
      }
    }
  }
  __syncthreads();

  // two neighbouring threads per vertex: thread h of the pair takes the
  // dims k and the negatives r with k, r = h mod 2; the pair trades its
  // negatives' values by one shuffle each, so every thread of a warp runs
  // the shuffles (a thread past the run's vertices computes on nothing)
  const int vt = tid / 2, h = tid % 2;
  const bool live = vt < nv;
  const int w = vb0 + vt, i = v0 + w;  // the vertex in the window and in emb
  float ei[DIM];
#pragma unroll
  for (int k = 0; k < DIM; ++k) ei[k] = live ? s_ei[vt * DIM + k] : 0.f;
  constexpr int kHalf = kMaxNegRun / 2;
  float un[kHalf][DIM];  // lane 2 s + h's value of negative 2 s + h (+0 from neg_rate on)
#pragma unroll
  for (int q = 0; q < kHalf; ++q) {
    const int r = 2 * q + h;
    negative_row<DIM>(ei, emb, i, live && r < neg_rate ? negs[(int64_t)w * neg_rate + r] : i, a,
                      b, gamma, un[q]);
  }
  const int r0 = live ? s_ptr[vt] - E0 : 0, L = live ? s_ptr[vt + 1] - s_ptr[vt] : 0;
  const bool own = !chunked && L <= kThreadRow;
  const float dc = live ? dc_exp[w] : 0.f;
#pragma unroll
  for (int k = 0; k < DIM; ++k) {
    // this thread's lanes of the negatives' tree, and its partner's
    float v[kWarp];
#pragma unroll
    for (int l = 0; l < kWarp; ++l) v[l] = 0.f;
#pragma unroll
    for (int q = 0; q < kHalf; ++q) {
      const float mine = un[q][k], other = __shfl_xor_sync(0xffffffffu, un[q][k], 1);
      v[2 * q] = h ? other : mine;
      v[2 * q + 1] = h ? mine : other;
    }
    if (k % 2 != h || !live) continue;
    const float neg = lane0_tree(v);
    float up;
    if (own) {  // chain c: places c and c + 32 of the row, from +0
#pragma unroll
      for (int c = 0; c < kWarp; ++c) {
        v[c] = 0.f;
        if (c < L) v[c] = __fadd_rn(v[c], s_g[(r0 + c) * DIM + k]);
      }
      if (L > kWarp) {
#pragma unroll
        for (int c = 0; c < kWarp; ++c)
          if (c + kWarp < L) v[c] = __fadd_rn(v[c], s_g[(r0 + kWarp + c) * DIM + k]);
      }
      up = lane0_tree(v);
    } else {
      up = s_up[vt * DIM + k];
    }
    emb_out[(int64_t)w * DIM + k] = __fadd_rn(
        ei[k], __fmul_rn(alpha, __fadd_rn(__fmul_rn(2.0f, up), __fmul_rn(neg, dc))));
  }
}

// squared distance of rows i and j of emb, coordinates in index order
__device__ __forceinline__ float sq_dist_rows(const float* __restrict__ emb, int64_t i,
                                              int64_t j, int dim) {
  const float* x = emb + i * dim;
  const float* y = emb + j * dim;
  float d0 = __fsub_rn(x[0], y[0]);
  float s = __fmul_rn(d0, d0);
  for (int k = 1; k < dim; ++k) {
    const float dk = __fsub_rn(x[k], y[k]);
    s = __fadd_rn(s, __fmul_rn(dk, dk));
  }
  return s;
}

// T13 for any number of components (the wrapper takes it from 9 on): the
// coordinates in chunks of kMaxDim, the edges walked once per chunk
__global__ void __launch_bounds__(kWarp * kWarpsPerBlock)
umap_epoch_any_dim_kernel(const float* __restrict__ emb, float* __restrict__ emb_out,
                          const int* __restrict__ indptr, const int* __restrict__ tails,
                          const float* __restrict__ eps, float* __restrict__ eons,
                          const signed char* __restrict__ shift,
                          const float* __restrict__ dc_exp, const int* __restrict__ negs,
                          int v0, int nv, int dim, int neg_rate, int epoch, float alpha,
                          float a, float b, float gamma) {
  const int w = blockIdx.x * kWarpsPerBlock + threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  if (w >= nv) return;
  const int i = v0 + w;
  const float due_by = (float)epoch + 1.0f;
  const float c_att = -2.0f * a * b;
  const int e0 = indptr[w], e1 = indptr[w + 1];
  const float* xi = emb + (int64_t)i * dim;
  for (int k0 = 0; k0 < dim; k0 += kMaxDim) {
    const int kc = min(kMaxDim, dim - k0);
    const bool last = k0 + kMaxDim >= dim;
    float up[kMaxDim], un[kMaxDim];
#pragma unroll
    for (int k = 0; k < kMaxDim; ++k) up[k] = un[k] = 0.f;
    for (int e = e0 + lane; e < e1; e += kWarp) {
      if (shift && (epoch & ((1 << shift[e]) - 1))) continue;
      const float eo = eons[e];
      if (!(eo <= due_by)) continue;
      const int t = tails[e];
      const float d2 = sq_dist_rows(emb, i, t, dim);
      float coeff = 0.f;
      if (d2 > 0.f)
        coeff = __fdiv_rn(__fmul_rn(c_att, powf(d2, b - 1.0f)),
                          __fadd_rn(__fmul_rn(a, powf(d2, b)), 1.0f));
      const float* xt = emb + (int64_t)t * dim;
#pragma unroll
      for (int k = 0; k < kMaxDim; ++k)
        if (k < kc)
          up[k] = __fadd_rn(up[k], clip4(__fmul_rn(coeff, __fsub_rn(xi[k0 + k], xt[k0 + k]))));
      if (last) eons[e] = __fadd_rn(eo, eps[e]);
    }
    if (lane < neg_rate) {
      const int j = negs[(int64_t)w * neg_rate + lane];
      if (j != i) {
        const float d2 = sq_dist_rows(emb, i, j, dim);
        if (d2 > 0.f) {
          const float coeff = __fdiv_rn(
              2.0f * gamma * b,
              __fmul_rn(__fadd_rn(0.001f, d2),
                        __fadd_rn(__fmul_rn(a, powf(d2, b)), 1.0f)));
          const float* xj = emb + (int64_t)j * dim;
#pragma unroll
          for (int k = 0; k < kMaxDim; ++k)
            if (k < kc) un[k] = clip4(__fmul_rn(coeff, __fsub_rn(xi[k0 + k], xj[k0 + k])));
        } else {
#pragma unroll
          for (int k = 0; k < kMaxDim; ++k) un[k] = 4.0f;  // the reference's d2 == 0 branch
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kMaxDim; ++k) {
#pragma unroll
      for (int o = kWarp / 2; o > 0; o >>= 1) {
        up[k] = __fadd_rn(up[k], __shfl_xor_sync(0xffffffffu, up[k], o));
        un[k] = __fadd_rn(un[k], __shfl_xor_sync(0xffffffffu, un[k], o));
      }
    }
    if (lane == 0) {
      const float dc = dc_exp[w];
#pragma unroll
      for (int k = 0; k < kMaxDim; ++k)
        if (k < kc)
          emb_out[(int64_t)w * dim + k0 + k] = __fadd_rn(
              xi[k0 + k],
              __fmul_rn(alpha, __fadd_rn(__fmul_rn(2.0f, up[k]), __fmul_rn(un[k], dc))));
    }
  }
}

// ---------------------------------------------------------------------------
// T22: one epoch of the reference's SGD on an asymmetric graph. The tail of
// an edge no longer mirrors a head edge, so the tail update is a pass of its
// own: emb_out = emb + alpha (upd_h + upd_neg) - alpha upd_t, where upd_h
// sums the clipped attraction g(e) of the due edges by head, upd_t the same
// g(e) by tail, and upd_neg the vertex-pooled negatives times the vertex's
// count of due head edges this epoch (an integer, not T13's expected rate).
// No stride buckets: an edge is due when eons <= epoch + 1.
//
// A warp per vertex, as T13, with the coordinates walked in chunks of 8 (any
// dim; one chunk up to 8). The head pass walks the vertex's head-sorted
// edges; the tail pass walks the edges whose tail it is, in the tail-sorted
// order t_order (a CSR over tails, t_indptr), and recomputes g(e) from the
// unchanged emb with the head's coordinates, so no E x dim buffer of g is
// kept. The due decision of both passes reads eons; the advanced eons go to
// eons_out (the caller swaps the two, as it swaps emb): a tail pass reading
// an eons that another warp's head pass had already advanced would see the
// edge not due. Every edge belongs to one head, so eons_out is written once
// per edge, due or not.
//
// Bound: per epoch each edge's eons is read twice and written once, its
// tail, head and order index read, eps read when due: about 24 bytes an
// edge; the layout stays in L2. Tail rows are gathered in another order than
// head rows, which the direct sums pay for in scattered reads of emb.
// ---------------------------------------------------------------------------

__device__ __forceinline__ float attraction(float d2, float c_att, float b, float a) {
  return d2 > 0.f ? __fdiv_rn(__fmul_rn(c_att, powf(d2, b - 1.0f)),
                              __fadd_rn(__fmul_rn(a, powf(d2, b)), 1.0f))
                  : 0.f;
}

__global__ void __launch_bounds__(kWarp * kWarpsPerBlock)
umap_epoch_asym_kernel(const float* __restrict__ emb, float* __restrict__ emb_out,
                       const int* __restrict__ indptr, const int* __restrict__ heads,
                       const int* __restrict__ tails, const float* __restrict__ eps,
                       const float* __restrict__ eons, float* __restrict__ eons_out,
                       const int* __restrict__ t_indptr, const int* __restrict__ t_order,
                       const int* __restrict__ negs, int n, int dim, int neg_rate,
                       int epoch, float alpha, float a, float b, float gamma) {
  const int i = blockIdx.x * kWarpsPerBlock + threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  if (i >= n) return;
  const float due_by = (float)epoch + 1.0f;
  const float c_att = -2.0f * a * b;
  const int e0 = indptr[i], e1 = indptr[i + 1];
  const int p0 = t_indptr[i], p1 = t_indptr[i + 1];
  const float* xi = emb + (int64_t)i * dim;
  int due_cnt = 0;
  for (int e = e0 + lane; e < e1; e += kWarp) {
    const float eo = eons[e];
    const bool due = eo <= due_by;
    due_cnt += due;
    eons_out[e] = due ? __fadd_rn(eo, eps[e]) : eo;
  }
#pragma unroll
  for (int o = kWarp / 2; o > 0; o >>= 1) due_cnt += __shfl_xor_sync(0xffffffffu, due_cnt, o);
  const float dc = (float)due_cnt;
  for (int k0 = 0; k0 < dim; k0 += kMaxDim) {
    const int kc = min(kMaxDim, dim - k0);
    float up[kMaxDim], ut[kMaxDim], un[kMaxDim];
#pragma unroll
    for (int k = 0; k < kMaxDim; ++k) up[k] = ut[k] = un[k] = 0.f;
    for (int e = e0 + lane; e < e1; e += kWarp) {
      if (!(eons[e] <= due_by)) continue;
      const int t = tails[e];
      const float coeff = attraction(sq_dist_rows(emb, i, t, dim), c_att, b, a);
      const float* xt = emb + (int64_t)t * dim;
#pragma unroll
      for (int k = 0; k < kMaxDim; ++k)
        if (k < kc)
          up[k] = __fadd_rn(up[k], clip4(__fmul_rn(coeff, __fsub_rn(xi[k0 + k], xt[k0 + k]))));
    }
    for (int p = p0 + lane; p < p1; p += kWarp) {
      const int e = t_order[p];
      if (!(eons[e] <= due_by)) continue;
      const int h = heads[e];
      const float coeff = attraction(sq_dist_rows(emb, h, i, dim), c_att, b, a);
      const float* xh = emb + (int64_t)h * dim;
#pragma unroll
      for (int k = 0; k < kMaxDim; ++k)
        if (k < kc)
          ut[k] = __fadd_rn(ut[k], clip4(__fmul_rn(coeff, __fsub_rn(xh[k0 + k], xi[k0 + k]))));
    }
    if (lane < neg_rate) {
      const int j = negs[(int64_t)i * neg_rate + lane];
      if (j != i) {
        const float d2 = sq_dist_rows(emb, i, j, dim);
        if (d2 > 0.f) {
          const float coeff = __fdiv_rn(
              2.0f * gamma * b,
              __fmul_rn(__fadd_rn(0.001f, d2),
                        __fadd_rn(__fmul_rn(a, powf(d2, b)), 1.0f)));
          const float* xj = emb + (int64_t)j * dim;
#pragma unroll
          for (int k = 0; k < kMaxDim; ++k)
            if (k < kc) un[k] = clip4(__fmul_rn(coeff, __fsub_rn(xi[k0 + k], xj[k0 + k])));
        } else {
#pragma unroll
          for (int k = 0; k < kMaxDim; ++k) un[k] = 4.0f;  // the reference's d2 == 0 branch
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kMaxDim; ++k) {
#pragma unroll
      for (int o = kWarp / 2; o > 0; o >>= 1) {
        up[k] = __fadd_rn(up[k], __shfl_xor_sync(0xffffffffu, up[k], o));
        ut[k] = __fadd_rn(ut[k], __shfl_xor_sync(0xffffffffu, ut[k], o));
        un[k] = __fadd_rn(un[k], __shfl_xor_sync(0xffffffffu, un[k], o));
      }
    }
    if (lane == 0) {
#pragma unroll
      for (int k = 0; k < kMaxDim; ++k)
        if (k < kc)
          emb_out[(int64_t)i * dim + k0 + k] = __fsub_rn(
              __fadd_rn(xi[k0 + k], __fmul_rn(alpha, __fadd_rn(up[k], __fmul_rn(un[k], dc)))),
              __fmul_rn(alpha, ut[k]));
    }
  }
}

// ---------------------------------------------------------------------------
// T16: Y = s . ((W + W^T)(s . Q)), one application of the normalised
// operator D^-1/2 (W + W^T) D^-1/2 of the spectral seed, for m <= 16
// columns. W is the directed (n, k) membership table: row i holds vals[i, p]
// at column idx[i, p], already zeroed where idx < 0 or idx == i. W X is a
// fixed-width gather along the row. For W^T X the reference scatters with a
// segment sum; here the table comes a second time, transposed (its entries
// sorted by target once per seed, a CSR over the targets: t_indptr, t_src,
// t_val), so W^T X is a second gather and every row's sum is taken in a
// fixed order: no atomics, the same seed in every run.
//
// Layout: kLanes = 16 lanes per row, lane c owning column c (lanes >= m
// idle), 16 rows per block. The lanes of a row read idx/vals as broadcasts
// and a source row of Q (m floats, 40 bytes at m = 10) side by side. The
// function is bound by its bytes: idx, vals, s, Q and Y once, about 0.25 GB
// at 1M x 20, m = 10. This design moves more, about 0.4 GB: the second
// table (t_src, t_val, another 8 bytes per entry) is its own choice and no
// part of the bound; the gathered rows of Q (40 MB) mostly hit L2.
// ---------------------------------------------------------------------------

constexpr int kLanes = 16;
constexpr int kRowsPerBlock = 16;

__global__ void __launch_bounds__(kLanes * kRowsPerBlock)
membership_matvec_kernel(const int* __restrict__ idx, const float* __restrict__ vals,
                         const int* __restrict__ t_indptr,
                         const int* __restrict__ t_src,
                         const float* __restrict__ t_val, const float* __restrict__ s,
                         const float* __restrict__ Q, int n, int k, int m,
                         float* __restrict__ Y) {
  const int i = blockIdx.x * kRowsPerBlock + threadIdx.x / kLanes;
  const int c = threadIdx.x % kLanes;
  if (i >= n || c >= m) return;
  float y1 = 0.f, y2 = 0.f;
  const int64_t base = (int64_t)i * k;
  for (int p = 0; p < k; ++p) {
    const float v = vals[base + p];
    if (v == 0.f) continue;  // also every masked slot
    const int j = idx[base + p];
    y1 = fmaf(v, __fmul_rn(Q[(int64_t)j * m + c], s[j]), y1);
  }
  const int e1 = t_indptr[i + 1];
  for (int e = t_indptr[i]; e < e1; ++e) {
    const int j = t_src[e];
    y2 = fmaf(t_val[e], __fmul_rn(Q[(int64_t)j * m + c], s[j]), y2);
  }
  Y[(int64_t)i * m + c] = __fmul_rn(__fadd_rn(y1, y2), s[i]);
}

// One epoch of T13's SGD on the vertex window [v0, v0 + nv) (T13: the window
// [0, n); T41: a rank's block, no shift).
int epoch_window(const float* emb, float* emb_out, const int* indptr, const int* tails,
                 const float* eps, float* eons, const signed char* shift,
                 const float* dc_exp, const int* negs, int v0, int nv, int dim,
                 int neg_rate, int epoch, float alpha, float a, float b, float gamma,
                 cudaStream_t s) {
  if (nv <= 0) return (int)cudaGetLastError();
  if (dim < 2 || neg_rate < 0 || neg_rate > kWarp || v0 < 0) return (int)cudaErrorInvalidValue;
  if (dim > kMaxDim) {
    const int blocks = (nv + kWarpsPerBlock - 1) / kWarpsPerBlock;
    umap_epoch_any_dim_kernel<<<blocks, kWarp * kWarpsPerBlock, 0, s>>>(
        emb, emb_out, indptr, tails, eps, eons, shift, dc_exp, negs, v0, nv, dim, neg_rate,
        epoch, alpha, a, b, gamma);
    return (int)cudaGetLastError();
  }
#define MT_UMAP_DIM(D)                                                        \
  case D:                                                                     \
    launch_epoch<D>(emb, emb_out, indptr, tails, eps, eons, shift, dc_exp,    \
                    negs, v0, nv, neg_rate, epoch, alpha, a, b, gamma, s);    \
    break;
  switch (dim) {
    MT_UMAP_DIM(2)
    MT_UMAP_DIM(3)
    MT_UMAP_DIM(4)
    MT_UMAP_DIM(5)
    MT_UMAP_DIM(6)
    MT_UMAP_DIM(7)
    MT_UMAP_DIM(8)
  }
#undef MT_UMAP_DIM
  return (int)cudaGetLastError();
}

// One epoch of the run kernel over the plan's n_blocks runs of the window
// [v0, ...) (T13: v0 = 0 with the strides of shift; T41: no shift).
template <bool SHIFT>
int epoch_runs(const float* emb, float* emb_out, const int* indptr, const int* tails,
               const float* eps, float* eons, const signed char* shift, const float* dc_exp,
               const int* negs, const int* plan, int n_blocks, int v0, int dim, int neg_rate,
               int epoch, float alpha, float a, float b, float gamma, cudaStream_t s) {
  if (dim < 2 || neg_rate < 0 || n_blocks <= 0 || v0 < 0) return (int)cudaErrorInvalidValue;
#define MT_UMAP_RUNS(D)                                                                  \
  case D: {                                                                              \
    static const cudaError_t ok = cudaFuncSetAttribute(                                  \
        umap_epoch_runs_kernel<D, SHIFT>, cudaFuncAttributeMaxDynamicSharedMemorySize,   \
        RunShape<D>::kBytes);                                                            \
    if (ok != cudaSuccess) return (int)ok;                                               \
    umap_epoch_runs_kernel<D, SHIFT><<<n_blocks, kRunThreads, RunShape<D>::kBytes, s>>>( \
        emb, emb_out, indptr, tails, eps, eons, shift, dc_exp, negs,                     \
        reinterpret_cast<const int2*>(plan), v0, neg_rate, epoch, alpha, a, b, gamma);   \
    break;                                                                               \
  }
  switch (dim) {
    MT_UMAP_RUNS(2)
    MT_UMAP_RUNS(3)
    MT_UMAP_RUNS(4)
    MT_UMAP_RUNS(5)
    MT_UMAP_RUNS(6)
    MT_UMAP_RUNS(7)
    MT_UMAP_RUNS(8)
  }
#undef MT_UMAP_RUNS
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The edges a block of T13's run kernel holds at dim components (2..8; 0
// otherwise): ops/umap.epoch_plan cuts the rows by it.
int mt_umap_epoch_block_edges(int dim) {
  switch (dim) {
    case 2: return RunShape<2>::kEdges;
    case 3: return RunShape<3>::kEdges;
    case 4: return RunShape<4>::kEdges;
    case 5: return RunShape<5>::kEdges;
    case 6: return RunShape<6>::kEdges;
    case 7: return RunShape<7>::kEdges;
    case 8: return RunShape<8>::kEdges;
    default: return 0;
  }
}

// T13. emb (n x dim) f32 in, emb_out (n x dim) f32 out; indptr (n+1) int32
// over the head-sorted edges; tails (E) int32; eps (E) f32; eons (E) f32,
// updated in place; shift (E) int8, 0 <= shift < 31; dc_exp (n) f32; negs
// (n x neg_rate) int32, 0 <= neg_rate <= 32; dim >= 2. plan (n_blocks + 1)
// int32, ops/umap.epoch_plan's runs of vertices for this dim, takes the run
// kernel at 2..8 components and up to 8 negatives; without a plan, with
// more negatives, the first design's kernel; from 9 components on the
// kernel that takes dim at run time.
int mt_umap_epoch(const float* emb, float* emb_out, const int* indptr,
                  const int* tails, const float* eps, float* eons,
                  const signed char* shift, const float* dc_exp, const int* negs,
                  const int* plan, int n_blocks, int n, int dim, int neg_rate, int epoch,
                  float alpha, float a, float b, float gamma, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n <= 0) return (int)cudaGetLastError();
  if (plan == nullptr || shift == nullptr || dim > kMaxDim || neg_rate > kMaxNegRun)
    return epoch_window(emb, emb_out, indptr, tails, eps, eons, shift, dc_exp, negs, 0, n,
                        dim, neg_rate, epoch, alpha, a, b, gamma, s);
  return epoch_runs<true>(emb, emb_out, indptr, tails, eps, eons, shift, dc_exp, negs, plan,
                          n_blocks, 0, dim, neg_rate, epoch, alpha, a, b, gamma, s);
}

// T41. emb (n x dim) f32, the whole layout; the window [v0, v0 + nv) of it:
// indptr (nv+1) int32 over its edges, tails (global ids), eps and eons (E_w,)
// f32, dc_exp (nv,) f32, negs (nv x neg_rate) int32; out_blk (nv x dim) f32
// out, not aliasing emb. plan (n_blocks + 1) int32 pairs, ops/umap.epoch_plan's
// runs of the window's vertices, takes T13's run kernel at 2..8 components
// and up to 8 negatives; without a plan, with more negatives or from 9
// components on, the first design's kernels, as mt_umap_epoch.
int mt_umap_epoch_block(const float* emb, float* out_blk, const int* indptr,
                        const int* tails, const float* eps, float* eons,
                        const float* dc_exp, const int* negs, const int* plan, int n_blocks,
                        int v0, int nv, int dim, int neg_rate, int epoch, float alpha,
                        float a, float b, float gamma, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (nv <= 0) return (int)cudaGetLastError();
  if (plan == nullptr || dim > kMaxDim || neg_rate > kMaxNegRun)
    return epoch_window(emb, out_blk, indptr, tails, eps, eons, nullptr, dc_exp, negs, v0,
                        nv, dim, neg_rate, epoch, alpha, a, b, gamma, s);
  return epoch_runs<false>(emb, out_blk, indptr, tails, eps, eons, nullptr, dc_exp, negs,
                           plan, n_blocks, v0, dim, neg_rate, epoch, alpha, a, b, gamma, s);
}

// T22. emb (n x dim) f32 in, emb_out (n x dim) f32 out; indptr (n+1) int32
// over the head-sorted edges; heads, tails (E) int32; eps (E) f32; eons (E)
// f32 in, eons_out (E) f32 out; t_indptr (n+1) int32 over the edges sorted
// by tail, t_order (E) int32 their indices; negs (n x neg_rate) int32,
// 0 <= neg_rate <= 32; dim >= 2.
int mt_umap_epoch_asym(const float* emb, float* emb_out, const int* indptr,
                       const int* heads, const int* tails, const float* eps,
                       const float* eons, float* eons_out, const int* t_indptr,
                       const int* t_order, const int* negs, int n, int dim, int neg_rate,
                       int epoch, float alpha, float a, float b, float gamma,
                       void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n <= 0) return (int)cudaGetLastError();
  if (dim < 2 || neg_rate < 0 || neg_rate > kWarp) return (int)cudaErrorInvalidValue;
  const int blocks = (n + kWarpsPerBlock - 1) / kWarpsPerBlock;
  umap_epoch_asym_kernel<<<blocks, kWarp * kWarpsPerBlock, 0, s>>>(
      emb, emb_out, indptr, heads, tails, eps, eons, eons_out, t_indptr, t_order, negs, n,
      dim, neg_rate, epoch, alpha, a, b, gamma);
  return (int)cudaGetLastError();
}

// T16. idx (n x k) int32 and vals (n x k) f32, vals zero wherever idx < 0 or
// idx == row; t_indptr (n+1) int32 over the entries sorted by target, t_src
// (nnz) int32 their source rows, t_val (nnz) f32; s (n) f32; Q (n x m) f32
// in, Y (n x m) f32 out, 1 <= m <= 16.
int mt_membership_matvec(const int* idx, const float* vals, const int* t_indptr,
                         const int* t_src, const float* t_val, const float* s,
                         const float* Q, int n, int k, int m, float* Y,
                         void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (n <= 0) return (int)cudaGetLastError();
  if (m < 1 || m > kLanes || k < 0) return (int)cudaErrorInvalidValue;
  const int blocks = (n + kRowsPerBlock - 1) / kRowsPerBlock;
  membership_matvec_kernel<<<blocks, kLanes * kRowsPerBlock, 0, st>>>(
      idx, vals, t_indptr, t_src, t_val, s, Q, n, k, m, Y);
  return (int)cudaGetLastError();
}

}  // extern "C"
