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
// Layout: a warp per vertex. Its lanes walk the vertex's edges, each
// summing the clipped gradients of its due edges in registers, then a
// butterfly sums the lanes; lanes 0..neg_rate-1 take one negative each.
// The per-vertex sum is direct (the reference reduces a whole bucket by a
// float32 prefix sum and a boundary difference, whose rounding grows with
// the bucket's size), so the two differ by that rounding.
//
// Bound: per epoch, each edge's tail, eps, eons and shift are read and
// the eons of due edges written (about 17 bytes an edge); emb (n x dim f32,
// 0.8 MB at 100k x 2) stays in L2, so at 3M edges an epoch needs about
// 51 MB, 15 us at 3.35 TB/s. The simple design here idles lanes on short
// rows of a skewed degree distribution; balancing them is later work.
// powf of d2 runs only on d2 > 0 (its exponent b - 1 is negative).
//
// Components: the kernel is instantiated for 2..8 components, a vertex's
// coordinates and sums in registers. From 9 components on a second kernel
// takes the number of components at run time: it walks the coordinates in
// chunks of 8, and for each chunk walks the vertex's edges again, reading
// every coordinate from global memory for the distance. That is dim / 8
// times the work of the first kernel and is meant to be right, not fast.
// Every sum is taken in the same order as in the first kernel, and eons
// advances in the last chunk's walk only, so every walk sees the same due
// edges.
//
// T41:
// T13's kernels run on a window of the vertices: [v0, v0 + nv), a rank's
// block of the sharded layout. The window's edges (heads in the window,
// sorted by head) arrive as a CSR over the window, with their tails, eps and
// eons; dc_exp and the negatives are the window's; emb is the whole layout
// (the tails and negatives lie anywhere) and emb_out receives the window's
// new rows. The sharded reference has no stride buckets: T41 passes no
// shift, and an edge is due when eons <= epoch + 1. The sums are T13's, in
// T13's order; T13 itself is the window [0, n). Every update of the epoch is
// summed from emb before any is applied (the reference's sum-first order),
// and the caller gathers the windows into the next layout.
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

}  // namespace

extern "C" {

// T13. emb (n x dim) f32 in, emb_out (n x dim) f32 out; indptr (n+1) int32
// over the head-sorted edges; tails (E) int32; eps (E) f32; eons (E) f32,
// updated in place; shift (E) int8, 0 <= shift < 31; dc_exp (n) f32; negs
// (n x neg_rate) int32, 0 <= neg_rate <= 32; dim >= 2 (2..8 in registers,
// from 9 on the kernel that takes dim at run time).
int mt_umap_epoch(const float* emb, float* emb_out, const int* indptr,
                  const int* tails, const float* eps, float* eons,
                  const signed char* shift, const float* dc_exp, const int* negs,
                  int n, int dim, int neg_rate, int epoch, float alpha, float a,
                  float b, float gamma, void* stream) {
  return epoch_window(emb, emb_out, indptr, tails, eps, eons, shift, dc_exp, negs, 0, n,
                      dim, neg_rate, epoch, alpha, a, b, gamma, (cudaStream_t)stream);
}

// T41. emb (n x dim) f32, the whole layout; the window [v0, v0 + nv) of it:
// indptr (nv+1) int32 over its edges, tails (global ids), eps and eons (E_w,)
// f32, dc_exp (nv,) f32, negs (nv x neg_rate) int32; out_blk (nv x dim) f32
// out, not aliasing emb.
int mt_umap_epoch_block(const float* emb, float* out_blk, const int* indptr,
                        const int* tails, const float* eps, float* eons,
                        const float* dc_exp, const int* negs, int v0, int nv, int dim,
                        int neg_rate, int epoch, float alpha, float a, float b,
                        float gamma, void* stream) {
  return epoch_window(emb, out_blk, indptr, tails, eps, eons, nullptr, dc_exp, negs, v0,
                      nv, dim, neg_rate, epoch, alpha, a, b, gamma, (cudaStream_t)stream);
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
