// Kernels of the MOFA+ coordinate-ascent sweeps, for Hopper (sm_90a).
//
//   T17 mofa_col_dot       <- muon_tpu/models/mofa.py _make_step / _make_svi_step:
//                             zk @ E in w_body, (E * E).sum(0) in the tau update
//   T18 mofa_w_posterior   <- w_body's elementwise posterior of one factor's weights
//   T19 mofa_row_dot       <- z_body's Es[m] @ tsw (masked: also B @ tSWW[:, k] and
//                             B @ tSW2[:, k])
//   T20 mofa_rank1_update  <- the rank-1 corrections of E in w_body and z_body
//   T23 mofa_bound_refresh <- the bernoulli / poisson bound refresh at the start of
//                             _make_step (:136-170) and _make_svi_step (:860-893)
//
// T23 replaces three (N, K) x (K, D) products and the elementwise pass that
// XLA fuses around them: per entry F = Zm SW^T, for bernoulli the Jaakkola
// precision T = 2 lambda(zeta) M01 with zeta^2 = F^2 + (z2 SWW^T - Zm^2 (SW^2)^T),
// and the residual E (and in SVI the target). It is bound by bytes: it reads
// Y0 and M01 and writes E and T, 16 bytes an entry (480 MB at 10,000 x 3000,
// 0.14 ms at 3.35 TB/s), where the products over K = 15 are 2.7e9 flop. A
// block keeps its tile's rows of Zm and z2 and columns of SW and SWW in
// shared memory, so each entry of Y0 / M01 / E / T crosses device memory
// once. The factor sums run in ascending k, without atomics.
//
// The reference runs the loop over the K factors inside one compiled
// program, and its compiler fuses each factor's reduction, posterior and
// rank-1 correction around the residual E (N x D float32, row-major, one
// per view; a masked view has a 0/1 or per-entry-precision B of E's shape).
// Here each of those passes over E is one kernel.
//
// Bound: all four are bound by bytes. T17 and T19 read E once (T19 also B
// where masked), T20 reads and writes E once (and reads B), T18 touches a few
// vectors of D floats. At the bench's 10,000 x 3000 a pass over E is 120 MB,
// 36 us at 3.35 TB/s; E does not fit the 50 MB L2, so every pass comes from
// device memory. T17 and T20 take 16 bytes a thread where the shapes allow;
// T19 reads with one 4-byte load a thread, neighbouring threads on
// neighbouring columns.
//
// Order of sums: T17 sums each tile of 256 rows by 8 row lanes and a tree,
// then the tiles in index order; T19 gives a row to a warp, each lane summing
// every 32nd column in order, then a butterfly. No float atomics: the same
// inputs give the same bits in every run.
//
// Vectors may be strided views (column k of a row-major (N, K) or (D, K)
// array): every vector argument comes with its stride in elements, and a
// stride of 0 broadcasts one value.
//
// Interface: plain C functions (loaded with ctypes), as in
// sparse_kernels.cu. Each launches on the stream it is given, allocates
// nothing, and returns cudaGetLastError(). Outputs and scratch are
// allocated by the caller.

#include <cuda/atomic>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarp = 32;
constexpr int kWarpsPerBlock = 8;
constexpr unsigned kFull = 0xffffffffu;

// T17: u[c] = sum_r z[r] E[r, c] (z given) or sum_r E[r, c]^2 (z null),
// summed in one fixed order, which depends on n alone: per tile of 256
// rows, row lane y (of 8) takes rows y, y + 8, ... of the tile in turn by
// fmaf, the lanes meet by a fixed tree (lane y + lane y + 4, then + 2, then
// + 1) into partial[tile, c], and the tiles are added in index order from
// 0. This is the order of the port's first T17 (two 4-byte launches), kept
// bit for bit, so the MOFA fits repeat theirs to the last bit.
// The memory access is new. A (32 x 8) block takes a run of tiles, so that
// the grid is about one wave of 4 blocks on each of 132 SMs, and a strip of
// at most 32 groups of V columns (the d / V groups dealt evenly to the
// strips): thread (x, y) owns columns c .. c + V - 1 (V = 4: one 16-byte
// load a row, so a warp reads up to 512 contiguous bytes of a row) and has
// kCdUnroll of its 32 rows in flight before their FMAs. A warp reads the z
// values of its 32 rows with one load, a lane each, into a register and
// hands them out by shuffles (z is a strided column of Zm, or a broadcast):
// no block barrier stalls the stream of E. The 4-byte variant (V = 1: d %
// 4 != 0 or E's base not 16-byte aligned) takes the same rows in the same
// order. The finish: the last block of a strip to write its partial, known
// by an acquire-release add to a per-strip counter, adds the strip's tiles
// (kCdChunk at a time through shared memory, the next chunk in flight) and
// resets the counter to 0 for the next call, so the counters must not be
// shared by two calls in flight (the port runs one stream a device). This
// one launch beat a second finish kernel of one block a strip, timed in
// turns beside it: 0.0481-0.0492 ms against 0.0494-0.0501 at 10,000 x 3000,
// 0.0278-0.0286 against 0.0295-0.0301 at 50,000 x 256 (H100 80GB HBM3,
// 700 W), so the second kernel was dropped. A faster order of its own (one
// wave of larger tiles) moved the MOFA fits' float32 paths; this one keeps
// every fit as it was.
// Bound: by bytes, E once, z once, u once (10,000 x 3000: 120 MB, 0.0358
// ms at 3.35 TB/s; 50,000 x 256: 0.0153 ms). The partials (tiles x d) are
// under 1% of E's bytes.
constexpr int kCdTile = 256;  // rows a tile; ops/mofa.py
constexpr int kCdCols = 32;
constexpr int kCdLanes = 8;
constexpr int kCdUnroll = 8;
constexpr int kCdChunk = 32;  // tiles a finish step stages
constexpr int kCdSlots = 132 * 4;  // blocks resident at once: 4 on each of 132 SMs

// the first column of thread x's group in strip s, or -1 past the strip
template <int V>
__device__ __forceinline__ int col_dot_column(int s, int strips, int d, int x) {
  const int groups = d / V;
  const int g = (int)((int64_t)s * groups / strips) + x;
  return g < (int)((int64_t)(s + 1) * groups / strips) ? g * V : -1;
}

// u[c .. c + V - 1] = the strip's tiles in index order, by the (x, 0)
// threads. The tiles pass through buf (kCdChunk x kCdCols * 4, shared)
// kCdChunk at a time; the block loads chunk k + 1 into registers while the
// (x, 0) threads add chunk k, so the adds wait on one round trip to L2 only.
constexpr int kCdStage = kCdChunk / kCdLanes;  // partial entries a thread stages

template <int V>
__device__ __forceinline__ void col_dot_stage(const float* partial, int t0, int tiles, int d,
                                              int strip, int strips, float (&st)[kCdStage][V]) {
  const int tid = threadIdx.y * kCdCols + threadIdx.x;
#pragma unroll
  for (int q = 0; q < kCdStage; ++q) {
    const int i = tid + q * kCdCols * kCdLanes;
    const int t = t0 + i / kCdCols;
    const int col = col_dot_column<V>(strip, strips, d, i % kCdCols);
    if (t < tiles && col >= 0) {
      const float* p = partial + (int64_t)t * d + col;
      if constexpr (V == 4) {
        const float4 f = __ldcg(reinterpret_cast<const float4*>(p));
        st[q][0] = f.x; st[q][1] = f.y; st[q][2] = f.z; st[q][3] = f.w;
      } else {
        st[q][0] = __ldcg(p);
      }
    } else {
#pragma unroll
      for (int v = 0; v < V; ++v) st[q][v] = 0.f;
    }
  }
}

template <int V>
__device__ __forceinline__ void col_dot_finish(const float* partial, int tiles, int d,
                                               int strip, int strips,
                                               float (*buf)[kCdCols * 4],
                                               float* __restrict__ u) {
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kCdCols + tx;
  const int c = col_dot_column<V>(strip, strips, d, tx);
  float s[V], st[kCdStage][V];
#pragma unroll
  for (int v = 0; v < V; ++v) s[v] = 0.f;
  col_dot_stage<V>(partial, 0, tiles, d, strip, strips, st);
  for (int t0 = 0; t0 < tiles; t0 += kCdChunk) {
    __syncthreads();  // the previous chunk is added
#pragma unroll
    for (int q = 0; q < kCdStage; ++q) {
      const int i = tid + q * kCdCols * kCdLanes;
#pragma unroll
      for (int v = 0; v < V; ++v) buf[i / kCdCols][(i % kCdCols) * V + v] = st[q][v];
    }
    __syncthreads();
    if (t0 + kCdChunk < tiles) col_dot_stage<V>(partial, t0 + kCdChunk, tiles, d, strip, strips, st);
    if (ty == 0 && c >= 0)
      for (int t = 0; t < min(kCdChunk, tiles - t0); ++t)
#pragma unroll
        for (int v = 0; v < V; ++v) s[v] = __fadd_rn(s[v], buf[t][tx * V + v]);
  }
  if (ty == 0 && c >= 0)
#pragma unroll
    for (int v = 0; v < V; ++v) u[c + v] = s[v];
}

template <int V>
__global__ void __launch_bounds__(kCdCols * kCdLanes, 4)
col_dot_kernel(const float* __restrict__ E, const float* __restrict__ z, int64_t z_stride,
               int n, int d, int tiles_per_block, float* partial, unsigned* __restrict__ done,
               float* __restrict__ u) {
  __shared__ float buf[kCdChunk][kCdCols * 4];
  __shared__ bool last;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int c = col_dot_column<V>(blockIdx.y, gridDim.y, d, tx);
  const int tiles = n > 0 ? (n + kCdTile - 1) / kCdTile : 1;
  const int lane = tx % kWarp;
  float (*red)[kCdCols * 4] = buf;  // the first kCdLanes rows of buf
  const int t_end = min(tiles, (blockIdx.x + 1) * tiles_per_block);
  for (int t = blockIdx.x * tiles_per_block; t < t_end; ++t) {
    const int r0 = t * kCdTile + ty;  // this lane's rows: r0 + kCdLanes j
    const int rows = max(0, (min(kCdTile, n - t * kCdTile) - ty + kCdLanes - 1) /
                                kCdLanes);  // at most 32, uniform across the warp
    const float* e_lane = E + (int64_t)r0 * d + max(c, 0);
    const int64_t step = (int64_t)kCdLanes * d;
    // z of this lane's row j sits in lane j of the warp
    const float zr =
        z != nullptr && lane < rows ? z[(int64_t)(r0 + kCdLanes * lane) * z_stride] : 0.f;
    float acc[V];
#pragma unroll
    for (int v = 0; v < V; ++v) acc[v] = 0.f;
    for (int j = 0; j < rows; j += kCdUnroll) {
      float e[kCdUnroll][V];
#pragma unroll
      for (int k = 0; k < kCdUnroll; ++k) {
        const float* p = e_lane + (j + k) * step;
        if (j + k < rows && c >= 0) {  // E is read once: evict-first loads
          if constexpr (V == 4) {
            const float4 f = __ldcs(reinterpret_cast<const float4*>(p));
            e[k][0] = f.x; e[k][1] = f.y; e[k][2] = f.z; e[k][3] = f.w;
          } else {
            e[k][0] = __ldcs(p);
          }
        } else {
#pragma unroll
          for (int v = 0; v < V; ++v) e[k][v] = 0.f;
        }
      }
#pragma unroll
      for (int k = 0; k < kCdUnroll; ++k) {
        const float w = z != nullptr ? __shfl_sync(kFull, zr, (j + k) % kWarp) : 0.f;
        if (j + k < rows)  // the rows of the tile, in turn, as the first T17 took them
#pragma unroll
          for (int v = 0; v < V; ++v)
            acc[v] = fmaf(z != nullptr ? w : e[k][v], e[k][v], acc[v]);
      }
    }
    __syncthreads();  // the previous tile's partial is read out of red
#pragma unroll
    for (int v = 0; v < V; ++v) red[ty][tx * V + v] = acc[v];
    __syncthreads();
#pragma unroll
    for (int h = kCdLanes / 2; h > 0; h >>= 1) {
      if (ty < h)
#pragma unroll
        for (int v = 0; v < V; ++v)
          red[ty][tx * V + v] = __fadd_rn(red[ty][tx * V + v], red[ty + h][tx * V + v]);
      __syncthreads();
    }
    if (ty == 0 && c >= 0)
#pragma unroll
      for (int v = 0; v < V; ++v) partial[(int64_t)t * d + c + v] = red[0][tx * V + v];
  }
  __syncthreads();  // the block's partials are written before thread 0 counts them
  if (ty == 0 && tx == 0) {
    // release: this block's partials are visible to the block that reads
    // the last count; acquire: that block sees every tile's partial
    cuda::atomic_ref<unsigned, cuda::thread_scope_device> count(done[blockIdx.y]);
    last = count.fetch_add(1u, cuda::memory_order_acq_rel) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  col_dot_finish<V>(partial, tiles, d, blockIdx.y, gridDim.y, buf, u);
  if (ty == 0 && tx == 0) done[blockIdx.y] = 0u;  // ready for the next call
}

// T18: the posterior of column k of one view's weights, a thread per feature
__global__ void __launch_bounds__(kThreads)
w_posterior_kernel(const float* __restrict__ u, const float* __restrict__ tau,
                   const float* __restrict__ z2, int64_t z2_stride,
                   const float* __restrict__ zz, int64_t zz_stride,
                   const float* __restrict__ alpha, const float* __restrict__ ln_alpha,
                   const float* __restrict__ theta_ln,
                   const float* __restrict__ theta_ln1m, float scale, int scaled,
                   int spikeslab, int d, int K, int k, float* __restrict__ W_hat,
                   float* __restrict__ W_var, float* __restrict__ S,
                   float* __restrict__ SW, float* __restrict__ delta) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= d) return;
  const int64_t at = (int64_t)c * K + k;
  const float t = tau[c];
  const float sw_old = SW[at];
  const float a = __fadd_rn(__fmul_rn(t, z2[(int64_t)c * z2_stride]), alpha[0]);
  const float zzc = zz[(int64_t)c * zz_stride];
  // full batch: tau (u + sw zz); stochastic: tau scale u + tau sw zz, with
  // zz (and z2) already scaled by the caller, as the reference writes them
  const float b = scaled
      ? __fadd_rn(__fmul_rn(__fmul_rn(t, scale), u[c]),
                  __fmul_rn(__fmul_rn(t, sw_old), zzc))
      : __fmul_rn(t, __fadd_rn(u[c], __fmul_rn(sw_old, zzc)));
  const float w = __fdiv_rn(b, a);
  const float v = __fdiv_rn(1.f, a);
  float s = 1.f;
  if (spikeslab) {
    float lam = __fsub_rn(theta_ln[0], theta_ln1m[0]);
    lam = __fadd_rn(lam, __fmul_rn(0.5f, ln_alpha[0]));
    lam = __fsub_rn(lam, __fmul_rn(0.5f, logf(a)));
    lam = __fadd_rn(lam, __fdiv_rn(__fmul_rn(__fmul_rn(0.5f, b), b), a));
    s = __fdiv_rn(1.f, __fadd_rn(1.f, expf(-lam)));
  }
  const float sw_new = __fmul_rn(s, w);
  W_hat[at] = w;
  W_var[at] = v;
  S[at] = s;
  SW[at] = sw_new;
  delta[c] = __fsub_rn(sw_old, sw_new);
}

// T19: a warp per row; r[row] = sum_c E[row, c] t[c], and with B also
// pb[row] = sum_c B[row, c] t1[c] and qb[row] = sum_c B[row, c] t2[c]
__global__ void __launch_bounds__(kWarp * kWarpsPerBlock)
row_dot_kernel(const float* __restrict__ E, const float* __restrict__ t,
               int64_t t_stride, const float* __restrict__ B,
               const float* __restrict__ t1, const float* __restrict__ t2,
               int64_t tb_stride, int n, int d, float* __restrict__ r,
               float* __restrict__ pb, float* __restrict__ qb) {
  const int row = blockIdx.x * kWarpsPerBlock + threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  if (row >= n) return;  // whole warps leave together
  const float* e = E + (int64_t)row * d;
  float s = 0.f, p = 0.f, q = 0.f;
  if (B == nullptr) {
    for (int c = lane; c < d; c += kWarp) s = fmaf(e[c], t[(int64_t)c * t_stride], s);
  } else {
    const float* b = B + (int64_t)row * d;
    for (int c = lane; c < d; c += kWarp) {
      const float bc = b[c];
      s = fmaf(e[c], t[(int64_t)c * t_stride], s);
      p = fmaf(bc, t1[(int64_t)c * tb_stride], p);
      q = fmaf(bc, t2[(int64_t)c * tb_stride], q);
    }
  }
#pragma unroll
  for (int o = kWarp / 2; o > 0; o >>= 1) {
    s = __fadd_rn(s, __shfl_xor_sync(kFull, s, o));
    p = __fadd_rn(p, __shfl_xor_sync(kFull, p, o));
    q = __fadd_rn(q, __shfl_xor_sync(kFull, q, o));
  }
  if (lane == 0) {
    r[row] = s;
    if (B != nullptr) {
      pb[row] = p;
      qb[row] = q;
    }
  }
}

// T20: E[r, c] += x[r] y[c] (times B[r, c] where masked), in place. A block
// of 64 x 4 threads takes 64 groups of V columns of 4 x rows_per_thread rows;
// V = 4 (one 16-byte load and store a thread) where the row length and the
// pointers allow it, else 1. A thread's rows are independent, so its loads
// are in flight together.
constexpr int kR1Cols = 64;
constexpr int kR1Rows = 4;

template <int V>
__global__ void __launch_bounds__(kR1Cols * kR1Rows)
rank1_update_kernel(float* __restrict__ E, const float* __restrict__ x,
                    int64_t x_stride, const float* __restrict__ y, int64_t y_stride,
                    const float* __restrict__ B, int n, int d, int rows_per_thread) {
  const int c = (blockIdx.x * kR1Cols + threadIdx.x) * V;
  if (c >= d) return;
  float yc[V];
#pragma unroll
  for (int v = 0; v < V; ++v) yc[v] = y[(int64_t)(c + v) * y_stride];
  const int r0 = blockIdx.y * (kR1Rows * rows_per_thread) + threadIdx.y;
#pragma unroll 4
  for (int i = 0; i < rows_per_thread; ++i) {
    const int r = r0 + i * kR1Rows;
    if (r >= n) return;
    const int64_t at = (int64_t)r * d + c;
    const float xr = x[(int64_t)r * x_stride];
    __align__(16) float e[V];
    __align__(16) float b[V] = {};
    if (V == 4) {
      *reinterpret_cast<float4*>(e) = *reinterpret_cast<const float4*>(E + at);
      if (B != nullptr) *reinterpret_cast<float4*>(b) = *reinterpret_cast<const float4*>(B + at);
    } else {
      e[0] = E[at];
      if (B != nullptr) b[0] = B[at];
    }
#pragma unroll
    for (int v = 0; v < V; ++v) {
      float upd = __fmul_rn(xr, yc[v]);
      if (B != nullptr) upd = __fmul_rn(upd, b[v]);
      e[v] = __fadd_rn(e[v], upd);
    }
    if (V == 4) {
      *reinterpret_cast<float4*>(E + at) = *reinterpret_cast<const float4*>(e);
    } else {
      E[at] = e[0];
    }
  }
}

// T23: the bound refresh of a bernoulli or poisson view. A block takes a
// tile of kBrRows cells x kBrCols features; its rows of Zm (and z2) and
// columns of SW (and SWW) pass through shared memory kBrK factors at a
// time, and each thread keeps kBrRows / kBrLanes cells of one feature in
// registers. Per (n, d), F = sum_k zm sw and, for bernoulli, the variance
// term sum_k (z2 sww - zm^2 sw^2), both summed over k in ascending order.
constexpr int kBrRows = 32;
constexpr int kBrCols = 64;
constexpr int kBrLanes = 4;  // row lanes: a thread takes kBrRows / kBrLanes cells
constexpr int kBrK = 16;     // factors per pass through shared memory
constexpr int kBrPer = kBrRows / kBrLanes;

__global__ void __launch_bounds__(kBrCols * kBrLanes)
bound_refresh_kernel(const float* __restrict__ Zm, const float* __restrict__ z2,
                     const float* __restrict__ SW, const float* __restrict__ SWW,
                     const float* __restrict__ Y0, const float* __restrict__ M01,
                     const float* __restrict__ kappa, int poisson, int n, int d, int K,
                     float* __restrict__ E, float* __restrict__ T, float* __restrict__ Tgt) {
  __shared__ float zs[kBrRows][kBrK];
  __shared__ float z2s[kBrRows][kBrK];
  __shared__ float sws[kBrK][kBrCols];
  __shared__ float swws[kBrK][kBrCols];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kBrCols + tx;
  const int r0 = blockIdx.y * kBrRows;
  const int c = blockIdx.x * kBrCols + tx;
  float F[kBrPer], V[kBrPer];
#pragma unroll
  for (int i = 0; i < kBrPer; ++i) F[i] = V[i] = 0.f;
  for (int k0 = 0; k0 < K; k0 += kBrK) {
    const int kc = min(kBrK, K - k0);
    __syncthreads();
    for (int e = tid; e < kBrRows * kBrK; e += kBrCols * kBrLanes) {
      const int r = e / kBrK, k = e % kBrK;
      const bool in = r0 + r < n && k < kc;
      const int64_t at = (int64_t)(r0 + r) * K + k0 + k;
      zs[r][k] = in ? Zm[at] : 0.f;
      if (!poisson) z2s[r][k] = in ? z2[at] : 0.f;
    }
    for (int e = tid; e < kBrK * kBrCols; e += kBrCols * kBrLanes) {
      const int k = e / kBrCols, cc = e % kBrCols;
      const int col = blockIdx.x * kBrCols + cc;
      const bool in = col < d && k < kc;
      const int64_t at = (int64_t)col * K + k0 + k;
      sws[k][cc] = in ? SW[at] : 0.f;
      if (!poisson) swws[k][cc] = in ? SWW[at] : 0.f;
    }
    __syncthreads();
    for (int k = 0; k < kc; ++k) {
      const float sw = sws[k][tx];
      const float sww = swws[k][tx];
#pragma unroll
      for (int i = 0; i < kBrPer; ++i) {
        const int r = ty + i * kBrLanes;
        const float zm = zs[r][k];
        F[i] = fmaf(zm, sw, F[i]);
        if (!poisson) {
          const float diff = __fsub_rn(__fmul_rn(z2s[r][k], sww),
                                       __fmul_rn(__fmul_rn(zm, zm), __fmul_rn(sw, sw)));
          V[i] = __fadd_rn(V[i], diff);
        }
      }
    }
  }
  if (c >= d) return;
  const float kap = poisson ? kappa[c] : 1.f;
#pragma unroll
  for (int i = 0; i < kBrPer; ++i) {
    const int r = r0 + ty + i * kBrLanes;
    if (r >= n) break;
    const int64_t at = (int64_t)r * d + c;
    const float y = Y0[at];
    const float m = M01 != nullptr ? M01[at] : 1.f;
    const float f = F[i];
    if (!poisson) {
      // Jaakkola: zeta^2 = E[(z.w)^2], T = 2 lambda(zeta) M01
      const float e2 = __fadd_rn(__fmul_rn(f, f), V[i]);
      const float zeta = sqrtf(fmaxf(e2, 1e-10f));
      const float lam = zeta > 1e-4f ? __fdiv_rn(tanhf(__fmul_rn(zeta, 0.5f)),
                                                 __fmul_rn(4.f, zeta))
                                     : 0.125f;
      const float t = __fmul_rn(__fmul_rn(2.f, lam), m);
      const float tgt = __fsub_rn(y, __fmul_rn(0.5f, m));
      T[at] = t;
      E[at] = __fsub_rn(tgt, __fmul_rn(t, f));
      if (Tgt != nullptr) Tgt[at] = tgt;
    } else {
      // Seeger: pseudo-data F - sigmoid(F) (1 - y / max(softplus F, 1e-6)) / kappa
      const float rate = __fadd_rn(fmaxf(f, 0.f), log1pf(expf(-fabsf(f))));
      const float sig = __fdiv_rn(1.f, __fadd_rn(1.f, expf(-f)));
      const float ratio = __fsub_rn(1.f, __fdiv_rn(y, fmaxf(rate, 1e-6f)));
      const float pseudo = __fsub_rn(f, __fdiv_rn(__fmul_rn(sig, ratio), kap));
      if (T != nullptr) T[at] = m;
      E[at] = __fmul_rn(__fsub_rn(pseudo, f), m);
      if (Tgt != nullptr) Tgt[at] = __fmul_rn(pseudo, m);
    }
  }
}

}  // namespace

extern "C" {

// T23. Zm (n x K) f32; z2 (n x K) f32 and SWW (d x K) f32 for bernoulli,
// unread (may be null) for poisson; SW (d x K) f32; Y0 (n x d) f32; M01
// (n x d) f32 or null (read as 1); kappa (d) f32 for poisson; all
// contiguous. Writes E (n x d); T (n x d) for bernoulli (for poisson, if
// not null, the mask); Tgt (n x d) if not null: the stochastic sweep's
// target (bernoulli Y0 - M01 / 2, poisson pseudo M01).
int mt_mofa_bound_refresh(const float* Zm, const float* z2, const float* SW,
                          const float* SWW, const float* Y0, const float* M01,
                          const float* kappa, int poisson, int n, int d, int K, float* E,
                          float* T, float* Tgt, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n <= 0 || d <= 0) return (int)cudaGetLastError();
  if (!poisson && (z2 == nullptr || SWW == nullptr || T == nullptr))
    return (int)cudaErrorInvalidValue;
  if (poisson && kappa == nullptr) return (int)cudaErrorInvalidValue;
  const int row_tiles = (n + kBrRows - 1) / kBrRows;
  const int col_tiles = (d + kBrCols - 1) / kBrCols;
  // grid.y holds at most 65535 row tiles: longer views take several launches
  for (int t0 = 0; t0 < row_tiles; t0 += 65535) {
    const int tiles = row_tiles - t0 < 65535 ? row_tiles - t0 : 65535;
    const int64_t off = (int64_t)t0 * kBrRows;
    const int64_t left = (int64_t)n - off;
    const int n_here = (int)(left < (int64_t)tiles * kBrRows ? left : (int64_t)tiles * kBrRows);
    bound_refresh_kernel<<<dim3(col_tiles, tiles), dim3(kBrCols, kBrLanes), 0, s>>>(
        Zm + off * K, poisson ? nullptr : z2 + off * K, SW, SWW, Y0 + off * d,
        M01 != nullptr ? M01 + off * d : nullptr, kappa, poisson, n_here, d, K, E + off * d,
        T != nullptr ? T + off * d : nullptr, Tgt != nullptr ? Tgt + off * d : nullptr);
  }
  return (int)cudaGetLastError();
}

// T17. E (n x d) f32; z (n) f32 with stride z_stride (0: one value), or
// null for the column sums of E^2; partial (max(1, ceil(n / 256)) x d) f32
// scratch; done (ceil(d / 32)) uint32 counters, zero on entry and left
// zero; u (d) f32 out.
int mt_mofa_col_dot(const float* E, const float* z, long long z_stride, int n, int d,
                    float* partial, unsigned* done, float* u, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (d <= 0) return (int)cudaGetLastError();
  const bool vec4 = d % 4 == 0 && (uintptr_t)E % 16 == 0;
  const int V = vec4 ? 4 : 1;
  const int tiles = n > 0 ? (n + kCdTile - 1) / kCdTile : 1;
  const int strips = (d / V + kCdCols - 1) / kCdCols;
  if (strips > 65535) return (int)cudaErrorInvalidValue;
  // a run of tiles a block, so that the grid is about one wave of kCdSlots
  const int64_t tasks = (int64_t)tiles * strips;
  const int per = (int)((tasks + kCdSlots - 1) / kCdSlots);
  const dim3 grid((tiles + per - 1) / per, strips), block(kCdCols, kCdLanes);
  if (vec4)
    col_dot_kernel<4><<<grid, block, 0, s>>>(E, z, z_stride, n, d, per, partial, done, u);
  else
    col_dot_kernel<1><<<grid, block, 0, s>>>(E, z, z_stride, n, d, per, partial, done, u);
  return (int)cudaGetLastError();
}

// T18. u, tau (d) f32; z2 and zz (d) f32 with their strides (0: one value);
// alpha, ln_alpha, theta_ln, theta_ln1m point at the (view, factor) entry;
// scaled selects the stochastic form with `scale`; W_hat, W_var, S, SW
// (d x K) f32, column k updated in place; delta (d) f32 out = SW_old - SW_new.
int mt_mofa_w_posterior(const float* u, const float* tau, const float* z2,
                        long long z2_stride, const float* zz, long long zz_stride,
                        const float* alpha, const float* ln_alpha, const float* theta_ln,
                        const float* theta_ln1m, float scale, int scaled, int spikeslab,
                        int d, int K, int k, float* W_hat, float* W_var, float* S,
                        float* SW, float* delta, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (d <= 0) return (int)cudaGetLastError();
  if (k < 0 || k >= K) return (int)cudaErrorInvalidValue;
  w_posterior_kernel<<<(d + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      u, tau, z2, z2_stride, zz, zz_stride, alpha, ln_alpha, theta_ln, theta_ln1m, scale,
      scaled, spikeslab, d, K, k, W_hat, W_var, S, SW, delta);
  return (int)cudaGetLastError();
}

// T19. E (n x d) f32; t (d) f32 with stride t_stride; B (n x d) f32 or null;
// with B, t1 and t2 (d) f32 with stride tb_stride; r (n) out, and with B also
// pb, qb (n) out.
int mt_mofa_row_dot(const float* E, const float* t, long long t_stride, const float* B,
                    const float* t1, const float* t2, long long tb_stride, int n, int d,
                    float* r, float* pb, float* qb, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n <= 0) return (int)cudaGetLastError();
  const int blocks = (n + kWarpsPerBlock - 1) / kWarpsPerBlock;
  row_dot_kernel<<<blocks, kWarp * kWarpsPerBlock, 0, s>>>(E, t, t_stride, B, t1, t2,
                                                           tb_stride, n, d, r, pb, qb);
  return (int)cudaGetLastError();
}

// T20. E (n x d) f32, updated in place; x (n) and y (d) f32 with their
// strides; B (n x d) f32 or null.
int mt_mofa_rank1_update(float* E, const float* x, long long x_stride, const float* y,
                         long long y_stride, const float* B, int n, int d, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n <= 0 || d <= 0) return (int)cudaGetLastError();
  int rows_per_thread = 8;
  while ((n + kR1Rows * rows_per_thread - 1) / (kR1Rows * rows_per_thread) > 65535)
    rows_per_thread *= 2;
  const bool vec4 = d % 4 == 0 && (uintptr_t)E % 16 == 0 && (B == nullptr || (uintptr_t)B % 16 == 0);
  const int groups = vec4 ? d / 4 : d;
  const dim3 grid((groups + kR1Cols - 1) / kR1Cols,
                  (n + kR1Rows * rows_per_thread - 1) / (kR1Rows * rows_per_thread));
  const dim3 block(kR1Cols, kR1Rows);
  if (vec4)
    rank1_update_kernel<4><<<grid, block, 0, s>>>(E, x, x_stride, y, y_stride, B, n, d,
                                                  rows_per_thread);
  else
    rank1_update_kernel<1><<<grid, block, 0, s>>>(E, x, x_stride, y, y_stride, B, n, d,
                                                  rows_per_thread);
  return (int)cudaGetLastError();
}

}  // extern "C"
