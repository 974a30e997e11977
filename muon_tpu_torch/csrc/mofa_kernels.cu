// Kernels of the MOFA+ coordinate-ascent sweeps, for Hopper (sm_90a).
//
//   T17 mofa_col_dot       <- muon_tpu/models/mofa.py _make_step / _make_svi_step:
//                             zk @ E in w_body, (E * E).sum(0) in the tau update
//   T18 mofa_w_posterior   <- w_body's elementwise posterior of one factor's weights
//   T19 mofa_row_dot       <- z_body's Es[m] @ tsw (masked: also B @ tSWW[:, k] and
//                             B @ tSW2[:, k])
//   T20 mofa_rank1_update  <- the rank-1 corrections of E in w_body and z_body
//   mofa_rank1_col_dot     <- a factor's correction in w_body and the next
//                             factor's zk @ E (T20 then T17, one pass)
//   mofa_col_dot_posterior, mofa_rank1_col_dot_posterior
//                          <- T17 and mofa_rank1_col_dot with T18's posterior
//                             of the factor just summed in their finish
//   mofa_rank1_row_dot     <- a factor's correction in z_body and the next
//                             factor's Es[m] @ tsw (T20 then T19, one pass)
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
// Here the sweeps fuse likewise where a pass over E can: factor k's
// correction and factor k + 1's reduction read E once and write it once
// (mofa_rank1_col_dot in the w sweep, mofa_rank1_row_dot in the z sweep),
// since the reduction reads exactly the entries the correction has just
// written. A sweep's first factor starts with T17 or T19 alone and its last
// ends with T20 alone: per factor and view 4 passes over E where one kernel
// a pass took 6. The posterior between them needs the whole reduction:
// the factors' runs in torch; T18 is elementwise over the columns of u, so
// where no sum over cells of other devices stands between (one device, or
// a mesh whose cells axis is 1) the last block of each strip of T17 or
// mofa_rank1_col_dot, which holds the strip's finished u, computes it there
// (the _posterior variants), through the same device function as T18's
// own kernel, so every value has T18's bits; T18 stays a launch of its own
// where u is all-reduced over cells first. The variants write delta into a
// buffer of their own, since the pass still reads the previous factor's
// (the sweep ping-pongs two).
//
// Bound: all are bound by bytes. T17 and T19 read E once (T19 also B where
// masked), T20 and the fused passes read and write E once (and read B), T18
// touches a few vectors of D floats. At the bench's 10,000 x 3000 a pass
// over E is 120 MB, 36 us at 3.35 TB/s; E does not fit the 50 MB L2, so
// every pass comes from device memory. The layouts (measured on an H100):
// T17 reads 16 bytes a thread, eight warps a block, one a row lane of its
// order; mofa_rank1_col_dot keeps T17's order with a one-warp block that
// walks whole row segments, the eight row lanes in registers; T20 streams E
// as one flat array of 16-byte groups; T19 and mofa_rank1_row_dot give a
// warp a row, 4-byte loads in its order, several columns in flight a lane,
// the strided vectors staged in shared memory. Passes that write E measured
// fastest where the warps in flight read and write contiguous stretches of
// rows: T17's own layout, eight rows at once, wrote more slowly.
//
// Order of sums: T17 sums each tile of 256 rows by 8 row lanes and a tree,
// then the tiles in index order; T19 gives a row to a warp, each lane summing
// every 32nd column in order, then a butterfly. The fused passes sum the
// corrected values in the same orders, so they give the bits of T20 then
// T17 or T19. No float atomics: the same inputs give the same bits in every
// run.
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

// T18's operands: column k of one view's weights. alpha, ln_alpha,
// theta_ln and theta_ln1m point at the (view, factor) entry; z2 and zz are
// strided (0: one value); scaled selects the stochastic form with scale.
struct WPost {
  const float* tau;
  const float* z2;
  int64_t z2_stride;
  const float* zz;
  int64_t zz_stride;
  const float* alpha;
  const float* ln_alpha;
  const float* theta_ln;
  const float* theta_ln1m;
  float scale;
  int scaled;
  int spikeslab;
  int K;
  int k;
  float* W_hat;
  float* W_var;
  float* S;
  float* SW;
  float* delta;
};

// T18 for feature c from its u: the one body of T18's kernel and of the
// _posterior finishes, so every operation rounds the same way in each
__device__ __forceinline__ void w_posterior_column(const WPost& p, int c, float uc) {
  const int64_t at = (int64_t)c * p.K + p.k;
  const float t = p.tau[c];
  const float sw_old = p.SW[at];
  const float a = __fadd_rn(__fmul_rn(t, p.z2[(int64_t)c * p.z2_stride]), p.alpha[0]);
  const float zzc = p.zz[(int64_t)c * p.zz_stride];
  // full batch: tau (u + sw zz); stochastic: tau scale u + tau sw zz, with
  // zz (and z2) already scaled by the caller, as the reference writes them
  const float b = p.scaled
      ? __fadd_rn(__fmul_rn(__fmul_rn(t, p.scale), uc), __fmul_rn(__fmul_rn(t, sw_old), zzc))
      : __fmul_rn(t, __fadd_rn(uc, __fmul_rn(sw_old, zzc)));
  const float w = __fdiv_rn(b, a);
  const float v = __fdiv_rn(1.f, a);
  float s = 1.f;
  if (p.spikeslab) {
    float lam = __fsub_rn(p.theta_ln[0], p.theta_ln1m[0]);
    lam = __fadd_rn(lam, __fmul_rn(0.5f, p.ln_alpha[0]));
    lam = __fsub_rn(lam, __fmul_rn(0.5f, logf(a)));
    lam = __fadd_rn(lam, __fdiv_rn(__fmul_rn(__fmul_rn(0.5f, b), b), a));
    s = __fdiv_rn(1.f, __fadd_rn(1.f, expf(-lam)));
  }
  const float sw_new = __fmul_rn(s, w);
  p.W_hat[at] = w;
  p.W_var[at] = v;
  p.S[at] = s;
  p.SW[at] = sw_new;
  p.delta[c] = __fsub_rn(sw_old, sw_new);
}

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

template <int V, bool POST>
__device__ __forceinline__ void col_dot_finish(const float* partial, int tiles, int d,
                                               int strip, int strips,
                                               float (*buf)[kCdCols * 4],
                                               float* __restrict__ u, const WPost& post) {
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
    for (int v = 0; v < V; ++v) {
      u[c + v] = s[v];
      if constexpr (POST) w_posterior_column(post, c + v, s[v]);
    }
}

template <int V, bool POST>
__global__ void __launch_bounds__(kCdCols * kCdLanes, 4)
col_dot_kernel(const float* __restrict__ E, const float* __restrict__ z, int64_t z_stride,
               int n, int d, int tiles_per_block, float* partial, unsigned* __restrict__ done,
               float* __restrict__ u, const WPost post) {
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
  col_dot_finish<V, POST>(partial, tiles, d, blockIdx.y, gridDim.y, buf, u, post);
  if (ty == 0 && tx == 0) done[blockIdx.y] = 0u;  // ready for the next call
}

// T20 then T17 in one pass (mofa_rank1_col_dot). A block is one warp: it
// takes a strip of 32 groups of V columns (512 bytes of a row at V = 4) and
// walks its run of row tiles a row at a time, kCsUnroll rows (and their B)
// in flight, correcting each entry in place, as T20 rounds it, and storing
// it. A lane keeps T17's eight row lanes of its columns as eight
// accumulators, row i of a tile feeding lane i % 8 by fmaf in row order,
// and meets them by T17's tree (lane y + lane y + 4, then + 2, then + 1) in
// registers, so each column's sum has T17's order bit for bit. The x and z
// of 32 rows come with one load a warp and shuffles; y of the lane's
// columns is read once. The finish is T17's: the last block of a strip,
// known by its counter, adds the strip's tiles in index order from 0 and
// resets the counter. One warp a block and 16 rows in flight measured
// fastest of 32, 64 and 128 threads and 8, 16 and 32 rows (0.113 ms at
// 10,000 x 3000 against 0.117-0.121; H100 80GB HBM3, 700 W), and T17's
// own layout (eight warps, one a row lane) 0.125: a correction's writes
// want a row's segments in turn, not eight rows at once.
constexpr int kCsUnroll = 16;
constexpr int kCsSlots = 132 * 8;  // one-warp blocks resident at once (registers)

template <int V, bool MASK, bool POST>
__global__ void __launch_bounds__(kWarp)
rank1_col_dot_kernel(float* __restrict__ E, const float* __restrict__ x, int64_t x_stride,
                     const float* __restrict__ y, int64_t y_stride,
                     const float* __restrict__ B, const float* __restrict__ z,
                     int64_t z_stride, int n, int d, int tiles_per_block, float* partial,
                     unsigned* __restrict__ done, float* __restrict__ u, const WPost post) {
  constexpr int U = kCsUnroll;
  __shared__ bool last;
  const int lane = threadIdx.x;
  const int g = blockIdx.y * kWarp + lane;
  const int c = g < d / V ? g * V : -1;
  const int tiles = n > 0 ? (n + kCdTile - 1) / kCdTile : 1;
  float yc[V];
#pragma unroll
  for (int v = 0; v < V; ++v) yc[v] = c >= 0 ? y[(int64_t)(c + v) * y_stride] : 0.f;
  const int t_end = min(tiles, (blockIdx.x + 1) * tiles_per_block);
  for (int t = blockIdx.x * tiles_per_block; t < t_end; ++t) {
    const int rows = min(kCdTile, n - t * kCdTile);
    const int64_t r0 = (int64_t)t * kCdTile;
    const int64_t at = r0 * d + max(c, 0);
    float acc[kCdLanes][V];
#pragma unroll
    for (int l = 0; l < kCdLanes; ++l)
#pragma unroll
      for (int v = 0; v < V; ++v) acc[l][v] = 0.f;
    float xr = 0.f, zr = 0.f;
    for (int i = 0; i < rows; i += U) {
      if (i % kWarp == 0) {  // the next 32 rows' x and z, a lane each
        const int64_t r = r0 + i + lane;
        xr = i + lane < rows ? x[r * x_stride] : 0.f;
        zr = i + lane < rows ? z[r * z_stride] : 0.f;
      }
      float e[U][V], b[U][V];
#pragma unroll
      for (int k = 0; k < U; ++k) {
        const int64_t p = at + (int64_t)(i + k) * d;
        if (i + k < rows && c >= 0) {
          if constexpr (V == 4) {
            const float4 f = __ldcg(reinterpret_cast<const float4*>(E + p));
            e[k][0] = f.x; e[k][1] = f.y; e[k][2] = f.z; e[k][3] = f.w;
            if constexpr (MASK) {
              const float4 h = __ldcs(reinterpret_cast<const float4*>(B + p));
              b[k][0] = h.x; b[k][1] = h.y; b[k][2] = h.z; b[k][3] = h.w;
            }
          } else {
            e[k][0] = __ldcg(E + p);
            if constexpr (MASK) b[k][0] = __ldcs(B + p);
          }
        } else {
#pragma unroll
          for (int v = 0; v < V; ++v) e[k][v] = b[k][v] = 0.f;
        }
      }
#pragma unroll
      for (int k = 0; k < U; ++k) {
        const float xv = __shfl_sync(kFull, xr, (i + k) % kWarp);
        const float w = __shfl_sync(kFull, zr, (i + k) % kWarp);
        if (i + k < rows) {
#pragma unroll
          for (int v = 0; v < V; ++v) {
            float upd = __fmul_rn(xv, yc[v]);
            if constexpr (MASK) upd = __fmul_rn(upd, b[k][v]);
            e[k][v] = __fadd_rn(e[k][v], upd);
          }
          if (c >= 0) {
            float* q = E + at + (int64_t)(i + k) * d;
            if constexpr (V == 4)
              *reinterpret_cast<float4*>(q) = make_float4(e[k][0], e[k][1], e[k][2], e[k][3]);
            else
              *q = e[k][0];
          }
#pragma unroll
          for (int v = 0; v < V; ++v)
            acc[k % kCdLanes][v] = fmaf(w, e[k][v], acc[k % kCdLanes][v]);
        }
      }
    }
#pragma unroll
    for (int h = kCdLanes / 2; h > 0; h >>= 1)
#pragma unroll
      for (int l = 0; l < h; ++l)
#pragma unroll
        for (int v = 0; v < V; ++v) acc[l][v] = __fadd_rn(acc[l][v], acc[l + h][v]);
    if (c >= 0)
#pragma unroll
      for (int v = 0; v < V; ++v) partial[(int64_t)t * d + c + v] = acc[0][v];
  }
  __syncthreads();  // the block's partials are written before lane 0 counts them
  if (lane == 0) {
    // release: this block's partials are visible to the block that reads
    // the last count; acquire: that block sees every tile's partial
    cuda::atomic_ref<unsigned, cuda::thread_scope_device> count(done[blockIdx.y]);
    last = count.fetch_add(1u, cuda::memory_order_acq_rel) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  // T17's finish: the strip's tiles in index order, from 0
  float s[V];
#pragma unroll
  for (int v = 0; v < V; ++v) s[v] = 0.f;
  for (int t0 = 0; t0 < tiles; t0 += kCdLanes) {
    float pv[kCdLanes][V];
#pragma unroll
    for (int q = 0; q < kCdLanes; ++q)
#pragma unroll
      for (int v = 0; v < V; ++v)
        pv[q][v] = t0 + q < tiles && c >= 0 ? __ldcg(partial + (int64_t)(t0 + q) * d + c + v)
                                           : 0.f;
#pragma unroll
    for (int q = 0; q < kCdLanes; ++q)
      if (t0 + q < tiles)
#pragma unroll
        for (int v = 0; v < V; ++v) s[v] = __fadd_rn(s[v], pv[q][v]);
  }
  if (c >= 0)
#pragma unroll
    for (int v = 0; v < V; ++v) {
      u[c + v] = s[v];
      if constexpr (POST) w_posterior_column(post, c + v, s[v]);
    }
  if (lane == 0) done[blockIdx.y] = 0u;  // ready for the next call
}

// T18: the posterior of column k of one view's weights, a thread per feature
__global__ void __launch_bounds__(kThreads)
w_posterior_kernel(const float* __restrict__ u, int d, const WPost post) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c < d) w_posterior_column(post, c, u[c]);
}

// T19, and T20 then T19 in one pass (UPD: mofa_rank1_row_dot). A warp per
// row, the grid at most one wave of blocks, each warp a run of
// rows_per_warp rows (so no wave ends with a few warps on their last row).
// Lane l takes columns l, l + 32, ... in order: with UPD it corrects
// E[row, c] += x[row] y[c] (times B where MASK), rounded as T20, and stores
// it; then r[row] += E[row, c] t[c] by fmaf, and with B also pb += B t1,
// qb += B t2; a butterfly ends each sum. That is the first T19's order,
// kept bit for bit. A lane has the loads of its next kRdUnroll columns (E,
// and B) in flight before their FMAs and stores. The vectors y, t, t1, t2
// are strided columns of (D, K) arrays: where they fit 48 KB, each block
// stages them once in shared memory (one strided read a block, not one a
// row), else every row reads them from L1/L2.
constexpr int kRdUnroll = 8;
constexpr size_t kRdStageBytes = 48 * 1024;

template <bool MASK, bool UPD, bool STAGED>
__global__ void __launch_bounds__(kWarp * kWarpsPerBlock)
row_dot_kernel(float* __restrict__ E, const float* __restrict__ t, int64_t t_stride,
               const float* __restrict__ B, const float* __restrict__ t1,
               const float* __restrict__ t2, int64_t tb_stride,
               const float* __restrict__ x, int64_t x_stride, const float* __restrict__ y,
               int64_t y_stride, int n, int d, int rows_per_warp, float* __restrict__ r,
               float* __restrict__ pb, float* __restrict__ qb) {
  extern __shared__ float vs[];  // STAGED: y (UPD) | t | t1 | t2 (MASK), d each
  float* const ys = vs;
  float* const ts = vs + (UPD ? d : 0);
  float* const t1s = ts + d;
  float* const t2s = t1s + d;
  if constexpr (STAGED) {
    for (int c = threadIdx.x; c < d; c += blockDim.x) {
      if constexpr (UPD) ys[c] = y[(int64_t)c * y_stride];
      ts[c] = t[(int64_t)c * t_stride];
      if constexpr (MASK) {
        t1s[c] = t1[(int64_t)c * tb_stride];
        t2s[c] = t2[(int64_t)c * tb_stride];
      }
    }
    __syncthreads();
  }
  const int lane = threadIdx.x % kWarp;
  const int64_t first = ((int64_t)blockIdx.x * kWarpsPerBlock + threadIdx.x / kWarp) *
                        rows_per_warp;  // a warp's run of rows
  const int end = (int)min((int64_t)n, first + rows_per_warp);
  for (int row = (int)min(first, (int64_t)n); row < end; ++row) {
    float* e = E + (int64_t)row * d;
    const float* b = MASK ? B + (int64_t)row * d : nullptr;
    const float xr = UPD ? x[(int64_t)row * x_stride] : 0.f;
    float s = 0.f, p = 0.f, q = 0.f;
    for (int c0 = lane; c0 < d; c0 += kWarp * kRdUnroll) {
      float ev[kRdUnroll], bv[kRdUnroll];
#pragma unroll
      for (int i = 0; i < kRdUnroll; ++i) {
        const int c = c0 + i * kWarp;
        ev[i] = c < d ? __ldcs(e + c) : 0.f;
        bv[i] = MASK && c < d ? __ldcs(b + c) : 0.f;
      }
#pragma unroll
      for (int i = 0; i < kRdUnroll; ++i) {
        const int c = c0 + i * kWarp;
        if (c < d) {
          float ec = ev[i];
          if constexpr (UPD) {
            float upd = __fmul_rn(xr, STAGED ? ys[c] : y[(int64_t)c * y_stride]);
            if constexpr (MASK) upd = __fmul_rn(upd, bv[i]);
            ec = __fadd_rn(ec, upd);
            e[c] = ec;
          }
          s = fmaf(ec, STAGED ? ts[c] : t[(int64_t)c * t_stride], s);
          if constexpr (MASK) {
            p = fmaf(bv[i], STAGED ? t1s[c] : t1[(int64_t)c * tb_stride], p);
            q = fmaf(bv[i], STAGED ? t2s[c] : t2[(int64_t)c * tb_stride], q);
          }
        }
      }
    }
#pragma unroll
    for (int o = kWarp / 2; o > 0; o >>= 1) {
      s = __fadd_rn(s, __shfl_xor_sync(kFull, s, o));
      if constexpr (MASK) {
        p = __fadd_rn(p, __shfl_xor_sync(kFull, p, o));
        q = __fadd_rn(q, __shfl_xor_sync(kFull, q, o));
      }
    }
    if (lane == 0) {
      r[row] = s;
      if constexpr (MASK) {
        pb[row] = p;
        qb[row] = q;
      }
    }
  }
}

// T20: E[r, c] += x[r] y[c] (times B[r, c] where MASK), in place, over E as
// one flat array of V-wide groups (V = 4: 16 bytes, where the row length
// and the pointers allow it). A thread takes kR1Unroll groups 256 apart,
// all loaded before any is corrected and stored, and the grid covers E
// once: the warps of the card stream contiguous stretches of rows, which
// a correction's writes want (0.088 ms at 10,000 x 3000 against 0.113 in
// T17's layout and 0.106 for E.addr_; H100 80GB HBM3, 700 W). x of a row
// is one value for the threads of the row (a broadcast load).
constexpr int kR1Threads = 256;
constexpr int kR1Unroll = 4;

template <bool MASK, int V>
__global__ void __launch_bounds__(kR1Threads)
rank1_update_kernel(float* __restrict__ E, const float* __restrict__ x, int64_t x_stride,
                    const float* __restrict__ y, int64_t y_stride, const float* __restrict__ B,
                    int64_t count, int groups) {
  const int64_t base = (int64_t)blockIdx.x * kR1Threads * kR1Unroll + threadIdx.x;
  float e[kR1Unroll][V], b[kR1Unroll][V];
#pragma unroll
  for (int k = 0; k < kR1Unroll; ++k) {
    const int64_t i = base + k * kR1Threads;
    if (i < count) {
      if constexpr (V == 4) {
        const float4 f = __ldcg(reinterpret_cast<const float4*>(E) + i);
        e[k][0] = f.x; e[k][1] = f.y; e[k][2] = f.z; e[k][3] = f.w;
        if constexpr (MASK) {
          const float4 h = __ldcs(reinterpret_cast<const float4*>(B) + i);
          b[k][0] = h.x; b[k][1] = h.y; b[k][2] = h.z; b[k][3] = h.w;
        }
      } else {
        e[k][0] = __ldcg(E + i);
        if constexpr (MASK) b[k][0] = __ldcs(B + i);
      }
    }
  }
#pragma unroll
  for (int k = 0; k < kR1Unroll; ++k) {
    const int64_t i = base + k * kR1Threads;
    if (i < count) {
      const int64_t row = i / groups;
      const int c = (int)(i - row * groups) * V;
      const float xr = x[row * x_stride];
#pragma unroll
      for (int v = 0; v < V; ++v) {
        float upd = __fmul_rn(xr, y[(int64_t)(c + v) * y_stride]);
        if constexpr (MASK) upd = __fmul_rn(upd, b[k][v]);
        e[k][v] = __fadd_rn(e[k][v], upd);
      }
      if constexpr (V == 4)
        reinterpret_cast<float4*>(E)[i] = make_float4(e[k][0], e[k][1], e[k][2], e[k][3]);
      else
        E[i] = e[k][0];
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

// mofa_rank1_col_dot: V = 4 where the row length and the pointers allow
// it; a run of tiles a block, so that the grid is about one wave.
template <bool MASK, bool POST>
cudaError_t launch_rank1_col_dot(float* E, const float* x, int64_t x_stride, const float* y,
                                 int64_t y_stride, const float* B, const float* z,
                                 int64_t z_stride, int n, int d, float* partial,
                                 unsigned* done, float* u, const WPost& post, cudaStream_t s) {
  const bool vec4 = d % 4 == 0 && (uintptr_t)E % 16 == 0 && (!MASK || (uintptr_t)B % 16 == 0);
  const int V = vec4 ? 4 : 1;
  const int tiles = n > 0 ? (n + kCdTile - 1) / kCdTile : 1;
  const int strips = (d / V + kWarp - 1) / kWarp;
  if (strips > 65535) return cudaErrorInvalidValue;
  const int64_t tasks = (int64_t)tiles * strips;
  const int per = (int)((tasks + kCsSlots - 1) / kCsSlots);
  const dim3 grid((tiles + per - 1) / per, strips);
  if (vec4)
    rank1_col_dot_kernel<4, MASK, POST><<<grid, kWarp, 0, s>>>(
        E, x, x_stride, y, y_stride, B, z, z_stride, n, d, per, partial, done, u, post);
  else
    rank1_col_dot_kernel<1, MASK, POST><<<grid, kWarp, 0, s>>>(
        E, x, x_stride, y, y_stride, B, z, z_stride, n, d, per, partial, done, u, post);
  return cudaGetLastError();
}

template <bool POST>
cudaError_t launch_rank1_col_dot_any(float* E, const float* x, int64_t x_stride, const float* y,
                                     int64_t y_stride, const float* B, const float* z,
                                     int64_t z_stride, int n, int d, float* partial,
                                     unsigned* done, float* u, const WPost& post,
                                     cudaStream_t s) {
  if (d <= 0) return cudaGetLastError();
  if (z == nullptr) return cudaErrorInvalidValue;
  return B == nullptr ? launch_rank1_col_dot<false, POST>(E, x, x_stride, y, y_stride, B, z,
                                                          z_stride, n, d, partial, done, u,
                                                          post, s)
                      : launch_rank1_col_dot<true, POST>(E, x, x_stride, y, y_stride, B, z,
                                                         z_stride, n, d, partial, done, u,
                                                         post, s);
}

// T17 (and with POST its posterior variant): V = 4 where the row length
// and E's base allow it; a run of tiles a block, so that the grid is about
// one wave of kCdSlots.
template <bool POST>
cudaError_t launch_col_dot(const float* E, const float* z, int64_t z_stride, int n, int d,
                           float* partial, unsigned* done, float* u, const WPost& post,
                           cudaStream_t s) {
  if (d <= 0) return cudaGetLastError();
  const bool vec4 = d % 4 == 0 && (uintptr_t)E % 16 == 0;
  const int V = vec4 ? 4 : 1;
  const int tiles = n > 0 ? (n + kCdTile - 1) / kCdTile : 1;
  const int strips = (d / V + kCdCols - 1) / kCdCols;
  if (strips > 65535) return cudaErrorInvalidValue;
  const int64_t tasks = (int64_t)tiles * strips;
  const int per = (int)((tasks + kCdSlots - 1) / kCdSlots);
  const dim3 grid((tiles + per - 1) / per, strips), block(kCdCols, kCdLanes);
  if (vec4)
    col_dot_kernel<4, POST><<<grid, block, 0, s>>>(E, z, z_stride, n, d, per, partial, done, u,
                                                   post);
  else
    col_dot_kernel<1, POST><<<grid, block, 0, s>>>(E, z, z_stride, n, d, per, partial, done, u,
                                                   post);
  return cudaGetLastError();
}

WPost make_post(const float* tau, const float* z2, long long z2_stride, const float* zz,
                long long zz_stride, const float* alpha, const float* ln_alpha,
                const float* theta_ln, const float* theta_ln1m, float scale, int scaled,
                int spikeslab, int K, int k, float* W_hat, float* W_var, float* S, float* SW,
                float* delta) {
  return WPost{tau,      z2,         z2_stride, zz,    zz_stride, alpha, ln_alpha,
               theta_ln, theta_ln1m, scale,     scaled, spikeslab, K,     k,
               W_hat,    W_var,      S,         SW,    delta};
}

// T19 and mofa_rank1_row_dot: the vectors staged where they fit
// kRdStageBytes; at most one wave of blocks, every warp a run of the same
// number of rows.
template <bool MASK, bool UPD>
cudaError_t launch_row_dot(float* E, const float* t, int64_t t_stride, const float* B,
                           const float* t1, const float* t2, int64_t tb_stride, const float* x,
                           int64_t x_stride, const float* y, int64_t y_stride, int n, int d,
                           float* r, float* pb, float* qb, cudaStream_t s) {
  const size_t bytes = sizeof(float) * (size_t)d * ((UPD ? 1 : 0) + (MASK ? 3 : 1));
  const bool staged = bytes <= kRdStageBytes;
  auto kernel = staged ? &row_dot_kernel<MASK, UPD, true> : &row_dot_kernel<MASK, UPD, false>;
  const size_t smem = staged ? bytes : 0;
  int device = 0, sms = 0, resident = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, kernel,
                                                      kWarp * kWarpsPerBlock, smem);
  if (e != cudaSuccess) return e;
  const int64_t warps = (int64_t)sms * (resident > 0 ? resident : 1) * kWarpsPerBlock;
  const int per = (int)(((int64_t)n + warps - 1) / warps);
  const int64_t rows_a_block = (int64_t)per * kWarpsPerBlock;
  const int blocks = (int)(((int64_t)n + rows_a_block - 1) / rows_a_block);
  kernel<<<blocks, kWarp * kWarpsPerBlock, smem, s>>>(E, t, t_stride, B, t1, t2, tb_stride, x,
                                                      x_stride, y, y_stride, n, d, per, r, pb,
                                                      qb);
  return cudaGetLastError();
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
  return (int)launch_col_dot<false>(E, z, z_stride, n, d, partial, done, u, WPost{},
                                    (cudaStream_t)stream);
}

// T17's sum then T18 in its finish: the arguments of mt_mofa_col_dot (z not
// null), then those of mt_mofa_w_posterior after u and d; delta must not
// be an operand of the pass.
int mt_mofa_col_dot_posterior(const float* E, const float* z, long long z_stride, int n, int d,
                              float* partial, unsigned* done, float* u, const float* tau,
                              const float* z2, long long z2_stride, const float* zz,
                              long long zz_stride, const float* alpha, const float* ln_alpha,
                              const float* theta_ln, const float* theta_ln1m, float scale,
                              int scaled, int spikeslab, int K, int k, float* W_hat,
                              float* W_var, float* S, float* SW, float* delta, void* stream) {
  if (z == nullptr || k < 0 || k >= K) return (int)cudaErrorInvalidValue;
  const WPost post = make_post(tau, z2, z2_stride, zz, zz_stride, alpha, ln_alpha, theta_ln,
                               theta_ln1m, scale, scaled, spikeslab, K, k, W_hat, W_var, S, SW,
                               delta);
  return (int)launch_col_dot<true>(E, z, z_stride, n, d, partial, done, u, post,
                                   (cudaStream_t)stream);
}

// T20 then T17 in one pass. E (n x d) f32, updated in place; x (n) and y (d)
// f32 with their strides; B (n x d) f32 or null; z (n) f32 with its stride
// (0: one value); partial, done and u as T17's: u = sum_r z[r] E_new[r, c].
int mt_mofa_rank1_col_dot(float* E, const float* x, long long x_stride, const float* y,
                          long long y_stride, const float* B, const float* z,
                          long long z_stride, int n, int d, float* partial, unsigned* done,
                          float* u, void* stream) {
  return (int)launch_rank1_col_dot_any<false>(E, x, x_stride, y, y_stride, B, z, z_stride, n,
                                              d, partial, done, u, WPost{},
                                              (cudaStream_t)stream);
}

// T20 then T17, then T18 of the factor summed in the finish: the arguments
// of mt_mofa_rank1_col_dot, then those of mt_mofa_w_posterior after u and
// d; delta must not be y (the previous factor's, which the pass reads).
int mt_mofa_rank1_col_dot_posterior(float* E, const float* x, long long x_stride, const float* y,
                                    long long y_stride, const float* B, const float* z,
                                    long long z_stride, int n, int d, float* partial,
                                    unsigned* done, float* u, const float* tau, const float* z2,
                                    long long z2_stride, const float* zz, long long zz_stride,
                                    const float* alpha, const float* ln_alpha,
                                    const float* theta_ln, const float* theta_ln1m, float scale,
                                    int scaled, int spikeslab, int K, int k, float* W_hat,
                                    float* W_var, float* S, float* SW, float* delta,
                                    void* stream) {
  if (k < 0 || k >= K || delta == y) return (int)cudaErrorInvalidValue;
  const WPost post = make_post(tau, z2, z2_stride, zz, zz_stride, alpha, ln_alpha, theta_ln,
                               theta_ln1m, scale, scaled, spikeslab, K, k, W_hat, W_var, S, SW,
                               delta);
  return (int)launch_rank1_col_dot_any<true>(E, x, x_stride, y, y_stride, B, z, z_stride, n, d,
                                             partial, done, u, post, (cudaStream_t)stream);
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
  const WPost post = make_post(tau, z2, z2_stride, zz, zz_stride, alpha, ln_alpha, theta_ln,
                               theta_ln1m, scale, scaled, spikeslab, K, k, W_hat, W_var, S, SW,
                               delta);
  w_posterior_kernel<<<(d + kThreads - 1) / kThreads, kThreads, 0, s>>>(u, d, post);
  return (int)cudaGetLastError();
}

// T19. E (n x d) f32; t (d) f32 with stride t_stride; B (n x d) f32 or null;
// with B, t1 and t2 (d) f32 with stride tb_stride; r (n) out, and with B also
// pb, qb (n) out.
int mt_mofa_row_dot(const float* E, const float* t, long long t_stride, const float* B,
                    const float* t1, const float* t2, long long tb_stride, int n, int d,
                    float* r, float* pb, float* qb, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  float* e = const_cast<float*>(E);
  return B == nullptr ? (int)launch_row_dot<false, false>(e, t, t_stride, B, t1, t2, tb_stride,
                                                          nullptr, 0, nullptr, 0, n, d, r, pb,
                                                          qb, s)
                      : (int)launch_row_dot<true, false>(e, t, t_stride, B, t1, t2, tb_stride,
                                                         nullptr, 0, nullptr, 0, n, d, r, pb,
                                                         qb, s);
}

// T20 then T19 in one pass. E (n x d) f32, updated in place; x (n) and y (d)
// f32 with their strides; B (n x d) f32 or null; then as T19 on the
// corrected E: t (d) with stride t_stride, and with B t1, t2 with stride
// tb_stride; r (n) out, and with B also pb, qb (n) out.
int mt_mofa_rank1_row_dot(float* E, const float* x, long long x_stride, const float* y,
                          long long y_stride, const float* B, const float* t,
                          long long t_stride, const float* t1, const float* t2,
                          long long tb_stride, int n, int d, float* r, float* pb, float* qb,
                          void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  return B == nullptr ? (int)launch_row_dot<false, true>(E, t, t_stride, B, t1, t2, tb_stride,
                                                         x, x_stride, y, y_stride, n, d, r, pb,
                                                         qb, s)
                      : (int)launch_row_dot<true, true>(E, t, t_stride, B, t1, t2, tb_stride,
                                                        x, x_stride, y, y_stride, n, d, r, pb,
                                                        qb, s);
}

// T20. E (n x d) f32, updated in place; x (n) and y (d) f32 with their
// strides; B (n x d) f32 or null.
int mt_mofa_rank1_update(float* E, const float* x, long long x_stride, const float* y,
                         long long y_stride, const float* B, int n, int d, void* stream) {
  if (n <= 0 || d <= 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  const bool vec4 = d % 4 == 0 && (uintptr_t)E % 16 == 0 && (B == nullptr || (uintptr_t)B % 16 == 0);
  const int groups = vec4 ? d / 4 : d;
  const int64_t count = (int64_t)n * groups;
  const int64_t blocks = (count + kR1Threads * kR1Unroll - 1) / (kR1Threads * kR1Unroll);
  if (blocks > 2147483647) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)blocks);
  if (vec4) {
    if (B == nullptr)
      rank1_update_kernel<false, 4><<<grid, kR1Threads, 0, s>>>(E, x, x_stride, y, y_stride, B,
                                                                count, groups);
    else
      rank1_update_kernel<true, 4><<<grid, kR1Threads, 0, s>>>(E, x, x_stride, y, y_stride, B,
                                                               count, groups);
  } else {
    if (B == nullptr)
      rank1_update_kernel<false, 1><<<grid, kR1Threads, 0, s>>>(E, x, x_stride, y, y_stride, B,
                                                                count, groups);
    else
      rank1_update_kernel<true, 1><<<grid, kR1Threads, 0, s>>>(E, x, x_stride, y, y_stride, B,
                                                               count, groups);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
