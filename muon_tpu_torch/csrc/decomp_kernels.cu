// Kernels of the matrix decompositions (FastICA, NMF), for Hopper (sm_90a).
//
//   T32 ica_contrast  <- muon_tpu/ops/ica.py _fastica_fn: the loop body's
//                        fixed-point step before the decorrelation
//   T33 nmf_update    <- muon_tpu/ops/nmf.py _nmf_fn: one multiplicative
//                        update of H or of W, its Gram included
//
// T32. Xw (k x n) f32, the whitened data, row-major; W (k x k) f32. It
// computes, as the reference writes it,
//   g = tanh(W Xw),   W_new = (g Xw^T) / n - mean_j(1 - g^2)[:, None] * W.
// Work: 4 k^2 n flop (two k x k x n products) against k n floats read, so at
// the e2e's k = 50, n = 100,000 it is bound by operations (1.0e9 flop,
// 0.015 ms at 67 TFLOP/s) and Xw's 20 MB take 0.006 ms. The products are
// tiled as a plain float32 GEMM would be, with no tensor cores (the reference
// computes in float32). A block owns a 32 x 32 tile (rows i of W, rows l of
// Xw) of the k x k result and one chunk of the n columns: for each 32
// columns of its chunk it forms g for its 32 rows i (W[i, :] Xw[:, j] over k
// in slices of 32, then tanhf) and adds g Xw[l, j]^T to 4 sums a thread in
// registers. So any k runs in the same 17 KB of shared memory; g is formed
// again for each tile of l (twice at k = 50). Each block writes its partial
// sums of A = g Xw^T and (blocks of the first l tile) of sum_j g', and a
// second kernel adds the chunks' partials in chunk order and forms W_new:
// no float atomics, so a fit repeats bit for bit.
//
// T33. One multiplicative update of the reference's NMF, both factors kept
// with the k factors along their rows (H as H^T, n x k):
//   H^T <- H^T * (X^T W) / (H^T (W^T W) + alpha H^T + eps)
//   W   <- W   * (X H^T) / (W (H H^T) + alpha W + eps)
// So one form serves both: F (rows x k) the factor, N (rows x k) its
// numerator (T2's product of the CSR of X or X^T with the other factor), O
// (other_rows x k) the other factor, whose Gram G = O^T O (k x k) T33 forms
// first. Three orders fix its bits, kept from the first design (three
// launches, a thread per entry): chunk c's partial of G[i][j] is the fmaf
// chain from +0 of O[r, i] O[r, j] over the chunk's rows ascending (the
// wrapper cuts O's rows into the chunks); G[i][j] is the partials added by
// __fadd_rn in chunk order from +0 (no float atomics: a fit repeats bit for
// bit); out[v, i] is the fmaf chain over l ascending from +0 of F[v, l]
// G[l, i], then ((acc + alpha x) + eps) and x N / den.
// Bound: the bytes of F, N, O and the output, 39 MB for H^T at k = 30, n =
// 100,000 with W 25,000 x 30 (0.012 ms at 3.35 TB/s); the Gram's and the
// product's 2 k^2 (rows + other_rows) flop take 0.003 ms.
// Design (launch 1, the Gram): a block a chunk stages its rows of O in
// shared memory by cp.async in four parts, all issued at once, each read as
// soon as it has landed, and forms only the entries on and above the
// diagonal, k(k + 1)/2 (465 at k = 30): fmaf(a, b, c) is fmaf(b, a, c)
// exactly, so G[j][i] takes G[i][j]'s bits, the first design's. A thread
// takes a 2 x 2 tile of G: per row of O two 8-byte shared loads for its 4
// fmas. Launch 2, the fold: a block 8 entries, their partials staged in
// shared memory an entry a row, and a thread an entry runs its chain of
// n_chunks adds from there (16 loaded, then added), then writes G[i][j] and
// G[j][i]. Launch 3, the update at k <= 32 (scOpen's 30): four threads a row
// of F, eight outputs each, 128 rows a block, F, N and G staged in shared
// memory, the outputs written back over N and out coalesced. Above 32
// factors a thread an entry, reading F's row and G through L1.
// What sets the time (exp_t33_variants.py, torch.profiler's kernel spans on
// an H100 at scOpen's shapes): each launch costs about 5 us of the card's
// floor; the update's chains add about as much again as its staged loads
// and stores; the W update's Gram over 100,000 rows of H^T is half staging;
// the fold is its chain of n_chunks dependent adds.
//
// Interface: plain C functions (loaded with ctypes), as in
// sparse_kernels.cu. Each launches on the stream it is given, allocates
// nothing, and returns cudaGetLastError(). Outputs and scratch are
// allocated by the caller.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTile = 32;   // rows of W (i) and of Xw (l) per T32 block
constexpr int kSub = 32;    // columns of Xw per step of a T32 block
constexpr int kRowsPerThread = kTile / 8;  // 256 threads: 32 lanes x 8 warps
constexpr int kThreads = 256;
constexpr float kNmfEps = 1e-10f;  // the reference's eps, in float32

__global__ void __launch_bounds__(kThreads)
ica_partial_kernel(const float* __restrict__ Xw, const float* __restrict__ W, int k,
                   int n, int chunk, float* __restrict__ part_a,
                   float* __restrict__ part_b) {
  __shared__ float Ws[kTile][kTile + 1];  // W[i0 + r, s0 + c]
  __shared__ float Xs[kTile][kSub + 1];   // Xw[s0 + r, j0 + c]
  __shared__ float Gs[kTile][kSub + 1];   // g[i0 + r, j0 + c]
  __shared__ float Ls[kTile][kSub + 1];   // Xw[l0 + r, j0 + c]
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int i0 = blockIdx.x * kTile, l0 = blockIdx.y * kTile;
  const int j_begin = blockIdx.z * chunk;
  const int j_end = min(n, j_begin + chunk);
  float acc[kRowsPerThread] = {};  // A[i0 + warp + 8q, l0 + lane]
  float gp[kRowsPerThread] = {};   // sum of g' of row i0 + warp + 8q, this lane's columns
  for (int j0 = j_begin; j0 < j_end; j0 += kSub) {
    const int j = j0 + lane;
    const bool col_ok = j < j_end;
    float wx[kRowsPerThread] = {};  // (W Xw)[i0 + warp + 8q, j]
    for (int s0 = 0; s0 < k; s0 += kTile) {
#pragma unroll
      for (int q = 0; q < kRowsPerThread; ++q) {
        const int r = warp + 8 * q;
        Ws[r][lane] = (i0 + r < k && s0 + lane < k) ? W[(int64_t)(i0 + r) * k + s0 + lane] : 0.f;
        Xs[r][lane] = (s0 + r < k && col_ok) ? Xw[(int64_t)(s0 + r) * n + j] : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int t = 0; t < kTile; ++t) {
        const float x = Xs[t][lane];
#pragma unroll
        for (int q = 0; q < kRowsPerThread; ++q)
          wx[q] = fmaf(Ws[warp + 8 * q][t], x, wx[q]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int q = 0; q < kRowsPerThread; ++q) {
      const int r = warp + 8 * q;
      const bool ok = i0 + r < k && col_ok;
      const float g = ok ? tanhf(wx[q]) : 0.f;  // 0 adds nothing to A
      Gs[r][lane] = g;
      if (ok) gp[q] = __fadd_rn(gp[q], __fsub_rn(1.f, __fmul_rn(g, g)));
      Ls[r][lane] = (l0 + r < k && col_ok) ? Xw[(int64_t)(l0 + r) * n + j] : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int t = 0; t < kSub; ++t) {
      const float x = Ls[lane][t];
#pragma unroll
      for (int q = 0; q < kRowsPerThread; ++q)
        acc[q] = fmaf(Gs[warp + 8 * q][t], x, acc[q]);
    }
    __syncthreads();
  }
  const int64_t base = (int64_t)blockIdx.z * k;
#pragma unroll
  for (int q = 0; q < kRowsPerThread; ++q) {
    const int i = i0 + warp + 8 * q;
    if (i < k && l0 + lane < k) part_a[(base + i) * k + l0 + lane] = acc[q];
    if (blockIdx.y == 0) {
      float s = gp[q];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, o));
      if (lane == 0 && i < k) part_b[base + i] = s;
    }
  }
}

// W_new[i, l] = (sum over chunks of A) / n - ((sum over chunks of b_i) / n) W[i, l]
__global__ void ica_finish_kernel(const float* __restrict__ part_a,
                                  const float* __restrict__ part_b,
                                  const float* __restrict__ W, int k, int n, int n_chunks,
                                  float* __restrict__ W_new) {
  const int64_t kk = (int64_t)k * k;
  const int64_t e = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (e >= kk) return;
  const int i = (int)(e / k);
  float a = 0.f, b = 0.f;
  for (int c = 0; c < n_chunks; ++c) {
    a = __fadd_rn(a, part_a[c * kk + e]);
    b = __fadd_rn(b, part_b[(int64_t)c * k + i]);
  }
  const float nf = (float)n;
  W_new[e] = __fsub_rn(__fdiv_rn(a, nf), __fmul_rn(__fdiv_rn(b, nf), W[e]));
}

// --- T33 ---
constexpr int kGramThreads = 256;
constexpr int kGramSub = 2;       // a thread's tile of G: kGramSub x kGramSub entries
constexpr int kGramRows = 1536;   // floats of a chunk's rows of O a part holds
constexpr int kGramParts = 4;     // parts of a chunk's rows staged at once
constexpr int kFoldThreads = 256;
constexpr int kFoldEntries = 8;   // entries of G a fold block adds up
constexpr int kFoldTile = 8192;   // floats of their partials staged at a time
constexpr int kFoldBatch = 16;    // partials a thread loads before adding them
constexpr int kRowK = 32;         // the update's row path: k <= 32
constexpr int kRowSplit = 4;      // threads a row of F in the row path
constexpr int kRowsPerBlock = 128;
constexpr int kRowThreads = kRowsPerBlock * kRowSplit;
constexpr int kRowOut = kRowK / kRowSplit;  // outputs a thread, a multiple of 4

// 4 bytes from global to shared memory without a register (cp.async)
__device__ __forceinline__ void copy4(float* dst, const float* src) {
  __pipeline_memcpy_async(dst, src, 4);
}

__device__ __forceinline__ void wait_copies() {
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();
}

// the index of G's entry (i, j), i <= j, among the entries on and above the
// diagonal, row by row
__device__ __forceinline__ int upper_index(int i, int j, int k) {
  return i * k - i * (i - 1) / 2 + (j - i);
}

// n floats as loaded by one shared-memory load (n = 2 or 4, aligned)
template <int n>
__device__ __forceinline__ void load_sub(const float* p, float (&v)[n]) {
  if constexpr (n == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    v[0] = t.x, v[1] = t.y;
  } else {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x, v[1] = t.y, v[2] = t.z, v[3] = t.w;
  }
}

// Chunk c's partial Gram: the fmaf chain from +0 of O[r, i] O[r, j] over the
// chunk's rows r ascending, for the entries on and above the diagonal, into
// part[c][upper_index(i, j)]. A thread takes an S x S tile of G (S = kGramSub,
// rows S p .., columns S q .., p <= q): per row of O two S-float shared
// loads for its S^2 fmas. The chunk's rows are staged by cp.async in
// kGramParts parts of R rows (R kp <= kGramRows, kp = k rounded up to 4),
// all issued at once, and each part is read as soon as it has landed; a
// longer chunk takes several such rounds.
__device__ void gram_partial(const float* __restrict__ O, int other_rows, int k, int chunk,
                             int c, float* __restrict__ part, float* s_rows) {
  constexpr int S = kGramSub;
  const int n_up = k * (k + 1) / 2;
  const int kp = (k + 3) & ~3, nt = kp / S;
  const int R = max(1, kGramRows / kp);
  const int r_begin = c * chunk, r_end = min(other_rows, r_begin + chunk);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int tiles = nt * (nt + 1) / 2;
  for (int t0 = 0; t0 < tiles; t0 += kGramThreads) {
    int p = 0, q = t0 + threadIdx.x;  // tile row p holds nt - p tiles
    while (q >= nt - p && p < nt) q -= nt - p++;
    q += p;
    const bool live = t0 + threadIdx.x < tiles;
    float acc[S][S] = {};
    for (int base = r_begin; base < r_end; base += kGramParts * R) {
      __syncthreads();  // the previous round's rows are read
      for (int part_ = 0; part_ < kGramParts; ++part_) {  // one commit group a part
        const int r0 = base + part_ * R, nr = max(0, min(R, r_end - r0));
        const float* src = O + (size_t)r0 * k;
        float* buf = s_rows + part_ * R * kp;
        for (int r = warp; r < nr; r += kGramThreads / 32)
          for (int x = lane; x < k; x += 32) copy4(buf + r * kp + x, src + r * k + x);
        __pipeline_commit();
      }
#pragma unroll
      for (int part_ = 0; part_ < kGramParts; ++part_) {
        __pipeline_wait_prior(kGramParts - 1 - part_);
        __syncthreads();  // part part_ has landed
        const float* rows = s_rows + part_ * R * kp;
        const int nr = max(0, min(R, r_end - (base + part_ * R)));
        if (live) {
#pragma unroll 4
          for (int r = 0; r < nr; ++r) {
            float av[S], bv[S];
            load_sub<S>(rows + r * kp + S * p, av);
            load_sub<S>(rows + r * kp + S * q, bv);
#pragma unroll
            for (int u = 0; u < S; ++u)
#pragma unroll
              for (int v = 0; v < S; ++v) acc[u][v] = fmaf(av[u], bv[v], acc[u][v]);
          }
        }
      }
    }
    if (live) {
#pragma unroll
      for (int u = 0; u < S; ++u)
#pragma unroll
        for (int v = 0; v < S; ++v) {
          const int i = S * p + u, j = S * q + v;
          if (i <= j && j < k) part[(size_t)c * n_up + upper_index(i, j, k)] = acc[u][v];
        }
    }
  }
}

// kFoldEntries entries of G from the partials: G[i][j] = G[j][i] =
// part[0][e] + ... + part[n_chunks - 1][e], __fadd_rn in chunk order from
// +0, e = upper_index(i, j). The block stages its entries' partials (a
// chunk's entries lie together) into shared memory an entry a row, rows an
// odd number of floats apart, and a thread an entry runs its chain from
// there, kFoldBatch partials loaded before they are added.
__device__ void fold_entries(const float* __restrict__ part, int n_chunks, int k, int e0,
                             float* __restrict__ G, float* s_part) {
  const int n_up = k * (k + 1) / 2, ne = min(kFoldEntries, n_up - e0);
  const int C = kFoldTile / kFoldEntries - 1;  // chunks a tile: rows of C | 1 floats
  float g = 0.f;
  for (int c0 = 0; c0 < n_chunks; c0 += C) {
    const int nc = min(C, n_chunks - c0), ncs = nc | 1;
    __syncthreads();  // the previous tile is read
    for (int x = threadIdx.x; x < nc * ne; x += kFoldThreads) {
      const int c = x / ne, e = x - c * ne;
      copy4(s_part + e * ncs + c, part + (size_t)(c0 + c) * n_up + e0 + e);
    }
    wait_copies();
    if (threadIdx.x < ne) {
      const float* sp = s_part + threadIdx.x * ncs;
      int x = 0;
      for (; x + kFoldBatch <= nc; x += kFoldBatch) {
        float v[kFoldBatch];
#pragma unroll
        for (int u = 0; u < kFoldBatch; ++u) v[u] = sp[x + u];
#pragma unroll
        for (int u = 0; u < kFoldBatch; ++u) g = __fadd_rn(g, v[u]);
      }
      for (; x < nc; ++x) g = __fadd_rn(g, sp[x]);
    }
  }
  if (threadIdx.x < ne) {
    int i = 0, j = e0 + threadIdx.x;  // row i of the upper entries holds k - i of them
    while (j >= k - i) j -= k - i++;
    j += i;
    G[(size_t)i * k + j] = g;
    G[(size_t)j * k + i] = g;
  }
}

__global__ void __launch_bounds__(kGramThreads)
nmf_gram_partial_kernel(const float* __restrict__ O, int other_rows, int k, int chunk,
                        float* __restrict__ part) {
  extern __shared__ __align__(16) float s_rows[];
  gram_partial(O, other_rows, k, chunk, blockIdx.x, part, s_rows);
}

__global__ void __launch_bounds__(kFoldThreads)
nmf_gram_fold_kernel(const float* __restrict__ part, int n_chunks, int k,
                     float* __restrict__ G) {
  __shared__ float s_part[kFoldTile];
  fold_entries(part, n_chunks, k, blockIdx.x * kFoldEntries, G, s_part);
}

// The update for k <= 32: kRowSplit threads a row v of F, each kRowOut of
// its outputs. The block's rows of F and N are staged in shared memory (a
// warp a row, coalesced; rows k | 1 floats apart, so the rows a warp reads
// meet no bank conflict), G (k x k) too, its rows 32 floats apart. Out[v,
// i] is the fmaf chain over l ascending from +0 of F[v, l] G[l, i], F[v, l]
// read from shared memory as a broadcast to the row's threads and G's rows
// four entries at a time, then ((acc + alpha x) + eps) and x N / den (IEEE
// division); each output replaces its N in shared memory, and the block's
// rows go out coalesced.
__global__ void __launch_bounds__(kRowThreads)
nmf_update_rows_kernel(const float* __restrict__ F, const float* __restrict__ N,
                       const float* __restrict__ G, int k, int rows, float alpha,
                       float* __restrict__ out) {
  __shared__ __align__(16) float s_g[kRowK * kRowK];
  __shared__ float s_f[kRowsPerBlock * (kRowK + 1)];
  __shared__ float s_n[kRowsPerBlock * (kRowK + 1)];
  const int ks = k | 1;
  const int64_t v0 = (int64_t)blockIdx.x * kRowsPerBlock;
  const int nr = (int)min((int64_t)kRowsPerBlock, rows - v0);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const float* Fb = F + v0 * k;
  const float* Nb = N + v0 * k;
  for (int r = warp; r < nr; r += kRowThreads / 32) {
    for (int x = lane; x < k; x += 32) {
      copy4(s_f + r * ks + x, Fb + r * k + x);
      copy4(s_n + r * ks + x, Nb + r * k + x);
    }
  }
  for (int x = threadIdx.x; x < kRowK * kRowK; x += kRowThreads) {
    const int l = x / kRowK, i = x % kRowK;
    s_g[x] = l < k && i < k ? G[l * k + i] : 0.f;
  }
  wait_copies();
  const int t = threadIdx.x / kRowSplit, i0 = threadIdx.x % kRowSplit * kRowOut;
  if (t < nr) {
    const float* fr = s_f + t * ks;
    float* nt = s_n + t * ks;
    float acc[kRowOut];
#pragma unroll
    for (int u = 0; u < kRowOut; ++u) acc[u] = 0.f;
#pragma unroll
    for (int l = 0; l < kRowK; ++l) {
      if (l < k) {
        const float f = fr[l];
#pragma unroll
        for (int q = 0; q < kRowOut / 4; ++q) {
          const float4 g = *reinterpret_cast<const float4*>(s_g + l * kRowK + i0 + 4 * q);
          acc[4 * q] = fmaf(f, g.x, acc[4 * q]);
          acc[4 * q + 1] = fmaf(f, g.y, acc[4 * q + 1]);
          acc[4 * q + 2] = fmaf(f, g.z, acc[4 * q + 2]);
          acc[4 * q + 3] = fmaf(f, g.w, acc[4 * q + 3]);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kRowOut; ++u) {
      const int i = i0 + u;
      if (i < k) {
        const float x = fr[i];
        const float den = __fadd_rn(__fadd_rn(acc[u], __fmul_rn(alpha, x)), kNmfEps);
        nt[i] = __fdiv_rn(__fmul_rn(x, nt[i]), den);
      }
    }
  }
  __syncthreads();
  float* ob = out + v0 * k;
  for (int r = warp; r < nr; r += kRowThreads / 32)
    for (int x = lane; x < k; x += 32) ob[r * k + x] = s_n[r * ks + x];
}

// The update for k > 32: a thread an entry, the same chain and expression
// (F's row and G's column read through L1)
__global__ void nmf_update_kernel(const float* __restrict__ F, const float* __restrict__ N,
                                  const float* __restrict__ G, int k, int rows, float alpha,
                                  float* __restrict__ out) {
  const int64_t total = (int64_t)k * rows;
  for (int64_t e = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; e < total;
       e += (int64_t)gridDim.x * blockDim.x) {
    const int64_t v = e / k;
    const int i = (int)(e - v * k);
    const float* f = F + v * k;
    float acc = 0.f;
    for (int l = 0; l < k; ++l) acc = fmaf(f[l], __ldg(G + (int64_t)l * k + i), acc);
    const float x = F[e];
    const float den = __fadd_rn(__fadd_rn(acc, __fmul_rn(alpha, x)), kNmfEps);
    out[e] = __fdiv_rn(__fmul_rn(x, N[e]), den);
  }
}

// the dynamic shared memory of the Gram kernel at k: its parts
size_t gram_smem_bytes(int k) {
  const int kp = (k + 3) & ~3;
  return kGramParts * (size_t)max(1, kGramRows / kp) * kp * sizeof(float);
}

// the Gram's dynamic shared memory limit, raised above the default 48 KB
// where k needs it
cudaError_t allow_smem(size_t gram_bytes) {
  if (gram_bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(nmf_gram_partial_kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, (int)gram_bytes);
}

}  // namespace

extern "C" {

// T32. Xw (k x n) f32; W (k x k) f32; the columns in n_chunks chunks of
// `chunk` (a multiple of 32; n_chunks = ceil(n / chunk) <= 65535);
// part_a (n_chunks x k x k) and part_b (n_chunks x k) f32 scratch; W_new
// (k x k) f32 out.
int mt_ica_contrast(const float* Xw, const float* W, int k, int n, int chunk, int n_chunks,
                    float* part_a, float* part_b, float* W_new, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (k <= 0 || n <= 0) return (int)cudaGetLastError();
  const int tiles = (k + kTile - 1) / kTile;
  ica_partial_kernel<<<dim3(tiles, tiles, n_chunks), kThreads, 0, s>>>(Xw, W, k, n, chunk,
                                                                       part_a, part_b);
  const int64_t kk = (int64_t)k * k;
  ica_finish_kernel<<<(unsigned)((kk + kThreads - 1) / kThreads), kThreads, 0, s>>>(
      part_a, part_b, W, k, n, n_chunks, W_new);
  return (int)cudaGetLastError();
}

// T33. F and N (rows x k) f32; O (other_rows x k) f32; its rows in n_chunks
// chunks of `chunk` (n_chunks = ceil(other_rows / chunk) <= 65535); part
// (n_chunks x k x k) f32 scratch (its first n_chunks k (k + 1) / 2 floats
// written); G (k x k) f32, written with O^T O; out (rows x k) f32 (not F
// itself). events: null, or four cudaEvent_t recorded on the stream before
// the Gram, the fold and the update and after the update (their times).
int mt_nmf_update(const float* F, const float* N, const float* O, int rows, int other_rows,
                  int k, float alpha, int chunk, int n_chunks, float* part, float* G,
                  float* out, void* const* events, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  auto mark = [&](int p) {
    if (events != nullptr) cudaEventRecord((cudaEvent_t)events[p], s);
  };
  if (k <= 0) return (int)cudaGetLastError();
  mark(0);
  if (n_chunks > 0) {
    const size_t smem = gram_smem_bytes(k);
    const cudaError_t ok = allow_smem(smem);
    if (ok != cudaSuccess) return (int)ok;
    nmf_gram_partial_kernel<<<n_chunks, kGramThreads, smem, s>>>(O, other_rows, k, chunk, part);
    mark(1);
    const int64_t n_up = (int64_t)k * (k + 1) / 2;
    nmf_gram_fold_kernel<<<(int)((n_up + kFoldEntries - 1) / kFoldEntries), kFoldThreads, 0, s>>>(
        part, n_chunks, k, G);
  } else {
    mark(1);
    cudaMemsetAsync(G, 0, (size_t)k * k * sizeof(float), s);
  }
  mark(2);
  if (rows > 0 && k <= kRowK) {
    const int blocks = (int)(((int64_t)rows + kRowsPerBlock - 1) / kRowsPerBlock);
    nmf_update_rows_kernel<<<blocks, kRowThreads, 0, s>>>(F, N, G, k, rows, alpha, out);
  } else if (rows > 0) {
    int64_t blocks = ((int64_t)k * rows + kThreads - 1) / kThreads;
    if (blocks > 132 * 16) blocks = 132 * 16;  // grid-stride beyond 16 per SM
    nmf_update_kernel<<<(int)blocks, kThreads, 0, s>>>(F, N, G, k, rows, alpha, out);
  }
  mark(3);
  return (int)cudaGetLastError();
}

}  // extern "C"
