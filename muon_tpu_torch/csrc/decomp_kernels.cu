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
// first. Launch 1 gives each block a chunk of O's rows and each thread up to
// 4 entries of G a pass (k^2 / 1024 passes), reading O's rows through L1
// (a row is 120 B at k = 30); it writes the chunk's partial Gram. Launch 2
// adds the partials in chunk order (no float atomics: a fit repeats bit for
// bit). Launch 3 updates F, a thread per entry, the sum over k ascending and
// the denominator added as the reference writes it ((FG + aF) + eps).
// Bound: the bytes of F, N, O and the output, 39 MB for H at k = 30, n =
// 100,000 with W 25,000 x 30 (0.012 ms); the Gram's and the product's
// 2 k^2 (rows + other_rows) flop take 0.003 ms.
//
// Interface: plain C functions (loaded with ctypes), as in
// sparse_kernels.cu. Each launches on the stream it is given, allocates
// nothing, and returns cudaGetLastError(). Outputs and scratch are
// allocated by the caller.

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

constexpr int kGramAcc = 4;  // entries of G a thread holds in one pass

// part[c] = sum over the rows r of chunk c of O[r, i] O[r, j], rows ascending
__global__ void __launch_bounds__(kThreads)
nmf_gram_partial_kernel(const float* __restrict__ O, int other_rows, int k, int chunk,
                        float* __restrict__ part) {
  const int64_t kk = (int64_t)k * k;
  const int r_begin = blockIdx.x * chunk;
  const int r_end = min(other_rows, r_begin + chunk);
  for (int64_t e0 = 0; e0 < kk; e0 += (int64_t)kThreads * kGramAcc) {
    int ii[kGramAcc], jj[kGramAcc];
    float acc[kGramAcc];
#pragma unroll
    for (int q = 0; q < kGramAcc; ++q) {
      const int64_t e = min(e0 + threadIdx.x + (int64_t)q * kThreads, kk - 1);
      ii[q] = (int)(e / k);
      jj[q] = (int)(e - (int64_t)ii[q] * k);
      acc[q] = 0.f;
    }
    for (int r = r_begin; r < r_end; ++r) {
      const float* o = O + (int64_t)r * k;
#pragma unroll
      for (int q = 0; q < kGramAcc; ++q) acc[q] = fmaf(__ldg(o + ii[q]), __ldg(o + jj[q]), acc[q]);
    }
#pragma unroll
    for (int q = 0; q < kGramAcc; ++q) {
      const int64_t e = e0 + threadIdx.x + (int64_t)q * kThreads;
      if (e < kk) part[blockIdx.x * kk + e] = acc[q];
    }
  }
}

__global__ void nmf_gram_reduce_kernel(const float* __restrict__ part, int n_chunks,
                                       int64_t kk, float* __restrict__ G) {
  const int64_t e = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (e >= kk) return;
  float g = 0.f;
  for (int c = 0; c < n_chunks; ++c) g = __fadd_rn(g, part[c * kk + e]);
  G[e] = g;
}

// out[v, i] = F[v, i] N[v, i] / ((F G)[v, i] + alpha F[v, i] + eps)
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
// (n_chunks x k x k) f32 scratch; G (k x k) f32, written with O^T O; out
// (rows x k) f32 (not F itself: every thread reads k entries of F).
int mt_nmf_update(const float* F, const float* N, const float* O, int rows, int other_rows,
                  int k, float alpha, int chunk, int n_chunks, float* part, float* G,
                  float* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (k <= 0) return (int)cudaGetLastError();
  const int64_t kk = (int64_t)k * k;
  if (n_chunks > 0) {
    nmf_gram_partial_kernel<<<n_chunks, kThreads, 0, s>>>(O, other_rows, k, chunk, part);
    nmf_gram_reduce_kernel<<<(unsigned)((kk + kThreads - 1) / kThreads), kThreads, 0, s>>>(
        part, n_chunks, kk, G);
  } else {
    cudaMemsetAsync(G, 0, kk * sizeof(float), s);
  }
  const int64_t total = (int64_t)k * rows;
  if (total <= 0) return (int)cudaGetLastError();
  int64_t blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 132 * 16) blocks = 132 * 16;  // grid-stride beyond 16 per SM
  nmf_update_kernel<<<(int)blocks, kThreads, 0, s>>>(F, N, G, k, rows, alpha, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
