// Kernels of the WNN multimodal neighbors path, for Hopper (sm_90a).
//
//   T9  wnn_bandwidth      <- muon_tpu/ops/wnn.py _bandwidth_fn +
//                             _bandwidth_block_math
//   T10 wnn_theta          <- muon_tpu/ops/wnn.py _theta_fn + _theta_block_math
//   T11 wnn_fusion_scores  <- muon_tpu/ops/wnn.py _fusion_all_fn +
//                             _fusion_block_math
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
// (rank sort), so each Jaccard intersection is kk binary searches; the order
// of the C candidates is a rank count over (score, position), O(C^2) per
// cell, which at C = 209 is 44k comparisons spread over the block. The
// gathers (neighbour rows, bf16 reps) stay in L2 at 100k cells (NI 7.6 MB,
// reps 10 MB). Bound by the per-candidate gathers and the rank count.
// Not done yet (later work): a warp per cell with a bitonic top-osz.
// ---------------------------------------------------------------------------

constexpr int kBwThreads = 256;

// the number of entries of the sorted sx[0, kk) equal to y
__device__ __forceinline__ int count_equal(const int* sx, int kk, int y) {
  int lo = 0, hi = kk;
  while (lo < hi) {  // first >= y
    const int mid = (lo + hi) >> 1;
    if (sx[mid] < y) lo = mid + 1; else hi = mid;
  }
  int lo2 = lo, hi2 = kk;
  while (lo2 < hi2) {  // first > y
    const int mid = (lo2 + hi2) >> 1;
    if (sx[mid] <= y) lo2 = mid + 1; else hi2 = mid;
  }
  return lo2 - lo;
}

__global__ void __launch_bounds__(kBwThreads)
    wnn_bandwidth_kernel(const int* __restrict__ NI,
                         const int* __restrict__ set_sizes,
                         const __nv_bfloat16* __restrict__ rep16,
                         const float* __restrict__ sq, int kk, int d,
                         int stride, int n_bw, float n_total, float bbox,
                         float* __restrict__ sigma) {
  extern __shared__ int smem[];
  const int s = (kk + stride - 1) / stride;
  const int C = kk + kk * s;
  const int osz = min(C, 4 * n_bw);
  int* sx = smem;                     // kk: the cell's set, sorted
  int* cand = sx + kk;                // C
  int* top = cand + C;                // osz: positions, in (score, pos) order
  int* drop = top + osz;              // osz: bad or duplicate
  float* score = reinterpret_cast<float*>(drop + osz);  // C
  float* eucl = score + C;            // C
  float* q = eucl + C;                // d: the cell's bf16 rep, as f32
  __shared__ float fallback_sum;

  const int i = blockIdx.x;
  const int t = threadIdx.x;
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

  // the first osz by (score, position): rank count, every rank distinct
  for (int p = t; p < C; p += blockDim.x) {
    const int key = ordered(score[p]);
    int rank = 0;
    for (int j = 0; j < C; ++j) {
      const int kj = ordered(score[j]);
      rank += (kj < key) || (kj == key && j < p);
    }
    if (rank < osz) top[rank] = p;
  }
  __syncthreads();
  for (int r = t; r < osz; r += blockDim.x) {
    const int c = cand[top[r]];
    bool bad = score[top[r]] >= bad_score;
    for (int j = 0; j < r && !bad; ++j) bad = cand[top[j]] == c;
    drop[r] = bad;
  }
  if (t == 0) {
    float f = 0.f;
    for (int p = 0; p < kk; ++p) f += eucl[p];
    fallback_sum = f;
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
    sigma[i] = cnt > 0 ? __fdiv_rn(sum, (float)cnt)
                       : __fdiv_rn(fallback_sum, (float)kk);
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
// One warp per cell: the cell's row is staged in shared memory as f32, and
// each lane scores one candidate at a time, walking its bf16 row. Bound by
// the candidate gathers: 100k x 400 rows of 200 B, 8 GB read mostly from
// L2 (the table is 20 MB). Not done yet: coalesced row loads (a warp per
// candidate row) or a tensor-core cross term.
// ---------------------------------------------------------------------------

constexpr int kFusionWarps = 8;

__global__ void __launch_bounds__(kFusionWarps * 32)
    wnn_fusion_kernel(const int* __restrict__ cand,
                      const __nv_bfloat16* __restrict__ cat16,
                      const float* __restrict__ aux,
                      const float* __restrict__ sigw,
                      const int* __restrict__ offs, int n, int C, int D, int M,
                      int cosine, float* __restrict__ out) {
  extern __shared__ float qs[];  // kFusionWarps rows of D
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * kFusionWarps + warp;
  if (i >= n) return;  // no block-wide barrier below
  float* q = qs + (int64_t)warp * D;
  for (int u = lane; u < D; u += 32)
    q[u] = __bfloat162float(cat16[(int64_t)i * D + u]);
  __syncwarp();
  const float* aq = aux + (int64_t)i * 2 * M;
  const float* sw = sigw + (int64_t)i * 2 * M;
  for (int p = lane; p < C; p += 32) {
    const int c = cand[(int64_t)i * C + p];
    float total = 0.f;
    if (c >= 0) {
      const __nv_bfloat16* crow = cat16 + (int64_t)c * D;
      const float* ac = aux + (int64_t)c * 2 * M;
      for (int mm = 0; mm < M; ++mm) {
        float cross = 0.f;
        for (int u = offs[mm]; u < offs[mm + 1]; ++u)
          cross = fmaf(q[u], __bfloat162float(crow[u]), cross);
        const float dist =
            cosine ? __fsub_rn(1.f, cross)
                   : sqrtf(fmaxf(__fsub_rn(__fadd_rn(aq[mm], ac[mm]),
                                           __fmul_rn(2.f, cross)), 0.f));
        const float pres = __fmul_rn(ac[M + mm], aq[M + mm]);
        const float sig = fmaxf(sw[mm], 1e-12f);
        const float contrib = __fmul_rn(expf(__fdiv_rn(-dist, sig)), sw[M + mm]);
        total = __fadd_rn(total, __fmul_rn(contrib, pres));
      }
    }
    out[(int64_t)i * C + p] = total;
  }
}

}  // namespace

extern "C" {

// T9. NI (n x kk) int32, pad -1; set_sizes (n,) int32 = valid entries per
// row; rep16 (n x d) bf16; sq (n,) f32 squared norms of the unrounded rep;
// sigma (n,) f32 out.
int mt_wnn_bandwidth(const int* NI, const int* set_sizes, const void* rep16,
                     const float* sq, int n, int kk, int d, int stride,
                     int n_bw, float n_total, float bbox, float* sigma,
                     void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (n > 0 && kk > 0) {
    const int s = (kk + stride - 1) / stride;
    const int C = kk + kk * s;
    const int osz = C < 4 * n_bw ? C : 4 * n_bw;
    const size_t bytes = sizeof(int) * (kk + C + 2 * osz) + sizeof(float) * (2 * C + d);
    cudaError_t e = cudaFuncSetAttribute(
        wnn_bandwidth_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
    wnn_bandwidth_kernel<<<n, kBwThreads, bytes, st>>>(
        NI, set_sizes, reinterpret_cast<const __nv_bfloat16*>(rep16), sq, kk, d,
        stride, n_bw, n_total, bbox, sigma);
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

// T11. cand (n x C) int32, -1 absent; cat16 (n x D) bf16; aux, sigw
// (n x 2M) f32; offs (M+1,) int32 slice bounds; out (n x C) f32.
int mt_wnn_fusion_scores(const int* cand, const void* cat16, const float* aux,
                         const float* sigw, const int* offs, int n, int C,
                         int D, int M, int cosine, float* out, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (n > 0 && C > 0) {
    const size_t bytes = sizeof(float) * kFusionWarps * (size_t)D;
    cudaError_t e = cudaFuncSetAttribute(
        wnn_fusion_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
    wnn_fusion_kernel<<<(n + kFusionWarps - 1) / kFusionWarps, kFusionWarps * 32,
                        bytes, st>>>(
        cand, reinterpret_cast<const __nv_bfloat16*>(cat16), aux, sigw, offs, n,
        C, D, M, cosine, out);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
