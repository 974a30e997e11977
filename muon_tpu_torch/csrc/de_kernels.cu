// Kernels of the marker-gene tests (rank_genes_groups), for Hopper (sm_90a).
//
//   T26 wilcoxon_rank_sums   <- muon_tpu/_core/tools_de.py ranksum (:175)
//   T27 logreg_softmax_grad  <- muon_tpu/_core/tools_de.py fit (:248): the
//                               gradient of the weighted cross entropy in the logits
//   T28 adam_update          <- the same fit: optax.adam's update of W and b,
//                               with the L2 term's gradient added to W's
//
// T26 takes one column block of X already sorted along the cells (torch.sort,
// stable, by the wrapper: a sort is no product and the reference sorts too),
// as `vals` (b x n, f32, a row per column) and the permutation `perm` (b x n,
// int64), and the group code of every cell (-1: no group; such a cell still
// takes part in the ranks, as in the reference). A warp walks one column in
// chunks of 32 cells. The reference's searchsorted bounds of an element's tie
// run are, with 0-based positions, lo = the run's first position and hi = one
// past its last; its average rank is (lo + 1 + hi) / 2. Forward over the
// chunks, a ballot of the run starts and the carried last start give lo; in
// the same pass each run's last element adds t^3 - t (t = hi - lo: the
// reference's sum over elements of t^2 - 1). Backward, a ballot of the run
// ends and the carried next end give hi. The warp adds lo + 1 and hi, as
// integers, into its group's 64-bit counter in shared memory: twice the rank
// sum, exact in any order, so the atomics repeat bit for bit. The counters
// become the float64 rank sums (exact: half-integers below 2^53) and the tie
// term an int64.
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
constexpr int kRankWarps = 8;      // T26: columns (warps) per block
constexpr int kGradWarps = 8;      // T27: warps per block
constexpr int kFinishThreads = 256;
constexpr int kAdamThreads = 256;

// T26: a warp per column of the sorted block
__global__ void __launch_bounds__(kWarp * kRankWarps)
wilcoxon_rank_sums_kernel(const float* __restrict__ vals,
                          const int64_t* __restrict__ perm,
                          const int* __restrict__ codes, int n, int b, int g,
                          double* __restrict__ rank_sums,
                          long long* __restrict__ tie_term) {
  extern __shared__ unsigned long long acc[];  // kRankWarps x g
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int c = blockIdx.x * kRankWarps + warp;
  unsigned long long* my = acc + (int64_t)warp * g;
  for (int i = lane; i < g; i += kWarp) my[i] = 0ull;
  __syncwarp();
  if (c >= b) return;  // whole warps leave together
  const float* s = vals + (int64_t)c * n;
  const int64_t* p = perm + (int64_t)c * n;

  // forward: lo of every element, and t^3 - t at every run's last element
  int carry_lo = 0;
  unsigned long long tie = 0ull;
  for (int base = 0; base < n; base += kWarp) {
    const int i = base + lane;
    const bool in = i < n;
    const float x = in ? s[i] : 0.f;
    const bool start = in && (i == 0 || x != s[i - 1]);
    const unsigned below = __ballot_sync(kFull, start) & ((2u << lane) - 1u);
    const int lo = below ? base + 31 - __clz(below) : carry_lo;
    carry_lo = __shfl_sync(kFull, lo, kWarp - 1);
    if (in) {
      if (i == n - 1 || s[i + 1] != x) {
        const unsigned long long t = (unsigned long long)(i + 1 - lo);
        tie += t * t * t - t;
      }
      const int code = codes[p[i]];
      if (code >= 0) atomicAdd(&my[code], (unsigned long long)(lo + 1));
    }
  }
  // backward: hi of every element
  int carry_hi = n;
  for (int base = ((n - 1) / kWarp) * kWarp; base >= 0; base -= kWarp) {
    const int i = base + lane;
    const bool in = i < n;
    const bool end = in && (i == n - 1 || s[i + 1] != s[i]);
    const unsigned above = __ballot_sync(kFull, end) & ~((1u << lane) - 1u);
    const int hi = above ? base + __ffs(above) : carry_hi;  // one past the run's end
    carry_hi = __shfl_sync(kFull, hi, 0);
    if (in) {
      const int code = codes[p[i]];
      if (code >= 0) atomicAdd(&my[code], (unsigned long long)hi);
    }
  }
#pragma unroll
  for (int o = kWarp / 2; o > 0; o >>= 1) tie += __shfl_xor_sync(kFull, tie, o);
  __syncwarp();
  if (lane == 0) tie_term[c] = (long long)tie;
  for (int i = lane; i < g; i += kWarp) rank_sums[(int64_t)i * b + c] = 0.5 * (double)my[i];
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
  const size_t shm = (size_t)kRankWarps * (g > 0 ? g : 1) * sizeof(unsigned long long);
  if (shm > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(wilcoxon_rank_sums_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)shm);
    if (e != cudaSuccess) return (int)e;
  }
  const int blocks = (b + kRankWarps - 1) / kRankWarps;
  wilcoxon_rank_sums_kernel<<<blocks, kWarp * kRankWarps, shm, s>>>(
      vals, perm, codes, n, b, g, rank_sums, tie_term);
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
