// PWM motif scan, for Hopper (sm_90a).
//
//   T36 pwm_scan  <- muon_tpu/ops/pwm.py _conv_fn (:114), and the comparison
//                    with each motif's threshold in find_hits (:166)
//
// A window's score under a motif of width w is the float32 sum, in column
// order j = 0..w-1 and with plain adds, of lo[off + j][code[pos + j]]. The
// reference forms the same w terms as a one-hot convolution (the other
// three products of a column are exact zeros), perhaps in another order. A
// window with a code of 4 (not ACGT, or padding) is no hit and scores -inf,
// as the reference's mask convolution makes it.
//
// Operands: the sequences as uint8 codes (n x L, row-major); every motif's
// log-odds packed as float32 rows of 4 (A, C, G, T), motif m at rows
// off[m] .. off[m] + width[m] - 1; one float32 threshold per motif (the
// least float32 not below the float64 threshold, so `score >= t` admits
// the reference's hits exactly). A launch scans the motifs [m0, m1), whose
// rows it copies into shared memory (JASPAR's 746 motifs are 8,983 rows,
// 140 KiB, under the H100's 227 KB a block may opt into; the wrapper reads
// the device's limit and cuts a larger set into chunks that fit, one launch
// each).
//
// Modes:
//   0 count:  counts[s * M + m] = number of hits of the pair (s, m);
//   1 write:  for the pairs with a count, the hits again, written from
//             offsets[s * M + m] on (the exclusive scan of counts in
//             (sequence, motif) order, so the hits come out in the
//             reference's lexsorted order with no sort), in position order
//             by a ballot prefix within the warp;
//   2 scores: scores[(s * P + p) * M + m] for every window, -inf where
//             invalid (all M motifs of one width; a launch writes its own
//             motifs' columns).
//
// Work: a warp per (sequence, motif) pair, its lanes over consecutive
// positions (kWin windows a lane, 32 positions apart, summed side by side
// so that their loads overlap), so the codes one warp reads are 32
// consecutive bytes (L1) and
// the log-odds of one column are 4 words of one 16-byte row of shared
// memory (a broadcast, no bank conflict). Blocks of 32 warps walk the pairs
// with a grid stride, consecutive warps on consecutive motifs of one
// sequence, so a sequence's codes stay in L1 while its motifs pass. At
// 100,000 x 500 bp x 746 motifs there are 4.4e11 lookups and adds over
// 3.65e10 windows: bound by operations (about 6.6 ms at the float32 rate)
// while the bytes (50 MB of codes, the hits) take 0.03 ms. This simple
// design spends two dependent loads (a code from L1, then a log-odds word
// from shared memory) on each add; hits are about 1e-4 of windows, so the
// write pass rescans only the few pairs that have any.
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
constexpr int kThreads = 1024;  // 32 warps a block
constexpr int kInvalid = 4;
constexpr int kWin = 4;  // windows a lane keeps in flight

template <int kMode>
__global__ void __launch_bounds__(kThreads)
pwm_scan_kernel(const uint8_t* __restrict__ codes, int n, int L,
                const float* __restrict__ lo, const int* __restrict__ off,
                const int* __restrict__ width, const float* __restrict__ thr,
                int n_motifs, int m0, int m1, int row0, int rows, int* __restrict__ counts,
                const long long* __restrict__ offsets, int* __restrict__ hit_seq,
                int* __restrict__ hit_motif, int* __restrict__ hit_pos,
                float* __restrict__ hit_score, float* __restrict__ scores, int P_out) {
  extern __shared__ float4 lo_rows[];
  const float* lo_s = reinterpret_cast<const float*>(lo_rows);
  const float4* lo4 = reinterpret_cast<const float4*>(lo) + row0;
  for (int i = threadIdx.x; i < rows; i += blockDim.x) lo_rows[i] = lo4[i];
  __syncthreads();

  const int lane = threadIdx.x % kWarp;
  const int mc = m1 - m0;
  const long long n_tasks = (long long)n * mc;
  const long long warps = (long long)gridDim.x * (kThreads / kWarp);
  for (long long task = (long long)blockIdx.x * (kThreads / kWarp) + threadIdx.x / kWarp;
       task < n_tasks; task += warps) {
    const int s = (int)(task / mc);
    const int m = m0 + (int)(task % mc);
    const long long pair = (long long)s * n_motifs + m;
    if (kMode == 1 && counts[pair] == 0) continue;  // warp-uniform
    const int w = width[m];
    const int o = off[m] - row0;
    const float t = kMode == 2 ? 0.f : thr[m];
    const uint8_t* cs = codes + (long long)s * L;
    const int P = L - w + 1;  // may be <= 0: no window
    int count = 0;
    long long at = kMode == 1 ? offsets[pair] : 0;
    for (int p0 = 0; p0 < P; p0 += kWarp * kWin) {
      // kWin windows a lane, kWarp apart: independent sums in flight. A
      // window past the end reads the last window's bytes (in bounds) and
      // is masked after; a code of 4 marks the window bad and reads the
      // column's A entry, so the loop has no branch
      int at_p[kWin];
      float score[kWin];
      bool bad[kWin];
#pragma unroll
      for (int k = 0; k < kWin; ++k) {
        at_p[k] = min(p0 + k * kWarp + lane, P - 1);
        score[k] = 0.f;
        bad[k] = p0 + k * kWarp + lane >= P;
      }
      for (int j = 0; j < w; ++j) {
        const float* col = lo_s + (o + j) * 4;
#pragma unroll
        for (int k = 0; k < kWin; ++k) {
          const int c = __ldg(cs + at_p[k] + j);
          bad[k] |= c >= kInvalid;
          score[k] = __fadd_rn(score[k], col[c & 3]);
        }
      }
#pragma unroll
      for (int k = 0; k < kWin; ++k) {
        const int p = p0 + k * kWarp + lane;
        if (kMode == 2) {
          if (p < P)
            scores[((long long)s * P_out + p) * n_motifs + m] = bad[k] ? -INFINITY : score[k];
          continue;
        }
        // windows in position order: k, then lane
        const bool hit = !bad[k] && score[k] >= t;
        const unsigned mask = __ballot_sync(0xffffffffu, hit);
        if (kMode == 1 && hit) {
          const long long i = at + __popc(mask & ((1u << lane) - 1u));
          hit_seq[i] = s;
          hit_motif[i] = m;
          hit_pos[i] = p;
          hit_score[i] = score[k];
        }
        at += __popc(mask);
        count += __popc(mask);
      }
    }
    if (kMode == 0 && lane == 0) counts[pair] = count;
  }
}

template <int kMode>
cudaError_t launch_mode(const uint8_t* codes, int n, int L, const float* lo, const int* off,
                        const int* width, const float* thr, int n_motifs, int m0, int m1,
                        int row0, int rows, int* counts, const long long* offsets,
                        int* hit_seq, int* hit_motif, int* hit_pos, float* hit_score,
                        float* scores, int P, size_t shm, cudaStream_t s) {
  cudaError_t e = cudaFuncSetAttribute(pwm_scan_kernel<kMode>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shm);
  if (e != cudaSuccess) return e;
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return e;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, pwm_scan_kernel<kMode>,
                                                         kThreads, shm)) != cudaSuccess)
    return e;
  if (per_sm < 1) per_sm = 1;
  const long long tasks = (long long)n * (m1 - m0);
  long long blocks = (tasks + kThreads / kWarp - 1) / (kThreads / kWarp);
  if (blocks > (long long)sms * per_sm) blocks = (long long)sms * per_sm;
  pwm_scan_kernel<kMode><<<(int)blocks, kThreads, shm, s>>>(
      codes, n, L, lo, off, width, thr, n_motifs, m0, m1, row0, rows, counts, offsets, hit_seq,
      hit_motif, hit_pos, hit_score, scores, P);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// T36. codes (n x L) uint8; lo (rows x 4) f32; off, width (n_motifs,) int32;
// thr (n_motifs,) f32 (unused in mode 2); the motifs [m0, m1) of this launch
// and their rows [row0, row0 + rows) of lo (which must fit the block's
// shared memory, 16 bytes a row); mode 0 count, 1 write, 2 scores; counts
// (n x n_motifs) int32 (written in mode 0, read in mode 1);
// offsets (n x n_motifs) int64, the exclusive scan of counts (mode 1);
// hit_seq, hit_motif, hit_pos int32 and hit_score f32, the hits (mode 1);
// scores (n x P x n_motifs) f32 (mode 2).
int mt_pwm_scan(const unsigned char* codes, int n, int L, const float* lo, const int* off,
                const int* width, const float* thr, int n_motifs, int m0, int m1, int row0,
                int rows, int mode, int* counts, const long long* offsets, int* hit_seq,
                int* hit_motif, int* hit_pos, float* hit_score, float* scores, int P,
                void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n <= 0 || m1 <= m0) return (int)cudaGetLastError();
  const size_t shm = (size_t)rows * sizeof(float4);
  cudaError_t e;
  const uint8_t* c = reinterpret_cast<const uint8_t*>(codes);
  switch (mode) {
    case 0:
      e = launch_mode<0>(c, n, L, lo, off, width, thr, n_motifs, m0, m1, row0, rows, counts,
                         offsets, hit_seq, hit_motif, hit_pos, hit_score, scores, P, shm, s);
      break;
    case 1:
      e = launch_mode<1>(c, n, L, lo, off, width, thr, n_motifs, m0, m1, row0, rows, counts,
                         offsets, hit_seq, hit_motif, hit_pos, hit_score, scores, P, shm, s);
      break;
    case 2:
      e = launch_mode<2>(c, n, L, lo, off, width, thr, n_motifs, m0, m1, row0, rows, counts,
                         offsets, hit_seq, hit_motif, hit_pos, hit_score, scores, P, shm, s);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)e;
}

}  // extern "C"
