// Per-cell interval coverage, for Hopper (sm_90a).
//
//   T37 interval_pileup  <- muon_tpu/ops/pileup.py _pileup_fn (via
//                           interval_pileup), the TSS pileup of
//                           atac.tl.tss_enrichment
//
// Fragments i = 0..nnz-1 carry (cell, start, end, score), int32, start and
// end relative to the window. The reference builds a difference array of
// (n_cells + 1) x (n_pos + 1) with +score at (row, clip(start, 0, n_pos))
// and -score at (row, clip(end, 0, n_pos)), row = cell when 0 <= cell <
// n_cells and the spill row n_cells otherwise, and returns the cumulative
// sum of diff[:n_cells, :n_pos] along the positions: an (n_cells x n_pos)
// int32 matrix, row-major. The spill row and the spill column are never
// read, so here they are simply not written.
//
// What bounds it: the bytes. Each fragment is read once (16 bytes) and the
// output written once (4 bytes a cell and position): at the smoke's 100,000
// cells x 2001 positions and about 2e7 fragments that is 0.32 + 0.80 GB,
// about 0.33 ms at 3.35 TB/s. The simple design here, two passes over the
// output in place, moves more: the caller zeroes the output (one write),
// pass 1 adds into it with atomics (a read-modify-write in L2 per touched
// word), pass 2 reads each row and writes its scan (one read, one write).
//   pass 1 (scatter): a thread per fragment (grid-stride), two atomicAdds,
//     none for a fragment outside the cells, a clipped end or start at
//     n_pos (the spill column), or a start equal to its end (the two adds
//     cancel). Fragments arrive grouped by TSS window and sorted by
//     position with their cells in random order, so the atomics land on
//     scattered rows: each is its own L2 transaction.
//   pass 2 (scan): a block per cell row; the row in tiles of 2048 words
//     through shared memory (coalesced loads and stores), 8 consecutive
//     words a thread summed in registers, a warp-shuffle scan of the thread
//     sums and a scan of the 8 warp sums, a carry across tiles.
// Arithmetic is unsigned 32-bit, so every add wraps as the reference's int32
// adds do; integer addition does not depend on its order, so the atomics
// give the same matrix in every run, equal to the reference bit for bit.
//
// Interface: a plain C function (loaded with ctypes), as in
// sparse_kernels.cu. It launches on the stream it is given, allocates
// nothing, and returns cudaGetLastError(). The caller passes the output
// zeroed.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kScatterThreads = 256;
constexpr int kScatterBlocksMax = 132 * 16;  // grid-stride beyond this
constexpr int kScanThreads = 256;
constexpr int kScanWarps = kScanThreads / 32;
constexpr int kItems = 8;                          // words a thread scans
constexpr int kTile = kScanThreads * kItems;       // words of a row a tile
constexpr int kTilePadded = kTile + kTile / 32;    // one pad word every 32

// word i of a tile in shared memory: thread t reads words 8t..8t+7, and the
// pad word every 32 spreads a warp's reads over the 32 banks
__device__ __forceinline__ int padded(int i) { return i + (i >> 5); }

__global__ void __launch_bounds__(kScatterThreads)
pileup_scatter_kernel(const int* __restrict__ cells, const int* __restrict__ starts,
                      const int* __restrict__ ends, const int* __restrict__ scores,
                      long long nnz, int n_cells, int n_pos, unsigned* __restrict__ out) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < nnz; i += stride) {
    const int c = cells[i];
    if (c < 0 || c >= n_cells) continue;
    const int s = min(max(starts[i], 0), n_pos);
    const int e = min(max(ends[i], 0), n_pos);
    if (s == e) continue;
    const unsigned w = (unsigned)scores[i];
    unsigned* row = out + (size_t)c * (size_t)n_pos;
    if (s < n_pos) atomicAdd(row + s, w);
    if (e < n_pos) atomicAdd(row + e, 0u - w);
  }
}

__global__ void __launch_bounds__(kScanThreads)
pileup_scan_kernel(unsigned* __restrict__ out, int n_pos) {
  __shared__ unsigned tile[kTilePadded];
  __shared__ unsigned warp_sums[kScanWarps];
  unsigned* row = out + (size_t)blockIdx.x * (size_t)n_pos;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned carry = 0;
  for (int base = 0; base < n_pos; base += kTile) {
    const int len = min(kTile, n_pos - base);
    for (int i = threadIdx.x; i < kTile; i += kScanThreads)
      tile[padded(i)] = i < len ? row[base + i] : 0u;
    __syncthreads();
    unsigned v[kItems];
    unsigned sum = 0;
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      sum += tile[padded(threadIdx.x * kItems + j)];
      v[j] = sum;
    }
    unsigned x = sum;  // inclusive scan of the thread sums within the warp
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const unsigned y = __shfl_up_sync(0xffffffffu, x, o);
      if (lane >= o) x += y;
    }
    if (lane == 31) warp_sums[warp] = x;
    __syncthreads();
    unsigned before = 0, total = 0;
#pragma unroll
    for (int k = 0; k < kScanWarps; ++k) {
      const unsigned t = warp_sums[k];
      if (k < warp) before += t;
      total += t;
    }
    const unsigned excl = carry + before + (x - sum);
#pragma unroll
    for (int j = 0; j < kItems; ++j) tile[padded(threadIdx.x * kItems + j)] = excl + v[j];
    __syncthreads();
    for (int i = threadIdx.x; i < len; i += kScanThreads) row[base + i] = tile[padded(i)];
    carry += total;
    __syncthreads();  // the tile and the warp sums are written again next
  }
}

}  // namespace

extern "C" {

// T37. cells, starts, ends, scores: nnz int32 each; out (n_cells x n_pos)
// int32, zeroed by the caller, written in place.
int mt_interval_pileup(const int* cells, const int* starts, const int* ends,
                       const int* scores, long long nnz, int n_cells, int n_pos,
                       int* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n_cells <= 0 || n_pos <= 0) return (int)cudaGetLastError();
  if (nnz > 0) {
    const long long want = (nnz + kScatterThreads - 1) / kScatterThreads;
    const int blocks = (int)(want < kScatterBlocksMax ? want : kScatterBlocksMax);
    pileup_scatter_kernel<<<blocks, kScatterThreads, 0, s>>>(
        cells, starts, ends, scores, nnz, n_cells, n_pos, (unsigned*)out);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  pileup_scan_kernel<<<n_cells, kScanThreads, 0, s>>>((unsigned*)out, n_pos);
  return (int)cudaGetLastError();
}

}  // extern "C"
