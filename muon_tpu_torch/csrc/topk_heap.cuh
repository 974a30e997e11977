// The per-thread max-heap on (distance, index) that T29 and T31
// (snf_kernels.cu) keep their best candidates in (T5, T14 and T40 keep
// theirs in knn_tile.cuh's packed 8-ary heap).
#pragma once

// (d, i) before (e, j): the order of the result
__device__ __forceinline__ bool before(float d, int i, float e, int j) {
  return d < e || (d == e && i < j);
}

// restore the max-heap hd/hi[0, m) below position p
__device__ __forceinline__ void sift_down(float* hd, int* hi, int m, int p) {
  const float d = hd[p];
  const int i = hi[p];
  for (int c = 2 * p + 1; c < m; c = 2 * p + 1) {
    if (c + 1 < m && before(hd[c], hi[c], hd[c + 1], hi[c + 1])) ++c;
    if (!before(d, i, hd[c], hi[c])) break;
    hd[p] = hd[c];
    hi[p] = hi[c];
    p = c;
  }
  hd[p] = d;
  hi[p] = i;
}

// append (dist, j) to the heap of m entries and sift it up; returns m + 1
__device__ __forceinline__ int heap_push(float* hd, int* hi, int m, float dist,
                                         int j) {
  int p = m;
  while (p > 0) {
    const int par = (p - 1) / 2;
    if (!before(hd[par], hi[par], dist, j)) break;
    hd[p] = hd[par];
    hi[p] = hi[par];
    p = par;
  }
  hd[p] = dist;
  hi[p] = j;
  return m + 1;
}

// heap sort of the m entries: ascending (d, i)
__device__ __forceinline__ void heap_sort(float* hd, int* hi, int m) {
  for (int e = m - 1; e > 0; --e) {
    const float td = hd[0];
    const int ti = hi[0];
    hd[0] = hd[e];
    hi[0] = hi[e];
    hd[e] = td;
    hi[e] = ti;
    sift_down(hd, hi, e, 0);
  }
}
