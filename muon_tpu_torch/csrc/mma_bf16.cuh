// The pieces of a bfloat16 tensor-core screen that T5 (knn_kernels.cu) and
// T15 (ivf_kernels.cu) share: cp.async staging, ldmatrix, mma.sync
// m16n8k16 (bf16 products, float32 sums) and the float32 fma chain that
// decides what the tensor cores only screen.
#pragma once

#include <cuda_runtime.h>

typedef unsigned short bf16_bits;  // a bfloat16 value, moved but not computed on

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool pred) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(pred ? 16 : 0));  // a source size of 0 writes zeros
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}
__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const bf16_bits* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}
// c += a b: a 16 x 16 (row), b 16 x 8 (col), bf16 products, f32 sums
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// q . c over ld bfloat16 values (ld a multiple of 8, both rows 16-byte
// aligned, in shared or global memory) as one float32 fma chain in order:
// the products are exact, and the chain is the float32 kernel's, so its
// value is the bits of that kernel on the same rows held as float32 (the
// zeros that pad a row add nothing)
__device__ __forceinline__ float dot_bf16_chain(const bf16_bits* q, const bf16_bits* c, int ld) {
  float acc = 0.f;
  for (int u = 0; u < ld; u += 8) {
    const uint4 a = *reinterpret_cast<const uint4*>(q + u);
    const uint4 b = *reinterpret_cast<const uint4*>(c + u);
    const unsigned aw[4] = {a.x, a.y, a.z, a.w}, bw[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int w = 0; w < 4; ++w) {  // a word holds values u (low half) and u + 1
      acc = fmaf(__uint_as_float(aw[w] << 16), __uint_as_float(bw[w] << 16), acc);
      acc = fmaf(__uint_as_float(aw[w] & 0xffff0000u), __uint_as_float(bw[w] & 0xffff0000u), acc);
    }
  }
  return acc;
}
