// Tensor-core and copy helpers shared by the attention kernels (sm_90a).
//
// mma.sync fragments (PTX layouts; lane = 4*g + t):
//  - m16n8k16 bf16: A holds rows g and g+8, columns 2t, 2t+1 (+8); B holds
//    k-rows 2t, 2t+1 (+8) of column g; the f32 accumulator holds rows g and
//    g+8, columns 2t and 2t+1.
//  - m16n8k8 TF32: A holds rows g and g+8, columns t and t+4; B k-rows t and
//    t+4 of column g; the accumulator as above.
// f32 products run as 3xTF32 (each operand split into a TF32 high and low
// part; lo.hi + hi.lo + hi.hi), which keeps an f32 product's accuracy: one
// TF32 pass errs by ~1e-3.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace tac {

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo to ~22 bits, both TF32.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// A split in two ALU ops for products that may truncate the low part: hi
// is x with its low 13 bits cleared (exact TF32), lo = x - hi exactly, handed
// to the tensor cores as it is (they read a .tf32 operand's top 19 bits).
// cvt issues at a quarter of the f32 rate; this costs an AND and a subtract.
// The operand then errs by under 2^-20 |x| (the rounded split: 2^-22).
__device__ __forceinline__ void split_tf32_trunc(float x, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(__fsub_rn(x, __uint_as_float(hi)));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// c += A.B to f32 accuracy with 3xTF32: lo.hi + hi.lo + hi.hi, the small
// terms first, into a fresh accumulator that is then added to c with an
// IEEE add. The tensor cores truncate when they accumulate, so a long chain
// of mma into one accumulator drifts (at T = 2048 the output erred by ~7e-6);
// a chain of three from zero does not.
__device__ __forceinline__ void mma_3xtf32(float (&c)[4], const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4], uint32_t bh0,
                                           uint32_t bh1, uint32_t bl0, uint32_t bl1) {
  float d[4] = {0.f, 0.f, 0.f, 0.f};
  mma_tf32(d, al[0], al[1], al[2], al[3], bh0, bh1);
  mma_tf32(d, ah[0], ah[1], ah[2], ah[3], bl0, bl1);
  mma_tf32(d, ah[0], ah[1], ah[2], ah[3], bh0, bh1);
#pragma unroll
  for (int i = 0; i < 4; ++i) c[i] += d[i];
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t& b0, uint32_t& b1,
                                                  const void* smem) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(b0), "=r"(b1)
               : "r"(addr)
               : "memory");
}

// 16 bytes global -> shared; zero-filled when !valid (no bytes are read).
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(addr),
               "l"(gmem), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
  __nv_bfloat162 x = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<uint32_t*>(&x);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

}  // namespace tac
