// Device helpers of the tensor-core attention kernels (samattn.cu,
// swinattn.cu): f32 products as three TF32 tensor-core passes, and
// asynchronous copies into shared memory.
//
// 3xTF32: an f32 operand x is split into hi = tf32(x) and lo = tf32(x -
// hi), both rounded as cvt.rna.tf32.f32 rounds (to a 10-bit mantissa,
// ties away from zero; x - hi is exact in f32). A product then
// accumulates hi·lo, lo·hi and hi·hi, each an m16n8k8 TF32 mma, into
// f32; the dropped lo·lo term is below f32's own rounding. One
// pass (hi·hi) keeps about three decimal digits, which the f32 gates
// of both kernels do not allow (tests/test_torch_attn_tf32.py).
//
// Fragments of mma.sync.m16n8k8.row.col.f32.tf32.tf32.f32 for lane =
// 4 g + t: A (16 x 8) a0 = (g, t), a1 = (g + 8, t), a2 = (g, t + 4),
// a3 = (g + 8, t + 4); B (8 x 8) b0 = (t, g), b1 = (t + 4, g); C (16 x
// 8) c0, c1 = (g, 2t), (g, 2t + 1), c2, c3 = (g + 8, 2t), (g + 8, 2t +
// 1). The kernels map the 8-deep index k = t to element 2t and k = t +
// 4 to 2t + 1 of every 8-wide step, in A and B alike: a sum over k
// does not see the order, a thread then reads two neighbouring
// elements of a row, and a score fragment (C) is already the
// probability fragment (A) of the p·v product: (c0, c2, c1, c3).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace kbmma {

// cvt.rna.tf32.f32 done on the integer pipe: add half of the dropped
// 13 bits' range to the magnitude, then clear them: ties away from
// zero, the bits cvt.rna gives a finite x. The conversion
// instruction itself issues on the slower conversion pipe, and the
// kernels split every operand they multiply.
__device__ __forceinline__ uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

// d += a · b, one m16n8k8 TF32 pass
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a · b in 3xTF32: the two small passes first, then hi·hi
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4],
                                     const uint32_t (&bh)[2],
                                     const uint32_t (&bl)[2]) {
  mma(d, ah, bl);
  mma(d, al, bh);
  mma(d, ah, bh);
}

// d_big += ah · bh and d_small += ah · bl + al · bh: the small passes
// in an accumulator of their own, so the big one truncates once a
// step, not three times
__device__ __forceinline__ void mma3(float (&d_big)[4], float (&d_small)[4],
                                     const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4],
                                     const uint32_t (&bh)[2],
                                     const uint32_t (&bl)[2]) {
  mma(d_small, ah, bl);
  mma(d_small, al, bh);
  mma(d_big, ah, bh);
}

// B fragment of two f32 values, split
struct Frag2 {
  uint32_t hi[2], lo[2];
  __device__ __forceinline__ Frag2(float x0, float x1) {
    split(x0, hi[0], lo[0]);
    split(x1, hi[1], lo[1]);
  }
};

// A fragment of four f32 values (a0..a3), split
struct Frag4 {
  uint32_t hi[4], lo[4];
  __device__ __forceinline__ Frag4() {}
  __device__ __forceinline__ Frag4(float x0, float x1, float x2, float x3) {
    split(x0, hi[0], lo[0]);
    split(x1, hi[1], lo[1]);
    split(x2, hi[2], lo[2]);
    split(x3, hi[3], lo[3]);
  }
};

__device__ __forceinline__ void mma3(float (&d_big)[4], float (&d_small)[4],
                                     const Frag4& a, const Frag2& b) {
  mma3(d_big, d_small, a.hi, a.lo, b.hi, b.lo);
}

// 16 bytes global -> shared; with valid false the 16 bytes are zeros
// (src-size 0: nothing is read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(s),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

// 4 bytes global -> shared, zero when not valid
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(s),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

// start the 128-byte line of p on its way into L2
__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];" ::"l"(p));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// wait until at most N groups of this thread are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x = x + __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

}  // namespace kbmma
