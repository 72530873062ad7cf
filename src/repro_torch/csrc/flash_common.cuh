// Shared by the flash-attention forward (flash_attention.cu) and its
// backward (flash_attention_backward.cu): fp32 products on the tensor cores
// in 3xTF32, and the 4-byte asynchronous copy of the backward's row
// statistics.
//
// A plain TF32 product keeps 10 mantissa bits, too few for the fp32 bars
// the kernels are held to, so each fp32 operand x is split into
// hi = tf32(x) and lo = tf32(x - hi) (cvt.rna: round to nearest, ties away
// from zero) and a product is lo*hi + hi*lo + hi*hi, the small terms first,
// accumulated in fp32 (lo*lo, below fp32's last bit, is dropped).
#pragma once

#include <cstdint>

#include "kernels_common.cuh"

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo up to fp32 rounding: hi keeps the top 10 mantissa bits (its
// low 13 bits cleared, so x - hi is exact), lo the next 11.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = to_tf32(x) & 0xffffe000u;
  lo = to_tf32(x - __uint_as_float(hi));
}

// The same hi without a cvt (x + half a tf32 ulp on the magnitude, then
// masked: round to nearest, ties away from zero, as cvt.rna), and lo =
// x - hi handed to the tensor core as its fp32 bits: a .tf32 operand keeps
// the top 10 mantissa bits, so lo is rounded toward zero there, at most
// 2^-21 of x off (cvt.rna: 2^-22).  Three plain instructions, no cvt.
__device__ __forceinline__ void split_tf32_fast(float x, uint32_t& hi,
                                                uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a * b in 3xTF32: lo*hi and hi*lo first, then hi*hi
__device__ __forceinline__ void mma_3xtf32(float (&c)[4],
                                           const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4],
                                           uint32_t bh0, uint32_t bh1,
                                           uint32_t bl0, uint32_t bl1) {
  mma_tf32(c, al, bh0, bh1);
  mma_tf32(c, ah, bl0, bl1);
  mma_tf32(c, ah, bh0, bh1);
}

// x = hi + lo by split_tf32, or split_tf32_fast when FAST
template <bool FAST>
__device__ __forceinline__ void split_as(float x, uint32_t& hi, uint32_t& lo) {
  if constexpr (FAST)
    split_tf32_fast(x, hi, lo);
  else
    split_tf32(x, hi, lo);
}

// The A fragment of a row-major tile for k-step ks, split: rows g and
// g + 8 of the warp's 16 (sw points at its first), columns 8 ks + t and
// 8 ks + t + 4.
template <bool FAST = false>
__device__ __forceinline__ void a_fragment(const float* sw, int ld, int ks,
                                           int g, int t, uint32_t (&h)[4],
                                           uint32_t (&l)[4]) {
  const float* p = sw + g * ld + ks * 8 + t;
  split_as<FAST>(p[0], h[0], l[0]);
  split_as<FAST>(p[8 * ld], h[1], l[1]);
  split_as<FAST>(p[4], h[2], l[2]);
  split_as<FAST>(p[8 * ld + 4], h[3], l[3]);
}

// 4-byte asynchronous copy (cp.async.ca): reads src_bytes (0 or 4) and
// zero-fills the rest, for rows whose base is not 16-byte aligned.
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes)
               : "memory");
}
