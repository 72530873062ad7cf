// Shared by the flash-attention forward (flash_attention.cu) and its
// backward (flash_attention_backward.cu and its bf16 half,
// flash_attention_backward_bf16.cu): fp32 products on the tensor cores in
// 3xTF32, the 4-byte asynchronous copy of the backward's row statistics,
// the backward's mask, its reading of the log-sum-exp, its dvec kernel and
// the shared-memory attribute its launches set.
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

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kDotThreads = 256;   // flash_bwd_dot_kernel: a warp a row

struct Mask {   // which keys a query position sees
  int valid, causal, window;
  __device__ __forceinline__ bool live(int qp, int kp) const {
    return kp < valid && (!causal || kp <= qp) &&
           (window <= 0 || kp > qp - window);
  }
};

// a row's log-sum-exp as P = exp(x - lse) reads it: +inf for a row with no
// live key (-inf) or past T, so P is exactly 0 there
__device__ __forceinline__ float row_lse(float l, bool in_range) {
  return in_range && l != -CUDART_INF_F ? l : CUDART_INF_F;
}

// dvec = rowsum(dO * O) in fp32, one warp per row of o / dO (rows
// (b * T + t) * Hq + h of D elements), written as dvec (B, Hq, T)
template <int D, typename T>
__global__ void __launch_bounds__(kDotThreads)
flash_bwd_dot_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                     long long n_rows, int T_, int Hq, float* __restrict__ dvec) {
  const long long row = (long long)blockIdx.x * (kDotThreads / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= n_rows) return;
  float s = 0.0f;
#pragma unroll
  for (int d = lane; d < D; d += 32)
    s = fmaf(widen(o[row * D + d]), widen(dout[row * D + d]), s);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) {   // row = (b * T + t) * Hq + h  ->  dvec[(b * Hq + h) * T + t]
    const long long bt = row / Hq;
    const int h = (int)(row % Hq);
    const long long b = bt / T_;
    const int t = (int)(bt % T_);
    dvec[(b * Hq + h) * T_ + t] = s;
  }
}

// the dynamic shared memory a kernel may take (and the largest carveout),
// set once per instantiation
template <typename K>
cudaError_t allow_smem(K kernel, int bytes, bool& configured) {
  if (configured) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  configured = err == cudaSuccess;
  return err;
}
