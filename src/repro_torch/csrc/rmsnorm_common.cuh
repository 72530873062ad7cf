// Shared by the RMSNorm forward (rmsnorm.cu) and backward
// (rmsnorm_backward.cu), both templated on the element type: a row's
// 8-column chunks as they are loaded and stored, and the sum across the
// threads of a row.  Each .cu is built into a library of its own.
#pragma once

#include "kernels_common.cuh"

constexpr int kMaxWidth = 8192;
constexpr int kChunks = 4;   // 8-column chunks a thread holds, at most

// an output rounded to the element type as it is stored (widen(), in
// kernels_common.cuh, is the way in)
template <typename T>
__device__ __forceinline__ T narrow(float v);
template <>
__device__ __forceinline__ float narrow<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// 8 consecutive elements of a row as they are loaded: 16 bytes of bf16,
// 32 of fp32
template <typename T>
struct Chunk {
  uint4 raw[sizeof(T) / 2];
};

// chunk c of row p (d elements): 16-byte loads when VEC (d a multiple of
// 8, p on 16 bytes), through the read-only path when RO; else element by
// element with the columns past d read as 0
template <typename T, bool VEC, bool RO = false>
__device__ __forceinline__ void load_chunk(Chunk<T>& ch, const T* p, int c, int d) {
  if constexpr (VEC) {
    const uint4* src = reinterpret_cast<const uint4*>(p + 8 * c);
#pragma unroll
    for (int h = 0; h < (int)(sizeof(T) / 2); ++h) ch.raw[h] = RO ? __ldg(src + h) : src[h];
  } else {
    T* e = reinterpret_cast<T*>(ch.raw);
#pragma unroll
    for (int i = 0; i < 8; ++i) e[i] = 8 * c + i < d ? p[8 * c + i] : narrow<T>(0.0f);
  }
}

// a chunk widened to fp32, and fp32 values rounded into a chunk (bf16 by
// pairs)
__device__ __forceinline__ void widen8(const Chunk<float>& ch, float (&f)[8]) {
  const float* e = reinterpret_cast<const float*>(ch.raw);
#pragma unroll
  for (int i = 0; i < 8; ++i) f[i] = e[i];
}
__device__ __forceinline__ void widen8(const Chunk<__nv_bfloat16>& ch, float (&f)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(ch.raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 v = __bfloat1622float2(h[i]);
    f[2 * i] = v.x;
    f[2 * i + 1] = v.y;
  }
}
__device__ __forceinline__ void narrow8(const float (&f)[8], Chunk<float>& ch) {
  float* e = reinterpret_cast<float*>(ch.raw);
#pragma unroll
  for (int i = 0; i < 8; ++i) e[i] = f[i];
}
__device__ __forceinline__ void narrow8(const float (&f)[8], Chunk<__nv_bfloat16>& ch) {
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(ch.raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
}

// f rounded to T into chunk c of row p (columns past d not written)
template <typename T, bool VEC>
__device__ __forceinline__ void store_chunk(T* p, int c, int d, const float (&f)[8]) {
  if constexpr (VEC) {
    Chunk<T> ch;
    narrow8(f, ch);
    uint4* dst = reinterpret_cast<uint4*>(p + 8 * c);
#pragma unroll
    for (int h = 0; h < (int)(sizeof(T) / 2); ++h) dst[h] = ch.raw[h];
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i)
      if (8 * c + i < d) p[8 * c + i] = narrow<T>(f[i]);
  }
}

// the sum of v over the TPR threads of a row, in each of them: shuffles,
// then across the row's warps through s_part behind a barrier of those
// warps alone (named barrier 1 + the row's slot in the block)
template <int TPR>
__device__ __forceinline__ float row_sum(float v, float* s_part, int sub) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if constexpr (TPR > 32) {
    constexpr int W = TPR / 32;
    float* part = s_part + sub * W;
    const int w = (threadIdx.x % TPR) >> 5;
    if ((threadIdx.x & 31) == 0) part[w] = v;
    asm volatile("bar.sync %0, %1;\n" ::"r"(1 + sub), "n"(TPR) : "memory");
    v = 0.0f;
#pragma unroll
    for (int i = 0; i < W; ++i) v += part[i];
    asm volatile("bar.sync %0, %1;\n" ::"r"(1 + sub), "n"(TPR) : "memory");
  }
  return v;
}

// a block: four rows of a warp each, or one row of TPR >= 128 threads
template <int TPR>
__host__ __device__ constexpr int block_threads() { return TPR < 128 ? 128 : TPR; }

