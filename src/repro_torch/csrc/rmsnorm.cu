// RMSNorm for Hopper (sm_90a), fp32 and bf16.
//
// Replaces the Pallas TPU kernel repro/kernels/rmsnorm/kernel.py
// `rmsnorm_tpu` (body `_rmsnorm_kernel`): over rows x (N, d),
// y = x * rsqrt(mean(x^2) + eps) * scale, the sum taken in fp32.  The JAX
// model computes (var + eps) ** -0.5 (repro/nn/norm.py), so this kernel
// agrees with its plain version to rounding, not bit for bit.
//
// Bound: bytes.  Each row is read once and written once, 2 * N * d * 4
// bytes, against about 4 flops per element; at the prefill shape of the
// LLM path (N = 8 * 512 rows of qwen2-0.5b, d = 896) that is 29 MB, about
// 9 us at 3.35 TB/s.
//
// Design: one block of 128 threads per row, grid-stride over rows for any
// N (the TPU's whole-tile row count becomes a loop bound).  Neighbouring
// threads read neighbouring elements; the sum of squares goes through warp
// shuffles and one shared-memory step across the 4 warps.  The second pass
// re-reads the row, which a block of d <= 8192 floats finds in L1/L2, so
// every byte crosses HBM once.
//
// The bf16 half (x, scale and y bf16, as the TPU kernel takes them) is a
// kernel of its own.  Bound: bytes, 2 * N * d * 2: 16.8 MB at
// moonshot-v1-16b-a3b's prefill rows (N = 8 * 256, d = 2048), 0.0050 ms.
// Design: the row is held in registers, so x crosses HBM once and nothing
// is read twice.  A row of d <= 2048 goes to one warp (4 rows a block of
// 128 threads), a wider one to the whole block; each thread takes 16-byte
// chunks (8 bf16) of x and of scale, at most 8 of each, strided by the
// threads of the row, so a warp's loads are contiguous 512-byte runs.  It
// widens to fp32, sums the squares in fp32 (the thread's own chunks, then
// shuffles, then one shared-memory step across a block's warps), scales
// in fp32 and rounds each output once (__float2bfloat16_rn), written by
// 16-byte stores.  A row whose d is not a multiple of 8, or operands off
// 16 bytes, take the same walk element by element with 2-byte accesses.
// Its sum is taken in another order than the fp32 kernel's, so it is not
// bitwise that kernel on the widened inputs: it is held to 2e-2 of the
// plain version and, against float64, to twice F.rms_norm's bf16 error
// (chip_smoke.py phase 16a).  x and scale are both loaded before the sum,
// so a row waits on memory once.
// Registers (-Xptxas -v, sm_90a): 96 on the 16-byte walks
// (warp or block per row), 87-88 element by element, no spill; shared
// memory 16 bytes (the block's partial sums).  The fp32 kernel: 32
// registers, 16 bytes.
#include <cstdint>

#include "kernels_common.cuh"

namespace {

constexpr int kRowThreads = 128;
constexpr int kMaxWidth = 8192;

__global__ void __launch_bounds__(kRowThreads)
rmsnorm_kernel(const float* __restrict__ x, const float* __restrict__ scale,
               long long n_rows, int d, float eps, float* __restrict__ y) {
  __shared__ float s_part[kRowThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (long long row = blockIdx.x; row < n_rows; row += gridDim.x) {
    const float* xr = x + row * d;
    float ss = 0.0f;
    for (int i = threadIdx.x; i < d; i += kRowThreads) {
      const float v = xr[i];
      ss = fmaf(v, v, ss);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
    if (lane == 0) s_part[warp] = ss;
    __syncthreads();
    float total = 0.0f;
#pragma unroll
    for (int w = 0; w < kRowThreads / 32; ++w) total += s_part[w];
    const float r = rsqrtf(total / (float)d + eps);
    float* yr = y + row * d;
    for (int i = threadIdx.x; i < d; i += kRowThreads)
      yr[i] = (xr[i] * r) * scale[i];
    __syncthreads();  // s_part is written again for the next row
  }
}

// ---------------------------------------------------------------- bf16 ---
constexpr int kWarpRowMax = 2048;   // widest row one warp takes
constexpr int kHeld = 64;           // elements a thread holds at most

// the sum of ss over the TPR threads of a row (32: a warp; more: the
// block, through s_part), in every one of them
template <int TPR>
__device__ __forceinline__ float row_sum(float ss, float* s_part) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
  if constexpr (TPR > 32) {
    if ((threadIdx.x & 31) == 0) s_part[threadIdx.x >> 5] = ss;
    __syncthreads();
    ss = 0.0f;
#pragma unroll
    for (int w = 0; w < TPR / 32; ++w) ss += s_part[w];
    __syncthreads();   // s_part is written again for the next row
  }
  return ss;
}

__device__ __forceinline__ void widen8(const uint4& raw, float (&f)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 p = __bfloat1622float2(h[e]);
    f[2 * e] = p.x;
    f[2 * e + 1] = p.y;
  }
}

// one row to TPR threads (32: a warp, 4 rows a block; 128: the block).
// VEC: 16-byte accesses (d % 8 == 0, operands 16-byte aligned), x and
// scale both loaded before the sum, so a row waits on memory once; else
// the same walk element by element, scale read after the sum
template <int TPR, bool VEC>
__global__ void __launch_bounds__(kRowThreads)
rmsnorm_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                    const __nv_bfloat16* __restrict__ scale, long long n_rows,
                    int d, float eps, __nv_bfloat16* __restrict__ y) {
  constexpr int RPB = kRowThreads / TPR;   // rows a block
  constexpr int PER = VEC ? 8 : 1;         // elements an access
  constexpr int NACC = kHeld / PER;        // accesses a thread, at most
  __shared__ float s_part[kRowThreads / 32];
  const int tr = threadIdx.x % TPR, sub = threadIdx.x / TPR;
  const int n_acc = d / PER;               // accesses a row
  for (long long row = (long long)blockIdx.x * RPB + sub; row < n_rows;
       row += (long long)gridDim.x * RPB) {
    const __nv_bfloat16* xr = x + row * d;
    __nv_bfloat16* yr = y + row * d;
    float ss = 0.0f;
    if constexpr (VEC) {
      uint4 xv[NACC], sv[NACC];
#pragma unroll
      for (int j = 0; j < NACC; ++j) {
        const int c = tr + j * TPR;
        if (c < n_acc) {
          xv[j] = *reinterpret_cast<const uint4*>(xr + c * 8);
          sv[j] = __ldg(reinterpret_cast<const uint4*>(scale) + c);
        }
      }
#pragma unroll
      for (int j = 0; j < NACC; ++j) {
        if (tr + j * TPR < n_acc) {
          float f[8];
          widen8(xv[j], f);
#pragma unroll
          for (int e = 0; e < 8; ++e) ss = fmaf(f[e], f[e], ss);
        }
      }
      const float r = rsqrtf(row_sum<TPR>(ss, s_part) / (float)d + eps);
#pragma unroll
      for (int j = 0; j < NACC; ++j) {
        const int c = tr + j * TPR;
        if (c < n_acc) {
          float f[8], w[8];
          widen8(xv[j], f);
          widen8(sv[j], w);
          uint4 out;
          __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&out);
#pragma unroll
          for (int e = 0; e < 4; ++e)
            h[e] = __floats2bfloat162_rn((f[2 * e] * r) * w[2 * e],
                                         (f[2 * e + 1] * r) * w[2 * e + 1]);
          *reinterpret_cast<uint4*>(yr + c * 8) = out;
        }
      }
    } else {
      float xv[NACC];
#pragma unroll
      for (int j = 0; j < NACC; ++j) {
        const int c = tr + j * TPR;
        if (c < n_acc) {
          xv[j] = __bfloat162float(xr[c]);
          ss = fmaf(xv[j], xv[j], ss);
        }
      }
      const float r = rsqrtf(row_sum<TPR>(ss, s_part) / (float)d + eps);
#pragma unroll
      for (int j = 0; j < NACC; ++j) {
        const int c = tr + j * TPR;
        if (c < n_acc)
          yr[c] = __float2bfloat16_rn((xv[j] * r) * __bfloat162float(scale[c]));
      }
    }
  }
}

template <int TPR, bool VEC>
void launch_bf16(const __nv_bfloat16* x, const __nv_bfloat16* scale,
                 long long n_rows, int d, float eps, __nv_bfloat16* y,
                 cudaStream_t stream) {
  constexpr int RPB = kRowThreads / TPR;
  const long long blocks = (n_rows + RPB - 1) / RPB;
  rmsnorm_bf16_kernel<TPR, VEC>
      <<<(int)(blocks < kMaxBlocks ? blocks : kMaxBlocks), kRowThreads, 0, stream>>>(
          x, scale, n_rows, d, eps, y);
}

}  // namespace

extern "C" int rmsnorm_launch(const float* x, const float* scale,
                              long long n_rows, int d, float eps, float* y,
                              void* stream) {
  if (d < 1 || d > kMaxWidth || n_rows < 0) return (int)cudaErrorInvalidValue;
  if (n_rows == 0) return 0;
  const int grid = (int)(n_rows < kMaxBlocks ? n_rows : kMaxBlocks);
  rmsnorm_kernel<<<grid, kRowThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, scale, n_rows, d, eps, y);
  return (int)cudaGetLastError();
}

extern "C" int rmsnorm_bf16_launch(const __nv_bfloat16* x,
                                   const __nv_bfloat16* scale,
                                   long long n_rows, int d, float eps,
                                   __nv_bfloat16* y, void* stream) {
  if (d < 1 || d > kMaxWidth || n_rows < 0) return (int)cudaErrorInvalidValue;
  if (n_rows == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = d % 8 == 0 && ((reinterpret_cast<uintptr_t>(x) |
                                   reinterpret_cast<uintptr_t>(scale) |
                                   reinterpret_cast<uintptr_t>(y)) & 15) == 0;
  // a thread holds kHeld elements: a warp takes d <= 2048, a block 8192
  if (d <= kWarpRowMax) {
    if (vec) launch_bf16<32, true>(x, scale, n_rows, d, eps, y, st);
    else launch_bf16<32, false>(x, scale, n_rows, d, eps, y, st);
  } else {
    if (vec) launch_bf16<kRowThreads, true>(x, scale, n_rows, d, eps, y, st);
    else launch_bf16<kRowThreads, false>(x, scale, n_rows, d, eps, y, st);
  }
  return (int)cudaGetLastError();
}
