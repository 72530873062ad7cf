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
// The bf16 half (x and scale bf16, as the TPU kernel takes them) reads
// 2 bytes an element and writes 2: 2 * N * d * 2 bytes, 16.8 MB at
// moonshot-v1-16b-a3b's prefill rows (N = 8 * 256, d = 2048), about 5 us.
// It widens each element to fp32 as it loads it, runs the fp32 arithmetic
// unchanged and rounds only the output (__float2bfloat16_rn), as the TPU
// kernel widens, computes and narrows: its output is bitwise the fp32
// kernel's on the widened inputs, rounded to bf16.
//
// Design: one block of 128 threads per row, grid-stride over rows for any
// N (the TPU's whole-tile row count becomes a loop bound).  Neighbouring
// threads read neighbouring elements; the sum of squares goes through warp
// shuffles and one shared-memory step across the 4 warps.  The second pass
// re-reads the row, which a block of d <= 8192 floats finds in L1/L2, so
// every byte crosses HBM once.
#include "kernels_common.cuh"

constexpr int kRowThreads = 128;
constexpr int kMaxWidth = 8192;

template <typename T>
__global__ void __launch_bounds__(kRowThreads)
rmsnorm_kernel(const T* __restrict__ x, const T* __restrict__ scale,
               long long n_rows, int d, float eps, T* __restrict__ y) {
  __shared__ float s_part[kRowThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (long long row = blockIdx.x; row < n_rows; row += gridDim.x) {
    const T* xr = x + row * d;
    float ss = 0.0f;
    for (int i = threadIdx.x; i < d; i += kRowThreads) {
      const float v = to_f32(xr[i]);
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
    T* yr = y + row * d;
    for (int i = threadIdx.x; i < d; i += kRowThreads)
      yr[i] = from_f32<T>((to_f32(xr[i]) * r) * to_f32(scale[i]));
    __syncthreads();  // s_part is written again for the next row
  }
}

template <typename T>
int launch(const T* x, const T* scale, long long n_rows, int d, float eps,
           T* y, void* stream) {
  if (d < 1 || d > kMaxWidth || n_rows < 0) return (int)cudaErrorInvalidValue;
  if (n_rows == 0) return 0;
  const int grid = (int)(n_rows < kMaxBlocks ? n_rows : kMaxBlocks);
  rmsnorm_kernel<T><<<grid, kRowThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, scale, n_rows, d, eps, y);
  return (int)cudaGetLastError();
}

extern "C" int rmsnorm_launch(const float* x, const float* scale,
                              long long n_rows, int d, float eps, float* y,
                              void* stream) {
  return launch(x, scale, n_rows, d, eps, y, stream);
}

extern "C" int rmsnorm_bf16_launch(const __nv_bfloat16* x,
                                   const __nv_bfloat16* scale,
                                   long long n_rows, int d, float eps,
                                   __nv_bfloat16* y, void* stream) {
  return launch(x, scale, n_rows, d, eps, y, stream);
}
