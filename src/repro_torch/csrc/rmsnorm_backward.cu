// RMSNorm backward for Hopper (sm_90a), fp32.
//
// The gradient of repro/kernels/rmsnorm/kernel.py `rmsnorm_tpu`'s function,
// y = x * r * scale with r = rsqrt(mean(x^2) + eps) over rows x (N, d).
// The TPU kernel has no backward: the JAX model differentiates its jnp
// `rmsnorm_apply` (repro/nn/norm.py).  Given g = dL/dy:
//   dx     = r * (scale * g) - x * r^3 * mean(x * scale * g)
//   dscale = sum over rows of g * (x * r)
// which is exactly what autograd of the plain version computes, to
// rounding.
//
// Bound: bytes.  x and g are read once, dx written once, 3 * N * d * 4
// bytes (scale and dscale are d floats); at the training shape of
// qwen2-0.5b (N = 4 * 4096 rows, d = 896) that is 176 MB, 0.053 ms at
// 3.35 TB/s.
//
// Design: one block of 128 threads per row, grid-stride over rows with a
// fixed grid of min(N, 1024) blocks.  Pass 1 sums x^2 and x * scale * g
// (warp shuffles, one shared-memory step); pass 2 re-reads the row from
// L1/L2, writes dx and adds g * (x * r) into a per-block dscale row in
// shared memory, each column owned by one thread.  The blocks' rows of
// partial sums go to a (grid, d) scratch, and a second kernel sums them
// per column in block order.  No float atomics: the grid depends on N
// alone, so two calls give bitwise equal gradients.
#include "kernels_common.cuh"

constexpr int kRowThreads = 128;
constexpr int kMaxWidth = 8192;
constexpr long long kBwdBlocks = 1024;   // kernel.py BACKWARD_BLOCKS

__global__ void __launch_bounds__(kRowThreads)
rmsnorm_backward_kernel(const float* __restrict__ x,
                        const float* __restrict__ scale,
                        const float* __restrict__ g, long long n_rows, int d,
                        float eps, float* __restrict__ dx,
                        float* __restrict__ partial) {
  extern __shared__ float s_acc[];           // d floats: this block's dscale
  __shared__ float s_ss[kRowThreads / 32], s_dot[kRowThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int i = threadIdx.x; i < d; i += kRowThreads) s_acc[i] = 0.0f;
  for (long long row = blockIdx.x; row < n_rows; row += gridDim.x) {
    const float* xr = x + row * d;
    const float* gr = g + row * d;
    float ss = 0.0f, dot = 0.0f;
    for (int i = threadIdx.x; i < d; i += kRowThreads) {
      const float v = xr[i];
      ss = fmaf(v, v, ss);
      dot = fmaf(v * scale[i], gr[i], dot);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      ss += __shfl_xor_sync(0xffffffffu, ss, o);
      dot += __shfl_xor_sync(0xffffffffu, dot, o);
    }
    if (lane == 0) {
      s_ss[warp] = ss;
      s_dot[warp] = dot;
    }
    __syncthreads();
    float tss = 0.0f, tdot = 0.0f;
#pragma unroll
    for (int w = 0; w < kRowThreads / 32; ++w) {
      tss += s_ss[w];
      tdot += s_dot[w];
    }
    const float r = rsqrtf(tss / (float)d + eps);
    const float c = r * r * r * (tdot / (float)d);
    float* dxr = dx + row * d;
    for (int i = threadIdx.x; i < d; i += kRowThreads) {
      const float xv = xr[i], gv = gr[i];
      dxr[i] = r * (scale[i] * gv) - xv * c;
      s_acc[i] = fmaf(gv, xv * r, s_acc[i]);
    }
    __syncthreads();  // s_ss / s_dot are written again for the next row
  }
  for (int i = threadIdx.x; i < d; i += kRowThreads)
    partial[(long long)blockIdx.x * d + i] = s_acc[i];
}

// dscale[i] = sum over blocks b, in order, of partial[b][i]
__global__ void __launch_bounds__(kThreads)
rmsnorm_dscale_kernel(const float* __restrict__ partial, int n_parts, int d,
                      float* __restrict__ dscale) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= d) return;
  float s = 0.0f;
  for (int b = 0; b < n_parts; ++b) s += partial[(long long)b * d + i];
  dscale[i] = s;
}

extern "C" int rmsnorm_backward_launch(const float* x, const float* scale,
                                       const float* g, long long n_rows,
                                       int d, float eps, float* dx,
                                       float* partial, float* dscale,
                                       void* stream) {
  if (d < 1 || d > kMaxWidth || n_rows < 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int grid = (int)(n_rows < kBwdBlocks ? n_rows : kBwdBlocks);
  if (grid > 0) {
    rmsnorm_backward_kernel<<<grid, kRowThreads, d * sizeof(float), st>>>(
        x, scale, g, n_rows, d, eps, dx, partial);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  rmsnorm_dscale_kernel<<<(d + kThreads - 1) / kThreads, kThreads, 0, st>>>(
      partial, grid, d, dscale);
  return (int)cudaGetLastError();
}
