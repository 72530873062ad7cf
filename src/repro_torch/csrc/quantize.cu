// Nearest-center quantizer for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/quantize/kernel.py
// `quantize_tpu` (body `_quant_kernel`): for every element of a flat fp32
// stream, the nearest of L <= 256 codebook centers as an int32 index and
// the dequantized value centers[idx].  It is the quantize half of
// offload_fused.cu and shares its device function.  Its callers: the
// offload and training paths (L = 8) and the prefix cache's cold tier,
// which quantizes a demoted K/V page to 1 << kv_tier_bits centers (256 at
// the default 8 bits; the TPU kernel's (1, L) codebook block takes any L).
//
// Bound: bytes at L = 8, operations at L = 256.  4 bytes in and 8 bytes
// out per element against 3*L flops: on the two-pass deployment path at
// B = 256 (N*(C-k) = 147456*19 values) 11.2 MB in and 22.4 MB out, about
// 10 us at 3.35 TB/s; for one full-width qwen2-0.5b page (98,304 values)
// 1.2 MB, against 75.5 M flops, about 1.1 us at 67 TFLOP/s fp32.
//
// Design: one thread per element, grid-stride, a bounds check for any
// length (the TPU's (rows, 128) lane packing and row padding are not
// needed); neighbouring threads read and write neighbouring addresses.
// The centers are staged in shared memory once per block (1 KB at
// L = 256; kThreads >= kMaxQuantCenters, so one load per thread); every
// thread of a warp reads the same center at each step of the scan, a
// shared-memory broadcast.
#include "kernels_common.cuh"

// L of the standalone quantizer's codebook (the fused pass keeps
// kMaxCenters = 16)
constexpr int kMaxQuantCenters = 256;
static_assert(kThreads >= kMaxQuantCenters, "one center per thread");

__global__ void quantize_kernel(const float* __restrict__ x,
                                const float* __restrict__ centers,
                                long long n, int L, int* __restrict__ idx,
                                float* __restrict__ deq) {
  __shared__ float s_c[kMaxQuantCenters];
  if (threadIdx.x < L) s_c[threadIdx.x] = centers[threadIdx.x];
  __syncthreads();

  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x; e < n;
       e += stride) {
    int i;
    float q;
    nearest_center(x[e], s_c, L, i, q);
    idx[e] = i;
    deq[e] = q;
  }
}

extern "C" int quantize_launch(const float* x, const float* centers,
                               long long n, int L, int* idx, float* deq,
                               void* stream) {
  if (L < 1 || L > kMaxQuantCenters || n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  quantize_kernel<<<grid_for(n), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(x, centers, n, L,
                                                         idx, deq);
  return (int)cudaGetLastError();
}
