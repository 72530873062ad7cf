// Nearest-center quantizer for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/quantize/kernel.py
// `quantize_tpu` (body `_quant_kernel`): for every element of a flat fp32
// stream, the nearest of L <= 256 codebook centers as an int32 index and
// the dequantized value centers[idx].  Its callers: the offload and
// training paths (L = 8) and the prefix cache's cold tier, which quantizes
// a demoted K/V page to 1 << kv_tier_bits centers (256 at the default 8
// bits; the TPU kernel's (1, L) codebook block takes any L).
//
// Bound: bytes.  4 bytes in and 8 bytes out per element.  On the two-pass
// deployment path at B = 256 (N*(C-k) = 147456*19 values, L = 8) 11.2 MB
// in and 22.4 MB out, about 10 us at 3.35 TB/s against 3*L flops an
// element (2 us at 67 TFLOP/s fp32).  For one full-width qwen2-0.5b page
// (98,304 values, L = 256) 1.2 MB, 0.35 us; the scan's 3*L flops an
// element would be 75.5 M, 1.1 us, and the search below needs about
// 3 * (log2(L) + 3), under 0.1 us.
//
// Design: one thread per element, grid-stride, a bounds check for any
// length (the TPU's (rows, 128) lane packing and row padding are not
// needed); neighbouring threads read and write neighbouring addresses.
// The centers are staged in shared memory once per block (1 KB at
// L = 256; kThreads >= kMaxQuantCenters, so one load per thread).  Then
// one of two walks, chosen by the block for all its elements:
// - the scan (kernels_common.cuh `nearest_center`, the fused pass's): L
//   steps an element, every thread of a warp reading the same center, a
//   shared-memory broadcast.  It takes L < kSearchMinCenters (the offload
//   and training paths' L = 8 keep their bits and their time; on an H100
//   80GB HBM3 the two walks cross between L = 12 and 24) and any codebook
//   that is not sorted;
// - the search (`nearest_sorted`), when every center is finite and none
//   is below the one before it, which the block checks on every call
//   (__syncthreads_and): jnp.linspace's float32 grid is not always
//   non-decreasing when lo and hi have one sign.  About 2 * log2(L)
//   steps an element, giving the scan's index and value bit for bit.
// Registers (-Xptxas -v, sm_90a): 28, no spill; shared memory 1,024
// bytes (the codebook).  x is loaded before the codebook is staged, so the
// two loads overlap.
#include "kernels_common.cuh"

// L of the standalone quantizer's codebook (the fused pass keeps
// kMaxCenters = 16)
constexpr int kMaxQuantCenters = 256;
static_assert(kThreads >= kMaxQuantCenters, "one center per thread");
// the fewest centers the search takes (kernel.py SEARCH_MIN_CENTERS)
constexpr int kSearchMinCenters = 17;

__device__ __forceinline__ float sq_dist(float x, float c) {
  const float t = __fsub_rn(x, c);
  return __fmul_rn(t, t);
}

// nearest_center's index and value on a codebook c[0..L) of finite
// centers, each >= the one before it.  With p the first center >= x, the
// distances fall (or stay) up to p - 1 and rise (or stay) from p, as x - c
// rounds monotonically; so the scan's pick (the lowest index of the least
// distance) is the first center whose distance equals c[p-1]'s, unless
// c[p]'s is smaller.  A NaN x finds p = 0 and a NaN distance; x = +-inf,
// or a square past the float range, gives inf distances: the scan keeps
// index 0 and value 0.0 for both, and so does this.
__device__ __forceinline__ void nearest_sorted(float x, const float* c, int L,
                                               int& idx, float& val) {
  int lo = 0, hi = L;
  while (lo < hi) {                       // p: the first c[p] >= x, else L
    const int mid = (lo + hi) >> 1;
    if (c[mid] < x) lo = mid + 1;
    else hi = mid;
  }
  const int p = lo;
  float best_d = CUDART_INF_F;
  int best_i = 0;
  float best_v = 0.0f;
  if (p > 0) {
    const float dl = sq_dist(x, c[p - 1]);
    lo = 0;
    hi = p - 1;
    while (lo < hi) {                     // the first j <= p - 1 at dl
      const int mid = (lo + hi) >> 1;
      if (sq_dist(x, c[mid]) <= dl) hi = mid;
      else lo = mid + 1;
    }
    if (dl < best_d) {
      best_d = dl;
      best_i = lo;
      best_v = c[lo];
    }
  }
  if (p < L && sq_dist(x, c[p]) < best_d) {
    best_i = p;
    best_v = c[p];
  }
  idx = best_i;
  val = best_v;
}

// one walk over this thread's elements, the first of them x0 (loaded
// before the codebook was staged)
template <bool SEARCH>
__device__ __forceinline__ void walk(const float* __restrict__ x, const float* c, int L,
                                     long long e, long long n, float x0,
                                     int* __restrict__ idx, float* __restrict__ deq) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (float v = x0; e < n; e += stride) {
    int i;
    float q;
    if constexpr (SEARCH) nearest_sorted(v, c, L, i, q);
    else nearest_center(v, c, L, i, q);
    idx[e] = i;
    deq[e] = q;
    if (e + stride < n) v = x[e + stride];
  }
}

__global__ void quantize_kernel(const float* __restrict__ x,
                                const float* __restrict__ centers,
                                long long n, int L, int* __restrict__ idx,
                                float* __restrict__ deq) {
  __shared__ float s_c[kMaxQuantCenters];
  const int t = threadIdx.x;
  const long long e = (long long)blockIdx.x * blockDim.x + t;
  const float x0 = e < n ? x[e] : 0.0f;   // in flight while the codebook is staged
  const float own = t < L ? centers[t] : 0.0f;
  if (t < L) s_c[t] = own;
  __syncthreads();
  // L is the same in every thread, so all of them reach the barrier or none
  if (L >= kSearchMinCenters &&
      __syncthreads_and(t >= L || (isfinite(own) && (t == 0 || own >= s_c[t - 1]))))
    walk<true>(x, s_c, L, e, n, x0, idx, deq);
  else
    walk<false>(x, s_c, L, e, n, x0, idx, deq);
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
