// RMSNorm for Hopper (sm_90a), fp32 and bf16.
//
// Replaces the Pallas TPU kernel repro/kernels/rmsnorm/kernel.py
// `rmsnorm_tpu` (body `_rmsnorm_kernel`): over rows x (N, d),
// y = x * rsqrt(mean(x^2) + eps) * scale, the sum taken in fp32.  The JAX
// model computes (var + eps) ** -0.5 (repro/nn/norm.py), so this kernel
// agrees with its plain version to rounding, not bit for bit.
//
// Bound: bytes.  Each row is read once and written once, 2 * N * d * E
// bytes for elements of E bytes (scale is d more), against about 4 flops
// an element.  In fp32 at the prefill shape of the LLM path (N = 8 * 512
// rows of qwen2-0.5b, d = 896) that is 29 MB, 0.0088 ms at 3.35 TB/s; at a
// decode step's 8 rows 57 KB, 0.00002 ms, far under the ~0.005 ms a launch
// takes.  In bf16 at moonshot-v1-16b-a3b's prefill rows (N = 8 * 256,
// d = 2048) 16.8 MB, 0.0050 ms.
//
// Design: one pass over HBM, the row in registers; one kernel templated
// on the element type, as rmsnorm_backward.cu is (rmsnorm_common.cuh).
// - A row goes to TPR threads: 32 (a warp, four rows a block of 128) for
//   d <= 1024, 64 for d <= 2048, 128 for d <= 4096, 256 (a block of 256)
//   for d <= 8192, so a thread holds at most 4 chunks of 8 columns (32
//   floats of x and 32 of scale in fp32).  Chunk c of a row goes to thread
//   c % TPR, so a warp's loads are contiguous runs.
// - A row's x and its scale chunks are both loaded by 16-byte loads before
//   the sum (scale by the read-only path, from L2 after the first row), so
//   a row waits on memory once and x is read once.  Loading scale once a
//   block before the row loop, or staging it in shared memory, or a
//   persistent grid that loads the next row during this one's sum, were
//   each slower on an H100 80GB HBM3 at 700 W.
// - The sum of squares is taken in fp32: the thread's chunks in order
//   (explicit fmaf's), then shuffles, then (TPR > 32) one shared-memory
//   step behind a barrier of the row's warps alone.  r = 1 / sqrt(sum / d
//   + eps) is formed in double from that fp32 sum and rounded once (a
//   row's scalar: with rsqrtf's 2 ulp a one-row call at d = 896 came to
//   2.2x F.rms_norm's error against float64 on an H100).  y = (x * r) * scale
//   goes out by 16-byte stores from the same registers.
// - A d that is not a multiple of 8, or an operand off 16 bytes, takes the
//   same chunks element by element (the columns past d read as 0): the
//   same columns to the same threads and the same sums in the same order.
// - The bf16 half widens each value as it is loaded and rounds each output
//   once (__floats2bfloat162_rn) as it is stored; the fp32 arithmetic is
//   the fp32 half's, so it is bitwise the fp32 kernel on the widened
//   inputs, rounded (chip_smoke.py phase 16a).
// - Any N: the grid is min(ceil(N / rows a block), kMaxBlocks), grid-stride
//   beyond.
// Registers (-Xptxas -v, sm_90a): fp32 95-108 on the 16-byte walks, 95-96
// element by element; bf16 62-71 and 96-114; no spill; shared memory
// 16-32 bytes (the row's partial sums).
#include <cstdint>

#include "rmsnorm_common.cuh"

namespace {

template <typename T, int TPR, bool VEC>
__global__ void __launch_bounds__(TPR < 128 ? 128 : TPR)
rmsnorm_kernel(const T* __restrict__ x, const T* __restrict__ scale,
               long long n_rows, int d, float eps, T* __restrict__ y) {
  constexpr int BT = block_threads<TPR>();
  constexpr int RPB = BT / TPR;               // rows a block walks at once
  __shared__ float s_part[BT / 32];
  const int tr = threadIdx.x % TPR, sub = threadIdx.x / TPR;
  const int n_ch = (d + 7) / 8;               // chunks a row
  const long long groups = (long long)gridDim.x * RPB;
  for (long long row = (long long)blockIdx.x * RPB + sub; row < n_rows; row += groups) {
    const T* xr = x + row * d;
    Chunk<T> xc[kChunks], sc[kChunks];        // the columns past d read as 0
#pragma unroll
    for (int j = 0; j < kChunks; ++j) {
      const int c = tr + j * TPR;
      if (c < n_ch) {
        load_chunk<T, VEC>(xc[j], xr, c, d);
        load_chunk<T, VEC, true>(sc[j], scale, c, d);
      }
    }
    float ss = 0.0f;
#pragma unroll
    for (int j = 0; j < kChunks; ++j) {
      if (tr + j * TPR < n_ch) {
        float xf[8];
        widen8(xc[j], xf);
#pragma unroll
        for (int i = 0; i < 8; ++i) ss = fmaf(xf[i], xf[i], ss);
      }
    }
    // 1 / sqrt(mean + eps) from the fp32 sum, in double and rounded once:
    // rsqrtf's 2 ulp would be most of a short row's error
    const float r = (float)rsqrt((double)row_sum<TPR>(ss, s_part, sub) / d + eps);
    T* yr = y + row * d;
#pragma unroll
    for (int j = 0; j < kChunks; ++j) {
      const int c = tr + j * TPR;
      if (c < n_ch) {
        float xf[8], sf[8], out[8];
        widen8(xc[j], xf);
        widen8(sc[j], sf);
#pragma unroll
        for (int i = 0; i < 8; ++i) out[i] = (xf[i] * r) * sf[i];
        store_chunk<T, VEC>(yr, c, d, out);
      }
    }
  }
}

template <typename T, int TPR, bool VEC>
void launch_rows(const T* x, const T* scale, long long n_rows, int d, float eps,
                 T* y, cudaStream_t st) {
  constexpr int RPB = block_threads<TPR>() / TPR;
  const long long blocks = (n_rows + RPB - 1) / RPB;
  rmsnorm_kernel<T, TPR, VEC>
      <<<(int)(blocks < kMaxBlocks ? blocks : kMaxBlocks), block_threads<TPR>(), 0, st>>>(
          x, scale, n_rows, d, eps, y);
}

template <typename T, bool VEC>
void launch_vec(const T* x, const T* scale, long long n_rows, int d, float eps,
                T* y, cudaStream_t st) {
  // a thread holds at most kChunks chunks: TPR * kChunks * 8 >= d
  if (d <= 32 * kChunks * 8) launch_rows<T, 32, VEC>(x, scale, n_rows, d, eps, y, st);
  else if (d <= 64 * kChunks * 8) launch_rows<T, 64, VEC>(x, scale, n_rows, d, eps, y, st);
  else if (d <= 128 * kChunks * 8) launch_rows<T, 128, VEC>(x, scale, n_rows, d, eps, y, st);
  else launch_rows<T, 256, VEC>(x, scale, n_rows, d, eps, y, st);
}

template <typename T>
int launch(const T* x, const T* scale, long long n_rows, int d, float eps, T* y,
           void* stream) {
  if (d < 1 || d > kMaxWidth || n_rows < 0) return (int)cudaErrorInvalidValue;
  if (n_rows == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = d % 8 == 0 && ((reinterpret_cast<uintptr_t>(x) |
                                   reinterpret_cast<uintptr_t>(scale) |
                                   reinterpret_cast<uintptr_t>(y)) & 15) == 0;
  if (vec) launch_vec<T, true>(x, scale, n_rows, d, eps, y, st);
  else launch_vec<T, false>(x, scale, n_rows, d, eps, y, st);
  return (int)cudaGetLastError();
}

}  // namespace

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
