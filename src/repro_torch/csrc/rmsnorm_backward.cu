// RMSNorm backward for Hopper (sm_90a), fp32 and bf16.
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
// Bound: bytes.  x and g are read once, dx written once, 3 * N * d * E
// bytes for elements of E bytes (scale and dscale are d elements): in fp32
// at the training shape of qwen2-0.5b (N = 4 * 4096 rows, d = 896) 176 MB,
// 0.053 ms at 3.35 TB/s; in bf16 at moonshot-v1-16b-a3b's training
// microbatch (N = 2 * 4096 rows, d = 2048) 100.7 MB, 0.030 ms.
//
// The bf16 half (x, scale, g, dx and dscale bf16; the partial sums fp32)
// is the same two kernels instantiated on the element type: each value is
// widened as it is loaded, the fp32 arithmetic runs unchanged, and dx and
// dscale are rounded to bf16 once, as they are stored.  So it is bitwise
// the fp32 kernels on the widened inputs, rounded (chip_smoke.py phase
// 17a), as the JAX model's autodiff of `rmsnorm_apply` widens, computes in
// fp32 and rounds.  That holds because both halves give a column to the
// same thread and take every sum in the same order: a thread's columns
// are 8-column chunks (one 16-byte load of bf16, two of fp32), and the
// explicit fmaf's leave the compiler nothing to contract differently.
//
// Design: one pass over HBM, the rows in registers (the chunk walk and
// the row sum in rmsnorm_common.cuh, shared with the forward).
// - A row goes to TPR threads: 32 (a warp, four rows a block of 128) for
//   d <= 1024, 64 for d <= 2048, 128 for d <= 4096, 256 (a block of 256)
//   for d <= 8192, so a thread holds at most 4 chunks (32 columns) of x, g
//   and scale: the fp32 half, whose chunks are twice the registers, stays
//   unspilled.  Chunk c of a row goes to thread c % TPR, so a warp's loads
//   are contiguous runs.
// - scale is loaded once a block and kept in registers.  A row's x and g
//   are loaded once; the thread sums x^2 and x * scale * g over its chunks
//   in order, then shuffles, then (TPR > 32) one shared-memory step behind
//   a barrier of the row's warps alone; then dx goes out by 16-byte stores
//   from the same registers.
// - dscale: each thread keeps g * (x * r) for its columns in registers
//   across the rows it walks (rows sub, sub + G, ... for the G row groups
//   of the grid); at the end a block's row groups are added in order
//   through shared memory and the block writes one partial row.  The grid
//   is min(ceil(N / rows a block), kBwdBlocks): a function of N and d
//   alone, never of the card, so two calls give bitwise equal gradients
//   (no float atomics).  The partial rows are at most kBwdBlocks x d
//   floats: 4 MB at d = 2048, 4 % of the bf16 kernel's bytes there.
// - rmsnorm_dscale_kernel sums the partial rows by column: a block of 256
//   threads takes 16 columns (a thread 4, by 16-byte loads) and splits the
//   rows among 64 row groups, then folds the 64 sums in a fixed tree.
// - A d that is not a multiple of 8, or an operand off 16 bytes, takes the
//   same chunks element by element (VEC false): the same columns to the
//   same threads and the same sums in the same order.
// - Registers (-Xptxas -v, sm_90a): 126-128 (bf16) and 156-166 (fp32) on
//   the 16-byte walks, 153-162 element by element, no spill; shared memory
//   12 KB (32 threads a row), 8 KB (64) or 16-32 bytes (a block a row) for
//   the fold.  rmsnorm_dscale_kernel: 32 registers, 4 KB.
#include <cstdint>

#include "rmsnorm_common.cuh"

namespace {

constexpr long long kBwdBlocks = 512;    // kernel.py BACKWARD_BLOCKS
constexpr int kPartialRowsPerBlock = 1;  // kernel.py PARTIAL_ROWS_PER_BLOCK
constexpr int kSumThreads = 256;         // rmsnorm_dscale_kernel's block
constexpr int kSumColThreads = 4;        // threads across its 16 columns
constexpr int kSumGroups = kSumThreads / kSumColThreads;   // row groups
constexpr int kSumCols = 4 * kSumColThreads;

template <typename T, int TPR, bool VEC>
__global__ void __launch_bounds__(TPR < 128 ? 128 : TPR)
rmsnorm_backward_kernel(const T* __restrict__ x, const T* __restrict__ scale,
                        const T* __restrict__ g, long long n_rows, int d,
                        float eps, T* __restrict__ dx,
                        float* __restrict__ partial) {
  constexpr int BT = block_threads<TPR>();
  constexpr int RPB = BT / TPR;               // rows a block walks at once
  constexpr int DMAX = TPR * kChunks * 8;     // widest row at this TPR
  __shared__ float s_part[BT / 32];
  __shared__ __align__(16) float s_fold[RPB > 1 ? (RPB - 1) * DMAX : 4];
  const int tr = threadIdx.x % TPR, sub = threadIdx.x / TPR;
  const int n_ch = (d + 7) / 8;               // chunks a row

  Chunk<T> sc[kChunks];                       // this thread's scale chunks
#pragma unroll
  for (int j = 0; j < kChunks; ++j)
    if (tr + j * TPR < n_ch) load_chunk<T, VEC>(sc[j], scale, tr + j * TPR, d);
  float acc[kChunks][8];                      // its columns' g * (x * r)
#pragma unroll
  for (int j = 0; j < kChunks; ++j)
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[j][i] = 0.0f;

  const long long groups = (long long)gridDim.x * RPB;
  for (long long row = (long long)blockIdx.x * RPB + sub; row < n_rows; row += groups) {
    const T* xr = x + row * d;
    const T* gr = g + row * d;
    Chunk<T> xc[kChunks], gc[kChunks];
#pragma unroll
    for (int j = 0; j < kChunks; ++j) {
      if (tr + j * TPR < n_ch) {
        load_chunk<T, VEC>(xc[j], xr, tr + j * TPR, d);
        load_chunk<T, VEC>(gc[j], gr, tr + j * TPR, d);
      }
    }
    float ss = 0.0f, dot = 0.0f;
#pragma unroll
    for (int j = 0; j < kChunks; ++j) {
      const int c = tr + j * TPR;
      if (c < n_ch) {
        float xf[8], gf[8], sf[8];
        widen8(xc[j], xf);
        widen8(gc[j], gf);
        widen8(sc[j], sf);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          if (VEC || 8 * c + i < d) {
            ss = fmaf(xf[i], xf[i], ss);
            dot = fmaf(xf[i] * sf[i], gf[i], dot);
          }
        }
      }
    }
    ss = row_sum<TPR>(ss, s_part, sub);
    dot = row_sum<TPR>(dot, s_part, sub);
    const float r = rsqrtf(ss / (float)d + eps);
    const float cr = r * r * r * (dot / (float)d);
    T* dxr = dx + row * d;
#pragma unroll
    for (int j = 0; j < kChunks; ++j) {
      const int c = tr + j * TPR;
      if (c < n_ch) {
        float xf[8], gf[8], sf[8], out[8];
        widen8(xc[j], xf);
        widen8(gc[j], gf);
        widen8(sc[j], sf);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          out[i] = fmaf(-xf[i], cr, r * (sf[i] * gf[i]));
          acc[j][i] = fmaf(gf[i], xf[i] * r, acc[j][i]);
        }
        store_chunk<T, VEC>(dxr, c, d, out);
      }
    }
  }

  // the block's row groups added in order: group 0 + group 1 + ...
  if constexpr (RPB > 1) {
    if (sub > 0) {
#pragma unroll
      for (int j = 0; j < kChunks; ++j)
#pragma unroll
        for (int i = 0; i < 8; ++i)
          s_fold[(sub - 1) * DMAX + 8 * (tr + j * TPR) + i] = acc[j][i];
    }
    __syncthreads();
    if (sub > 0) return;
#pragma unroll
    for (int s = 1; s < RPB; ++s)
#pragma unroll
      for (int j = 0; j < kChunks; ++j)
#pragma unroll
        for (int i = 0; i < 8; ++i)
          acc[j][i] += s_fold[(s - 1) * DMAX + 8 * (tr + j * TPR) + i];
  }
  float* prow = partial + (long long)blockIdx.x * kPartialRowsPerBlock * d;
#pragma unroll
  for (int j = 0; j < kChunks; ++j) {
    const int c = tr + j * TPR;
    if (c < n_ch) store_chunk<float, VEC>(prow, c, d, acc[j]);
  }
}

// dscale[i] = the sum over the partial rows of partial[.][i]: each thread
// sums rows grp, grp + kSumGroups, ... of its 4 columns in row order, and
// the kSumGroups sums are folded in a fixed tree
template <typename T, bool VEC>
__global__ void __launch_bounds__(kSumThreads)
rmsnorm_dscale_kernel(const float* __restrict__ partial, int n_parts, int d,
                      T* __restrict__ dscale) {
  __shared__ __align__(16) float s_sum[kSumGroups][kSumCols];
  const int cq = threadIdx.x % kSumColThreads, grp = threadIdx.x / kSumColThreads;
  const int col = blockIdx.x * kSumCols + 4 * cq;
  float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  if (col < d) {
    for (int b = grp; b < n_parts; b += kSumGroups) {
      const float* p = partial + (long long)b * d + col;
      if constexpr (VEC) {
        const float4 v = *reinterpret_cast<const float4*>(p);
        s[0] += v.x;
        s[1] += v.y;
        s[2] += v.z;
        s[3] += v.w;
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (col + i < d) s[i] += p[i];
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) s_sum[grp][4 * cq + i] = s[i];
  __syncthreads();
#pragma unroll
  for (int half = kSumGroups / 2; half > 0; half >>= 1) {
    if (grp < half) {
#pragma unroll
      for (int i = 0; i < 4; ++i) s_sum[grp][4 * cq + i] += s_sum[grp + half][4 * cq + i];
    }
    __syncthreads();
  }
  if (grp == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (col + i < d) dscale[col + i] = narrow<T>(s_sum[0][4 * cq + i]);
  }
}

template <typename T, int TPR, bool VEC>
cudaError_t launch_rows(const T* x, const T* scale, const T* g, long long n_rows,
                        int d, float eps, T* dx, float* partial, int* grid,
                        cudaStream_t st) {
  constexpr int RPB = block_threads<TPR>() / TPR;
  const long long blocks = (n_rows + RPB - 1) / RPB;
  *grid = (int)(blocks < kBwdBlocks ? blocks : kBwdBlocks);
  if (*grid > 0)
    rmsnorm_backward_kernel<T, TPR, VEC><<<*grid, block_threads<TPR>(), 0, st>>>(
        x, scale, g, n_rows, d, eps, dx, partial);
  return cudaGetLastError();
}

template <typename T, bool VEC>
cudaError_t launch_vec(const T* x, const T* scale, const T* g, long long n_rows,
                       int d, float eps, T* dx, float* partial, int* grid,
                       cudaStream_t st) {
  // a thread holds at most kChunks chunks: TPR * kChunks * 8 >= d
  if (d <= 32 * kChunks * 8)
    return launch_rows<T, 32, VEC>(x, scale, g, n_rows, d, eps, dx, partial, grid, st);
  if (d <= 64 * kChunks * 8)
    return launch_rows<T, 64, VEC>(x, scale, g, n_rows, d, eps, dx, partial, grid, st);
  if (d <= 128 * kChunks * 8)
    return launch_rows<T, 128, VEC>(x, scale, g, n_rows, d, eps, dx, partial, grid, st);
  return launch_rows<T, 256, VEC>(x, scale, g, n_rows, d, eps, dx, partial, grid, st);
}

template <typename T>
int launch(const T* x, const T* scale, const T* g, long long n_rows, int d,
           float eps, T* dx, float* partial, T* dscale, void* stream) {
  if (d < 1 || d > kMaxWidth || n_rows < 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = d % 8 == 0 && ((reinterpret_cast<uintptr_t>(x) |
                                   reinterpret_cast<uintptr_t>(scale) |
                                   reinterpret_cast<uintptr_t>(g) |
                                   reinterpret_cast<uintptr_t>(dx) |
                                   reinterpret_cast<uintptr_t>(partial)) & 15) == 0;
  int grid = 0;
  cudaError_t err =
      vec ? launch_vec<T, true>(x, scale, g, n_rows, d, eps, dx, partial, &grid, st)
          : launch_vec<T, false>(x, scale, g, n_rows, d, eps, dx, partial, &grid, st);
  if (err != cudaSuccess) return (int)err;
  const int n_parts = grid * kPartialRowsPerBlock;
  const int sum_blocks = (d + kSumCols - 1) / kSumCols;
  if (d % 4 == 0 && (reinterpret_cast<uintptr_t>(partial) & 15) == 0)
    rmsnorm_dscale_kernel<T, true><<<sum_blocks, kSumThreads, 0, st>>>(
        partial, n_parts, d, dscale);
  else
    rmsnorm_dscale_kernel<T, false><<<sum_blocks, kSumThreads, 0, st>>>(
        partial, n_parts, d, dscale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int rmsnorm_backward_launch(const float* x, const float* scale,
                                       const float* g, long long n_rows,
                                       int d, float eps, float* dx,
                                       float* partial, float* dscale,
                                       void* stream) {
  return launch(x, scale, g, n_rows, d, eps, dx, partial, dscale, stream);
}

extern "C" int rmsnorm_backward_bf16_launch(
    const __nv_bfloat16* x, const __nv_bfloat16* scale, const __nv_bfloat16* g,
    long long n_rows, int d, float eps, __nv_bfloat16* dx, float* partial,
    __nv_bfloat16* dscale, void* stream) {
  return launch(x, scale, g, n_rows, d, eps, dx, partial, dscale, stream);
}
