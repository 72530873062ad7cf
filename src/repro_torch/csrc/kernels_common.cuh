// Shared by the port's CUDA kernels: the launch shape, the static channel
// permutation passed by value, the nearest-center scan, and the error
// string the Python wrappers report.  Each .cu that includes this header
// is built into a shared library of its own (repro_torch/kernels/_build.py).
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

constexpr int kMaxChannels = 64;   // C of the fused pass and the permute
constexpr int kMaxCenters = 16;    // L of the codebook
constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 65536;   // beyond this, grid-stride loops

// The deployed channel permutation is fixed at training time.  It travels
// in the kernel's parameter space (by value), so a launch needs no device
// allocation and no host-to-device copy of it.
struct Perm {
  int p[kMaxChannels];
};

static inline int grid_for(long long n) {
  long long blocks = (n + kThreads - 1) / kThreads;
  return (int)(blocks < kMaxBlocks ? blocks : kMaxBlocks);
}

// Row-wise kernels over (N, C) rows give each block whole rows: a block of
// rows_per_block(C) * C threads, thread t on column t % C of row t / C.
// The grid-stride step is a whole number of rows, so a thread's column
// never changes and the loop needs no 64-bit divide.
static inline int rows_per_block(int C) { return kThreads / C; }

static inline int row_grid_for(long long n_rows, int C) {
  long long blocks = (n_rows + rows_per_block(C) - 1) / rows_per_block(C);
  return (int)(blocks < kMaxBlocks ? blocks : kMaxBlocks);
}

// Nearest center of x in c[0..L): a strict `<` scan from center 0 upward,
// so ties go to the lowest index, as repro.kernels.common.nearest_center_scan
// and argmin do.  The distance is formed with round-to-nearest intrinsics,
// which the compiler never contracts into an FMA, so indices and values are
// bit-exact with the plain PyTorch scan.  A NaN x never wins: index 0, 0.0.
__device__ __forceinline__ void nearest_center(float x, const float* c, int L,
                                               int& idx, float& val) {
  float best_d = CUDART_INF_F;
  int best_i = 0;
  float best_v = 0.0f;
#pragma unroll 4
  for (int j = 0; j < L; ++j) {
    const float t = __fsub_rn(x, c[j]);
    const float d = __fmul_rn(t, t);
    if (d < best_d) {
      best_d = d;
      best_i = j;
      best_v = c[j];
    }
  }
  idx = best_i;
  val = best_v;
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
