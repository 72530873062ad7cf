// Shared by the port's CUDA kernels: the launch shape, the static channel
// permutation passed by value, the SM count, the nearest-center scan, the
// 16-byte asynchronous copy, and the error string the Python wrappers
// report.
// Each .cu that includes this header is built into a shared library of its
// own (repro_torch/kernels/_build.py).
#pragma once

#include <cuda_bf16.h>
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

// Multiprocessors of the current device, cached by device ordinal: what a
// persistent grid is sized by.
static inline cudaError_t current_sm_count(int* sms) {
  static int count[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64) return cudaErrorInvalidDevice;
  if (count[dev] == 0) {
    err = cudaDeviceGetAttribute(&count[dev], cudaDevAttrMultiProcessorCount,
                                 dev);
    if (err != cudaSuccess) return err;
  }
  *sms = count[dev];
  return cudaSuccess;
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

// 16-byte asynchronous copy from device memory into shared memory
// (cp.async.cg: cached in L2 only).  Both addresses are 16-byte aligned.
// The copy reads src_bytes (0 or 16) and zero-fills the rest, so a row
// past the edge costs no branch: pass 0 and any valid address.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
