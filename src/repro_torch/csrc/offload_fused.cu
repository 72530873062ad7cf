// Fused AgileNN offload pass for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/offload_fused/kernel.py
// `offload_fused_tpu` (body `_fused_kernel`): over channels-last feature
// rows x (N, C) fp32, the static channel permute y = x[:, perm], the split
// local = y[:, :k], remote = y[:, k:], and the nearest-center quantization
// of remote against an L <= 16 codebook: idx (int32) and deq = centers[idx].
//
// Bound: bytes.  Each row reads C*4 bytes and writes (k + 3*(C-k))*4 bytes
// against 3*L flops per remote value; at the main-path shape (N = B*24*24,
// C = 24, k = 5, L = 8, B = 256) that is 14.2 MB in and 36.6 MB out, about
// 15 us at 3.35 TB/s, while the flops take about 1 us at fp32 peak.
//
// Design: one thread per (row, output column), grid-stride over N*C, a
// bounds check for any N (the TPU's padding to whole tiles becomes the loop
// bound).  A warp covers about 32/C consecutive rows, so its gathered reads
// stay inside those rows' few 32-byte sectors and its writes to each output
// are contiguous: every byte crosses HBM once.  perm (C <= 64) and the
// centers are staged in shared memory once per block.  The whole-rows
// layout of topk_split.cu (no divide) measured about 5% slower here on the
// H100 (PERF.md), so this kernel keeps the flat index and its divide.
#include "kernels_common.cuh"

__global__ void offload_fused_kernel(const float* __restrict__ x,
                                     const float* __restrict__ centers,
                                     Perm perm, long long n_rows, int C, int k,
                                     int L, float* __restrict__ local,
                                     float* __restrict__ remote,
                                     int* __restrict__ idx,
                                     float* __restrict__ deq) {
  __shared__ int s_perm[kMaxChannels];
  __shared__ float s_c[kMaxCenters];
  if (threadIdx.x < C) s_perm[threadIdx.x] = perm.p[threadIdx.x];
  if (threadIdx.x < L) s_c[threadIdx.x] = centers[threadIdx.x];
  __syncthreads();

  const int R = C - k;
  const long long total = n_rows * C;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       e < total; e += stride) {
    const long long row = e / C;
    const int j = (int)(e - row * C);
    const float v = x[row * C + s_perm[j]];
    if (j < k) {
      local[row * k + j] = v;
    } else {
      const long long o = row * R + (j - k);
      int i;
      float q;
      nearest_center(v, s_c, L, i, q);
      remote[o] = v;
      idx[o] = i;
      deq[o] = q;
    }
  }
}

extern "C" int offload_fused_launch(const float* x, const float* centers,
                                    const int* perm_host, long long n_rows,
                                    int C, int k, int L, float* local,
                                    float* remote, int* idx, float* deq,
                                    void* stream) {
  if (C < 1 || C > kMaxChannels || k < 0 || k > C || L < 1 ||
      L > kMaxCenters || n_rows < 0)
    return (int)cudaErrorInvalidValue;
  if (n_rows == 0) return 0;
  Perm perm;
  for (int j = 0; j < C; ++j) perm.p[j] = perm_host[j];
  offload_fused_kernel<<<grid_for(n_rows * C), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      x, centers, perm, n_rows, C, k, L, local, remote, idx, deq);
  return (int)cudaGetLastError();
}
