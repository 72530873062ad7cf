// Static channel permute for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/topk_split/kernel.py
// `channel_permute_tpu` (body `_permute_kernel`): out[:, c] = x[:, perm[c]]
// over channels-last rows (N, C) fp32.  The local/remote split is a slice
// of the result (repro_torch/kernels/topk_split/ops.py `split_op`).  It is
// the permute half of offload_fused.cu.
//
// Bound: bytes, with no arithmetic: N*C*4 bytes in and out; at the
// main-path shape (N = 147456, C = 24) 14.2 MB each way, about 8.5 us at
// 3.35 TB/s.
//
// Design: one thread per output element; a block holds whole rows and
// strides over rows with each thread's column fixed (no divide in the
// loop), a bounds check for any N.  A warp's gathered reads stay inside
// the few rows it writes, and its writes are contiguous.  perm (C <= 64)
// rides in the parameter space and is staged in shared memory once per
// block.
#include "kernels_common.cuh"

__global__ void topk_split_kernel(const float* __restrict__ x, Perm perm,
                                  long long n_rows, int C,
                                  float* __restrict__ out) {
  __shared__ int s_perm[kMaxChannels];
  if (threadIdx.x < C) s_perm[threadIdx.x] = perm.p[threadIdx.x];
  __syncthreads();

  const int rpb = blockDim.x / C;
  const int j = threadIdx.x % C;
  const int src = s_perm[j];
  for (long long row = (long long)blockIdx.x * rpb + threadIdx.x / C;
       row < n_rows; row += (long long)gridDim.x * rpb)
    out[row * C + j] = x[row * C + src];
}

extern "C" int topk_split_launch(const float* x, const int* perm_host,
                                 long long n_rows, int C, float* out,
                                 void* stream) {
  if (C < 1 || C > kMaxChannels || n_rows < 0)
    return (int)cudaErrorInvalidValue;
  if (n_rows == 0) return 0;
  Perm perm;
  for (int j = 0; j < C; ++j) perm.p[j] = perm_host[j];
  topk_split_kernel<<<row_grid_for(n_rows, C), rows_per_block(C) * C, 0,
                      static_cast<cudaStream_t>(stream)>>>(x, perm, n_rows,
                                                           C, out);
  return (int)cudaGetLastError();
}
