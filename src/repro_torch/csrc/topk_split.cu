// Static channel permute for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/topk_split/kernel.py
// `channel_permute_tpu` (body `_permute_kernel`): out[:, c] = x[:, perm[c]]
// over channels-last rows (N, C) fp32, C <= 64, any N.  The local/remote
// split is a slice of the result (repro_torch/kernels/topk_split/ops.py
// `split_op`).  It is the permute half of offload_fused.cu.  Pure data
// movement: the result is bit-exact.  x and out are 16-byte aligned.
//
// Bound: bytes, with no arithmetic: N*C*4 bytes in and out; at the
// main-path shape (N = 147456, C = 24) 14.2 MB each way, 0.0085 ms at
// 3.35 TB/s.
//
// Design: every device-memory access is 16 bytes.  A row of C floats is
// not a whole number of float4s, but a tile of R rows with R a multiple of
// 4 is, for any C, and starts on a 16-byte boundary; R = 4 * (768 / C)
// rounds a tile to at most 3072 floats (12 KB; R = 128 at C = 24).  A
// persistent grid of four blocks per SM walks the tiles.  Each block
// copies its next tile into shared memory by 16-byte cp.async while it
// permutes the current one (two stages), gathers each output float4's
// four sources from shared memory through a table of tile offsets built
// once per block from perm (staged once per block), and writes the float4
// to device memory.  The ragged end of the last tile (fewer than 4 floats)
// takes a scalar path in the same kernel.
#include "kernels_common.cuh"

namespace {

constexpr int kTileFloats = 3072;
constexpr int kPermThreads = 256;
constexpr int kBlocksPerSM = 4;

// rows per tile: a multiple of 4, at most kTileFloats / C
__host__ __device__ inline int rows_per_tile(int C) {
  return 4 * (kTileFloats / (4 * C));
}

__global__ void __launch_bounds__(kPermThreads)
topk_split_kernel(const float* __restrict__ x, Perm perm, long long n_rows,
                  int C, float* __restrict__ out) {
  __shared__ __align__(16) float s_x[2][kTileFloats];
  __shared__ __align__(16) int s_src[kTileFloats];   // tile offset read by
                                                     // each output element
  __shared__ int s_perm[kMaxChannels];
  if (threadIdx.x < C) s_perm[threadIdx.x] = perm.p[threadIdx.x];
  __syncthreads();
  const int E = rows_per_tile(C) * C;                // floats per full tile
  for (int f = threadIdx.x; f < E; f += kPermThreads)
    s_src[f] = (f / C) * C + s_perm[f % C];          // seen after the
                                                     // loop's first barrier
  const long long total = n_rows * C;
  const long long n_tiles = (total + E - 1) / E;

  auto issue = [&](long long tile, int stage) {      // tile -> s_x[stage]
    const long long base = tile * E;
    const int n = (int)(total - base < E ? total - base : E);
    const int n4 = n / 4;
    for (int i = threadIdx.x; i < n4; i += kPermThreads)
      cp_async16(&s_x[stage][4 * i], x + base + 4 * i, 16);
    for (int i = 4 * n4 + threadIdx.x; i < n; i += kPermThreads)
      s_x[stage][i] = x[base + i];
  };
  int stage = 0;
  if (blockIdx.x < n_tiles) issue(blockIdx.x, 0);
  cp_async_commit();
  for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    if (tile + gridDim.x < n_tiles) issue(tile + gridDim.x, stage ^ 1);
    cp_async_commit();
    cp_async_wait<1>();                              // this tile has landed
    __syncthreads();
    const long long base = tile * E;
    const int n = (int)(total - base < E ? total - base : E);
    const int n4 = n / 4;
    const float* s = s_x[stage];
    float4* o4 = reinterpret_cast<float4*>(out + base);
    for (int i = threadIdx.x; i < n4; i += kPermThreads) {
      const int4 src = reinterpret_cast<const int4*>(s_src)[i];
      o4[i] = make_float4(s[src.x], s[src.y], s[src.z], s[src.w]);
    }
    for (int i = 4 * n4 + threadIdx.x; i < n; i += kPermThreads)
      out[base + i] = s[s_src[i]];
    __syncthreads();                 // s_x[stage] is refilled next round
    stage ^= 1;
  }
}

}  // namespace

extern "C" int topk_split_launch(const float* x, const int* perm_host,
                                 long long n_rows, int C, float* out,
                                 void* stream) {
  if (C < 1 || C > kMaxChannels || n_rows < 0)
    return (int)cudaErrorInvalidValue;
  if (n_rows == 0) return 0;
  int sms = 0;
  const cudaError_t err = current_sm_count(&sms);
  if (err != cudaSuccess) return (int)err;
  Perm perm;
  for (int j = 0; j < C; ++j) perm.p[j] = perm_host[j];
  const long long E = (long long)rows_per_tile(C) * C;
  const long long n_tiles = (n_rows * C + E - 1) / E;
  const long long most = (long long)kBlocksPerSM * sms;
  const long long blocks = n_tiles < most ? n_tiles : most;
  topk_split_kernel<<<(int)blocks, kPermThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(x, perm, n_rows, C,
                                                           out);
  return (int)cudaGetLastError();
}
