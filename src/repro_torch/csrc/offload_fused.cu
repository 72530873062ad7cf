// Fused AgileNN offload pass for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/offload_fused/kernel.py
// `offload_fused_tpu` (body `_fused_kernel`): over channels-last feature
// rows x (N, C) fp32, the static channel permute y = x[:, perm], the split
// local = y[:, :k], remote = y[:, k:], and the nearest-center quantization
// of remote against an L <= 16 codebook: idx (int32) and deq = centers[idx].
// x and the four outputs are 16-byte aligned.  The result is bit-exact
// with the plain version (kernels_common.cuh `nearest_center`).
//
// Bound: bytes.  Each row reads C*4 bytes and writes (k + 3*(C-k))*4 bytes
// against 3*L flops per remote value; at the main-path shape (N = B*24*24,
// C = 24, k = 5, L = 8, B = 256) that is 14.2 MB in and 36.6 MB out, about
// 15 us at 3.35 TB/s, while the flops take about 1 us at fp32 peak.
//
// Design: topk_split.cu's 16-byte tiles, with the split and the quantizer
// folded in.  Every device-memory access is 16 bytes.  A tile of R rows,
// R = 4 * (768 / C) (a multiple of 4; 128 at C = 24), starts on a 16-byte
// boundary in x (R*C floats) and in each output (R*k and R*(C-k) floats),
// for any C and k.  A persistent grid of four blocks per SM (fewer if the
// build's registers do not let four fit) walks the tiles; each block
// copies its next tile into shared memory by 16-byte cp.async while it
// works on the current one (two stages).  A table of
// tile offsets, built once per block from perm, gives the source of every
// output float: the R*k local ones, then the R*(C-k) remote ones.  Each
// thread gathers four sources per float4 from shared memory and writes
// local with one 16-byte store, or remote, idx and deq with one each after
// four nearest-center scans against the codebook in shared memory.  The
// ragged end of the last tile (fewer than 4 floats of an output) takes a
// scalar path in the same kernel.
#include "kernels_common.cuh"

namespace {

constexpr int kTileFloats = 3072;
constexpr int kFusedThreads = 256;
constexpr int kBlocksPerSM = 4;

// rows per tile: a multiple of 4, at most kTileFloats / C
__host__ __device__ inline int rows_per_tile(int C) {
  return 4 * (kTileFloats / (4 * C));
}

__global__ void __launch_bounds__(kFusedThreads)
offload_fused_kernel(const float* __restrict__ x,
                     const float* __restrict__ centers, Perm perm,
                     long long n_rows, int C, int k, int L,
                     float* __restrict__ local, float* __restrict__ remote,
                     int* __restrict__ idx, float* __restrict__ deq) {
  __shared__ __align__(16) float s_x[2][kTileFloats];
  __shared__ __align__(16) int s_src[kTileFloats];   // tile offset read by
                                                     // each output float
  __shared__ int s_perm[kMaxChannels];
  __shared__ float s_c[kMaxCenters];
  if (threadIdx.x < C) s_perm[threadIdx.x] = perm.p[threadIdx.x];
  if (threadIdx.x < L) s_c[threadIdx.x] = centers[threadIdx.x];
  __syncthreads();
  const int R = rows_per_tile(C), W = C - k;
  const int EL = R * k;                              // local floats per tile
  for (int f = threadIdx.x; f < EL; f += kFusedThreads)
    s_src[f] = (f / k) * C + s_perm[f % k];
  for (int f = threadIdx.x; f < R * W; f += kFusedThreads)
    s_src[EL + f] = (f / W) * C + s_perm[k + f % W];  // seen after the
                                                       // loop's first barrier
  const long long n_tiles = (n_rows + R - 1) / R;

  auto tile_rows = [&](long long tile) {
    const long long left = n_rows - tile * R;
    return (int)(left < R ? left : R);
  };
  auto issue = [&](long long tile, int stage) {      // tile -> s_x[stage]
    const float* src = x + tile * R * C;
    const int n = tile_rows(tile) * C, n4 = n / 4;
    for (int i = threadIdx.x; i < n4; i += kFusedThreads)
      cp_async16(&s_x[stage][4 * i], src + 4 * i, 16);
    for (int i = 4 * n4 + threadIdx.x; i < n; i += kFusedThreads)
      s_x[stage][i] = src[i];
  };
  int stage = 0;
  if (blockIdx.x < n_tiles) issue(blockIdx.x, 0);
  cp_async_commit();
  for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    if (tile + gridDim.x < n_tiles) issue(tile + gridDim.x, stage ^ 1);
    cp_async_commit();
    cp_async_wait<1>();                              // this tile has landed
    __syncthreads();
    const int rows = tile_rows(tile);
    const float* s = s_x[stage];

    const int nl = rows * k, nl4 = nl / 4;
    float* lo = local + tile * R * k;
    for (int i = threadIdx.x; i < nl4; i += kFusedThreads) {
      const int4 src = reinterpret_cast<const int4*>(s_src)[i];
      reinterpret_cast<float4*>(lo)[i] =
          make_float4(s[src.x], s[src.y], s[src.z], s[src.w]);
    }
    for (int i = 4 * nl4 + threadIdx.x; i < nl; i += kFusedThreads)
      lo[i] = s[s_src[i]];

    const int nr = rows * W, nr4 = nr / 4;
    const long long ro = tile * R * W;
    const int* rsrc = s_src + EL;                    // 16-byte aligned: 4 | R
    for (int i = threadIdx.x; i < nr4; i += kFusedThreads) {
      const int4 src = reinterpret_cast<const int4*>(rsrc)[i];
      const float4 val = make_float4(s[src.x], s[src.y], s[src.z], s[src.w]);
      int4 id;
      float4 dq;
      nearest_center(val.x, s_c, L, id.x, dq.x);
      nearest_center(val.y, s_c, L, id.y, dq.y);
      nearest_center(val.z, s_c, L, id.z, dq.z);
      nearest_center(val.w, s_c, L, id.w, dq.w);
      reinterpret_cast<float4*>(remote + ro)[i] = val;
      reinterpret_cast<int4*>(idx + ro)[i] = id;
      reinterpret_cast<float4*>(deq + ro)[i] = dq;
    }
    for (int i = 4 * nr4 + threadIdx.x; i < nr; i += kFusedThreads) {
      const float val = s[rsrc[i]];
      int id;
      float dq;
      nearest_center(val, s_c, L, id, dq);
      remote[ro + i] = val;
      idx[ro + i] = id;
      deq[ro + i] = dq;
    }
    __syncthreads();                 // s_x[stage] is refilled next round
    stage ^= 1;
  }
}

}  // namespace

extern "C" int offload_fused_launch(const float* x, const float* centers,
                                    const int* perm_host, long long n_rows,
                                    int C, int k, int L, float* local,
                                    float* remote, int* idx, float* deq,
                                    void* stream) {
  if (C < 1 || C > kMaxChannels || k < 0 || k > C || L < 1 ||
      L > kMaxCenters || n_rows < 0)
    return (int)cudaErrorInvalidValue;
  if (n_rows == 0) return 0;
  int sms = 0;
  cudaError_t err = current_sm_count(&sms);
  if (err != cudaSuccess) return (int)err;
  Perm perm;
  for (int j = 0; j < C; ++j) perm.p[j] = perm_host[j];
  const long long R = rows_per_tile(C);
  const long long n_tiles = (n_rows + R - 1) / R;
  int per_sm = 0;                    // resident blocks, by the build
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, offload_fused_kernel, kFusedThreads, 0);
  if (err != cudaSuccess) return (int)err;
  const long long most =
      (long long)(per_sm < kBlocksPerSM ? per_sm : kBlocksPerSM) * sms;
  const long long blocks = n_tiles < most ? n_tiles : most;
  offload_fused_kernel<<<(int)blocks, kFusedThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      x, centers, perm, n_rows, C, k, L, local, remote, idx, deq);
  return (int)cudaGetLastError();
}
