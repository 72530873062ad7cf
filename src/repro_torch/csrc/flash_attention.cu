// Flash attention for Hopper (sm_90a), fp32: causal / sliding-window GQA
// prefill attention.
//
// Replaces the Pallas TPU kernel repro/kernels/attention/kernel.py
// `flash_attention_tpu` (body `_attn_kernel`).  The JAX model calls the
// jnp `flash_attention` of repro/nn/attention.py in its place, which adds
// what the Pallas kernel lacks, so this kernel takes that function's
// contract: `causal`, `window` (keys more than `window - 1` behind a query
// are masked), `q_offset` (absolute position of query 0 relative to key 0)
// and a per-row `kv_valid_len`.  Every key at or past S is masked too; the
// jnp function masks its padded keys only under causal masking.  A query
// row with no live key writes 0, as the jnp function does.
// Layout: q (B, T, Hq, D), k/v (B, S, Hkv, D), o (B, T, Hq, D); query head
// hq reads kv head hq / (Hq / Hkv).
//
// Bound: fp32 operations outside the tensor cores.  4 * D flops per live
// (query, key) pair (a multiply-add each for q.k and p.v); at the prefill
// shape of the LLM path (qwen2-0.5b, B = 8, T = S = 512, Hq = 14, D = 64,
// causal) that is 3.8 GFLOP, about 56 us at 67 TFLOP/s, while q, k, v and
// o are 33 MB, about 10 us at 3.35 TB/s.
//
// Design: one block of 256 threads per (q tile of 64 rows, q head, batch
// row); the TPU's sequential KV grid axis becomes the block's loop over
// 64-key tiles, which starts at the window's first live tile and stops at
// the causal diagonal (shifted by q_offset) or at kv_valid_len.  Four
// neighbouring threads share a query row: each scores 16 keys of the tile
// (keys sub, sub + 4, ...) and owns D / 4 output columns (sub, sub + 4,
// ...), so the row's max and sum take two shuffles.  Q, K, V and the
// tile's probabilities sit in shared memory with rows padded to an odd
// stride, so the reads of a warp fall in distinct banks or broadcast.  The
// online softmax runs in fp32 as in the jnp function.  Every inner product
// reads shared memory once per multiply-add, so the kernel is held by
// shared-memory bandwidth well below the fp32 peak: register tiling, and
// the tensor cores in bf16/TF32, are later work.
#include "kernels_common.cuh"

namespace {

constexpr int kBQ = 64;                 // query rows per block
constexpr int kBK = 64;                 // keys per tile
constexpr int kSub = 4;                 // threads per query row
constexpr int kFlashThreads = kBQ * kSub;

template <int D>
constexpr int smem_floats() {
  return kBQ * (D + 1) + kBK * (D + 1) + kBK * D + kBQ * (kBK + 1);
}

template <int D>
__global__ void __launch_bounds__(kFlashThreads)
flash_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v,
                       const int* __restrict__ kv_valid, int T, int S, int Hq,
                       int Hkv, int causal, int window, int q_offset,
                       float scale, float* __restrict__ o) {
  extern __shared__ float smem[];
  constexpr int DP = D + 1;
  constexpr int PP = kBK + 1;
  constexpr int KPT = kBK / kSub;        // keys scored per thread
  constexpr int CPT = D / kSub;          // output columns per thread
  float* sQ = smem;                      // kBQ x DP
  float* sK = sQ + kBQ * DP;             // kBK x DP
  float* sV = sK + kBK * DP;             // kBK x D
  float* sP = sV + kBK * D;              // kBQ x PP

  const int b = blockIdx.z, hq = blockIdx.y, q0 = blockIdx.x * kBQ;
  const int hk = hq / (Hq / Hkv);
  const int tid = threadIdx.x, r = tid / kSub, sub = tid % kSub;
  const int n_q = min(kBQ, T - q0);

  for (int e = tid; e < kBQ * D; e += kFlashThreads) {
    const int i = e / D, d = e % D;
    sQ[i * DP + d] =
        i < n_q ? q[(((long long)b * T + q0 + i) * Hq + hq) * D + d] : 0.0f;
  }

  // the keys any row of this tile can see: [k_begin, k_end)
  const int valid = kv_valid ? max(0, min(S, kv_valid[b])) : S;
  const int qp_lo = q_offset + q0, qp_hi = q_offset + q0 + n_q - 1;
  const int k_end = causal ? min(valid, max(0, qp_hi + 1)) : valid;
  const int k_begin = window > 0 ? max(0, qp_lo - window + 1) : 0;
  const int qpos = q_offset + q0 + r;
  const bool row_live = r < n_q;

  float m = -CUDART_INF_F, l = 0.0f;
  float acc[CPT];
#pragma unroll
  for (int c = 0; c < CPT; ++c) acc[c] = 0.0f;

  for (int kb = (k_begin / kBK) * kBK; kb < k_end; kb += kBK) {
    __syncthreads();  // the previous tile's reads of sK, sV, sP are done
    for (int e = tid; e < kBK * D; e += kFlashThreads) {
      const int j = e / D, d = e % D;
      const int kp = kb + j;
      float kv = 0.0f, vv = 0.0f;
      if (kp < S) {
        const long long off = (((long long)b * S + kp) * Hkv + hk) * D + d;
        kv = k[off];
        vv = v[off];
      }
      sK[j * DP + d] = kv;
      sV[j * D + d] = vv;
    }
    __syncthreads();

    float s[KPT];
#pragma unroll
    for (int t = 0; t < KPT; ++t) s[t] = 0.0f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float qd = sQ[r * DP + d];
#pragma unroll
      for (int t = 0; t < KPT; ++t)
        s[t] = fmaf(qd, sK[(sub + kSub * t) * DP + d], s[t]);
    }
    float tile_max = -CUDART_INF_F;
#pragma unroll
    for (int t = 0; t < KPT; ++t) {
      const int kp = kb + sub + kSub * t;
      const bool live = row_live && kp < valid && (!causal || kp <= qpos) &&
                        (window <= 0 || kp > qpos - window);
      s[t] = live ? s[t] * scale : -CUDART_INF_F;
      tile_max = fmaxf(tile_max, s[t]);
    }
    tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 1));
    tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 2));
    const float m_new = fmaxf(m, tile_max);
    const float m_safe = m_new == -CUDART_INF_F ? 0.0f : m_new;
    const float corr = m == -CUDART_INF_F ? 0.0f : expf(m - m_safe);
    float psum = 0.0f;
#pragma unroll
    for (int t = 0; t < KPT; ++t) {
      const float p = s[t] == -CUDART_INF_F ? 0.0f : expf(s[t] - m_safe);
      sP[r * PP + sub + kSub * t] = p;
      psum += p;
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    l = corr * l + psum;
    m = m_new;
    __syncwarp();  // the row's four threads wrote sP; all of it is read below
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[c] *= corr;
#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      const float p = sP[r * PP + j];
#pragma unroll
      for (int c = 0; c < CPT; ++c)
        acc[c] = fmaf(p, sV[j * D + sub + kSub * c], acc[c]);
    }
  }

  if (row_live) {
    const float denom = fmaxf(l, 1e-20f);
    float* orow = o + (((long long)b * T + q0 + r) * Hq + hq) * D;
#pragma unroll
    for (int c = 0; c < CPT; ++c) orow[sub + kSub * c] = acc[c] / denom;
  }
}

template <int D>
int launch(const float* q, const float* k, const float* v, const int* kv_valid,
           int B, int T, int S, int Hq, int Hkv, int causal, int window,
           int q_offset, float scale, float* o, cudaStream_t stream) {
  constexpr int bytes = smem_floats<D>() * (int)sizeof(float);
  static bool configured = false;   // the attribute is set once per D
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_attention_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        bytes);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  const dim3 grid((T + kBQ - 1) / kBQ, Hq, B);
  flash_attention_kernel<D><<<grid, kFlashThreads, bytes, stream>>>(
      q, k, v, kv_valid, T, S, Hq, Hkv, causal, window, q_offset, scale, o);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int flash_attention_launch(const float* q, const float* k,
                                      const float* v, const int* kv_valid,
                                      int B, int T, int S, int Hq, int Hkv,
                                      int D, int causal, int window,
                                      int q_offset, float scale, float* o,
                                      void* stream) {
  if (B < 0 || T < 0 || S < 0 || Hkv < 1 || Hq < Hkv || Hq % Hkv ||
      B > 65535 || Hq > 65535)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || T == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return launch<64>(q, k, v, kv_valid, B, T, S, Hq, Hkv, causal, window,
                        q_offset, scale, o, st);
    case 128:
      return launch<128>(q, k, v, kv_valid, B, T, S, Hq, Hkv, causal, window,
                         q_offset, scale, o, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
