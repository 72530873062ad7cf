// Paged decode attention for Hopper (sm_90a), fp32: flash-decoding of one
// query token per row against a KV cache.
//
// Replaces the Pallas TPU kernel repro/kernels/decode_attention/kernel.py
// `paged_decode_attention_tpu` (body `_paged_decode_kernel`): for every
// batch row b and kv head h, the G = Hq / Hkv query heads of h attend the
// first attend_len[b] slots of the cache with an online softmax; pages at
// or past attend_len[b] are neither read nor computed, and the slots past
// it inside the last live page are masked.  Any cache width S works: the
// last page is cut at attend_len, not padded.  attend_len comes from a
// device array (B,) or, for a batch whose rows share one depth, from a
// scalar argument.  A row with attend_len = 0 writes 0: no page is live,
// and the output is acc / max(l, 1e-20) with acc and l at 0, as in the TPU
// kernel's `_finish`.  The plain version (kernels/decode_attention/ref.py)
// keeps the same convention, that a query with no live key gets 0.
// Layout: q (B, Hkv, G, D) (the (B, 1, Hq, D) query with hq = h * G + g),
// k/v (B, S, Hkv, D), o (B, Hkv, G, D).
//
// Bound: bytes.  Every live K and V slot is read once,
// B * attend * Hkv * D * 4 * 2 bytes, against 4 * D flops per (query head,
// slot); at the decode shape of the LLM path (qwen2-0.5b, B = 8, Hkv = 2,
// D = 64, attend about 530 of S = 1024) that is 4.3 MB, about 1.3 us at
// 3.35 TB/s.
//
// Design: one block of 128 threads per (kv head, batch row) holds all G
// query heads of that kv head, so each K/V page crosses HBM once for the
// whole group, as in the Pallas kernel.  The Pallas grid's sequential page
// axis becomes the block's loop over pages; a page's K and V rows are
// staged in shared memory (K rows padded to an odd stride), the G x page
// scores are spread over the threads, one warp per head takes the page's
// max and sum and rescales its running state, and each thread then owns
// fixed (head, column) pairs of the fp32 accumulator in registers.  At the
// decode shape that is only B * Hkv = 16 blocks on the card's 132 SMs:
// the kernel is far from its bound, and splitting the pages of a row over
// several blocks (split-K flash-decoding, with a combine pass) is later
// work.
#include "kernels_common.cuh"

namespace {

constexpr int kDecodeThreads = 128;
constexpr int kMaxGroup = 16;           // G = Hq / Hkv
constexpr int kMaxPage = 128;

__host__ __device__ constexpr int smem_floats(int D, int G, int page) {
  return G * D + page * (D + 1) + page * D + G * page + 3 * G;
}

template <int D>
__global__ void __launch_bounds__(kDecodeThreads)
decode_attention_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const int* __restrict__ attend_rows, int attend_all,
                        int S, int Hkv, int G, int page, float scale,
                        float* __restrict__ o) {
  extern __shared__ float smem[];
  constexpr int DP = D + 1;
  constexpr int SLOTS = kMaxGroup * D / kDecodeThreads;
  float* sQ = smem;                      // G x D
  float* sK = sQ + G * D;                // page x DP
  float* sV = sK + page * DP;            // page x D
  float* sS = sV + page * D;             // G x page: scores, then p
  float* sM = sS + G * page;             // G running max
  float* sL = sM + G;                    // G running sum
  float* sC = sL + G;                    // G rescale of the page

  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int attend =
      max(0, min(S, attend_rows ? attend_rows[b] : attend_all));
  const long long head = ((long long)b * Hkv + h) * G * D;

  for (int e = tid; e < G * D; e += kDecodeThreads) sQ[e] = q[head + e];
  for (int g = tid; g < G; g += kDecodeThreads) {
    sM[g] = -CUDART_INF_F;
    sL[g] = 0.0f;
  }
  float acc[SLOTS];
#pragma unroll
  for (int i = 0; i < SLOTS; ++i) acc[i] = 0.0f;

  for (int p0 = 0; p0 < attend; p0 += page) {
    const int n = min(page, attend - p0);
    __syncthreads();  // the previous page's reads are done
    for (int e = tid; e < n * D; e += kDecodeThreads) {
      const int j = e / D, d = e % D;
      const long long off = (((long long)b * S + p0 + j) * Hkv + h) * D + d;
      sK[j * DP + d] = k[off];
      sV[j * D + d] = v[off];
    }
    __syncthreads();

    for (int e = tid; e < G * n; e += kDecodeThreads) {
      const int g = e / n, j = e - g * n;
      float dot = 0.0f;
#pragma unroll 16
      for (int d = 0; d < D; ++d) dot = fmaf(sQ[g * D + d], sK[j * DP + d], dot);
      sS[g * page + j] = dot * scale;
    }
    __syncthreads();

    for (int g = warp; g < G; g += kDecodeThreads / 32) {
      float mx = -CUDART_INF_F;
      for (int j = lane; j < n; j += 32) mx = fmaxf(mx, sS[g * page + j]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_prev = sM[g];
      const float m_new = fmaxf(m_prev, mx);
      const float corr = m_prev == -CUDART_INF_F ? 0.0f : expf(m_prev - m_new);
      float sum = 0.0f;
      for (int j = lane; j < n; j += 32) {
        const float p = expf(sS[g * page + j] - m_new);
        sS[g * page + j] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        sL[g] = corr * sL[g] + sum;
        sM[g] = m_new;
        sC[g] = corr;
      }
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < SLOTS; ++i) {
      const int pair = tid + kDecodeThreads * i;
      if (pair < G * D) {
        const int g = pair / D, d = pair % D;
        float a = acc[i] * sC[g];
        for (int j = 0; j < n; ++j) a = fmaf(sS[g * page + j], sV[j * D + d], a);
        acc[i] = a;
      }
    }
  }

  __syncthreads();  // sL is final (no page ran: it is still 0)
#pragma unroll
  for (int i = 0; i < SLOTS; ++i) {
    const int pair = tid + kDecodeThreads * i;
    if (pair < G * D) o[head + pair] = acc[i] / fmaxf(sL[pair / D], 1e-20f);
  }
}

template <int D>
int launch(const float* q, const float* k, const float* v,
           const int* attend_rows, int attend_all, int B, int S, int Hkv,
           int G, int page, float scale, float* o, cudaStream_t stream) {
  const int bytes = smem_floats(D, G, page) * (int)sizeof(float);
  static int configured = 48 * 1024;  // the default dynamic limit
  if (bytes > configured) {
    const int most = smem_floats(D, kMaxGroup, kMaxPage) * (int)sizeof(float);
    const cudaError_t err = cudaFuncSetAttribute(
        decode_attention_kernel<D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, most);
    if (err != cudaSuccess) return (int)err;
    configured = most;
  }
  const dim3 grid(Hkv, B);
  decode_attention_kernel<D><<<grid, kDecodeThreads, bytes, stream>>>(
      q, k, v, attend_rows, attend_all, S, Hkv, G, page, scale, o);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int decode_attention_launch(const float* q, const float* k,
                                       const float* v, const int* attend_rows,
                                       int attend_all, int B, int S, int Hkv,
                                       int G, int D, int page, float scale,
                                       float* o, void* stream) {
  if (B < 0 || S < 0 || Hkv < 1 || Hkv > 65535 || B > 65535 || G < 1 ||
      G > kMaxGroup || page < 1 || page > kMaxPage)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return launch<64>(q, k, v, attend_rows, attend_all, B, S, Hkv, G, page,
                        scale, o, st);
    case 128:
      return launch<128>(q, k, v, attend_rows, attend_all, B, S, Hkv, G, page,
                         scale, o, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
