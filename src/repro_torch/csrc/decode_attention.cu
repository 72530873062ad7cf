// Paged decode attention for Hopper (sm_90a), fp32 or bf16: split-K
// flash-decoding of one query token per row against a KV cache.
//
// Replaces the Pallas TPU kernel repro/kernels/decode_attention/kernel.py
// `paged_decode_attention_tpu` (body `_paged_decode_kernel`): for every
// batch row b and kv head h, the G = Hq / Hkv query heads of h attend the
// first attend_len[b] slots of the cache with an online softmax; slots at
// or past attend_len[b] are neither read nor computed.  Any cache width S
// works.  attend_len comes from a device array (B,) or, for a batch whose
// rows share one depth, from a scalar argument.  A row with attend_len = 0
// writes 0, as the TPU kernel's `_finish` does (acc = 0 over
// max(l, 1e-20)); the plain version (kernels/decode_attention/ref.py)
// keeps that convention.  Layout: q (B, Hkv, G, D) (the (B, 1, Hq, D)
// query with hq = h * G + g), k/v (B, S, Hkv, D), o (B, Hkv, G, D); every
// pointer 16-byte aligned.
//
// Bound: bytes.  Every live K and V slot is read once,
// B * attend * Hkv * D * 4 * 2 bytes, against 4 * D flops per (query head,
// slot); at the decode shape of the LLM path (qwen2-0.5b, B = 8, Hkv = 2,
// D = 64, attend about 530 of S = 1024) that is 4.3 MB, about 1.3 us at
// 3.35 TB/s.  Launch latency, not bytes, is the floor at that size.
//
// Design.  The TPU kernel walks a row's pages in order on one core; one
// block per (b, kv head) does the same on Hopper with only B * Hkv = 16
// blocks on 132 SMs.  Here the slots of a row are cut into splits of
// `split` slots (a multiple of the 32-slot tile, chosen by the wrapper so
// that B * Hkv * splits fills the card about four blocks per SM), and the
// grid is (splits, Hkv, B):
//   - decode_split_kernel: one block of 4 warps per (split, kv head, row).
//     A split that starts at or past its row's attend_len returns before
//     it reads anything, so with a per-row device attend_len the grid is
//     sized from S and the host never reads the depths.  A live block
//     copies q and its slots of K and V into shared memory by 16-byte
//     cp.async, 32 slots a tile, two tiles in flight; slots past
//     attend_len are not copied.  The G x 32 scores: 8 lanes share a slot,
//     each takes D / 8 columns as float4s, and three xor shuffles sum
//     them.  One warp per head takes the tile's max and sum (a lane per
//     slot) and rescales its running (m, l); each thread owns float4
//     columns of the G x D accumulator.  The block writes its partial
//     (m, l, acc) to a scratch tensor that the wrapper allocates.
//   - decode_combine_kernel: one warp per (row, kv head, query head); lane
//     i weighs live split i by exp(m_i - m), and the warp sums the splits'
//     acc and l and divides by max(sum l_i e^(m_i - m), 1e-20).  Only
//     splits below attend_len are read, so no exp(-inf - (-inf)) arises,
//     and a row with attend_len = 0 has no live split and writes 0.  The
//     combine is a second kernel, launched by the same C entry point,
//     rather than the last block of each (b, h) found through an atomic
//     counter: the counter would be state kept zeroed between calls (a
//     memset launch, or a buffer shared by every stream), and the second
//     kernel sums the splits in a fixed order.  It is launched as a
//     programmatic dependent launch (Hopper): the split kernel's blocks let
//     it be scheduled at once, and it waits (griddepcontrol.wait) for their
//     results, so its launch overlaps the split kernel.
// `page` is the TPU kernel's page: it is range-checked (1..128) and no
// longer shapes the work, which the split and the tile do.
// bf16 (q, the cache and o bf16; the TPU kernel widens them to fp32 and
// returns q's dtype): the same kernels with bf16 tiles.  q and each tile
// of K and V land in shared memory as bf16 by the same 16-byte cp.async,
// half the bytes of fp32, and each group of four elements is widened to a
// float4 as it is read; the fp32 arithmetic, the fp32 partials and the
// combine are unchanged, and the combine rounds each output to bf16
// (__float2bfloat16_rn).  The output is bitwise the fp32 kernel's on the
// widened inputs, rounded to bf16.  Bound at moonshot-v1-16b-a3b's decode
// (B = 8, Hkv = Hq = 16, D = 128, attend up to 288): B * attend * Hkv * D
// * 2 * 2 bytes, 18.9 MB at attend 288, about 5.6 us at 3.35 TB/s.
#include "kernels_common.cuh"

namespace {

constexpr int kThreads4 = 128;          // 4 warps
constexpr int kWarps = kThreads4 / 32;
constexpr int kTile = 32;               // slots per tile: a lane per slot
constexpr int kMaxGroup = 16;           // G = Hq / Hkv
constexpr int kMaxPage = 128;
constexpr int kHeadsPerWarp = kMaxGroup / kWarps;

template <typename Elt, int D>
struct SplitSmem {
  Elt q[kMaxGroup * D];
  Elt k[2][kTile * D];
  Elt v[2][kTile * D];
  float p[kMaxGroup * kTile];           // scores, then probabilities
  float corr[kMaxGroup];                // each head's rescale of the tile
};

// elements of Elt in a 16-byte copy
template <typename Elt>
__host__ __device__ constexpr int per16() { return 16 / (int)sizeof(Elt); }

// four neighbouring elements as fp32, and four outputs rounded to Elt
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ void store4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 x) {
  __nv_bfloat162 a = __floats2bfloat162_rn(x.x, x.y);
  __nv_bfloat162 b = __floats2bfloat162_rn(x.z, x.w);
  uint2 u;
  u.x = *reinterpret_cast<const unsigned*>(&a);
  u.y = *reinterpret_cast<const unsigned*>(&b);
  *reinterpret_cast<uint2*>(p) = u;
}

__device__ __forceinline__ int row_attend(const int* rows, int all, int b,
                                          int S) {
  return max(0, min(S, rows ? rows[b] : all));
}

template <typename Elt, int D>
__global__ void __launch_bounds__(kThreads4)
decode_split_kernel(const Elt* __restrict__ q, const Elt* __restrict__ k,
                    const Elt* __restrict__ v,
                    const int* __restrict__ attend_rows, int attend_all,
                    int S, int Hkv, int G, int split, float scale,
                    float* __restrict__ part_acc,
                    float* __restrict__ part_ml) {
  constexpr int D4 = D / 4;             // groups of 4 per row
  constexpr int KV4 = D / 32;           // groups of 4 of a row per lane (8 lanes)
  constexpr int PAIRS = kMaxGroup * D4 / kThreads4;
  constexpr int EL = per16<Elt>();      // elements per 16-byte copy
  constexpr int DC = D / EL;            // 16-byte copies per row
  // the combine may be scheduled now; it waits for this grid's results
  asm volatile("griddepcontrol.launch_dependents;");
  const int h = blockIdx.y, b = blockIdx.z;
  const int s0 = blockIdx.x * split;
  const int attend = row_attend(attend_rows, attend_all, b, S);
  if (s0 >= attend) return;             // a dead split: nothing read
  const int s1 = min(attend, s0 + split);

  extern __shared__ __align__(16) float smem_raw[];
  SplitSmem<Elt, D>& sm = *reinterpret_cast<SplitSmem<Elt, D>*>(smem_raw);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long bh = (long long)b * Hkv + h;
  const long long slot_stride = (long long)Hkv * D;
  const Elt* kb = k + ((long long)b * S * Hkv + h) * D;
  const Elt* vb = v + ((long long)b * S * Hkv + h) * D;

  for (int i = tid; i < G * DC; i += kThreads4)
    cp_async16(&sm.q[EL * i], q + bh * G * D + EL * i, 16);
  auto issue = [&](int t0, int stage) {   // live slots of [t0, t0 + kTile)
    const int n = min(kTile, s1 - t0);
    for (int i = tid; i < n * DC; i += kThreads4) {
      const long long off = (long long)(t0 + i / DC) * slot_stride
                            + EL * (i % DC);
      cp_async16(&sm.k[stage][EL * i], kb + off, 16);
      cp_async16(&sm.v[stage][EL * i], vb + off, 16);
    }
  };

  float m_run[kHeadsPerWarp], l_run[kHeadsPerWarp];
#pragma unroll
  for (int r = 0; r < kHeadsPerWarp; ++r) {
    m_run[r] = -CUDART_INF_F;
    l_run[r] = 0.0f;
  }
  float4 acc[PAIRS];
#pragma unroll
  for (int i = 0; i < PAIRS; ++i) acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);

  int stage = 0;
  issue(s0, 0);
  cp_async_commit();
  for (int t0 = s0; t0 < s1; t0 += kTile) {
    const int n = min(kTile, s1 - t0);
    if (t0 + kTile < s1) issue(t0 + kTile, stage ^ 1);
    cp_async_commit();
    cp_async_wait<1>();                 // q and this tile have landed
    __syncthreads();
    const Elt* K = sm.k[stage];
    const Elt* V = sm.v[stage];

    // scores: warp w takes slots w * kTile / 4 ... in passes of four; lane
    // (j, t) = (lane >> 3, lane & 7) holds columns 4 (t + 8u) of slot j
#pragma unroll
    for (int pass = 0; pass < kTile / (4 * kWarps); ++pass) {
      const int first = kTile / kWarps * warp + 4 * pass;
      if (first >= n) break;            // warp-uniform
      const int j = first + (lane >> 3), t = lane & 7;
      float4 kr[KV4];
#pragma unroll
      for (int u = 0; u < KV4; ++u)
        kr[u] = load4(&K[j * D + 4 * (t + 8 * u)]);
      for (int g = 0; g < G; ++g) {
        float dot = 0.0f;
#pragma unroll
        for (int u = 0; u < KV4; ++u) {
          const float4 qv = load4(&sm.q[g * D + 4 * (t + 8 * u)]);
          dot = fmaf(qv.x, kr[u].x, dot);
          dot = fmaf(qv.y, kr[u].y, dot);
          dot = fmaf(qv.z, kr[u].z, dot);
          dot = fmaf(qv.w, kr[u].w, dot);
        }
        dot += __shfl_xor_sync(0xffffffffu, dot, 1);
        dot += __shfl_xor_sync(0xffffffffu, dot, 2);
        dot += __shfl_xor_sync(0xffffffffu, dot, 4);
        if (t == 0) sm.p[g * kTile + j] = dot * scale;
      }
    }
    __syncthreads();

    // the tile's softmax: warp w owns heads w, w + 4, ...; lane = slot
#pragma unroll
    for (int r = 0; r < kHeadsPerWarp; ++r) {
      const int g = warp + kWarps * r;
      if (g < G) {
        const bool live = lane < n;     // n <= kTile
        const float s = live ? sm.p[g * kTile + lane] : -CUDART_INF_F;
        float mx = s;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        const float m_new = fmaxf(m_run[r], mx);   // finite: slot 0 is live
        const float corr = expf(m_run[r] - m_new); // 0 on the first tile
        const float p = live ? expf(s - m_new) : 0.0f;
        float sum = p;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          sum += __shfl_xor_sync(0xffffffffu, sum, off);
        l_run[r] = corr * l_run[r] + sum;
        m_run[r] = m_new;
        if (lane < kTile) sm.p[g * kTile + lane] = p;
        if (lane == 0) sm.corr[g] = corr;
      }
    }
    __syncthreads();

    // P.V: thread owns the (head, float4 column) pairs tid + 128 i
#pragma unroll
    for (int i = 0; i < PAIRS; ++i) {
      const int e = tid + kThreads4 * i;
      if (e < G * D4) {
        const int g = e / D4, c = e % D4;
        const float cr = sm.corr[g];
        float4 a = acc[i];
        a.x *= cr; a.y *= cr; a.z *= cr; a.w *= cr;
        const float* pg = &sm.p[g * kTile];
#pragma unroll 8
        for (int j = 0; j < n; ++j) {
          const float pj = pg[j];
          const float4 vv = load4(&V[j * D + 4 * c]);
          a.x = fmaf(pj, vv.x, a.x);
          a.y = fmaf(pj, vv.y, a.y);
          a.z = fmaf(pj, vv.z, a.z);
          a.w = fmaf(pj, vv.w, a.w);
        }
        acc[i] = a;
      }
    }
    __syncthreads();                    // the stage and p are refilled
    stage ^= 1;
  }

  // this split's partial: acc (G, D), then m (G) and l (G)
  const long long part = bh * gridDim.x + blockIdx.x;
  float4* pa = reinterpret_cast<float4*>(part_acc + part * G * D);
#pragma unroll
  for (int i = 0; i < PAIRS; ++i) {
    const int e = tid + kThreads4 * i;
    if (e < G * D4) pa[e] = acc[i];
  }
  float* pm = part_ml + part * 2 * G;
#pragma unroll
  for (int r = 0; r < kHeadsPerWarp; ++r) {
    const int g = warp + kWarps * r;
    if (g < G && lane == 0) {
      pm[g] = m_run[r];
      pm[G + g] = l_run[r];
    }
  }
}

// one warp per (row, kv head, query head): lane i holds split i's weight
// (32 splits at a time); lane (sub, c) = (lane / D4, lane % D4) sums the
// float4 column c of the splits sub, sub + 32 / D4, ...
template <typename Elt, int D>
__global__ void __launch_bounds__(kThreads4)
decode_combine_kernel(const float* __restrict__ part_acc,
                      const float* __restrict__ part_ml,
                      const int* __restrict__ attend_rows, int attend_all,
                      int B, int S, int Hkv, int G, int split, int n_splits,
                      Elt* __restrict__ o, float* __restrict__ lse) {
  constexpr int D4 = D / 4, SUBS = 32 / D4;
  // launched early (programmatic dependent launch): wait for the split
  // kernel to finish and its partials to be visible
  asm volatile("griddepcontrol.wait;" ::: "memory");
  const int lane = threadIdx.x & 31, sub = lane / D4, c = lane % D4;
  const long long w = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (w >= (long long)B * Hkv * G) return;       // a whole warp
  const long long bh = w / G;
  const int g = (int)(w - bh * G), b = (int)(bh / Hkv);
  const int attend = row_attend(attend_rows, attend_all, b, S);
  const int live = (attend + split - 1) / split;   // splits with a partial
  const float* pm = part_ml + bh * n_splits * 2 * G + g;   // m; l at + G
  const float4* pa = reinterpret_cast<const float4*>(
      part_acc + (bh * n_splits * G + g) * D);
  float m = -CUDART_INF_F;
  for (int i = lane; i < live; i += 32) m = fmaxf(m, pm[(long long)i * 2 * G]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  float den = 0.0f;
  float4 num = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int i0 = 0; i0 < live; i0 += 32) {
    const int i = i0 + lane, n = min(32, live - i0);
    float wi = 0.0f;
    if (i < live) {
      wi = expf(pm[(long long)i * 2 * G] - m);
      den = fmaf(wi, pm[(long long)i * 2 * G + G], den);
    }
#pragma unroll 4
    for (int j = 0; j < n; j += SUBS) {
      const float wj = __shfl_sync(0xffffffffu, wi, (j + sub) & 31);
      if (j + sub < n) {
        const float4 a = pa[(long long)(i0 + j + sub) * G * D4 + c];
        num.x = fmaf(wj, a.x, num.x);
        num.y = fmaf(wj, a.y, num.y);
        num.z = fmaf(wj, a.z, num.z);
        num.w = fmaf(wj, a.w, num.w);
      }
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    den += __shfl_xor_sync(0xffffffffu, den, off);
#pragma unroll
  for (int off = D4; off < 32; off <<= 1) {
    num.x += __shfl_xor_sync(0xffffffffu, num.x, off);
    num.y += __shfl_xor_sync(0xffffffffu, num.y, off);
    num.z += __shfl_xor_sync(0xffffffffu, num.z, off);
    num.w += __shfl_xor_sync(0xffffffffu, num.w, off);
  }
  if (sub == 0) {
    const float l = fmaxf(den, 1e-20f);
    store4(o + (bh * G + g) * D + 4 * c,
           make_float4(num.x / l, num.y / l, num.z / l, num.w / l));
  }
  // the head's log-sum-exp over its live slots, -inf with none
  if (lse != nullptr && lane == 0)
    lse[bh * G + g] = live > 0 ? m + logf(den) : -CUDART_INF_F;
}

template <typename Elt, int D>
int launch(const Elt* q, const Elt* k, const Elt* v,
           const int* attend_rows, int attend_all, int B, int S, int Hkv,
           int G, int split, int n_splits, float scale, float* part,
           Elt* o, float* lse, cudaStream_t stream) {
  float* part_ml = part + (long long)B * Hkv * n_splits * G * D;
  if (n_splits > 0) {
    constexpr int bytes = (int)sizeof(SplitSmem<Elt, D>);
    static bool configured = false;
    if (!configured && bytes > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          decode_split_kernel<Elt, D>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
      if (err != cudaSuccess) return (int)err;
    }
    configured = true;
    decode_split_kernel<Elt, D><<<dim3(n_splits, Hkv, B), kThreads4, bytes,
                                  stream>>>(q, k, v, attend_rows, attend_all,
                                            S, Hkv, G, split, scale, part,
                                            part_ml);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const long long warps = (long long)B * Hkv * G;
  cudaLaunchAttribute early;
  early.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  early.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((warps + kWarps - 1) / kWarps));
  cfg.blockDim = dim3(kThreads4);
  cfg.stream = stream;
  cfg.attrs = &early;
  cfg.numAttrs = n_splits > 0 ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, decode_combine_kernel<Elt, D>, (const float*)part,
      (const float*)part_ml, attend_rows, attend_all, B, S, Hkv, G, split,
      n_splits, o, lse);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename Elt>
int dispatch(const Elt* q, const Elt* k, const Elt* v, const int* attend_rows,
             int attend_all, int B, int S, int Hkv, int G, int D, int page,
             int split, int n_splits, float scale, float* part, Elt* o,
             float* lse, void* stream) {
  if (B < 0 || S < 0 || Hkv < 1 || Hkv > 65535 || B > 65535 || G < 1 ||
      G > kMaxGroup || page < 1 || page > kMaxPage || split < kTile ||
      split % kTile || n_splits < 0 ||
      (long long)n_splits * split < (attend_rows ? S : min(attend_all, S)))
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return launch<Elt, 64>(q, k, v, attend_rows, attend_all, B, S, Hkv, G,
                             split, n_splits, scale, part, o, lse, st);
    case 128:
      return launch<Elt, 128>(q, k, v, attend_rows, attend_all, B, S, Hkv, G,
                              split, n_splits, scale, part, o, lse, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// part: B * Hkv * n_splits * G * (D + 2) floats of scratch, 16-byte
// aligned: every split's acc, then every split's (m, l).  lse: null, or
// B * Hq floats that take each (row, query head)'s log-sum-exp of its
// scaled scores over the live slots (-inf where attend_len is 0), so that
// blocks of one cache run apart can be combined.
extern "C" int decode_attention_launch(const float* q, const float* k,
                                       const float* v, const int* attend_rows,
                                       int attend_all, int B, int S, int Hkv,
                                       int G, int D, int page, int split,
                                       int n_splits, float scale, float* part,
                                       float* o, float* lse, void* stream) {
  return dispatch(q, k, v, attend_rows, attend_all, B, S, Hkv, G, D, page,
                  split, n_splits, scale, part, o, lse, stream);
}

extern "C" int decode_attention_bf16_launch(
    const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
    const int* attend_rows, int attend_all, int B, int S, int Hkv, int G,
    int D, int page, int split, int n_splits, float scale, float* part,
    __nv_bfloat16* o, float* lse, void* stream) {
  return dispatch(q, k, v, attend_rows, attend_all, B, S, Hkv, G, D, page,
                  split, n_splits, scale, part, o, lse, stream);
}
