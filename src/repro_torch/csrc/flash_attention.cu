// Flash attention for Hopper (sm_90a), fp32 in and out: causal /
// sliding-window GQA prefill attention, both products on the tensor cores
// in 3xTF32.
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
// hq reads kv head hq / (Hq / Hkv).  q, k, v and o are 16-byte aligned.
//
// Bound: operations.  4 * D flops per live (query, key) pair (a
// multiply-add each for q.k and p.v); at the prefill shape of the LLM path
// (qwen2-0.5b, B = 8, T = S = 512, Hq = 14, Hkv = 2, D = 64, causal) that
// is 3.77 GFLOP: 0.0562 ms at 67 TFLOP/s of fp32 outside the tensor cores.
// This kernel issues three TF32 products for each fp32 one, 3 * 3.77 GFLOP
// at 495 TFLOP/s of TF32: 0.0228 ms, the least time for this design.  q,
// k, v and o are 33.5 MB, 0.0100 ms at 3.35 TB/s.
//
// Design.  A plain TF32 product keeps 10 mantissa bits, too few for the
// fp32 bar (2e-5) this kernel is held to, so each fp32 operand x is split
// into hi = tf32(x) and lo = tf32(x - hi) (cvt.rna: round to nearest, ties
// away from zero) and a product is hi*hi + hi*lo + lo*hi, the small terms
// first, accumulated in fp32 (lo*lo, below fp32's last bit, is dropped).
// - Tiles: one block of 4 warps per (64 query rows, q head, batch row);
//   each warp owns one 16-row group of the mma.sync.m16n8k8 tiles.
//   blockIdx.x runs over the q tiles last to first, so under causal
//   masking the longest tiles start first and the short ones fill the tail.
// - The TPU's sequential KV grid axis becomes the block's loop over KV
//   tiles, from the window's first live tile to the causal diagonal
//   (shifted by q_offset) or kv_valid_len.  K and V tiles go through a
//   two-stage ring in shared memory by 16-byte cp.async, so tile j + 1
//   loads while tile j computes; keys past S are zero-filled by the
//   copy's src-size operand.  Rows are padded to D + 4 floats, so every
//   fragment load of a warp falls in 32 distinct banks.
// - S = Q.K^T: K's row-major tile is the `col` B operand as it stands.
//   At D = 64 the Q fragments (hi and lo) are split once and held in
//   registers; at D = 128 they stay in shared memory and are split per
//   k-step, for register room.
// - Softmax in registers: an accumulator row lies on one quad of lanes, so
//   a row's max and sum take two shuffles.  The running max / sum /
//   correction arithmetic and expf are those of the plain version; the
//   mask is applied per element only on tiles that touch a mask edge.
// - P.V: P leaves the C fragment (row g: keys 2t, 2t + 1) and enters the
//   A fragment (row g: k-columns t, t + 4) in place, with no shuffle: the
//   k-order inside a k-step is a free choice of the sum, so k-column t is
//   key 2t and k-column t + 4 is key 2t + 1, and V's B fragment reads its
//   rows in the same order.
// - Epilogue: divide by max(l, 1e-20), stage the warp's 16 rows in its own
//   rows of the Q tile, write them with 16-byte stores.
// - Shared memory: D = 64, 64-key tiles: Q 17.4 KB + K/V ring 69.6 KB =
//   87 KB, two blocks per SM.  D = 128 takes 32-key tiles (Q 33.8 KB + ring
//   67.6 KB = 101 KB), so two blocks still fit an SM.
#include <climits>
#include <cstdint>

#include "kernels_common.cuh"

namespace {

constexpr int kBQ = 64;                 // query rows per block
constexpr int kWarps = kBQ / 16;        // one m16 row group per warp
constexpr int kFlashThreads = 32 * kWarps;

template <int D>
__host__ __device__ constexpr int kv_tile() { return D == 64 ? 64 : 32; }

template <int D>
__host__ __device__ constexpr int smem_floats() {
  return (kBQ + 4 * kv_tile<D>()) * (D + 4);
}

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo up to fp32 rounding: hi keeps the top 10 mantissa bits (its
// low 13 bits cleared, so x - hi is exact), lo the next 11.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = to_tf32(x) & 0xffffe000u;
  lo = to_tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a * b in 3xTF32: lo*hi and hi*lo first, then hi*hi
__device__ __forceinline__ void mma_3xtf32(float (&c)[4],
                                           const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4],
                                           uint32_t bh0, uint32_t bh1,
                                           uint32_t bl0, uint32_t bl1) {
  mma_tf32(c, al, bh0, bh1);
  mma_tf32(c, ah, bl0, bl1);
  mma_tf32(c, ah, bh0, bh1);
}

// The A fragment of Q for k-step ks: rows g and g + 8 of the warp's 16,
// columns 8 ks + t and 8 ks + t + 4.
__device__ __forceinline__ void q_fragment(const float* sQw, int ld, int ks,
                                           int g, int t, uint32_t (&h)[4],
                                           uint32_t (&l)[4]) {
  const float* p = sQw + g * ld + ks * 8 + t;
  split_tf32(p[0], h[0], l[0]);
  split_tf32(p[8 * ld], h[1], l[1]);
  split_tf32(p[4], h[2], l[2]);
  split_tf32(p[8 * ld + 4], h[3], l[3]);
}

template <int D>
__global__ void __launch_bounds__(kFlashThreads, 2)
flash_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v,
                       const int* __restrict__ kv_valid, int T, int S, int Hq,
                       int Hkv, int causal, int window, int q_offset,
                       float scale, float* __restrict__ o) {
  constexpr int BK = kv_tile<D>();
  constexpr int LD = D + 4;              // row stride of every tile, floats
  constexpr int CH = D / 4;              // 16-byte chunks per row
  constexpr int NS = BK / 8;             // score n-tiles = P.V k-steps
  constexpr int NO = D / 8;              // output n-tiles = Q.K^T k-steps
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;                      // kBQ x LD
  float* sKV = sQ + kBQ * LD;            // 2 stages x (K, V) x BK x LD

  // blockIdx.x = (q tiles from the last) x (batch row, q head)
  const int n_qt = (T + kBQ - 1) / kBQ;
  const int HB = gridDim.x / n_qt;
  const int hb = blockIdx.x % HB;
  const int b = hb / Hq, hq = hb % Hq;
  const int q0 = (n_qt - 1 - (int)(blockIdx.x / HB)) * kBQ;
  const int hk = hq / (Hq / Hkv);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int n_q = min(kBQ, T - q0);

  // the keys any row of this tile can see: [k_begin, k_end)
  const int valid = kv_valid ? max(0, min(S, kv_valid[b])) : S;
  const int qp_lo = q_offset + q0, qp_hi = q_offset + q0 + n_q - 1;
  const int k_end = causal ? min(valid, max(0, qp_hi + 1)) : valid;
  const int k_begin = window > 0 ? max(0, qp_lo - window + 1) : 0;
  const int kb0 = (k_begin / BK) * BK;
  const int n_tiles = k_end > kb0 ? (k_end - kb0 + BK - 1) / BK : 0;

  const float* qsrc = q + (((long long)b * T + q0) * Hq + hq) * D;
  for (int e = tid; e < kBQ * CH; e += kFlashThreads) {
    const int i = e / CH, c = e % CH;
    const bool live = i < n_q;
    cp_async16(sQ + i * LD + c * 4,
               qsrc + (live ? (long long)i * Hq * D : 0) + c * 4,
               live ? 16 : 0);
  }
  const long long kv_step = (long long)Hkv * D;   // floats between keys
  const float* ksrc = k + ((long long)b * S * Hkv + hk) * D;
  const float* vsrc = v + ((long long)b * S * Hkv + hk) * D;
  auto load_tile = [&](int kb, int stage) {
    float* sK = sKV + stage * 2 * BK * LD;
    float* sV = sK + BK * LD;
    for (int e = tid; e < BK * CH; e += kFlashThreads) {
      const int j = e / CH, c = e % CH;
      const bool in = kb + j < S;
      const long long off = (in ? (kb + j) * kv_step : 0) + c * 4;
      cp_async16(sK + j * LD + c * 4, ksrc + off, in ? 16 : 0);
      cp_async16(sV + j * LD + c * 4, vsrc + off, in ? 16 : 0);
    }
  };
  if (n_tiles > 0) load_tile(kb0, 0);
  cp_async_commit();                     // group 0: Q and the first tile

  const float* sQw = sQ + warp * 16 * LD;
  const int qpos0 = q_offset + q0 + warp * 16 + g;   // row of c[0], c[1]
  const int qpos1 = qpos0 + 8;                       // row of c[2], c[3]
  // at D = 64 the Q fragments live in registers (32 hi + 32 lo)
  constexpr int NQR = D == 64 ? NO : 1;
  uint32_t qh[NQR][4], ql[NQR][4];
  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F}, l[2] = {0.0f, 0.0f};

  for (int it = 0; it < n_tiles; ++it) {
    const int kb = kb0 + it * BK;
    const int stage = it & 1;
    if (it + 1 < n_tiles) load_tile(kb + BK, stage ^ 1);
    cp_async_commit();
    cp_async_wait<1>();                  // tile it (and Q) has landed
    __syncthreads();
    if constexpr (D == 64) {
      if (it == 0) {
#pragma unroll
        for (int ks = 0; ks < NO; ++ks)
          q_fragment(sQw, LD, ks, g, t, qh[ks], ql[ks]);
      }
    }
    const float* sK = sKV + stage * 2 * BK * LD;
    const float* sV = sK + BK * LD;

    // scores of the warp's 16 rows against the tile's BK keys
    float s[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.0f;
#pragma unroll
    for (int ks = 0; ks < NO; ++ks) {
      uint32_t ah[4], al[4];
      if constexpr (D == 64) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          ah[r] = qh[ks][r];
          al[r] = ql[ks][r];
        }
      } else {
        q_fragment(sQw, LD, ks, g, t, ah, al);
      }
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        const float* kr = sK + (n * 8 + g) * LD + ks * 8 + t;
        uint32_t bh0, bl0, bh1, bl1;
        split_tf32(kr[0], bh0, bl0);
        split_tf32(kr[4], bh1, bl1);
        mma_3xtf32(s[n], ah, al, bh0, bh1, bl0, bl1);
      }
    }

    // scale, mask (only on a tile that touches a mask edge), online softmax
    const bool edge = kb + BK > valid || (causal && kb + BK - 1 > qp_lo) ||
                      (window > 0 && kb <= qp_hi - window);
    float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
    for (int n = 0; n < NS; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e] * scale;
        if (edge) {
          const int kp = kb + n * 8 + 2 * t + (e & 1);
          const int qp = e < 2 ? qpos0 : qpos1;
          const bool live = kp < valid && (!causal || kp <= qp) &&
                            (window <= 0 || kp > qp - window);
          x = live ? x : -CUDART_INF_F;
        }
        s[n][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float corr[2], m_safe[2], psum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      m_safe[r] = m_new == -CUDART_INF_F ? 0.0f : m_new;
      corr[r] = m[r] == -CUDART_INF_F ? 0.0f : expf(m[r] - m_safe[r]);
      m[r] = m_new;
    }
#pragma unroll
    for (int n = 0; n < NS; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = s[n][e];
        const float p = x == -CUDART_INF_F ? 0.0f : expf(x - m_safe[e >> 1]);
        s[n][e] = p;
        psum[e >> 1] += p;
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      psum[r] += __shfl_xor_sync(0xffffffffu, psum[r], 1);
      psum[r] += __shfl_xor_sync(0xffffffffu, psum[r], 2);
      l[r] = corr[r] * l[r] + psum[r];
    }
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      acc[n][0] *= corr[0];
      acc[n][1] *= corr[0];
      acc[n][2] *= corr[1];
      acc[n][3] *= corr[1];
    }

    // acc += P.V; k-column t of k-step ks is key 8 ks + 2t, t + 4 is 2t + 1
#pragma unroll
    for (int ks = 0; ks < NS; ++ks) {
      uint32_t ah[4], al[4];
      split_tf32(s[ks][0], ah[0], al[0]);
      split_tf32(s[ks][2], ah[1], al[1]);
      split_tf32(s[ks][1], ah[2], al[2]);
      split_tf32(s[ks][3], ah[3], al[3]);
      const float* v0 = sV + (ks * 8 + 2 * t) * LD + g;
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        uint32_t bh0, bl0, bh1, bl1;
        split_tf32(v0[n * 8], bh0, bl0);
        split_tf32(v0[LD + n * 8], bh1, bl1);
        mma_3xtf32(acc[n], ah, al, bh0, bh1, bl0, bl1);
      }
    }
    __syncthreads();  // this stage is refilled by the next iteration's load
  }
  cp_async_wait<0>();  // with no tile, Q's copies may still be in flight
  __syncthreads();

  // each warp stages its 16 rows in its own rows of the Q tile
  const float d0 = fmaxf(l[0], 1e-20f), d1 = fmaxf(l[1], 1e-20f);
  float* sO = sQ + warp * 16 * LD;
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    *reinterpret_cast<float2*>(sO + g * LD + n * 8 + 2 * t) =
        make_float2(acc[n][0] / d0, acc[n][1] / d0);
    *reinterpret_cast<float2*>(sO + (g + 8) * LD + n * 8 + 2 * t) =
        make_float2(acc[n][2] / d1, acc[n][3] / d1);
  }
  __syncwarp();
  for (int e = lane; e < 16 * CH; e += 32) {
    const int i = e / CH, c = e % CH;
    const int row = warp * 16 + i;
    if (row < n_q)
      *reinterpret_cast<float4*>(o + (((long long)b * T + q0 + row) * Hq + hq) * D +
                                 c * 4) =
          *reinterpret_cast<const float4*>(sO + i * LD + c * 4);
  }
}

template <int D>
int launch(const float* q, const float* k, const float* v, const int* kv_valid,
           int B, int T, int S, int Hq, int Hkv, int causal, int window,
           int q_offset, float scale, float* o, cudaStream_t stream) {
  constexpr int bytes = smem_floats<D>() * (int)sizeof(float);
  static bool configured = false;   // the attributes are set once per D
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_attention_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        bytes);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(flash_attention_kernel<D>,
                                 cudaFuncAttributePreferredSharedMemoryCarveout,
                                 (int)cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  const long long blocks = (long long)((T + kBQ - 1) / kBQ) * Hq * B;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  flash_attention_kernel<D><<<(unsigned)blocks, kFlashThreads, bytes, stream>>>(
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
  if (B < 0 || T < 0 || S < 0 || Hkv < 1 || Hq < Hkv || Hq % Hkv)
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
