// Flash attention for Hopper (sm_90a) in bf16: causal / sliding-window GQA
// prefill attention, both products on the bf16 tensor cores by wgmma.
//
// Replaces the Pallas TPU kernel repro/kernels/attention/kernel.py
// `flash_attention_tpu` (body `_attn_kernel`) for bf16 operands, with the
// contract of the fp32 kernel (flash_attention.cu), which takes the jnp
// `flash_attention` of repro/nn/attention.py: `causal`, `window` (keys
// more than `window - 1` behind a query are masked), `q_offset` (absolute
// position of query 0 relative to key 0), a per-row `kv_valid_len`; every
// key at or past S is masked; a query row with no live key writes 0.
// Layout: q (B, T, Hq, D), k/v (B, S, Hkv, D), o (B, T, Hq, D), all bf16
// and 16-byte aligned, D in {64, 128}; query head hq reads kv head
// hq / (Hq / Hkv).  With an `lse` pointer each row's natural-log m + log(l)
// of its scaled live scores goes to lse (B, Hq, T), fp32, -inf for a row
// with no live key; the output does not depend on it.
//
// Precision.  The TPU kernel widens bf16 to fp32.  A product of two bf16
// values is exact in fp32, so S = Q.K^T on the bf16 tensor cores, summed
// in fp32, is its arithmetic up to the order of the sums.  P is rounded to
// bf16 before P.V (as SDPA and FlashAttention-2/3 do), and the row sum l
// is taken over the unrounded fp32 P.  The fp32 kernel on the widened
// inputs is therefore not matched bit for bit; the kernel is held to the
// JAX package's bf16 bar (3e-2 of the plain version) and, against float64,
// to at most twice SDPA's bf16 error (chip_smoke.py phase 16a).
//
// Bound at moonshot-v1-16b-a3b's prefill, q = k/v (8, 256, 16, 128),
// causal: 4 * D flops a live (query, key) pair, 2.16 GFLOP, 0.0022 ms at
// 989 TFLOP/s of bf16; q, k, v and o are 33.6 MB, 0.0100 ms at 3.35 TB/s:
// bytes bound it.  At a 4,096-token prompt, q = k/v (1, 4096, 16, 128),
// causal: 68.7 GFLOP, 0.0695 ms, against 67.1 MB, 0.0200 ms: operations.
//
// Design.
// - Blocks: one warpgroup (4 warps, 128 threads) per (64 query rows, q
//   head, batch row); blockIdx.x runs over the q tiles last to first, so
//   under causal masking the longest tiles start first.
// - Shared memory holds 64-row tiles in wgmma's canonical 128-byte-swizzled
//   layout (its helpers, the wgmma forms and the tile copy are in
//   wgmma_common.cuh, shared with the bf16 backward): a row of D bf16 is
//   D / 64 panels of 128 bytes, a panel of 64
//   rows is 8 KB, and the 16-byte chunk c of row r sits at chunk c ^ (r % 8).
//   Q is loaded once.  K and V have rings of their own, two 64-key stages
//   each: tile j's K is loaded as soon as S_{j-2} has freed its stage, its
//   V as soon as P.V_{j-2} has, so two tiles are in flight ahead of the
//   products.  The copies are 16-byte cp.async; a thread's 8 (D = 128) or
//   4 (D = 64) copies of a tile are rows 8 or 16 apart, so they share one
//   swizzle and cost an add each.  Keys past S and query rows past T are
//   zero-filled by the copy's src-size.  The copies are generic-proxy
//   writes that wgmma reads through the async proxy: each thread fences
//   (fence.proxy.async) before the block barrier.
// - S = Q.K^T: D / 16 wgmma m64n64k16, A = Q and B = K both K-major from
//   shared memory (a k-step advances the descriptors by 32 bytes inside
//   the swizzle atom, then by a panel), fp32 accumulators in registers.
// - Softmax in registers, in the log2 domain: the running max is kept
//   scaled by scale * log2(e), and P = 2^(s * scale * log2(e) - m) is one
//   FFMA and one ex2.approx a score; the masks are the fp32 kernel's,
//   applied only on a tile that touches a mask edge (a masked score is
//   -inf, and 2^(-inf) = 0); a row lies on one quad of lanes, so its max
//   and sum take two shuffles each.
// - P.V: P is rounded to bf16 and handed to wgmma as its register A
//   operand (the accumulator's row g keys 2t, 2t + 1 are A's columns 2t,
//   2t + 1: no shuffle), O += P.V by 4 wgmma m64n{D}k16 a tile, B = V from
//   shared memory with the transpose bit (V is MN-major for this product:
//   panels 8 KB apart, 8-key groups 1 KB apart).
// - Epilogue: divide by max(l, 1e-20), round to bf16, stage in the Q tile
//   (the same swizzle, so the 4-byte stores of a warp hit 32 banks), write
//   with 16-byte stores.
// - Registers (-Xptxas -v, sm_90a): 178 at D = 128, 133 at
//   D = 64, no spill.  Shared memory: Q + 2 K + 2 V stages = 5 tiles, 80 KB
//   at D = 128 and 40 KB at D = 64, plus 1 KB to align them to the
//   1,024-byte swizzle atom: two blocks an SM at D = 128.
#include <climits>
#include <cstdint>

#include "wgmma_common.cuh"

namespace {

constexpr int kBQ = 64;          // query rows per block: wgmma's M
constexpr int kBK = 64;          // keys per tile
constexpr int kThreads = 128;    // one warpgroup
constexpr int kStages = 2;       // stages of the K ring and of the V ring

__device__ __forceinline__ float ex2(float x) {   // 2^x, -inf -> 0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// kStages stages each of the K and of the V ring: tile j's K is loaded
// once S_{j-kStages} is done with its stage, its V once P.V_{j-kStages} is
template <int D>
__global__ void __launch_bounds__(kThreads, 2)
flash_attention_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                            const __nv_bfloat16* __restrict__ k,
                            const __nv_bfloat16* __restrict__ v,
                            const int* __restrict__ kv_valid, int T, int S,
                            int Hq, int Hkv, int causal, int window,
                            int q_offset, float scale,
                            __nv_bfloat16* __restrict__ o,
                            float* __restrict__ lse) {
  constexpr int TB = tile_bytes<D>();
  constexpr int NO = D / 2;     // output accumulators a thread
  constexpr int CH = D / 8;     // 16-byte chunks a row
  constexpr int WAIT = 2 * kStages - 2;   // copy groups that may stay in flight
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sQ = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* sK = sQ + TB;          // stage s at s * TB
  unsigned char* sV = sK + kStages * TB;
  const uint32_t aQ = static_cast<uint32_t>(__cvta_generic_to_shared(sQ));
  const uint32_t aK = aQ + TB, aV = aK + kStages * TB;

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
  const int kb0 = (k_begin / kBK) * kBK;
  const int n_tiles = k_end > kb0 ? (k_end - kb0 + kBK - 1) / kBK : 0;

  const long long kv_step = (long long)Hkv * D;   // elements between keys
  const TileCopy<D> qcopy(tid, (long long)Hq * D), kvcopy(tid, kv_step);
  const __nv_bfloat16* ksrc = k + ((long long)b * S * Hkv + hk) * D;
  const __nv_bfloat16* vsrc = v + ((long long)b * S * Hkv + hk) * D;
  // tile j's K (or V) into its stage, or nothing past the last tile; one
  // copy group either way, so the groups alternate K_j, V_j
  auto load = [&](unsigned char* ring, const __nv_bfloat16* src, int j) {
    if (j < n_tiles) {
      const int kb = kb0 + j * kBK;
      kvcopy.load(ring + (j % kStages) * TB, src + kb * kv_step, kv_step, S - kb);
    }
    cp_async_commit();
  };
  qcopy.load(sQ, q + (((long long)b * T + q0) * Hq + hq) * D, (long long)Hq * D, n_q);
  load(sK, ksrc, 0);                      // group 0: Q and K_0
#pragma unroll
  for (int j = 0; j < kStages - 1; ++j) {      // V_j, K_{j+1}
    load(sV, vsrc, j);
    load(sK, ksrc, j + 1);
  }

  const float sl2 = scale * 1.4426950408889634f;   // scale * log2(e)
  const int qpos0 = q_offset + q0 + warp * 16 + g;  // row of s[4j], s[4j + 1]
  const int qpos1 = qpos0 + 8;                      // row of s[4j + 2], s[4j + 3]
  float acc[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) acc[i] = 0.0f;
  // running max (of the scaled scores, log2 units) and sum of each row
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F}, l[2] = {0.0f, 0.0f};

  for (int it = 0; it < n_tiles; ++it) {
    const int kb = kb0 + it * kBK;
    cp_async_wait<WAIT>();               // K_it (and Q) has landed
    fence_proxy_async();
    __syncthreads();                     // and P.V_{it-1} is done everywhere
    load(sV, vsrc, it + kStages - 1);

    // S = Q.K^T: k-step ks is 32 bytes into panel ks / 4
    const uint32_t aKs = aK + (it % kStages) * TB;
    float s[32];
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      const uint32_t off = (ks >> 2) * kPanelBytes + (ks & 3) * 32;
      wgmma_ss_n64(s, desc(aQ + off, 16, 1024), desc(aKs + off, 16, 1024), ks > 0);
    }
    wgmma_commit();
    wgmma_wait0();
    fence_regs(s);

    // mask (only on a tile that touches a mask edge), online softmax: a
    // masked score is -inf, and 2^(-inf) = 0
    if (kb + kBK > valid || (causal && kb + kBK - 1 > qp_lo) ||
        (window > 0 && kb <= qp_hi - window)) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int kp = kb + (i >> 2) * 8 + 2 * t + (i & 1);
        const int qp = (i & 2) ? qpos1 : qpos0;
        const bool live = kp < valid && (!causal || kp <= qp) &&
                          (window <= 0 || kp > qp - window);
        s[i] = live ? s[i] : -CUDART_INF_F;
      }
    }
    float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
    for (int i = 0; i < 32; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
    float corr[2], nm[2], psum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r] * sl2);
      nm[r] = m_new == -CUDART_INF_F ? 0.0f : -m_new;   // minus the finite max
      corr[r] = ex2(m[r] + nm[r]);
      m[r] = m_new;
    }
    uint32_t p[4][4];   // P as bf16, the A operand of k-step kk
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int r = (i >> 1) & 1;
      const float p0 = ex2(fmaf(s[i], sl2, nm[r]));
      const float p1 = ex2(fmaf(s[i + 1], sl2, nm[r]));
      psum[r] += p0 + p1;
      p[i >> 3][(i >> 1) & 3] = pack_bf16(p0, p1);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      psum[r] += __shfl_xor_sync(0xffffffffu, psum[r], 1);
      psum[r] += __shfl_xor_sync(0xffffffffu, psum[r], 2);
      l[r] = corr[r] * l[r] + psum[r];
    }
#pragma unroll
    for (int i = 0; i < NO; ++i) acc[i] *= corr[(i >> 1) & 1];

    cp_async_wait<WAIT>();               // V_it has landed
    fence_proxy_async();
    __syncthreads();                     // and S_it is done everywhere
    load(sK, ksrc, it + kStages);

    // O += P.V: k-step kk is keys 16 kk .. 16 kk + 15, 2 KB into the tile
    const uint32_t aVs = aV + (it % kStages) * TB;
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs(acc, p[kk], desc(aVs + kk * 2048, kPanelBytes, 1024));
    wgmma_commit();
    wgmma_wait0();
    fence_regs(acc);
    fence_regs(p);
  }
  cp_async_wait<0>();  // with no tile, Q's copies may still be in flight
  __syncthreads();

  if (lse != nullptr && t == 0) {   // one lane of each quad holds a row
    float* lrow = lse + ((long long)b * Hq + hq) * T + q0 + warp * 16 + g;
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (warp * 16 + g + 8 * r < n_q)
        lrow[8 * r] = m[r] == -CUDART_INF_F
                          ? -CUDART_INF_F
                          : m[r] * 0.6931471805599453f + logf(l[r]);
  }

  // stage each warp's 16 rows in its own rows of the Q tile, swizzled
  const float inv[2] = {1.0f / fmaxf(l[0], 1e-20f), 1.0f / fmaxf(l[1], 1e-20f)};
#pragma unroll
  for (int i = 0; i < NO; i += 2) {
    const int r = warp * 16 + g + ((i & 2) ? 8 : 0);
    const int col = (i >> 2) * 8 + 2 * t;
    const float dn = inv[(i >> 1) & 1];
    *reinterpret_cast<uint32_t*>(sQ + sw(r, col >> 3) + (col & 7) * 2) =
        pack_bf16(acc[i] * dn, acc[i + 1] * dn);
  }
  __syncwarp();
  for (int e = lane; e < 16 * CH; e += 32) {
    const int i = e / CH, c = e % CH;
    const int row = warp * 16 + i;
    if (row < n_q)
      *reinterpret_cast<uint4*>(o + (((long long)b * T + q0 + row) * Hq + hq) * D +
                                c * 8) =
          *reinterpret_cast<const uint4*>(sQ + sw(row, c));
  }
}

template <int D>
int launch(const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
           const int* kv_valid, int B, int T, int S, int Hq, int Hkv, int causal,
           int window, int q_offset, float scale, __nv_bfloat16* o, float* lse,
           cudaStream_t stream) {
  // Q, the two rings, and the slack to align them to the swizzle atom
  constexpr int bytes = (1 + 2 * kStages) * tile_bytes<D>() + 1024;
  static bool configured = false;   // the attributes are set once per D
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_attention_bf16_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        bytes);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(flash_attention_bf16_kernel<D>,
                                 cudaFuncAttributePreferredSharedMemoryCarveout,
                                 (int)cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  const long long blocks = (long long)((T + kBQ - 1) / kBQ) * Hq * B;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  flash_attention_bf16_kernel<D><<<(unsigned)blocks, kThreads, bytes, stream>>>(
      q, k, v, kv_valid, T, S, Hq, Hkv, causal, window, q_offset, scale, o, lse);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int flash_attention_bf16_launch(
    const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
    const int* kv_valid, int B, int T, int S, int Hq, int Hkv, int D,
    int causal, int window, int q_offset, float scale, __nv_bfloat16* o,
    float* lse, void* stream) {
  if (B < 0 || T < 0 || S < 0 || Hkv < 1 || Hq < Hkv || Hq % Hkv)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || T == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return launch<64>(q, k, v, kv_valid, B, T, S, Hq, Hkv, causal, window,
                        q_offset, scale, o, lse, st);
    case 128:
      return launch<128>(q, k, v, kv_valid, B, T, S, Hq, Hkv, causal, window,
                         q_offset, scale, o, lse, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
