// Flash-attention backward for Hopper (sm_90a) in bf16: the gradient of
// csrc/flash_attention_bf16.cu's causal / sliding-window GQA attention with
// respect to q, k and v, its five products on the bf16 tensor cores by
// wgmma.
//
// The TPU kernel repro/kernels/attention/kernel.py `flash_attention_tpu`
// has no backward: the JAX model differentiates its jnp `flash_attention`
// (repro/nn/attention.py), which widens bf16 to fp32, computes in fp32 and
// returns bf16 gradients.  This kernel is the bf16 half of
// csrc/flash_attention_backward.cu, with its contract: causal or not,
// `window` >= 0, `q_offset`, a per-row `kv_valid_len`, D in {64, 128}, Hq a
// multiple of Hkv, any T and S; a query row with no live key (log-sum-exp
// -inf) gets dq = 0, a key no row sees dk = dv = 0.
// Layout: q, o, dO, dq (B, T, Hq, D); k, v, dk, dv (B, S, Hkv, D), all bf16
// and 16-byte aligned; lse (the forward's fp32 log-sum-exp) and dvec
// (fp32 scratch) (B, Hq, T).
//
// Scheme: the fp32 backward's, recompute from the log-sum-exp as
// FlashAttention-2, three kernels on one stream and no atomics, so two
// calls give bitwise equal gradients:
// - flash_bwd_dot_kernel (flash_common.cuh): dvec = rowsum(dO * O) in fp32;
// - flash_bwd_bf16_dkdv_kernel: one block per (64-key tile, kv head, batch
//   row), walking every 64-row q tile of every query head of its kv head
//   that can see the tile, so the GQA sum of dK and dV stays in registers;
// - flash_bwd_bf16_dq_kernel: one block per (64 q rows, q head, batch row),
//   walking the 64-key tiles the rows can see; q tiles last to first.
// The loop bounds and the per-element mask on the tiles that touch a mask
// edge are the fp32 kernel's (see its notes).
//
// Precision.  A product of two bf16 values is exact in fp32, so
// S = Q.K^T and dP = dO.V^T on the bf16 tensor cores with fp32
// accumulation are the fp32 arithmetic on the widened inputs up to the
// order of the sums.  P = exp(S scale - lse) and dS = P (dP - dvec) are
// computed in fp32; P and dS are rounded to bf16 before dV += P^T dO,
// dK += dS^T Q and dQ += dS K (as SDPA's bf16 backward does), and the
// gradients, summed in fp32, are rounded to bf16 once.  Held to 3e-2 of
// the plain version (autograd of the fp32-inside forward) and, against
// float64, to at most twice SDPA's bf16 backward (chip_smoke.py phase 17a).
//
// Bound: operations.  10 * D flops a live (query, key) pair; this design
// issues 14 * D (q.k and dO.v twice: in dK/dV and again in dQ).  At
// moonshot-v1-16b-a3b's training microbatch, q = k/v (2, 4096, 16, 128),
// causal (268.5 M live pairs): 343.6 GFLOP, 0.347 ms at 989 TFLOP/s of
// bf16 (0.487 ms for the 14 * D issued); the tensors are 0.27 GB, 0.080 ms
// at 3.35 TB/s.
//
// What held the mma.sync design back: each of a block's 4 warps owned 16
// rows of M and fetched every B fragment itself by ldmatrix, so each B
// tile was read from shared memory four times a block (about 112
// ldmatrix.x4 for 192 mma.sync a dQ tile: some 15 GB of shared-memory
// reads at the training shape, 0.51 ms at 128 B a clock an SM, against
// 0.32 ms of mma.sync).  It ran at 1.92 ms, its dK/dV and dQ kernels in
// the 8 * D / 6 * D ratio of their flops: one shared-memory-bound rate.
//
// Design: every product is a wgmma of one warpgroup (128 threads, M = 64
// rows: warp w owns rows 16w .. 16w + 15 of the accumulators, lane (g, t)
// rows g and g + 8, columns 2t and 2t + 1 of each 8-column group), which
// reads its B operand from shared memory once for all 64 rows and stages
// nothing through registers.  Tiles are 64 rows in the forward's
// 128-byte-swizzled layout (wgmma_common.cuh), filled by 16-byte cp.async
// (rows past T or S zero-filled; the row statistics by 4-byte copies) and
// fenced to the async proxy before the block barrier.  One tile serves as
// a K-major operand and, read with the transpose bit, as an MN-major B, so
// nothing is copied twice.
// - dK/dV (M = the block's 64 keys): S^T = K.Q^T and dP^T = V.dO^T by
//   D / 16 wgmma m64n64k16 each, both operands K-major; then P^T and dS^T
//   element by element in fp32, each packed to bf16 as soon as it is
//   formed (the accumulator's row g, columns 2t, 2t + 1 are the register
//   A operand's, no shuffle), so S^T and dP^T die before the two
//   accumulating products; dV += P^T.dO and dK += dS^T.Q by 4 wgmma
//   m64n{D}k16 each, A from registers, B = dO / Q MN-major.  K and V are
//   loaded once; (Q, dO, lse, dvec) stream through a two-stage ring.
// - dQ (M = the block's 64 q rows): S = Q.K^T and dP = dO.V^T as above,
//   dS packed to bf16 in place, dQ += dS.K by 4 wgmma m64n{D}k16 with
//   B = K MN-major.  Q and dO are loaded once; (K, V) stream through a
//   two-stage ring.
// - Each product group waits for its wgmma before its results are read
//   and before a stage is refilled; the other resident block overlaps.
// - Epilogue: dK, dV (dQ) scaled and rounded to bf16 into the swizzled K,
//   V (Q) tiles, written with 16-byte stores.
// - Registers (-Xptxas -v, sm_90a): dK/dV 241 at D = 128, 176 at D = 64;
//   dQ 171 and 133; dvec 24; no spill.  Shared memory: 6 tiles + 1 KB of
//   row statistics (dK/dV) or 6 tiles (dQ), plus 1 KB to align them to the
//   1,024-byte swizzle atom: 98 / 97 KB at D = 128, 50 / 49 KB at D = 64.
//   Two blocks an SM at D = 128 (2 x 128 threads x 241 registers fit the
//   SM's 65,536), so one block's elementwise work overlaps the other's
//   products.
#include <climits>
#include <cstdint>

#include "flash_common.cuh"
#include "wgmma_common.cuh"

namespace {

constexpr int kTile = 64;   // keys of a dK/dV block and q rows of its q
                            // tiles; q rows of a dQ block and keys of its
                            // key tiles: wgmma's M and the score products' N

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ unsigned char* align_atom(unsigned char* p) {
  return reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}

// S1 = A1.B1^T and S2 = A2.B2^T (64 x 64, fp32, from zero): the two score
// products of both kernels, every operand a K-major 64-row tile of D
template <int D>
__device__ __forceinline__ void score_pair(float (&s1)[32], float (&s2)[32],
                                           uint32_t a1, uint32_t b1,
                                           uint32_t a2, uint32_t b2) {
  fence_regs(s1);
  fence_regs(s2);
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    wgmma_ss_n64(s1, desc_k(a1, ks), desc_k(b1, ks), ks > 0);
    wgmma_ss_n64(s2, desc_k(a2, ks), desc_k(b2, ks), ks > 0);
  }
  wgmma_commit();
  wgmma_wait0();
  fence_regs(s1);
  fence_regs(s2);
}

// acc += A.B over the 4 k-steps of a 64-wide K: A in registers, B the
// MN-major 64-row tile at b
template <int NO>
__device__ __forceinline__ void accumulate(float (&acc)[NO], uint32_t (&a)[4][4],
                                           uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_rs(acc, a[kk], desc_mn(b, kk));
}

// the accumulator pair (rows g, g + 8; columns 2t, 2t + 1 of 8-column
// group j) of x as bf16 into the register A operand of k-step j / 2
__device__ __forceinline__ void pack_pair(uint32_t (&a)[4][4], int j, const float (&x)[4]) {
  a[j >> 1][(j & 1) * 2] = pack_bf16(x[0], x[1]);
  a[j >> 1][(j & 1) * 2 + 1] = pack_bf16(x[2], x[3]);
}

// the warpgroup's accumulators (64 rows x D, fp32) times `mul`, rounded to
// bf16, into the swizzled tile at tile, then rows [0, n_live) out to dst
// (rows `stride` elements apart) by 16-byte stores; each warp its own rows
template <int D>
__device__ __forceinline__ void store_rows(const float (&acc)[D / 2], float mul,
                                           unsigned char* tile, bf16* dst,
                                           long long stride, int n_live,
                                           int warp, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < D / 2; i += 2) {
    const int r = warp * 16 + g + ((i & 2) ? 8 : 0);
    const int col = (i >> 2) * 8 + 2 * t;
    *reinterpret_cast<uint32_t*>(tile + sw(r, col >> 3) + (col & 7) * 2) =
        pack_bf16(acc[i] * mul, acc[i + 1] * mul);
  }
  __syncwarp();
  constexpr int CH = D / 8;
  for (int e = lane; e < 16 * CH; e += 32) {
    const int row = warp * 16 + e / CH, c = e % CH;
    if (row < n_live)
      *reinterpret_cast<uint4*>(dst + row * stride + c * 8) =
          *reinterpret_cast<const uint4*>(tile + sw(row, c));
  }
}

template <int D>
__host__ __device__ constexpr int dkdv_smem_bytes() {
  // K, V, two stages of (Q, dO), two of (lse, dvec), the alignment slack
  return 6 * tile_bytes<D>() + 2 * 2 * kTile * 4 + 1024;
}

template <int D>
__global__ void __launch_bounds__(kWarpgroup, 2)
flash_bwd_bf16_dkdv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                           const bf16* __restrict__ v, const bf16* __restrict__ dout,
                           const float* __restrict__ lse, const float* __restrict__ dvec,
                           const int* __restrict__ kv_valid, int T, int S, int Hq,
                           int Hkv, int causal, int window, int q_offset, float scale,
                           bf16* __restrict__ dk, bf16* __restrict__ dv) {
  constexpr int BK = kTile, BQ = kTile;
  constexpr int TB = tile_bytes<D>();
  constexpr int NO = D / 2;              // dK / dV accumulators a thread
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sK = align_atom(smem_raw);
  unsigned char* sV = sK + TB;
  unsigned char* sQ0 = sV + TB;          // stage s: Q at 2 s TB, dO TB further
  float* sStat = reinterpret_cast<float*>(sQ0 + 4 * TB);   // stage s: lse, dvec
  const uint32_t aK = static_cast<uint32_t>(__cvta_generic_to_shared(sK));
  const uint32_t aV = aK + TB, aQ0 = aV + TB;

  // blockIdx.x = (KV tiles from the first) x (batch row, kv head)
  const int n_kt = (S + BK - 1) / BK;
  const int HB = gridDim.x / n_kt;
  const int hb = blockIdx.x % HB;
  const int b = hb / Hkv, hk = hb % Hkv;
  const int kb = (int)(blockIdx.x / HB) * BK;
  const int G = Hq / Hkv;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int t = lane & 3, g = lane >> 2;

  const Mask mask{kv_valid ? max(0, min(S, kv_valid[b])) : S, causal, window};
  const float scale2 = scale * kLog2e;   // P = exp2(s scale log2 e - lse log2 e)
  // the live keys of this tile end at k_hi; the rows that see one: [i_lo, i_hi)
  const int k_hi = min(kb + BK, mask.valid);
  int i_lo = 0, i_hi = 0;
  if (k_hi > kb) {
    i_lo = causal ? max(0, kb - q_offset) : 0;
    i_hi = window > 0 ? min(T, k_hi - 1 + window - q_offset) : T;
  }
  const int qt0 = i_lo / BQ;
  const int n_qt = i_hi > i_lo ? (i_hi + BQ - 1) / BQ - qt0 : 0;
  const int n_it = G * n_qt;             // (query head, q tile) pairs

  const long long q_rs = (long long)Hq * D;
  const long long kv_rs = (long long)Hkv * D;   // elements between keys
  const long long kv_off0 = (long long)b * S * kv_rs + (long long)hk * D;
  const TileCopy<D> qcopy(tid, q_rs), kvcopy(tid, kv_rs);
  auto load_q_tile = [&](int it, int stage) {
    const int hq = hk * G + it / n_qt;
    const int q0 = (qt0 + it % n_qt) * BQ;
    const int n_q = min(BQ, T - q0);
    unsigned char* sQ = sQ0 + stage * 2 * TB;
    const long long off0 = ((long long)b * T + q0) * q_rs + (long long)hq * D;
    qcopy.load(sQ, q + off0, q_rs, n_q);
    qcopy.load(sQ + TB, dout + off0, q_rs, n_q);
    // threads 0-63 copy the rows' lse, 64-127 their dvec
    const int i = tid % BQ;
    const bool in = i < n_q;
    const long long row = ((long long)b * Hq + hq) * T + q0 + (in ? i : 0);
    cp_async4(sStat + stage * 2 * BQ + tid, (tid < BQ ? lse : dvec) + row, in ? 4 : 0);
  };
  if (n_it > 0) {
    kvcopy.load(sK, k + kv_off0 + (long long)kb * kv_rs, kv_rs, S - kb);
    kvcopy.load(sV, v + kv_off0 + (long long)kb * kv_rs, kv_rs, S - kb);
    load_q_tile(0, 0);
  }
  cp_async_commit();                     // group 0: K, V and the first q tile

  const int kp0 = kb + warp * 16 + g;    // key of accumulator row g; kp0 + 8 of g + 8
  float acc_k[NO], acc_v[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) acc_k[i] = acc_v[i] = 0.0f;

  for (int it = 0; it < n_it; ++it) {
    const int stage = it & 1;
    if (it + 1 < n_it) load_q_tile(it + 1, stage ^ 1);
    cp_async_commit();
    cp_async_wait<1>();                  // q tile it (and K, V) has landed
    fence_proxy_async();
    __syncthreads();
    const uint32_t aQ = aQ0 + stage * 2 * TB, adO = aQ + TB;
    const float* sL = sStat + stage * 2 * BQ;
    const float* sDv = sL + BQ;
    const int q0 = (qt0 + it % n_qt) * BQ;

    // S^T = K Q^T and dP^T = V dO^T
    float st[32], dpt[32];
    score_pair<D>(st, dpt, aK, aQ, aV, adO);

    // P^T and dS^T, each packed to bf16 as it is formed: accumulator
    // 4j + e is key kp0 + 8 (e >> 1), query row q0 + 8j + 2t + (e & 1)
    const int qp_lo = q_offset + q0, qp_hi = qp_lo + BQ - 1;
    const bool edge = kb + BK > mask.valid || (causal && kb + BK - 1 > qp_lo) ||
                      (window > 0 && kb <= qp_hi - window);
    uint32_t pa[4][4], da[4][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int i0 = j * 8 + 2 * t;
      const float2 l2 = *reinterpret_cast<const float2*>(sL + i0);
      const float2 d2 = *reinterpret_cast<const float2*>(sDv + i0);
      const float l[2] = {row_lse(l2.x, q0 + i0 < T) * kLog2e,
                          row_lse(l2.y, q0 + i0 + 1 < T) * kLog2e};
      const float dd[2] = {d2.x, d2.y};
      float p[4], ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float pe = exp2f(st[4 * j + e] * scale2 - l[e & 1]);
        if (edge && !mask.live(qp_lo + i0 + (e & 1), kp0 + (e >> 1) * 8)) pe = 0.0f;
        p[e] = pe;
        ds[e] = pe * (dpt[4 * j + e] - dd[e & 1]);
      }
      pack_pair(pa, j, p);
      pack_pair(da, j, ds);
    }

    // dV += P^T dO and dK += dS^T Q
    fence_regs(acc_v);
    fence_regs(acc_k);
    wgmma_fence();
    accumulate(acc_v, pa, adO);
    accumulate(acc_k, da, aQ);
    wgmma_commit();
    wgmma_wait0();
    fence_regs(acc_v);
    fence_regs(acc_k);
    fence_regs(pa);
    fence_regs(da);
    __syncthreads();  // this stage is refilled by the next iteration's load
  }
  cp_async_wait<0>();  // with no q tile, K's and V's copies may be in flight
  __syncthreads();

  // every key of the tile below S is written (zeros where no row sees it)
  const long long row0 = kv_off0 + (long long)kb * kv_rs;
  store_rows<D>(acc_k, scale, sK, dk + row0, kv_rs, S - kb, warp, lane);
  store_rows<D>(acc_v, 1.0f, sV, dv + row0, kv_rs, S - kb, warp, lane);
}

template <int D>
__host__ __device__ constexpr int dq_smem_bytes() {
  // Q, dO, two stages of (K, V), the alignment slack
  return 6 * tile_bytes<D>() + 1024;
}

template <int D>
__global__ void __launch_bounds__(kWarpgroup, 2)
flash_bwd_bf16_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, const bf16* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ dvec,
                         const int* __restrict__ kv_valid, int T, int S, int Hq,
                         int Hkv, int causal, int window, int q_offset, float scale,
                         bf16* __restrict__ dq) {
  constexpr int BQ = kTile, BK = kTile;
  constexpr int TB = tile_bytes<D>();
  constexpr int NO = D / 2;              // dQ accumulators a thread
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sQ = align_atom(smem_raw);
  unsigned char* sKV0 = sQ + 2 * TB;     // stage s: K at 2 s TB, V TB further
  const uint32_t aQ = static_cast<uint32_t>(__cvta_generic_to_shared(sQ));
  const uint32_t adO = aQ + TB, aKV0 = aQ + 2 * TB;

  // blockIdx.x = (q tiles from the last) x (batch row, q head)
  const int n_qt = (T + BQ - 1) / BQ;
  const int HB = gridDim.x / n_qt;
  const int hb = blockIdx.x % HB;
  const int b = hb / Hq, hq = hb % Hq;
  const int q0 = (n_qt - 1 - (int)(blockIdx.x / HB)) * BQ;
  const int hk = hq / (Hq / Hkv);
  const int n_q = min(BQ, T - q0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int t = lane & 3, g = lane >> 2;

  // the keys any row of this tile can see: [k_begin, k_end)
  const Mask mask{kv_valid ? max(0, min(S, kv_valid[b])) : S, causal, window};
  const float scale2 = scale * kLog2e;
  const int qp_lo = q_offset + q0, qp_hi = q_offset + q0 + n_q - 1;
  const int k_end = causal ? min(mask.valid, max(0, qp_hi + 1)) : mask.valid;
  const int k_begin = window > 0 ? max(0, qp_lo - window + 1) : 0;
  const int kb0 = (k_begin / BK) * BK;
  const int n_tiles = k_end > kb0 ? (k_end - kb0 + BK - 1) / BK : 0;

  const long long q_rs = (long long)Hq * D;
  const long long q_off0 = ((long long)b * T + q0) * q_rs + (long long)hq * D;
  const long long kv_rs = (long long)Hkv * D;
  const long long kv_off0 = (long long)b * S * kv_rs + (long long)hk * D;
  const TileCopy<D> qcopy(tid, q_rs), kvcopy(tid, kv_rs);
  qcopy.load(sQ, q + q_off0, q_rs, n_q);
  qcopy.load(sQ + TB, dout + q_off0, q_rs, n_q);
  auto load_tile = [&](int kbt, int stage) {
    unsigned char* sK = sKV0 + stage * 2 * TB;
    kvcopy.load(sK, k + kv_off0 + (long long)kbt * kv_rs, kv_rs, S - kbt);
    kvcopy.load(sK + TB, v + kv_off0 + (long long)kbt * kv_rs, kv_rs, S - kbt);
  };
  if (n_tiles > 0) load_tile(kb0, 0);
  cp_async_commit();                     // group 0: Q, dO and the first tile

  // the thread's two rows: lse and dvec in registers
  const int r0 = warp * 16 + g;          // accumulator row g; r0 + 8 of g + 8
  const long long st_row = ((long long)b * Hq + hq) * T + q0;
  float l[2], dd[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const bool in = r0 + 8 * r < n_q;
    l[r] = row_lse(in ? lse[st_row + r0 + 8 * r] : 0.0f, in) * kLog2e;
    dd[r] = in ? dvec[st_row + r0 + 8 * r] : 0.0f;
  }
  const int qpos0 = qp_lo + r0;
  float acc[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) acc[i] = 0.0f;

  for (int it = 0; it < n_tiles; ++it) {
    const int kb = kb0 + it * BK;
    const int stage = it & 1;
    if (it + 1 < n_tiles) load_tile(kb + BK, stage ^ 1);
    cp_async_commit();
    cp_async_wait<1>();                  // tile it (and Q, dO) has landed
    fence_proxy_async();
    __syncthreads();
    const uint32_t aK = aKV0 + stage * 2 * TB, aV = aK + TB;

    // S = Q K^T and dP = dO V^T
    float s[32], dp[32];
    score_pair<D>(s, dp, aQ, aK, adO, aV);

    // dS, packed to bf16 as it is formed: accumulator 4j + e is row
    // r0 + 8 (e >> 1), key kb + 8j + 2t + (e & 1)
    const bool edge = kb + BK > mask.valid || (causal && kb + BK - 1 > qp_lo) ||
                      (window > 0 && kb <= qp_hi - window);
    uint32_t da[4][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = exp2f(s[4 * j + e] * scale2 - l[e >> 1]);
        if (edge && !mask.live(qpos0 + (e >> 1) * 8, kb + j * 8 + 2 * t + (e & 1)))
          p = 0.0f;
        ds[e] = p * (dp[4 * j + e] - dd[e >> 1]);
      }
      pack_pair(da, j, ds);
    }

    // dQ += dS K
    fence_regs(acc);
    wgmma_fence();
    accumulate(acc, da, aK);
    wgmma_commit();
    wgmma_wait0();
    fence_regs(acc);
    fence_regs(da);
    __syncthreads();  // this stage is refilled by the next iteration's load
  }
  cp_async_wait<0>();  // with no tile, Q's copies may still be in flight
  __syncthreads();

  store_rows<D>(acc, scale, sQ, dq + q_off0, q_rs, n_q, warp, lane);
}

template <int D>
int launch(const bf16* q, const bf16* k, const bf16* v, const bf16* o,
           const bf16* dout, const float* lse, float* dvec, const int* kv_valid,
           int B, int T, int S, int Hq, int Hkv, int causal, int window,
           int q_offset, float scale, bf16* dq, bf16* dk, bf16* dv,
           cudaStream_t st) {
  constexpr int kv_bytes = dkdv_smem_bytes<D>();
  constexpr int q_bytes = dq_smem_bytes<D>();
  static bool kv_ok = false, q_ok = false;   // attributes set once per D
  cudaError_t err = allow_smem(flash_bwd_bf16_dkdv_kernel<D>, kv_bytes, kv_ok);
  if (err == cudaSuccess)
    err = allow_smem(flash_bwd_bf16_dq_kernel<D>, q_bytes, q_ok);
  if (err != cudaSuccess) return (int)err;

  const long long rows = (long long)B * T * Hq;
  const long long dot_blocks = (rows + kDotThreads / 32 - 1) / (kDotThreads / 32);
  const long long kv_blocks = (long long)((S + kTile - 1) / kTile) * Hkv * B;
  const long long q_blocks = (long long)((T + kTile - 1) / kTile) * Hq * B;
  if (dot_blocks > INT_MAX || kv_blocks > INT_MAX || q_blocks > INT_MAX)
    return (int)cudaErrorInvalidValue;
  flash_bwd_dot_kernel<D, bf16><<<(unsigned)dot_blocks, kDotThreads, 0, st>>>(
      o, dout, rows, T, Hq, dvec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  flash_bwd_bf16_dkdv_kernel<D><<<(unsigned)kv_blocks, kWarpgroup, kv_bytes, st>>>(
      q, k, v, dout, lse, dvec, kv_valid, T, S, Hq, Hkv, causal, window,
      q_offset, scale, dk, dv);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  flash_bwd_bf16_dq_kernel<D><<<(unsigned)q_blocks, kWarpgroup, q_bytes, st>>>(
      q, k, v, dout, lse, dvec, kv_valid, T, S, Hq, Hkv, causal, window,
      q_offset, scale, dq);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int flash_attention_backward_bf16_launch(
    const bf16* q, const bf16* k, const bf16* v, const bf16* o, const bf16* dout,
    const float* lse, float* dvec, const int* kv_valid, int B, int T, int S,
    int Hq, int Hkv, int D, int causal, int window, int q_offset, float scale,
    bf16* dq, bf16* dk, bf16* dv, void* stream) {
  if (B < 1 || T < 1 || S < 1 || Hkv < 1 || Hq < Hkv || Hq % Hkv)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return launch<64>(q, k, v, o, dout, lse, dvec, kv_valid, B, T, S, Hq, Hkv,
                        causal, window, q_offset, scale, dq, dk, dv, st);
    case 128:
      return launch<128>(q, k, v, o, dout, lse, dvec, kv_valid, B, T, S, Hq, Hkv,
                         causal, window, q_offset, scale, dq, dk, dv, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
