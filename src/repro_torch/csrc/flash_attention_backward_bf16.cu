// Flash-attention backward for Hopper (sm_90a) in bf16: the gradient of
// csrc/flash_attention_bf16.cu's causal / sliding-window GQA attention with
// respect to q, k and v, its five products on the bf16 tensor cores.
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
//   row), walking every q tile of every query head of its kv head that can
//   see the tile, so the GQA sum of dK and dV stays in registers;
// - flash_bwd_bf16_dq_kernel: one block per (64 q rows, q head, batch row),
//   walking the key tiles the rows can see; q tiles last to first.
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
// bf16; the tensors are 0.27 GB, 0.080 ms at 3.35 TB/s.
//
// Design: every product is mma.sync.m16n8k16 (bf16 in, fp32 accumulators),
// blocks of 4 warps, each warp 16 rows of M.  Tiles are row-major bf16 in
// shared memory, rows padded to D + 8 elements (a row stride of 16 bytes
// mod 128, so the 8 rows an ldmatrix reads fall in 8 distinct 16-byte bank
// groups).  Fragments come by ldmatrix.x4: A (rows as M) and B where the
// tile's rows are the product's N (K for S, V for dP, Q / dO for S^T /
// dP^T) as stored; B where the tile's rows are the product's K dimension
// (K in dS.K, dO in P^T.dO, Q in dS^T.Q) by ldmatrix.trans.  P (P^T) and
// dS (dS^T) leave the C fragments of two neighbouring n-tiles and enter
// the A fragment of one k-step in place (row g: columns 2t, 2t + 1 of each
// n-tile), packed to bf16, with no shuffle and no trip through shared
// memory.  Tiles stream through two-stage 16-byte cp.async rings (the
// row statistics by 4-byte copies), rows past T or S zero-filled.
// - dK/dV: M is the keys (16 a warp); q tiles of BQ rows: 64 at D = 64,
//   32 at D = 128 (the dK and dV accumulators of 16 keys x 128 are 128
//   registers a thread).  Shared memory: K, V and two stages of (Q, dO,
//   lse, dvec): 55 KB at D = 64, 69 KB at D = 128.
// - dQ: M is the queries (16 a warp); key tiles of 64; Q, dO and two
//   stages of (K, V): 54 KB at D = 64, 102 KB at D = 128.
#include <climits>
#include <cstdint>

#include "flash_common.cuh"

namespace {

constexpr int kWarps = 4;               // each owns one m16 row group
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = 16 * kWarps;      // keys of a dK/dV block, rows of dQ's

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// four 8 x 8 bf16 matrices from shared memory, each lane handing in one
// row address (lanes 8m .. 8m + 7: the rows of matrix m); TRANS gives each
// lane the transposed matrices' fragments
template <bool TRANS>
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  if constexpr (TRANS)
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(s)
        : "memory");
  else
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(s)
        : "memory");
}

// Lane offsets into a row-major tile (row stride LD) for ldmatrix.x4:
// - a_off: the A fragment of the 16 x 16 block at (0, 0) (matrices: rows
//   0-7 / 8-15 x columns 0-7, then the same x columns 8-15), and, read
//   with TRANS, the B fragments of a product whose K runs down the tile's
//   rows: b0 / b1 of the n-tile at column 0, then of the one at column 8;
// - b_off: the B fragments of a product whose N runs down the tile's rows
//   (16 rows = two n-tiles, 16 columns = one k-step): b0 / b1 of the
//   n-tile at row 0, then of the one at row 8.
template <int LD>
__device__ __forceinline__ int a_off(int lane) {
  return ((lane & 7) + ((lane >> 3) & 1) * 8) * LD + (lane >> 4) * 8;
}
template <int LD>
__device__ __forceinline__ int b_off(int lane) {
  return ((lane & 7) + (lane >> 4) * 8) * LD + ((lane >> 3) & 1) * 8;
}

// c += A B over one k-step range: A is NK k-steps of bf16 A fragments in
// registers, B's rows (the product's K) are the rows of the row-major tile
// sB from row 0, columns NO n-tiles from column 0 (read by ldmatrix.trans)
template <int NK, int NO, int LD>
__device__ __forceinline__ void product_rows_k(float (&c)[NO][4],
                                               const uint32_t (&a)[NK][4],
                                               const bf16* sB, int lane) {
  const bf16* base = sB + a_off<LD>(lane);
#pragma unroll
  for (int kk = 0; kk < NK; ++kk) {
#pragma unroll
    for (int n = 0; n < NO; n += 2) {
      uint32_t b[4];
      ldsm_x4<true>(b, base + kk * 16 * LD + n * 8);
      mma_bf16(c[n], a[kk], b[0], b[1]);
      mma_bf16(c[n + 1], a[kk], b[2], b[3]);
    }
  }
}

// sA1.B1^T and sA2.B2^T for a warp's 16 rows of sA1 / sA2 (row-major, D
// columns) against the NS rows of sB1 / sB2 (row-major, D columns): the
// two score products of both kernels (S, dP; S^T, dP^T), from zero
template <int D, int NS, int LD>
__device__ __forceinline__ void score_pair(float (&c1)[NS][4], float (&c2)[NS][4],
                                           const bf16* sA1, const bf16* sA2,
                                           const bf16* sB1, const bf16* sB2,
                                           int lane) {
#pragma unroll
  for (int n = 0; n < NS; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) c1[n][e] = c2[n][e] = 0.0f;
  const int ao = a_off<LD>(lane), bo = b_off<LD>(lane);
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    uint32_t a1[4], a2[4];
    ldsm_x4<false>(a1, sA1 + ao + ks * 16);
    ldsm_x4<false>(a2, sA2 + ao + ks * 16);
#pragma unroll
    for (int n = 0; n < NS; n += 2) {
      uint32_t b[4];
      ldsm_x4<false>(b, sB1 + bo + n * 8 * LD + ks * 16);
      mma_bf16(c1[n], a1, b[0], b[1]);
      mma_bf16(c1[n + 1], a1, b[2], b[3]);
      ldsm_x4<false>(b, sB2 + bo + n * 8 * LD + ks * 16);
      mma_bf16(c2[n], a2, b[0], b[1]);
      mma_bf16(c2[n + 1], a2, b[2], b[3]);
    }
  }
}

// the C fragments of NS n-tiles as the bf16 A fragments of NS / 2 k-steps
template <int NS>
__device__ __forceinline__ void to_a(uint32_t (&a)[NS / 2][4],
                                     const float (&c)[NS][4]) {
#pragma unroll
  for (int kk = 0; kk < NS / 2; ++kk) {
    a[kk][0] = pack_bf16(c[2 * kk][0], c[2 * kk][1]);
    a[kk][1] = pack_bf16(c[2 * kk][2], c[2 * kk][3]);
    a[kk][2] = pack_bf16(c[2 * kk + 1][0], c[2 * kk + 1][1]);
    a[kk][3] = pack_bf16(c[2 * kk + 1][2], c[2 * kk + 1][3]);
  }
}

// the rows [0, n_live) of a tile of `rows` rows x D bf16 from src (rows
// `stride` elements apart) into dst (row stride LD), the rest zero-filled
template <int D, int LD>
__device__ __forceinline__ void copy_tile(bf16* dst, const bf16* src,
                                          long long stride, int rows,
                                          int n_live, int tid) {
  constexpr int CH = D / 8;   // 16-byte chunks a row
  for (int e = tid; e < rows * CH; e += kThreads) {
    const int i = e / CH, c = e % CH;
    const bool in = i < n_live;
    cp_async16(dst + i * LD + c * 8, src + (in ? i * stride : 0) + c * 8,
               in ? 16 : 0);
  }
}

template <int D, int BQ>
__host__ __device__ constexpr int dkdv_smem_bytes() {
  // K and V tiles, then two stages of (Q, dO, lse, dvec)
  return 2 * kTile * (D + 8) * 2 + 2 * (2 * BQ * (D + 8) * 2 + 2 * BQ * 4);
}

template <int D, int BQ>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_bf16_dkdv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                           const bf16* __restrict__ v, const bf16* __restrict__ dout,
                           const float* __restrict__ lse, const float* __restrict__ dvec,
                           const int* __restrict__ kv_valid, int T, int S, int Hq,
                           int Hkv, int causal, int window, int q_offset, float scale,
                           bf16* __restrict__ dk, bf16* __restrict__ dv) {
  constexpr int BK = kTile;
  constexpr int LD = D + 8;              // row stride of every tile, elements
  constexpr int NQ = BQ / 8;             // S^T n-tiles
  constexpr int NO = D / 8;              // dK / dV n-tiles
  constexpr int STAGE = 2 * BQ * LD * 2 + 2 * BQ * 4;   // bytes
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sK = reinterpret_cast<bf16*>(smem);            // BK x LD
  bf16* sV = sK + BK * LD;                             // BK x LD
  unsigned char* ring = reinterpret_cast<unsigned char*>(sV + BK * LD);

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
  auto stage_ptrs = [&](int stage, bf16*& sQ, bf16*& sdO, float*& sL, float*& sDv) {
    sQ = reinterpret_cast<bf16*>(ring + stage * STAGE);
    sdO = sQ + BQ * LD;
    sL = reinterpret_cast<float*>(sdO + BQ * LD);
    sDv = sL + BQ;
  };
  auto load_q_tile = [&](int it, int stage) {
    const int hq = hk * G + it / n_qt;
    const int q0 = (qt0 + it % n_qt) * BQ;
    const int n_q = min(BQ, T - q0);
    bf16 *sQ, *sdO;
    float *sL, *sDv;
    stage_ptrs(stage, sQ, sdO, sL, sDv);
    const long long off0 = ((long long)b * T + q0) * q_rs + (long long)hq * D;
    copy_tile<D, LD>(sQ, q + off0, q_rs, BQ, n_q, tid);
    copy_tile<D, LD>(sdO, dout + off0, q_rs, BQ, n_q, tid);
    const long long row = ((long long)b * Hq + hq) * T + q0;
    for (int i = tid; i < BQ; i += kThreads) {
      const bool in = i < n_q;
      cp_async4(sL + i, lse + row + (in ? i : 0), in ? 4 : 0);
      cp_async4(sDv + i, dvec + row + (in ? i : 0), in ? 4 : 0);
    }
  };
  const long long kv_rs = (long long)Hkv * D;   // elements between keys
  const long long kv_off0 = (long long)b * S * kv_rs + (long long)hk * D;
  if (n_it > 0) {
    copy_tile<D, LD>(sK, k + kv_off0 + (long long)kb * kv_rs, kv_rs, BK, S - kb, tid);
    copy_tile<D, LD>(sV, v + kv_off0 + (long long)kb * kv_rs, kv_rs, BK, S - kb, tid);
    load_q_tile(0, 0);
  }
  cp_async_commit();                     // group 0: K, V and the first q tile

  const bf16* sKw = sK + warp * 16 * LD;
  const bf16* sVw = sV + warp * 16 * LD;
  const int kp0 = kb + warp * 16 + g;    // key of c[0], c[1]; kp0 + 8 of c[2], c[3]
  float acc_k[NO][4], acc_v[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[n][e] = acc_v[n][e] = 0.0f;

  for (int it = 0; it < n_it; ++it) {
    const int stage = it & 1;
    if (it + 1 < n_it) load_q_tile(it + 1, stage ^ 1);
    cp_async_commit();
    cp_async_wait<1>();                  // q tile it (and K, V) has landed
    __syncthreads();
    bf16 *sQ, *sdO;
    float *sL, *sDv;
    stage_ptrs(stage, sQ, sdO, sL, sDv);
    const int q0 = (qt0 + it % n_qt) * BQ;

    // S^T = K Q^T and dP^T = V dO^T for the warp's 16 keys
    float st[NQ][4], dpt[NQ][4];
    score_pair<D, NQ, LD>(st, dpt, sKw, sVw, sQ, sdO, lane);

    // P^T and dS^T in place: keys kp0 (e < 2), kp0 + 8; query 2t + (e & 1)
    const int qp_lo = q_offset + q0, qp_hi = qp_lo + BQ - 1;
    const bool edge = kb + BK > mask.valid || (causal && kb + BK - 1 > qp_lo) ||
                      (window > 0 && kb <= qp_hi - window);
#pragma unroll
    for (int n = 0; n < NQ; ++n) {
      const int i0 = n * 8 + 2 * t;
      const float2 l2 = *reinterpret_cast<const float2*>(sL + i0);
      const float2 d2 = *reinterpret_cast<const float2*>(sDv + i0);
      const float l[2] = {row_lse(l2.x, q0 + i0 < T) * kLog2e,
                          row_lse(l2.y, q0 + i0 + 1 < T) * kLog2e};
      const float dd[2] = {d2.x, d2.y};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = exp2f(st[n][e] * scale2 - l[e & 1]);
        if (edge && !mask.live(qp_lo + i0 + (e & 1), kp0 + (e >> 1) * 8)) p = 0.0f;
        st[n][e] = p;
        dpt[n][e] = p * (dpt[n][e] - dd[e & 1]);
      }
    }

    // dV += P^T dO and dK += dS^T Q, P^T and dS^T rounded to bf16
    uint32_t pa[NQ / 2][4], da[NQ / 2][4];
    to_a<NQ>(pa, st);
    to_a<NQ>(da, dpt);
    product_rows_k<NQ / 2, NO, LD>(acc_v, pa, sdO, lane);
    product_rows_k<NQ / 2, NO, LD>(acc_k, da, sQ, lane);
    __syncthreads();  // this stage is refilled by the next iteration's load
  }
  cp_async_wait<0>();

  // every key of the tile below S is written (zeros where no row sees it)
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int kp = kp0 + 8 * r;
    if (kp >= S) continue;
    const long long at = kv_off0 + (long long)kp * kv_rs + 2 * t;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(dk + at + n * 8) =
          __floats2bfloat162_rn(acc_k[n][2 * r] * scale, acc_k[n][2 * r + 1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dv + at + n * 8) =
          __floats2bfloat162_rn(acc_v[n][2 * r], acc_v[n][2 * r + 1]);
    }
  }
}

template <int D, int BK>
__host__ __device__ constexpr int dq_smem_bytes() {
  // Q and dO tiles, then two stages of (K, V)
  return 2 * kTile * (D + 8) * 2 + 2 * 2 * BK * (D + 8) * 2;
}

template <int D, int BK>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_bf16_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, const bf16* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ dvec,
                         const int* __restrict__ kv_valid, int T, int S, int Hq,
                         int Hkv, int causal, int window, int q_offset, float scale,
                         bf16* __restrict__ dq) {
  constexpr int BQ = kTile;
  constexpr int LD = D + 8;
  constexpr int NS = BK / 8;             // score n-tiles
  constexpr int NO = D / 8;              // dQ n-tiles
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);   // BQ x LD
  bf16* sdO = sQ + BQ * LD;                   // BQ x LD
  bf16* sKV = sdO + BQ * LD;                  // 2 stages x (K, V) x BK x LD

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
  copy_tile<D, LD>(sQ, q + q_off0, q_rs, BQ, n_q, tid);
  copy_tile<D, LD>(sdO, dout + q_off0, q_rs, BQ, n_q, tid);
  const long long kv_rs = (long long)Hkv * D;
  const long long kv_off0 = (long long)b * S * kv_rs + (long long)hk * D;
  auto load_tile = [&](int kbt, int stage) {
    bf16* sK = sKV + stage * 2 * BK * LD;
    copy_tile<D, LD>(sK, k + kv_off0 + (long long)kbt * kv_rs, kv_rs, BK, S - kbt, tid);
    copy_tile<D, LD>(sK + BK * LD, v + kv_off0 + (long long)kbt * kv_rs, kv_rs, BK,
                     S - kbt, tid);
  };
  if (n_tiles > 0) load_tile(kb0, 0);
  cp_async_commit();                     // group 0: Q, dO and the first tile

  // the warp's two rows: lse and dvec in registers
  const int r0 = warp * 16 + g;          // row of c[0], c[1]; r0 + 8 of c[2], c[3]
  const long long st_row = ((long long)b * Hq + hq) * T + q0;
  float l[2], dd[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const bool in = r0 + 8 * r < n_q;
    l[r] = row_lse(in ? lse[st_row + r0 + 8 * r] : 0.0f, in) * kLog2e;
    dd[r] = in ? dvec[st_row + r0 + 8 * r] : 0.0f;
  }
  const int qpos0 = qp_lo + r0;
  const bf16* sQw = sQ + warp * 16 * LD;
  const bf16* sdOw = sdO + warp * 16 * LD;
  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;

  for (int it = 0; it < n_tiles; ++it) {
    const int kb = kb0 + it * BK;
    const int stage = it & 1;
    if (it + 1 < n_tiles) load_tile(kb + BK, stage ^ 1);
    cp_async_commit();
    cp_async_wait<1>();                  // tile it (and Q, dO) has landed
    __syncthreads();
    const bf16* sK = sKV + stage * 2 * BK * LD;
    const bf16* sV = sK + BK * LD;

    // S = Q K^T and dP = dO V^T for the warp's 16 rows
    float s[NS][4], dp[NS][4];
    score_pair<D, NS, LD>(s, dp, sQw, sdOw, sK, sV, lane);

    // dS in place: rows r0 (e < 2), r0 + 8; keys 2t + (e & 1)
    const bool edge = kb + BK > mask.valid || (causal && kb + BK - 1 > qp_lo) ||
                      (window > 0 && kb <= qp_hi - window);
#pragma unroll
    for (int n = 0; n < NS; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = exp2f(s[n][e] * scale2 - l[e >> 1]);
        if (edge && !mask.live(qpos0 + (e >> 1) * 8, kb + n * 8 + 2 * t + (e & 1)))
          p = 0.0f;
        s[n][e] = p * (dp[n][e] - dd[e >> 1]);
      }
    }

    // dQ += dS K, dS rounded to bf16
    uint32_t da[NS / 2][4];
    to_a<NS>(da, s);
    product_rows_k<NS / 2, NO, LD>(acc, da, sK, lane);
    __syncthreads();  // this stage is refilled by the next iteration's load
  }
  cp_async_wait<0>();  // with no tile, Q's copies may still be in flight

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (r0 + 8 * r >= n_q) continue;
    bf16* qr = dq + q_off0 + (long long)(r0 + 8 * r) * q_rs + 2 * t;
#pragma unroll
    for (int n = 0; n < NO; ++n)
      *reinterpret_cast<__nv_bfloat162*>(qr + n * 8) =
          __floats2bfloat162_rn(acc[n][2 * r] * scale, acc[n][2 * r + 1] * scale);
  }
}

// KQ: q rows of a dK/dV q tile; QK: keys of a dQ key tile
template <int D, int KQ, int QK>
int launch(const bf16* q, const bf16* k, const bf16* v, const bf16* o,
           const bf16* dout, const float* lse, float* dvec, const int* kv_valid,
           int B, int T, int S, int Hq, int Hkv, int causal, int window,
           int q_offset, float scale, bf16* dq, bf16* dk, bf16* dv,
           cudaStream_t st) {
  constexpr int kv_bytes = dkdv_smem_bytes<D, KQ>();
  constexpr int q_bytes = dq_smem_bytes<D, QK>();
  static bool kv_ok = false, q_ok = false;   // attributes set once per D
  cudaError_t err = allow_smem(flash_bwd_bf16_dkdv_kernel<D, KQ>, kv_bytes, kv_ok);
  if (err == cudaSuccess)
    err = allow_smem(flash_bwd_bf16_dq_kernel<D, QK>, q_bytes, q_ok);
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
  flash_bwd_bf16_dkdv_kernel<D, KQ><<<(unsigned)kv_blocks, kThreads, kv_bytes, st>>>(
      q, k, v, dout, lse, dvec, kv_valid, T, S, Hq, Hkv, causal, window,
      q_offset, scale, dk, dv);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  flash_bwd_bf16_dq_kernel<D, QK><<<(unsigned)q_blocks, kThreads, q_bytes, st>>>(
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
      return launch<64, 64, 64>(q, k, v, o, dout, lse, dvec, kv_valid, B, T, S,
                                Hq, Hkv, causal, window, q_offset, scale, dq,
                                dk, dv, st);
    case 128:
      return launch<128, 32, 64>(q, k, v, o, dout, lse, dvec, kv_valid, B, T, S,
                                 Hq, Hkv, causal, window, q_offset, scale, dq,
                                 dk, dv, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
