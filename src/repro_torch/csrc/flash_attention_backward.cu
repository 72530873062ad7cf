// Flash-attention backward for Hopper (sm_90a), fp32 in and out: the
// gradient of csrc/flash_attention.cu's causal / sliding-window GQA
// attention with respect to q, k and v, its five products on the tensor
// cores in 3xTF32.
//
// The TPU kernel repro/kernels/attention/kernel.py `flash_attention_tpu`
// has no backward: the JAX model differentiates its jnp `flash_attention`
// (repro/nn/attention.py), a scan over KV blocks.  This kernel computes
// that gradient for the forward kernel's whole contract: causal or not,
// `window` >= 0, `q_offset` (absolute position of query 0 relative to key
// 0) and a per-row `kv_valid_len`, D in {64, 128}, Hq a multiple of Hkv,
// any T and S.  Key kp is live for the query at position qp = i + q_offset
// when kp <= qp (causal), kp > qp - window (window > 0), kp < S and
// kp < kv_valid_len[b].  A query row with no live key (its log-sum-exp is
// -inf) gets dq = 0 and gives nothing to dk, dv; a key no row sees gets
// dk = dv = 0.
// Layout: q, o, dO, dq (B, T, Hq, D); k, v, dk, dv (B, S, Hkv, D);
// lse, the forward's per-row log-sum-exp, and dvec (B, Hq, T).  Every
// tensor but lse and dvec is 16-byte aligned.
//
// Scheme: recompute from the log-sum-exp, as FlashAttention-2.
// With x = scale * q.k^T on the live keys, P = exp(x - lse):
//   dV = P^T dO,  dP = dO V^T,  dS = P * (dP - rowsum(dO * O)),
//   dQ = scale * dS K,  dK = scale * dS^T Q.
// Three kernels on one stream, no float atomics, so two calls give
// bitwise equal gradients:
// - flash_bwd_dot_kernel: dvec = rowsum(dO * O), one warp per row.
// - flash_bwd_dkdv_kernel: one block per (KV tile, kv head, batch row),
//   walking every q tile that can see the tile for all G = Hq / Hkv query
//   heads of its kv head, so the GQA sum of dK and dV stays in registers.
//   KV tiles run first to last: under causal masking the first tiles are
//   seen by the most q tiles.
// - flash_bwd_dq_kernel: one block per (q tile, q head, batch row),
//   walking the KV tiles the row tile can see; q tiles last to first.
// Fully masked tiles are skipped by the loop bounds; the mask is applied
// per element only on a tile that touches a mask edge:
//   dK/dV, KV tile [kb, kb + 64): live keys end at k_hi = min(kb + 64,
//     kv_valid_len[b], S); the rows that see one run from max(0, kb -
//     q_offset) (causal) to min(T, k_hi - 1 + window - q_offset) (window).
//   dQ, q tile [q0, q0 + n_q): keys from max(0, q0 + q_offset - window + 1)
//     (window), rounded down to a tile, to min(kv_valid_len[b], S,
//     q0 + n_q + q_offset) (causal).
// A row's -inf log-sum-exp, and a row past T, is read as +inf, so
// P = exp(x - lse) is exactly 0 there on every tile.
//
// Bound: operations.  Per live (query, key) pair the gradient needs
// 10 * D flops (q.k, dO.v, P^T dO, dS^T Q, dS K); this design does 14 * D,
// 8 * D in dK/dV (q.k, dO.v, P^T dO, dS^T Q) and 6 * D in dQ (q.k and dO.v
// again, dS K).  At qwen2-0.5b's training shape (B = 4, T = S = 4096,
// Hq = 14, Hkv = 2, D = 64, causal: 4.70e8 live pairs) 10 * D is 301
// GFLOP: 4.49 ms at 67 TFLOP/s of fp32 outside the tensor cores, 1.82 ms
// as three TF32 products each at 495 TFLOP/s (3xTF32), 2.55 ms for the
// 14 * D this design issues.  The tensors are about 0.27 GB, 0.08 ms.
//
// Design: every product is mma.sync.m16n8k8 in 3xTF32 (flash_common.cuh:
// lo*hi, hi*lo, then hi*hi into one fp32 accumulator), as in the forward.
// Blocks of 4 warps; each warp owns 16 rows of M.
// - Splits: by a count of this source about half of the instructions
//   are operand splits (each warp splits every value of the shared Q / dO
//   or K / V tile it multiplies).  They go by split_tf32_fast: the forward's
//   rounding of hi, lo = x - hi handed over as fp32 bits (rounded toward
//   zero by the tensor core), no cvt.  On an H100 that took this kernel
//   from 11.8 to 7.8 ms at the training shape, and dQ's error against
//   float64 at q (1, 2048, 14, 64) from 0.98e-6 to 1.22e-6 of its scale.
//   P = exp2(s scale log2 e - lse log2 e) by exp2f saved 0.3 ms more.
// - Sums over many tiles: the tensor cores' fp32 accumulation does not
//   round to nearest, so a long chain of mma.sync into one accumulator
//   drifts.  With dK and dV accumulated over a block's whole walk (448
//   q tiles, 10,752 mma.sync into each accumulator at the training shape)
//   dK missed float64 by 2.0e-4 of its scale on an H100, where dQ's 64
//   KV tiles kept 2.9e-6.  So each tile's dV, dK and dQ product runs from
//   0 in a partial of up to 8 n-tiles (kPartial: all of D = 64, half of
//   D = 128), and the partial joins the block's running sum by fp32 adds
//   (round to nearest).
// - dK/dV: M is the keys.  Each warp owns 16 of the tile's 64 keys and
//   computes S^T = K Q^T and dP^T = V dO^T for its keys against a q tile:
//   K's and V's rows are the A operand (split per k-step from shared
//   memory), the row-major Q and dO tiles the `col` B operand as they
//   stand.  P^T and dS^T leave the C fragment (row g: queries 2t, 2t + 1)
//   and enter the A fragment of dV += P^T dO and dK += dS^T Q (row g:
//   k-columns t, t + 4) in place, with no shuffle and no trip through
//   shared memory: k-column t of a k-step is query 2t and t + 4 is
//   query 2t + 1, and the B fragments of dO and Q read their rows in the
//   same order.  The lse and dvec of a query column are read from shared
//   memory beside the tile.
// - dQ: M is the queries, as in the forward: S = Q K^T, dP = dO V^T with
//   Q's and dO's rows as A, then dQ += dS K with dS entering the A
//   fragment in place and K read in the key order 2t, 2t + 1.  A row's
//   lse and dvec sit in registers.
// - The q tiles of dK/dV (Q, dO by 16-byte cp.async, lse, dvec by 4-byte
//   cp.async: a (b, head) row of T floats is not 16-byte aligned for
//   every T) and the K/V tiles of dQ stream through a two-stage ring in
//   shared memory, so tile j + 1 lands while tile j is multiplied; the
//   dK/dV walk runs over (query head, q tile) pairs as one sequence, so
//   the ring crosses from one head to the next.  Rows past T or S are
//   zero-filled by the copy's src-size operand.  Rows are padded to
//   D + 4 floats: every fragment load of a warp falls in 32 distinct
//   banks (rows g, columns t: 4g + t; rows 2t, columns g: 8t + g).
// - Tiles (keys BK, q rows BQ) and shared memory:
//   D = 64:  dK/dV BK = 64, BQ = 64: K, V 34.8 KB + ring 70.7 KB = 105 KB;
//            dQ    BQ = 64, BK = 64: Q, dO 34.8 KB + ring 69.6 KB = 104 KB;
//            two blocks per SM each.
//   D = 128: dK/dV BK = 64, BQ = 32: 67.6 + 68.1 KB = 136 KB;
//            dQ    BQ = 64, BK = 32: 67.6 + 67.6 KB = 135 KB; one block
//            per SM (the dK/dV accumulators of 16 keys x 128 are 128
//            registers a thread).
// Next design: wgmma.  Its tf32 form takes both operands K-major from
// shared memory, so the 3xTF32 split then needs hi and lo copies of each
// B operand in shared memory, and P^T / dS^T a trip through it; with a
// producer warp feeding the ring by TMA it would free the issue slots
// the per-use splits take here.
#include <climits>
#include <cstdint>

#include "flash_common.cuh"

namespace {

constexpr int kBwdWarps = 4;            // each owns one m16 row group
constexpr int kBwdThreads = 32 * kBwdWarps;
constexpr int kTile = 16 * kBwdWarps;   // keys of a dK/dV block, rows of dQ's
constexpr int kDotThreads = 256;
constexpr int kPartial = 8;             // n-tiles of a tile's partial sum
constexpr float kLog2e = 1.4426950408889634f;

struct Mask {   // which keys a query position sees
  int valid, causal, window;
  __device__ __forceinline__ bool live(int qp, int kp) const {
    return kp < valid && (!causal || kp <= qp) &&
           (window <= 0 || kp > qp - window);
  }
};

// a row's log-sum-exp as P = exp(x - lse) reads it: +inf for a row with no
// live key (-inf) or past T, so P is exactly 0 there
__device__ __forceinline__ float row_lse(float l, bool in_range) {
  return in_range && l != -CUDART_INF_F ? l : CUDART_INF_F;
}

// c = A B over one tile, in 3xTF32 from c = 0: A is the C fragments of
// NK score n-tiles (P^T, dS^T or dS: row g holds columns 2t, 2t + 1 of
// n-tile ks), entering the A fragment in place (k-column t of k-step ks
// is column 8 ks + 2t, t + 4 is 8 ks + 2t + 1); B is NT n-tiles from
// column 8 n0 of a row-major tile sB (row stride LD), whose rows are read
// in the same order.
template <int NK, int NT, int LD>
__device__ __forceinline__ void tile_product(float (&c)[NT][4],
                                             const float (&a)[NK][4],
                                             const float* sB, int n0, int g,
                                             int t) {
#pragma unroll
  for (int n = 0; n < NT; ++n) c[n][0] = c[n][1] = c[n][2] = c[n][3] = 0.0f;
#pragma unroll
  for (int ks = 0; ks < NK; ++ks) {
    uint32_t ah[4], al[4];
    split_tf32_fast(a[ks][0], ah[0], al[0]);
    split_tf32_fast(a[ks][2], ah[1], al[1]);
    split_tf32_fast(a[ks][1], ah[2], al[2]);
    split_tf32_fast(a[ks][3], ah[3], al[3]);
    const float* b = sB + (ks * 8 + 2 * t) * LD + n0 * 8 + g;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      uint32_t bh0, bl0, bh1, bl1;
      split_tf32_fast(b[n * 8], bh0, bl0);
      split_tf32_fast(b[LD + n * 8], bh1, bl1);
      mma_3xtf32(c[n], ah, al, bh0, bh1, bl0, bl1);
    }
  }
}

// acc += c on n-tiles n0 .. n0 + NT, by fp32 adds (round to nearest)
template <int NO, int NT>
__device__ __forceinline__ void add_partial(float (&acc)[NO][4],
                                            const float (&c)[NT][4], int n0) {
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n0 + n][e] += c[n][e];
}

template <int D>
__global__ void __launch_bounds__(kDotThreads)
flash_bwd_dot_kernel(const float* __restrict__ o, const float* __restrict__ dout,
                     long long n_rows, int T, int Hq, float* __restrict__ dvec) {
  const long long row = (long long)blockIdx.x * (kDotThreads / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= n_rows) return;
  float s = 0.0f;
#pragma unroll
  for (int d = lane; d < D; d += 32) s = fmaf(o[row * D + d], dout[row * D + d], s);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) {   // row = (b * T + t) * Hq + h  ->  dvec[(b * Hq + h) * T + t]
    const long long bt = row / Hq;
    const int h = (int)(row % Hq);
    const long long b = bt / T;
    const int t = (int)(bt % T);
    dvec[(b * Hq + h) * T + t] = s;
  }
}

template <int D, int BQ>
__host__ __device__ constexpr int dkdv_smem_floats() {
  // K and V tiles, then two stages of (Q, dO, lse, dvec)
  return 2 * kTile * (D + 4) + 2 * (2 * BQ * (D + 4) + 2 * BQ);
}

template <int D, int BQ>
__global__ void __launch_bounds__(kBwdThreads)
flash_bwd_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, const float* __restrict__ dout,
                      const float* __restrict__ lse, const float* __restrict__ dvec,
                      const int* __restrict__ kv_valid, int T, int S, int Hq,
                      int Hkv, int causal, int window, int q_offset, float scale,
                      float* __restrict__ dk, float* __restrict__ dv) {
  constexpr int BK = kTile;
  constexpr int LD = D + 4;              // row stride of every tile, floats
  constexpr int CH = D / 4;              // 16-byte chunks per row
  constexpr int NQ = BQ / 8;             // S^T n-tiles = P^T k-steps
  constexpr int NO = D / 8;              // dK/dV n-tiles = S^T k-steps
  constexpr int STAGE = 2 * BQ * LD + 2 * BQ;
  extern __shared__ __align__(16) float smem[];
  float* sK = smem;                      // BK x LD
  float* sV = sK + BK * LD;              // BK x LD
  float* ring = sV + BK * LD;            // 2 stages x (Q, dO: BQ x LD; lse, dvec: BQ)

  // blockIdx.x = (KV tiles from the first) x (batch row, kv head)
  const int n_kt = (S + BK - 1) / BK;
  const int HB = gridDim.x / n_kt;
  const int hb = blockIdx.x % HB;
  const int b = hb / Hkv, hk = hb % Hkv;
  const int kb = (int)(blockIdx.x / HB) * BK;
  const int G = Hq / Hkv;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;

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
  auto load_q_tile = [&](int it, int stage) {
    const int hq = hk * G + it / n_qt;
    const int q0 = (qt0 + it % n_qt) * BQ;
    const int n_q = min(BQ, T - q0);
    float* sQ = ring + stage * STAGE;
    float* sdO = sQ + BQ * LD;
    float* sL = sdO + BQ * LD;
    float* sDv = sL + BQ;
    const long long off0 = ((long long)b * T + q0) * q_rs + (long long)hq * D;
    for (int e = tid; e < BQ * CH; e += kBwdThreads) {
      const int i = e / CH, c = e % CH;
      const bool in = i < n_q;
      const long long off = off0 + (in ? i * q_rs : 0) + c * 4;
      cp_async16(sQ + i * LD + c * 4, q + off, in ? 16 : 0);
      cp_async16(sdO + i * LD + c * 4, dout + off, in ? 16 : 0);
    }
    const long long row = ((long long)b * Hq + hq) * T + q0;
    for (int i = tid; i < BQ; i += kBwdThreads) {
      const bool in = i < n_q;
      cp_async4(sL + i, lse + row + (in ? i : 0), in ? 4 : 0);
      cp_async4(sDv + i, dvec + row + (in ? i : 0), in ? 4 : 0);
    }
  };
  const long long kv_rs = (long long)Hkv * D;   // floats between keys
  const long long kv_off0 = (long long)b * S * kv_rs + (long long)hk * D;
  if (n_it > 0) {
    for (int e = tid; e < BK * CH; e += kBwdThreads) {
      const int j = e / CH, c = e % CH;
      const bool in = kb + j < S;
      const long long off = kv_off0 + (in ? (kb + j) * kv_rs : 0) + c * 4;
      cp_async16(sK + j * LD + c * 4, k + off, in ? 16 : 0);
      cp_async16(sV + j * LD + c * 4, v + off, in ? 16 : 0);
    }
    load_q_tile(0, 0);
  }
  cp_async_commit();                     // group 0: K, V and the first q tile

  const float* sKw = sK + warp * 16 * LD;
  const float* sVw = sV + warp * 16 * LD;
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
    const float* sQ = ring + stage * STAGE;
    const float* sdO = sQ + BQ * LD;
    const float* sL = sdO + BQ * LD;
    const float* sDv = sL + BQ;
    const int q0 = (qt0 + it % n_qt) * BQ;

    // S^T = K Q^T and dP^T = V dO^T for the warp's 16 keys
    float st[NQ][4], dpt[NQ][4];
#pragma unroll
    for (int n = 0; n < NQ; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[n][e] = dpt[n][e] = 0.0f;
#pragma unroll
    for (int ks = 0; ks < NO; ++ks) {
      uint32_t kh[4], kl[4], vh[4], vl[4];
      a_fragment<true>(sKw, LD, ks, g, t, kh, kl);
      a_fragment<true>(sVw, LD, ks, g, t, vh, vl);
#pragma unroll
      for (int n = 0; n < NQ; ++n) {
        const int at = (n * 8 + g) * LD + ks * 8 + t;
        uint32_t bh0, bl0, bh1, bl1;
        split_tf32_fast(sQ[at], bh0, bl0);
        split_tf32_fast(sQ[at + 4], bh1, bl1);
        mma_3xtf32(st[n], kh, kl, bh0, bh1, bl0, bl1);
        split_tf32_fast(sdO[at], bh0, bl0);
        split_tf32_fast(sdO[at + 4], bh1, bl1);
        mma_3xtf32(dpt[n], vh, vl, bh0, bh1, bl0, bl1);
      }
    }

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

    // dV += P^T dO, dK += dS^T Q: this tile's partials, NT n-tiles at a time
#pragma unroll
    for (int n0 = 0; n0 < NO; n0 += kPartial) {
      float part[kPartial][4];
      tile_product<NQ, kPartial, LD>(part, st, sdO, n0, g, t);
      add_partial<NO, kPartial>(acc_v, part, n0);
      tile_product<NQ, kPartial, LD>(part, dpt, sQ, n0, g, t);
      add_partial<NO, kPartial>(acc_k, part, n0);
    }
    __syncthreads();  // this stage is refilled by the next iteration's load
  }
  cp_async_wait<0>();

  // a key past the live range keeps zeros: the outputs come from torch.empty
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int kp = kp0 + 8 * r;
    if (kp >= S) continue;
    const long long at = kv_off0 + (long long)kp * kv_rs + 2 * t;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      *reinterpret_cast<float2*>(dk + at + n * 8) =
          make_float2(acc_k[n][2 * r] * scale, acc_k[n][2 * r + 1] * scale);
      *reinterpret_cast<float2*>(dv + at + n * 8) =
          make_float2(acc_v[n][2 * r], acc_v[n][2 * r + 1]);
    }
  }
}

template <int D, int BK>
__host__ __device__ constexpr int dq_smem_floats() {
  // Q and dO tiles, then two stages of (K, V)
  return 2 * kTile * (D + 4) + 2 * 2 * BK * (D + 4);
}

// one block an SM at least, named: without it ptxas aims at 168 registers
// and spills at D = 64 (3.13 against 2.87 ms on an H100)
template <int D, int BK>
__global__ void __launch_bounds__(kBwdThreads, 1)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ dvec,
                    const int* __restrict__ kv_valid, int T, int S, int Hq,
                    int Hkv, int causal, int window, int q_offset, float scale,
                    float* __restrict__ dq) {
  constexpr int BQ = kTile;
  constexpr int LD = D + 4;
  constexpr int CH = D / 4;
  constexpr int NS = BK / 8;             // score n-tiles = dS K k-steps
  constexpr int NO = D / 8;              // dQ n-tiles = score k-steps
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;                      // BQ x LD
  float* sdO = sQ + BQ * LD;             // BQ x LD
  float* sKV = sdO + BQ * LD;            // 2 stages x (K, V) x BK x LD

  // blockIdx.x = (q tiles from the last) x (batch row, q head)
  const int n_qt = (T + BQ - 1) / BQ;
  const int HB = gridDim.x / n_qt;
  const int hb = blockIdx.x % HB;
  const int b = hb / Hq, hq = hb % Hq;
  const int q0 = (n_qt - 1 - (int)(blockIdx.x / HB)) * BQ;
  const int hk = hq / (Hq / Hkv);
  const int n_q = min(BQ, T - q0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;

  // the keys any row of this tile can see: [k_begin, k_end)
  const Mask mask{kv_valid ? max(0, min(S, kv_valid[b])) : S, causal, window};
  const float scale2 = scale * kLog2e;   // P = exp2(s scale log2 e - lse log2 e)
  const int qp_lo = q_offset + q0, qp_hi = q_offset + q0 + n_q - 1;
  const int k_end = causal ? min(mask.valid, max(0, qp_hi + 1)) : mask.valid;
  const int k_begin = window > 0 ? max(0, qp_lo - window + 1) : 0;
  const int kb0 = (k_begin / BK) * BK;
  const int n_tiles = k_end > kb0 ? (k_end - kb0 + BK - 1) / BK : 0;

  const long long q_rs = (long long)Hq * D;
  const long long q_off0 = ((long long)b * T + q0) * q_rs + (long long)hq * D;
  for (int e = tid; e < BQ * CH; e += kBwdThreads) {
    const int i = e / CH, c = e % CH;
    const bool in = i < n_q;
    const long long off = q_off0 + (in ? i * q_rs : 0) + c * 4;
    cp_async16(sQ + i * LD + c * 4, q + off, in ? 16 : 0);
    cp_async16(sdO + i * LD + c * 4, dout + off, in ? 16 : 0);
  }
  const long long kv_rs = (long long)Hkv * D;
  const long long kv_off0 = (long long)b * S * kv_rs + (long long)hk * D;
  auto load_tile = [&](int kb, int stage) {
    float* sK = sKV + stage * 2 * BK * LD;
    float* sV = sK + BK * LD;
    for (int e = tid; e < BK * CH; e += kBwdThreads) {
      const int j = e / CH, c = e % CH;
      const bool in = kb + j < S;
      const long long off = kv_off0 + (in ? (kb + j) * kv_rs : 0) + c * 4;
      cp_async16(sK + j * LD + c * 4, k + off, in ? 16 : 0);
      cp_async16(sV + j * LD + c * 4, v + off, in ? 16 : 0);
    }
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
  const float* sQw = sQ + warp * 16 * LD;
  const float* sdOw = sdO + warp * 16 * LD;
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
    const float* sK = sKV + stage * 2 * BK * LD;
    const float* sV = sK + BK * LD;

    // S = Q K^T and dP = dO V^T for the warp's 16 rows
    float s[NS][4], dp[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.0f;
#pragma unroll
    for (int ks = 0; ks < NO; ++ks) {
      uint32_t qh[4], ql[4], oh[4], ol[4];
      a_fragment<true>(sQw, LD, ks, g, t, qh, ql);
      a_fragment<true>(sdOw, LD, ks, g, t, oh, ol);
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        const int at = (n * 8 + g) * LD + ks * 8 + t;
        uint32_t bh0, bl0, bh1, bl1;
        split_tf32_fast(sK[at], bh0, bl0);
        split_tf32_fast(sK[at + 4], bh1, bl1);
        mma_3xtf32(s[n], qh, ql, bh0, bh1, bl0, bl1);
        split_tf32_fast(sV[at], bh0, bl0);
        split_tf32_fast(sV[at + 4], bh1, bl1);
        mma_3xtf32(dp[n], oh, ol, bh0, bh1, bl0, bl1);
      }
    }

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

    // dQ += dS K: this tile's partial, NT n-tiles at a time
#pragma unroll
    for (int n0 = 0; n0 < NO; n0 += kPartial) {
      float part[kPartial][4];
      tile_product<NS, kPartial, LD>(part, s, sK, n0, g, t);
      add_partial<NO, kPartial>(acc, part, n0);
    }
    __syncthreads();  // this stage is refilled by the next iteration's load
  }
  cp_async_wait<0>();  // with no tile, Q's copies may still be in flight

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (r0 + 8 * r >= n_q) continue;
    float* qr = dq + q_off0 + (long long)(r0 + 8 * r) * q_rs + 2 * t;
#pragma unroll
    for (int n = 0; n < NO; ++n)
      *reinterpret_cast<float2*>(qr + n * 8) =
          make_float2(acc[n][2 * r] * scale, acc[n][2 * r + 1] * scale);
  }
}

template <typename K>
cudaError_t allow_smem(K kernel, int bytes, bool& configured) {
  if (configured) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  configured = err == cudaSuccess;
  return err;
}

// KQ: q rows of a dK/dV q tile; QK: keys of a dQ KV tile
template <int D, int KQ, int QK>
int launch(const float* q, const float* k, const float* v, const float* o,
           const float* dout, const float* lse, float* dvec,
           const int* kv_valid, int B, int T, int S, int Hq, int Hkv,
           int causal, int window, int q_offset, float scale, float* dq,
           float* dk, float* dv, cudaStream_t st) {
  constexpr int kv_bytes = dkdv_smem_floats<D, KQ>() * (int)sizeof(float);
  constexpr int q_bytes = dq_smem_floats<D, QK>() * (int)sizeof(float);
  static bool kv_ok = false, q_ok = false;   // attributes set once per D
  cudaError_t err = allow_smem(flash_bwd_dkdv_kernel<D, KQ>, kv_bytes, kv_ok);
  if (err == cudaSuccess)
    err = allow_smem(flash_bwd_dq_kernel<D, QK>, q_bytes, q_ok);
  if (err != cudaSuccess) return (int)err;

  const long long rows = (long long)B * T * Hq;
  const long long dot_blocks = (rows + kDotThreads / 32 - 1) / (kDotThreads / 32);
  const long long kv_blocks = (long long)((S + kTile - 1) / kTile) * Hkv * B;
  const long long q_blocks = (long long)((T + kTile - 1) / kTile) * Hq * B;
  if (dot_blocks > INT_MAX || kv_blocks > INT_MAX || q_blocks > INT_MAX)
    return (int)cudaErrorInvalidValue;
  flash_bwd_dot_kernel<D><<<(unsigned)dot_blocks, kDotThreads, 0, st>>>(
      o, dout, rows, T, Hq, dvec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dkdv_kernel<D, KQ><<<(unsigned)kv_blocks, kBwdThreads, kv_bytes, st>>>(
      q, k, v, dout, lse, dvec, kv_valid, T, S, Hq, Hkv, causal, window,
      q_offset, scale, dk, dv);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dq_kernel<D, QK><<<(unsigned)q_blocks, kBwdThreads, q_bytes, st>>>(
      q, k, v, dout, lse, dvec, kv_valid, T, S, Hq, Hkv, causal, window,
      q_offset, scale, dq);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int flash_attention_backward_launch(
    const float* q, const float* k, const float* v, const float* o,
    const float* dout, const float* lse, float* dvec, const int* kv_valid,
    int B, int T, int S, int Hq, int Hkv, int D, int causal, int window,
    int q_offset, float scale, float* dq, float* dk, float* dv, void* stream) {
  if (B < 1 || T < 1 || S < 1 || Hkv < 1 || Hq < Hkv || Hq % Hkv)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return launch<64, 64, 64>(q, k, v, o, dout, lse, dvec, kv_valid, B, T,
                                S, Hq, Hkv, causal, window, q_offset, scale,
                                dq, dk, dv, st);
    case 128:
      return launch<128, 32, 32>(q, k, v, o, dout, lse, dvec, kv_valid, B, T,
                                 S, Hq, Hkv, causal, window, q_offset, scale,
                                 dq, dk, dv, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
