// Flash-attention backward for Hopper (sm_90a), fp32 in and out: the
// gradient of csrc/flash_attention.cu's causal / sliding-window GQA
// attention with respect to q, k and v.
//
// The TPU kernel repro/kernels/attention/kernel.py `flash_attention_tpu`
// has no backward: the JAX model differentiates its jnp `flash_attention`
// (repro/nn/attention.py), a scan over KV blocks.  This kernel computes
// that gradient for the contract the training path uses: causal or not,
// `window` >= 0, D in {64, 128}, Hq a multiple of Hkv, any T and S, no
// q_offset and no kv_valid_len (the wrapper refuses them).
// Layout: q, o, dO, dq (B, T, Hq, D); k, v, dk, dv (B, S, Hkv, D);
// lse, the forward's per-row log-sum-exp, and dvec (B, Hq, T).
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
// Fully masked tiles are skipped by the loop bounds (the window's first
// live tile, the causal diagonal); the mask is applied per element.
//
// Bound: operations.  Per live (query, key) pair the dK/dV kernel does
// 8 * D flops (q.k, dO.v, P^T dO, dS^T Q) and the dQ kernel 6 * D (q.k
// and dO.v again, dS K): 14 * D in all, against the 10 * D the gradient
// needs (the bound counts 10 * D).  At qwen2-0.5b's training shape
// (B = 4, T = S = 4096, Hq = 14, Hkv = 2, D = 64, causal) that is 301
// GFLOP, 4.49 ms at 67 TFLOP/s of fp32 outside the tensor cores.
//
// Design: fp32 SIMT products.  A block of 256 threads is a 16 x 16 grid;
// every product is C[m][n] += sum_k A[k][m] * B[k][n] with both operands
// k-major in shared memory, each thread owning a contiguous (TM x TN)
// block of C and reading its TM and TN operands as 16- or 8-byte vectors
// (one A vector shared by a warp's 16 lanes of a row, the B vectors of the
// 16 lanes contiguous).  So Q and dO sit in shared memory twice, row-major
// (for dK = dS^T Q, dV = P^T dO) and transposed (for q.k and dO.v); K and V
// transposed, and K row-major too in the dQ kernel.  Rows past T or S are
// zero-filled.  Tiles (q rows BQ, keys BK):
//   D = 64:  dK/dV BQ = BK = 64, 140 KB of shared memory, one block/SM;
//            dQ    BQ = BK = 64, 104 KB, two blocks/SM.
//   D = 128: dK/dV BQ = 32, BK = 64, 158 KB; dQ BQ = 64, BK = 32, 132 KB.
// Tensor cores (3xTF32 mma.sync, as in the forward) are later work.
#include <climits>

#include "kernels_common.cuh"

namespace {

constexpr int kBwdThreads = 256;   // a 16 x 16 grid of threads

template <int N>
__device__ __forceinline__ void load_vec(float (&r)[N], const float* p) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int u = 0; u < N / 4; ++u) {
      const float4 t = reinterpret_cast<const float4*>(p)[u];
      r[4 * u] = t.x;
      r[4 * u + 1] = t.y;
      r[4 * u + 2] = t.z;
      r[4 * u + 3] = t.w;
    }
  } else {
    static_assert(N == 2, "vectors of 2, 4 or 8 floats");
    const float2 t = *reinterpret_cast<const float2*>(p);
    r[0] = t.x;
    r[1] = t.y;
  }
}

// c[i][j] += sum over k < KD of A[k * lda + m0 + i] * B[k * ldb + n0 + j]
template <int TM, int TN, int KD>
__device__ __forceinline__ void outer_acc(float (&c)[TM][TN], const float* A,
                                          int lda, int m0, const float* B,
                                          int ldb, int n0) {
#pragma unroll 4
  for (int k = 0; k < KD; ++k) {
    float a[TM], b[TN];
    load_vec<TM>(a, A + k * lda + m0);
    load_vec<TN>(b, B + k * ldb + n0);
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) c[i][j] = fmaf(a[i], b[j], c[i][j]);
  }
}

// R rows of D floats, `rs` floats apart, into shared memory: row-major
// (rm[i][d], row stride D + 4) and / or transposed (tr[d][i], row stride
// R + 4); rows at or past n_rows are zero.
template <int R, int D, bool ROW, bool TR>
__device__ __forceinline__ void load_rows(const float* src, long long rs,
                                          int n_rows, float* rm, float* tr) {
  constexpr int CH = D / 4;
  for (int e = threadIdx.x; e < R * CH; e += kBwdThreads) {
    const int i = e / CH, c = e % CH;
    float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (i < n_rows) v = *reinterpret_cast<const float4*>(src + i * rs + c * 4);
    if constexpr (ROW) *reinterpret_cast<float4*>(rm + i * (D + 4) + c * 4) = v;
    if constexpr (TR) {
      float* t = tr + (c * 4) * (R + 4) + i;
      t[0] = v.x;
      t[R + 4] = v.y;
      t[2 * (R + 4)] = v.z;
      t[3 * (R + 4)] = v.w;
    }
  }
}

__device__ __forceinline__ bool live(int qp, int kp, int T, int S, int causal,
                                     int window) {
  return qp < T && kp < S && (!causal || kp <= qp) &&
         (window <= 0 || kp > qp - window);
}

template <int D>
__global__ void __launch_bounds__(kBwdThreads)
flash_bwd_dot_kernel(const float* __restrict__ o, const float* __restrict__ dout,
                     long long n_rows, int T, int Hq, float* __restrict__ dvec) {
  const long long row = (long long)blockIdx.x * (kBwdThreads / 32) + (threadIdx.x >> 5);
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

template <int D, int BQ, int BK>
__host__ __device__ constexpr int dkdv_smem_floats() {
  return 2 * D * (BK + 4) + 2 * D * (BQ + 4) + 2 * BQ * (D + 4) +
         2 * BQ * (BK + 4) + 2 * BQ;
}

template <int D, int BQ, int BK>
__global__ void __launch_bounds__(kBwdThreads)
flash_bwd_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, const float* __restrict__ dout,
                      const float* __restrict__ lse, const float* __restrict__ dvec,
                      int T, int S, int Hq, int Hkv, int causal, int window,
                      float scale, float* __restrict__ dk, float* __restrict__ dv) {
  constexpr int LQ = BQ + 4, LK = BK + 4, LD = D + 4;
  constexpr int SM = BQ / 16, SN = BK / 16;   // a thread's block of P, dS
  constexpr int AM = BK / 16, AN = D / 16;    // a thread's block of dK, dV
  extern __shared__ __align__(16) float smem[];
  float* sKt = smem;                 // D x LK
  float* sVt = sKt + D * LK;         // D x LK
  float* sQt = sVt + D * LK;         // D x LQ
  float* sdOt = sQt + D * LQ;        // D x LQ
  float* sQ = sdOt + D * LQ;         // BQ x LD
  float* sdO = sQ + BQ * LD;         // BQ x LD
  float* sP = sdO + BQ * LD;         // BQ x LK
  float* sdS = sP + BQ * LK;         // BQ x LK
  float* sL = sdS + BQ * LK;         // BQ
  float* sDv = sL + BQ;              // BQ

  // blockIdx.x = (KV tiles from the first) x (batch row, kv head)
  const int n_kt = (S + BK - 1) / BK;
  const int HB = gridDim.x / n_kt;
  const int hb = blockIdx.x % HB;
  const int b = hb / Hkv, hk = hb % Hkv;
  const int kb = (int)(blockIdx.x / HB) * BK;
  const int n_k = min(BK, S - kb);
  const int G = Hq / Hkv;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;

  const long long kv_rs = (long long)Hkv * D;
  const long long kv_off = ((long long)b * S + kb) * kv_rs + (long long)hk * D;
  load_rows<BK, D, false, true>(k + kv_off, kv_rs, n_k, nullptr, sKt);
  load_rows<BK, D, false, true>(v + kv_off, kv_rs, n_k, nullptr, sVt);

  // the query rows that see a key of this tile: [q_lo, q_hi)
  const int q_lo = causal ? kb : 0;
  const int q_hi = window > 0 ? min(T, kb + n_k - 1 + window) : T;
  const int qt_end = q_hi > q_lo ? (q_hi + BQ - 1) / BQ : 0;

  float acc_k[AM][AN], acc_v[AM][AN];
#pragma unroll
  for (int r = 0; r < AM; ++r)
#pragma unroll
    for (int c = 0; c < AN; ++c) acc_k[r][c] = acc_v[r][c] = 0.0f;

  const long long q_rs = (long long)Hq * D;
  for (int gi = 0; gi < G; ++gi) {
    const int hq = hk * G + gi;
    const float* lrow = lse + ((long long)b * Hq + hq) * T;
    const float* drow = dvec + ((long long)b * Hq + hq) * T;
    for (int qt = q_lo / BQ; qt < qt_end; ++qt) {
      const int q0 = qt * BQ, n_q = min(BQ, T - q0);
      __syncthreads();               // the last tile's reads are done
      const long long q_off = ((long long)b * T + q0) * q_rs + (long long)hq * D;
      load_rows<BQ, D, true, true>(q + q_off, q_rs, n_q, sQ, sQt);
      load_rows<BQ, D, true, true>(dout + q_off, q_rs, n_q, sdO, sdOt);
      for (int i = tid; i < BQ; i += kBwdThreads) {
        sL[i] = i < n_q ? lrow[q0 + i] : 0.0f;
        sDv[i] = i < n_q ? drow[q0 + i] : 0.0f;
      }
      __syncthreads();

      float s[SM][SN], dp[SM][SN];
#pragma unroll
      for (int r = 0; r < SM; ++r)
#pragma unroll
        for (int c = 0; c < SN; ++c) s[r][c] = dp[r][c] = 0.0f;
      outer_acc<SM, SN, D>(s, sQt, LQ, ty * SM, sKt, LK, tx * SN);
      outer_acc<SM, SN, D>(dp, sdOt, LQ, ty * SM, sVt, LK, tx * SN);
#pragma unroll
      for (int r = 0; r < SM; ++r) {
        const int i = ty * SM + r;
#pragma unroll
        for (int c = 0; c < SN; ++c) {
          const int j = tx * SN + c;
          const float p = live(q0 + i, kb + j, T, S, causal, window)
                              ? expf(s[r][c] * scale - sL[i]) : 0.0f;
          sP[i * LK + j] = p;
          sdS[i * LK + j] = p * (dp[r][c] - sDv[i]);
        }
      }
      __syncthreads();
      outer_acc<AM, AN, BQ>(acc_v, sP, LK, ty * AM, sdO, LD, tx * AN);
      outer_acc<AM, AN, BQ>(acc_k, sdS, LK, ty * AM, sQ, LD, tx * AN);
    }
  }

#pragma unroll
  for (int r = 0; r < AM; ++r) {
    const int j = ty * AM + r;
    if (j >= n_k) continue;
    float* kr = dk + kv_off + (long long)j * kv_rs + tx * AN;
    float* vr = dv + kv_off + (long long)j * kv_rs + tx * AN;
#pragma unroll
    for (int c = 0; c < AN; c += 4) {
      *reinterpret_cast<float4*>(kr + c) =
          make_float4(acc_k[r][c] * scale, acc_k[r][c + 1] * scale,
                      acc_k[r][c + 2] * scale, acc_k[r][c + 3] * scale);
      *reinterpret_cast<float4*>(vr + c) =
          make_float4(acc_v[r][c], acc_v[r][c + 1], acc_v[r][c + 2], acc_v[r][c + 3]);
    }
  }
}

template <int D, int BQ, int BK>
__host__ __device__ constexpr int dq_smem_floats() {
  return 2 * D * (BQ + 4) + 2 * D * (BK + 4) + BK * (D + 4) + BK * (BQ + 4);
}

template <int D, int BQ, int BK>
__global__ void __launch_bounds__(kBwdThreads)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ dvec,
                    int T, int S, int Hq, int Hkv, int causal, int window,
                    float scale, float* __restrict__ dq) {
  constexpr int LQ = BQ + 4, LK = BK + 4, LD = D + 4;
  constexpr int SM = BQ / 16, SN = BK / 16;   // a thread's block of P, dS
  constexpr int AN = D / 16;                  // and of dQ: SM x AN
  extern __shared__ __align__(16) float smem[];
  float* sQt = smem;                 // D x LQ
  float* sdOt = sQt + D * LQ;        // D x LQ
  float* sKt = sdOt + D * LQ;        // D x LK
  float* sVt = sKt + D * LK;         // D x LK
  float* sK = sVt + D * LK;          // BK x LD
  float* sdSt = sK + BK * LD;        // BK x LQ

  // blockIdx.x = (q tiles from the last) x (batch row, q head)
  const int n_qt = (T + BQ - 1) / BQ;
  const int HB = gridDim.x / n_qt;
  const int hb = blockIdx.x % HB;
  const int b = hb / Hq, hq = hb % Hq;
  const int q0 = (n_qt - 1 - (int)(blockIdx.x / HB)) * BQ;
  const int hk = hq / (Hq / Hkv);
  const int n_q = min(BQ, T - q0);
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;

  const long long q_rs = (long long)Hq * D;
  const long long q_off = ((long long)b * T + q0) * q_rs + (long long)hq * D;
  load_rows<BQ, D, false, true>(q + q_off, q_rs, n_q, nullptr, sQt);
  load_rows<BQ, D, false, true>(dout + q_off, q_rs, n_q, nullptr, sdOt);
  float lr[SM], dr[SM];
#pragma unroll
  for (int r = 0; r < SM; ++r) {
    const int i = ty * SM + r;
    const long long at = ((long long)b * Hq + hq) * T + q0 + i;
    lr[r] = i < n_q ? lse[at] : 0.0f;
    dr[r] = i < n_q ? dvec[at] : 0.0f;
  }

  // the keys any row of this tile can see: [k_begin, k_end)
  const int k_end = causal ? min(S, q0 + n_q) : S;
  const int k_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  float acc[SM][AN];
#pragma unroll
  for (int r = 0; r < SM; ++r)
#pragma unroll
    for (int c = 0; c < AN; ++c) acc[r][c] = 0.0f;

  const long long kv_rs = (long long)Hkv * D;
  for (int kb = (k_begin / BK) * BK; kb < k_end; kb += BK) {
    const int n_k = min(BK, S - kb);
    __syncthreads();                 // the last tile's reads are done
    const long long kv_off = ((long long)b * S + kb) * kv_rs + (long long)hk * D;
    load_rows<BK, D, true, true>(k + kv_off, kv_rs, n_k, sK, sKt);
    load_rows<BK, D, false, true>(v + kv_off, kv_rs, n_k, nullptr, sVt);
    __syncthreads();

    float s[SM][SN], dp[SM][SN];
#pragma unroll
    for (int r = 0; r < SM; ++r)
#pragma unroll
      for (int c = 0; c < SN; ++c) s[r][c] = dp[r][c] = 0.0f;
    outer_acc<SM, SN, D>(s, sQt, LQ, ty * SM, sKt, LK, tx * SN);
    outer_acc<SM, SN, D>(dp, sdOt, LQ, ty * SM, sVt, LK, tx * SN);
#pragma unroll
    for (int r = 0; r < SM; ++r) {
      const int i = ty * SM + r;
#pragma unroll
      for (int c = 0; c < SN; ++c) {
        const int j = tx * SN + c;
        const float p = live(q0 + i, kb + j, T, S, causal, window)
                            ? expf(s[r][c] * scale - lr[r]) : 0.0f;
        sdSt[j * LQ + i] = p * (dp[r][c] - dr[r]);
      }
    }
    __syncthreads();
    outer_acc<SM, AN, BK>(acc, sdSt, LQ, ty * SM, sK, LD, tx * AN);
  }

#pragma unroll
  for (int r = 0; r < SM; ++r) {
    const int i = ty * SM + r;
    if (i >= n_q) continue;
    float* qr = dq + q_off + (long long)i * q_rs + tx * AN;
#pragma unroll
    for (int c = 0; c < AN; c += 4)
      *reinterpret_cast<float4*>(qr + c) =
          make_float4(acc[r][c] * scale, acc[r][c + 1] * scale,
                      acc[r][c + 2] * scale, acc[r][c + 3] * scale);
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

template <int D, int KQ, int KK, int QQ, int QK>
int launch(const float* q, const float* k, const float* v, const float* o,
           const float* dout, const float* lse, float* dvec, int B, int T,
           int S, int Hq, int Hkv, int causal, int window, float scale,
           float* dq, float* dk, float* dv, cudaStream_t st) {
  constexpr int kv_bytes = dkdv_smem_floats<D, KQ, KK>() * (int)sizeof(float);
  constexpr int q_bytes = dq_smem_floats<D, QQ, QK>() * (int)sizeof(float);
  static bool kv_ok = false, q_ok = false;   // attributes set once per D
  cudaError_t err = allow_smem(flash_bwd_dkdv_kernel<D, KQ, KK>, kv_bytes, kv_ok);
  if (err == cudaSuccess)
    err = allow_smem(flash_bwd_dq_kernel<D, QQ, QK>, q_bytes, q_ok);
  if (err != cudaSuccess) return (int)err;

  const long long rows = (long long)B * T * Hq;
  const long long dot_blocks = (rows + kBwdThreads / 32 - 1) / (kBwdThreads / 32);
  const long long kv_blocks = (long long)((S + KK - 1) / KK) * Hkv * B;
  const long long q_blocks = (long long)((T + QQ - 1) / QQ) * Hq * B;
  if (dot_blocks > INT_MAX || kv_blocks > INT_MAX || q_blocks > INT_MAX)
    return (int)cudaErrorInvalidValue;
  flash_bwd_dot_kernel<D><<<(unsigned)dot_blocks, kBwdThreads, 0, st>>>(
      o, dout, rows, T, Hq, dvec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dkdv_kernel<D, KQ, KK><<<(unsigned)kv_blocks, kBwdThreads, kv_bytes, st>>>(
      q, k, v, dout, lse, dvec, T, S, Hq, Hkv, causal, window, scale, dk, dv);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dq_kernel<D, QQ, QK><<<(unsigned)q_blocks, kBwdThreads, q_bytes, st>>>(
      q, k, v, dout, lse, dvec, T, S, Hq, Hkv, causal, window, scale, dq);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int flash_attention_backward_launch(
    const float* q, const float* k, const float* v, const float* o,
    const float* dout, const float* lse, float* dvec, int B, int T, int S,
    int Hq, int Hkv, int D, int causal, int window, float scale, float* dq,
    float* dk, float* dv, void* stream) {
  if (B < 1 || T < 1 || S < 1 || Hkv < 1 || Hq < Hkv || Hq % Hkv)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return launch<64, 64, 64, 64, 64>(q, k, v, o, dout, lse, dvec, B, T, S,
                                        Hq, Hkv, causal, window, scale, dq,
                                        dk, dv, st);
    case 128:
      return launch<128, 32, 64, 64, 32>(q, k, v, o, dout, lse, dvec, B, T, S,
                                         Hq, Hkv, causal, window, scale, dq,
                                         dk, dv, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
