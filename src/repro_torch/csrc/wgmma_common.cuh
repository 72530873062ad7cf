// Shared by the bf16 flash attention (flash_attention_bf16.cu) and its
// backward (flash_attention_backward_bf16.cu): tiles of 64 rows in wgmma's
// canonical 128-byte-swizzled layout, their shared-memory descriptors, the
// two wgmma forms both kernels issue, the fences around them, and the
// 16-byte asynchronous copy of one tile by one warpgroup.
//
// A row of D bf16 is D / 64 panels of 128 bytes; a panel of 64 rows is
// 8 KB, and the 16-byte chunk c of row r sits at chunk c ^ (r % 8) of its
// panel.  The same tile serves as a K-major operand (a product whose K
// runs along the row: descriptor strides 16 / 1024, a k-step 32 bytes
// further inside the swizzle atom, then a panel) and as an MN-major B
// operand read with the transpose bit (a product whose K runs down the
// rows: strides panel / 1024, a k-step of 16 rows 2 KB further).
#pragma once

#include <cstdint>

#include "kernels_common.cuh"

constexpr int kWarpgroup = 128;          // threads of one warpgroup
constexpr int kPanelBytes = 64 * 128;    // 64 rows of one 128-byte panel

// bytes of a 64-row tile of D bf16
template <int D>
__host__ __device__ constexpr int tile_bytes() { return (D / 64) * kPanelBytes; }

// byte offset of 16-byte chunk c (of D / 8) of row r in a swizzled tile
__device__ __forceinline__ uint32_t sw(int r, int c) {
  return (c >> 3) * kPanelBytes + r * 128 + (((c & 7) ^ (r & 7)) << 4);
}

// a wgmma shared-memory descriptor: 128-byte swizzle, start address and
// the two strides in 16-byte units
__device__ __forceinline__ uint64_t desc(uint32_t saddr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

// k-step ks of a K-major tile: 32 bytes into panel ks / 4
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int ks) {
  return desc(tile + (ks >> 2) * kPanelBytes + (ks & 3) * 32, 16, 1024);
}
// k-step kk of an MN-major tile: rows 16 kk .. 16 kk + 15
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int kk) {
  return desc(tile + kk * 2048, kPanelBytes, 1024);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keeps the compiler from moving accumulator reads or writes across the
// asynchronous product's start and its wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
// the same for register A operands (K-steps of 4 registers), which the
// product reads while it runs: kept live, their registers unused by
// anything else, until the wait
template <int K>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[K][4]) {
#pragma unroll
  for (int i = 0; i < 4 * K; ++i) asm volatile("" : "+r"(r[i / 4][i % 4])::"memory");
}
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

#define F8(i)                                                        \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),        \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

#define R32                                                                  \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"
#define R64                                                                  \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "  \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "  \
  "%58, %59, %60, %61, %62, %63}"

// d (64 x 64, fp32) = A.B (+ d if acc), A and B K-major in shared memory
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a, uint64_t b,
                                             int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " R32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : F8(0), F8(8), F8(16), F8(24)
      : "l"(a), "l"(b), "r"(acc));
}

// d (64 x N, fp32) += A.B, A (64 x 16 bf16) in registers, B MN-major in
// shared memory (transpose bit set)
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " R32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : F8(0), F8(8), F8(16), F8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4],
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " R64
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : F8(0), F8(8), F8(16), F8(24), F8(32), F8(40), F8(48), F8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

#undef F8
#undef R32
#undef R64

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// A thread's share of the copies of one 64-row tile by a warpgroup:
// 16-byte chunk c of rows r0, r0 + kStep, ...: kCopies of them, kStep a
// multiple of 8, so the swizzle of every one is that of r0 and the j-th
// lands j * kStep rows past the first.
template <int D>
struct TileCopy {
  static constexpr int kCh = D / 8;                    // chunks a row
  static constexpr int kStep = kWarpgroup / kCh;       // rows between copies
  static constexpr int kCopies = 64 / kStep;
  int r0;            // first row
  uint32_t smem;     // its byte offset in a tile
  long long gmem;    // its element offset from the tile's first row
  __device__ TileCopy(int tid, long long stride) {
    const int c = tid % kCh;
    r0 = tid / kCh;
    smem = sw(r0, c);
    gmem = r0 * stride + c * 8;
  }
  // rows [0, n_live) of the tile at src (rows `stride` apart), the rest
  // zero-filled
  __device__ __forceinline__ void load(unsigned char* dst, const __nv_bfloat16* src,
                                       long long stride, int n_live) const {
#pragma unroll
    for (int j = 0; j < kCopies; ++j) {
      const bool live = r0 + j * kStep < n_live;
      cp_async16(dst + smem + j * kStep * 128,
                 src + (live ? gmem + j * kStep * stride : 0), live ? 16 : 0);
    }
  }
};
