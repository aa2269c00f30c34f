// K3's Hopper building blocks, shared by the bf16 forward
// (flash_attention.cu) and the bf16 backward (flash_attention_bwd.cu):
// cp.async tile loads into the swizzled shared-memory layout that wgmma's
// descriptors name, the wgmma products on 64-row tiles, and the register
// helpers around them.
//
// Every operand tile is 64 rows (wgmma's M, and the kernels' token tile) by
// D bf16 columns.  Columns sit in atoms of 64 (128-byte rows, 128-byte
// swizzle) when D is a multiple of 64, else of 32 (64-byte rows, 64-byte
// swizzle), so D = 96 is three atoms.  One layout serves both the K-major
// and the MN-major reads.  The m64 accumulator's per-warp layout is
// mma.m16n8's C layout: thread (warp w, lane 4 g + t) holds rows 16 w + g
// and 16 w + g + 8, and acc[4 j + e] is column 8 j + 2 t + (e & 1) of the
// first row (e < 2) or the second (e >= 2); that is also the A operand's
// register layout, so an accumulator rounded to bf16 is an A operand.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWgThreads = 128;  // one warpgroup
constexpr int kRows = 64;        // rows per tile: wgmma's M, and the tiles' T
constexpr float kLog2e = 1.4426950408889634f;

// the swizzled layout of a 64 x D bf16 tile
template <int D>
struct Tile {
  static constexpr int kAtom = D % 64 == 0 ? 64 : 32;
  static constexpr uint64_t kSwizzle = kAtom == 64 ? 1 : 2;  // 128 B, 64 B
  static constexpr int kRowBytes = kAtom * 2;
  static constexpr int kGroupBytes = 8 * kRowBytes;  // 8 rows: one pattern
  static constexpr int kAtomBytes = kRows * kRowBytes;
  static constexpr int kTileBytes = kRows * D * 2;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// --- cp.async ---------------------------------------------------------------

__device__ __forceinline__ void cp_async16(uint32_t s, const void* g) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(g)
               : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t s, const void* g) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(g)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// shared-memory writes of the generic proxy (cp.async, st.shared) made
// visible to wgmma's reads, which go through the async proxy
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// A 64 x D bf16 tile from global rows of stride `st` into the swizzled
// layout at shared address `s`, by the warpgroup's thread `tid`: atom column
// c holds columns c*kAtom.. as 64 rows of kRowBytes, and 16-byte chunk j of
// row r sits at chunk j ^ (r % 8) (128-byte swizzle) or j ^ ((r / 2) % 4)
// (64-byte swizzle).  When D is a power of two, the threads cover whole rows
// and a multiple of 8 rows at a time, so a thread's chunk keeps its column
// and its swizzle from one pass to the next: one source pointer and one
// shared address serve every pass, with constant steps.
template <int D>
__device__ __forceinline__ void load_tile(uint32_t s, const uint16_t* g,
                                          long long st, int tid) {
  using C = Tile<D>;
  constexpr int kChunks = D / 8;  // 16-byte chunks per row
  constexpr int kPerAtom = C::kAtom / 8;
  auto dst = [](int r, int c) {
    const int x = C::kAtom == 64 ? (r & 7) : ((r >> 1) & 3);
    return (c / kPerAtom) * C::kAtomBytes + r * C::kRowBytes +
           (((c % kPerAtom) ^ x) << 4);
  };
  static_assert(kRows * kChunks % kWgThreads == 0, "whole passes");
  if constexpr (kWgThreads % kChunks == 0) {
    constexpr int kStep = kWgThreads / kChunks;  // rows per pass
    static_assert(kStep % 8 == 0, "a pass keeps the swizzle");
    const int r = tid / kChunks, c = tid % kChunks;
    const uint32_t d = s + dst(r, c);
    const uint16_t* src = g + r * st + c * 8;
#pragma unroll
    for (int it = 0; it < kRows / kStep; ++it) {
      cp_async16(d + it * kStep * C::kRowBytes, src + it * kStep * st);
    }
  } else {
#pragma unroll
    for (int it = 0; it < kRows * kChunks / kWgThreads; ++it) {
      const int i = tid + it * kWgThreads;
      const int r = i / kChunks, c = i % kChunks;
      cp_async16(s + dst(r, c), g + r * st + c * 8);
    }
  }
}

// --- wgmma ------------------------------------------------------------------

// shared-memory matrix descriptor: start address, leading and stride byte
// offsets (16-byte units), swizzle mode; every start address used here has
// address bits 7-9 clear within its pattern, so the base offset is 0
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint64_t swizzle) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (swizzle << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving accesses of an accumulator across the
// wgmma fence, commit and wait around it
template <int N>
__device__ __forceinline__ void pin(float* d) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]));
}

// the same for A fragments in registers, which a product in flight reads
template <int N>
__device__ __forceinline__ void pin_u32(uint32_t* a) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(a[i]));
}

#define BF_ACC4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define BF_ACC16(i) BF_ACC4(i), BF_ACC4(i + 4), BF_ACC4(i + 8), BF_ACC4(i + 12)

// D[64 x 64] (+)= A[64 x 16] B[16 x 64]; A and B from shared memory, both
// K-major
__device__ __forceinline__ void wgmma_ss_n64(float* d, uint64_t da,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : BF_ACC16(0), BF_ACC16(16)
      : "l"(da), "l"(db), "r"(accumulate));
}

// D[64 x 64] += A[64 x 16] B[16 x 64]; A from registers, B from shared
// memory, MN-major
__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t* a,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : BF_ACC16(0), BF_ACC16(16)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D[64 x 32] += A[64 x 16] B[16 x 32]; as wgmma_rs_n64
__device__ __forceinline__ void wgmma_rs_n32(float* d, const uint32_t* a,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : BF_ACC16(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef BF_ACC16
#undef BF_ACC4

// acc[64 x 64] = A B^T over D: A and B the 64 x D tiles at shared addresses
// sa and sb (rows of A are acc's rows, rows of B its columns), K-major
template <int D>
__device__ __forceinline__ void mma_abt(float* acc, uint32_t sa,
                                        uint32_t sb) {
  using C = Tile<D>;
  // the start address is the descriptor's low field: each k step adds its
  // offset there
  const uint64_t da = make_desc(sa, 16, C::kGroupBytes, C::kSwizzle);
  const uint64_t db = make_desc(sb, 16, C::kGroupBytes, C::kSwizzle);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off =
        (kk * 16 / C::kAtom) * C::kAtomBytes + (kk * 16 % C::kAtom) * 2;
    wgmma_ss_n64(acc, da + (off >> 4), db + (off >> 4), kk > 0);
  }
}

// acc[64 x D] += A B: A[64 x 64] in registers (a[4 kk..] for rows 16 kk..
// of B), B the 64 x D tile at shared address sb, MN-major: one instruction
// per k step and atom column.  The leading offset is the atom-column stride
// of a wider B, unused with one atom per instruction; set like the stride
// offset so that either field reading holds.
template <int D>
__device__ __forceinline__ void mma_ab(float* acc, const uint32_t* a,
                                       uint32_t sb) {
  using C = Tile<D>;
  const uint64_t db0 =
      make_desc(sb, C::kGroupBytes, C::kGroupBytes, C::kSwizzle);
#pragma unroll
  for (int kk = 0; kk < kRows / 16; ++kk) {
#pragma unroll
    for (int c = 0; c < D / C::kAtom; ++c) {
      const uint64_t db =
          db0 + ((c * C::kAtomBytes + kk * 2 * C::kGroupBytes) >> 4);
      if constexpr (C::kAtom == 64) {
        wgmma_rs_n64(acc + c * 32, a + 4 * kk, db);
      } else {
        wgmma_rs_n32(acc + c * 16, a + 4 * kk, db);
      }
    }
  }
}

// --- registers --------------------------------------------------------------

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// the A operand of a 64 x 64 product from a 64 x 64 accumulator, rounded to
// bf16: k step kk takes the accumulator's n8 blocks 2 kk and 2 kk + 1
__device__ __forceinline__ void acc_to_a(uint32_t* a, const float* acc) {
#pragma unroll
  for (int i = 0; i < 16; ++i) a[i] = pack_bf16(acc[2 * i], acc[2 * i + 1]);
}

// accumulator rows (r0 and r0 + 8 of this thread) x D stored as bf16 to
// global rows of stride st, each row scaled by its factor
template <int D>
__device__ __forceinline__ void store_acc(uint16_t* g, long long st,
                                          const float* acc, int r0, int t,
                                          float f0 = 1.f, float f1 = 1.f) {
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int col = j * 8 + 2 * t;
    *reinterpret_cast<uint32_t*>(g + r0 * st + col) =
        pack_bf16(acc[4 * j] * f0, acc[4 * j + 1] * f0);
    *reinterpret_cast<uint32_t*>(g + (r0 + 8) * st + col) =
        pack_bf16(acc[4 * j + 2] * f1, acc[4 * j + 3] * f1);
  }
}

// 2^x on the special function unit, a result below 2^-126 flushed to 0 (no
// P that small moves an output or a gradient summed from bf16 products)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// the maximum and the sum over the four threads of a quad (lanes 4 g ..
// 4 g + 3), which hold one accumulator row between them
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// the dynamic shared memory's first 1024-byte boundary (a swizzle pattern's
// alignment), as a shared address and a generic pointer
__device__ __forceinline__ uint32_t aligned_base(uint8_t* raw,
                                                 uint8_t** generic) {
  const uint32_t s = smem_u32(raw);
  const uint32_t base = (s + 1023) & ~1023u;
  *generic = raw + (base - s);
  return base;
}

}  // namespace
