// Hopper building blocks shared by the bf16 flash kernels
// (flash_attention_mma.cu, flash_attention_bwd.cu): shared-memory
// addresses, bf16 packing, the warpgroup MMA (wgmma.mma_async) products,
// their fences and descriptors.  Each source includes it once; the
// functions sit in its anonymous namespace and are inlined.
#pragma once
#include <cstdint>
#include <cuda_bf16.h>

namespace {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// this thread's copies into shared memory become visible to wgmma
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
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

// A wgmma reads and writes its registers after the instruction issues.
// These empty asm statements pin each register at the point where the
// product is known to be done, so the compiler neither reads an
// accumulator early nor reuses an operand's register while it is in flight.
template <int NT>
__device__ __forceinline__ void hold(float (&d)[NT][4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[j][e])::"memory");
}

template <int NT>
__device__ __forceinline__ void hold(uint32_t (&a)[NT][4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(a[j][e])::"memory");
}

// shared-memory matrix descriptor: start address, leading and stride byte
// offsets between 8x8 core matrices, swizzle mode (0 none, 3 32-byte)
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint64_t swz) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32) | (swz << 62);
}

// two fp32 values rounded to bf16 (nearest even), lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// Fragments (PTX wgmma m64nNk16, the same per warp as mma m16n8k16): warp w
// of a warpgroup holds rows 16 w .. 16 w + 15; lane = 4 * gid + tig.  An
// accumulator d[j][0..1] is row gid, columns 8 j + 2 tig and 8 j + 2 tig + 1;
// d[j][2..3] the same columns of row gid + 8.  A register A operand a[0..3]
// is (row gid, k 2 tig..), (row gid + 8, k 2 tig..), (row gid, k 2 tig + 8..),
// (row gid + 8, k 2 tig + 8..), two bf16 each.

// The wgmma products, one function per shape (PTX: wgmma.mma_async, bf16
// in, fp32 accumulators).  d[T0 + j][e] is the accumulator fragment of
// columns 8 j .. 8 j + 7 (see the note on fragments above); accumulate = 0
// overwrites d.
// D[64 x 32] (+)= A (shared, K-major) B (shared, K-major)
template <int T0, int NT>
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[NT][4], uint64_t da,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[T0 + 0][0]), "+f"(d[T0 + 0][1]), "+f"(d[T0 + 0][2]), "+f"(d[T0 + 0][3]),
        "+f"(d[T0 + 1][0]), "+f"(d[T0 + 1][1]), "+f"(d[T0 + 1][2]), "+f"(d[T0 + 1][3]),
        "+f"(d[T0 + 2][0]), "+f"(d[T0 + 2][1]), "+f"(d[T0 + 2][2]), "+f"(d[T0 + 2][3]),
        "+f"(d[T0 + 3][0]), "+f"(d[T0 + 3][1]), "+f"(d[T0 + 3][2]), "+f"(d[T0 + 3][3])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D[64 x 64] (+)= A (shared, K-major) B (shared, K-major)
template <int T0, int NT>
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[NT][4], uint64_t da,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[T0 + 0][0]), "+f"(d[T0 + 0][1]), "+f"(d[T0 + 0][2]), "+f"(d[T0 + 0][3]),
        "+f"(d[T0 + 1][0]), "+f"(d[T0 + 1][1]), "+f"(d[T0 + 1][2]), "+f"(d[T0 + 1][3]),
        "+f"(d[T0 + 2][0]), "+f"(d[T0 + 2][1]), "+f"(d[T0 + 2][2]), "+f"(d[T0 + 2][3]),
        "+f"(d[T0 + 3][0]), "+f"(d[T0 + 3][1]), "+f"(d[T0 + 3][2]), "+f"(d[T0 + 3][3]),
        "+f"(d[T0 + 4][0]), "+f"(d[T0 + 4][1]), "+f"(d[T0 + 4][2]), "+f"(d[T0 + 4][3]),
        "+f"(d[T0 + 5][0]), "+f"(d[T0 + 5][1]), "+f"(d[T0 + 5][2]), "+f"(d[T0 + 5][3]),
        "+f"(d[T0 + 6][0]), "+f"(d[T0 + 6][1]), "+f"(d[T0 + 6][2]), "+f"(d[T0 + 6][3]),
        "+f"(d[T0 + 7][0]), "+f"(d[T0 + 7][1]), "+f"(d[T0 + 7][2]), "+f"(d[T0 + 7][3])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D[64 x 128] (+)= A (shared, K-major) B (shared, K-major)
template <int T0, int NT>
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[NT][4], uint64_t da,
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[T0 + 0][0]), "+f"(d[T0 + 0][1]), "+f"(d[T0 + 0][2]), "+f"(d[T0 + 0][3]),
        "+f"(d[T0 + 1][0]), "+f"(d[T0 + 1][1]), "+f"(d[T0 + 1][2]), "+f"(d[T0 + 1][3]),
        "+f"(d[T0 + 2][0]), "+f"(d[T0 + 2][1]), "+f"(d[T0 + 2][2]), "+f"(d[T0 + 2][3]),
        "+f"(d[T0 + 3][0]), "+f"(d[T0 + 3][1]), "+f"(d[T0 + 3][2]), "+f"(d[T0 + 3][3]),
        "+f"(d[T0 + 4][0]), "+f"(d[T0 + 4][1]), "+f"(d[T0 + 4][2]), "+f"(d[T0 + 4][3]),
        "+f"(d[T0 + 5][0]), "+f"(d[T0 + 5][1]), "+f"(d[T0 + 5][2]), "+f"(d[T0 + 5][3]),
        "+f"(d[T0 + 6][0]), "+f"(d[T0 + 6][1]), "+f"(d[T0 + 6][2]), "+f"(d[T0 + 6][3]),
        "+f"(d[T0 + 7][0]), "+f"(d[T0 + 7][1]), "+f"(d[T0 + 7][2]), "+f"(d[T0 + 7][3]),
        "+f"(d[T0 + 8][0]), "+f"(d[T0 + 8][1]), "+f"(d[T0 + 8][2]), "+f"(d[T0 + 8][3]),
        "+f"(d[T0 + 9][0]), "+f"(d[T0 + 9][1]), "+f"(d[T0 + 9][2]), "+f"(d[T0 + 9][3]),
        "+f"(d[T0 + 10][0]), "+f"(d[T0 + 10][1]), "+f"(d[T0 + 10][2]), "+f"(d[T0 + 10][3]),
        "+f"(d[T0 + 11][0]), "+f"(d[T0 + 11][1]), "+f"(d[T0 + 11][2]), "+f"(d[T0 + 11][3]),
        "+f"(d[T0 + 12][0]), "+f"(d[T0 + 12][1]), "+f"(d[T0 + 12][2]), "+f"(d[T0 + 12][3]),
        "+f"(d[T0 + 13][0]), "+f"(d[T0 + 13][1]), "+f"(d[T0 + 13][2]), "+f"(d[T0 + 13][3]),
        "+f"(d[T0 + 14][0]), "+f"(d[T0 + 14][1]), "+f"(d[T0 + 14][2]), "+f"(d[T0 + 14][3]),
        "+f"(d[T0 + 15][0]), "+f"(d[T0 + 15][1]), "+f"(d[T0 + 15][2]), "+f"(d[T0 + 15][3])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D[64 x 16] (+)= A (registers) B (shared, MN-major)
template <int T0, int NT>
__device__ __forceinline__ void wgmma_rs_n16(float (&d)[NT][4],
                                             const uint32_t (&a)[4],
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[T0 + 0][0]), "+f"(d[T0 + 0][1]), "+f"(d[T0 + 0][2]), "+f"(d[T0 + 0][3]),
        "+f"(d[T0 + 1][0]), "+f"(d[T0 + 1][1]), "+f"(d[T0 + 1][2]), "+f"(d[T0 + 1][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// D[64 x 32] (+)= A (registers) B (shared, MN-major)
template <int T0, int NT>
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[NT][4],
                                             const uint32_t (&a)[4],
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[T0 + 0][0]), "+f"(d[T0 + 0][1]), "+f"(d[T0 + 0][2]), "+f"(d[T0 + 0][3]),
        "+f"(d[T0 + 1][0]), "+f"(d[T0 + 1][1]), "+f"(d[T0 + 1][2]), "+f"(d[T0 + 1][3]),
        "+f"(d[T0 + 2][0]), "+f"(d[T0 + 2][1]), "+f"(d[T0 + 2][2]), "+f"(d[T0 + 2][3]),
        "+f"(d[T0 + 3][0]), "+f"(d[T0 + 3][1]), "+f"(d[T0 + 3][2]), "+f"(d[T0 + 3][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// D[64 x 64] (+)= A (registers) B (shared, MN-major)
template <int T0, int NT>
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[NT][4],
                                             const uint32_t (&a)[4],
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[T0 + 0][0]), "+f"(d[T0 + 0][1]), "+f"(d[T0 + 0][2]), "+f"(d[T0 + 0][3]),
        "+f"(d[T0 + 1][0]), "+f"(d[T0 + 1][1]), "+f"(d[T0 + 1][2]), "+f"(d[T0 + 1][3]),
        "+f"(d[T0 + 2][0]), "+f"(d[T0 + 2][1]), "+f"(d[T0 + 2][2]), "+f"(d[T0 + 2][3]),
        "+f"(d[T0 + 3][0]), "+f"(d[T0 + 3][1]), "+f"(d[T0 + 3][2]), "+f"(d[T0 + 3][3]),
        "+f"(d[T0 + 4][0]), "+f"(d[T0 + 4][1]), "+f"(d[T0 + 4][2]), "+f"(d[T0 + 4][3]),
        "+f"(d[T0 + 5][0]), "+f"(d[T0 + 5][1]), "+f"(d[T0 + 5][2]), "+f"(d[T0 + 5][3]),
        "+f"(d[T0 + 6][0]), "+f"(d[T0 + 6][1]), "+f"(d[T0 + 6][2]), "+f"(d[T0 + 6][3]),
        "+f"(d[T0 + 7][0]), "+f"(d[T0 + 7][1]), "+f"(d[T0 + 7][2]), "+f"(d[T0 + 7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

}  // namespace
