// Hopper building blocks shared by the attention kernels written for the
// H100 (csrc/flash_attention_sm90.cu, csrc/flash_attention_bwd_sm90.cu):
// TMA loads through 4-D tensor maps, the layout of a head's columns in
// shared memory, wgmma with its shared-memory descriptors and fences, the
// accumulator layout, and the tensor-map encoder, looked up by
// cudaGetDriverEntryPoint so that no library links libcuda.  Inline PTX
// for sm_90a.
#pragma once
#include "common.cuh"

#include <cuda.h>   // CUtensorMap and its enums
#include <cuda_bf16.h>

namespace sm90 {

using bf16 = __nv_bfloat16;

constexpr int kBox = 64;             // bf16 columns per TMA box (128 bytes)
constexpr int kTail = 16;            // bf16 columns of a tail box (32 bytes)
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// TMA: one box of a 4-D map at coordinates (c0, c1, c2, c3), innermost
// first, into shared memory at dst, completing on bar.
__device__ __forceinline__ void tma_load_4d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
// Wait until at most n committed wgmma groups are still running.
template <int n>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(n) : "memory");
}
// Keep the compiler from moving accesses of an accumulator across the
// wgmma fence and wait around it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// A tile of R rows of a head of D bf16 columns (D 64, 80, 128 or 192) in
// shared memory, as TMA writes it: first D / 64 boxes of 64 columns, each
// R rows of 128 bytes with the 128-byte swizzle, then, where D % 64 is 16
// (D 80), one box of the last 16 columns, R rows of 32 bytes with the
// 32-byte swizzle.  R * D * 2 bytes in all; with the tile 1024-byte
// aligned and R a multiple of 8 (one swizzle period of either kind: 8
// rows), every box and every 8-row group is aligned to its swizzle's
// period (1024 and 256 bytes), which the descriptors below assume.  A
// 112-row box (the forward's key tile at D 192) is 14 periods.
template <int D>
__host__ __device__ constexpr bool has_tail() {
  static_assert(D % kBox == 0 || D % kBox == kTail,
                "head dim: a multiple of 64, plus 16 at most");
  return D % kBox != 0;
}
template <int D, int R>
__host__ __device__ constexpr int tile_bytes() {
  static_assert(R % 8 == 0, "tile rows: whole swizzle periods of 8 rows");
  return R * D * 2;
}
template <int D, int R>
__host__ __device__ constexpr int tail_at() {
  return (D / kBox) * R * kBox * 2;  // the tail box's offset in the tile
}

// The maps of one operand: its 64-column boxes and, for D 80, its tail.
struct HeadMaps {
  CUtensorMap box, tail;
};

// Load rows [r0, r0 + R) of head h of batch b into the R-row tile at dst
// (tile_bytes<D, R>() in all, on bar), in boxes of BoxRows rows.
template <int D, int R, int BoxRows>
__device__ __forceinline__ void load_tile(uint32_t dst, const HeadMaps& m,
                                          uint32_t bar, int h, int r0,
                                          int b) {
#pragma unroll
  for (int r = 0; r < R / BoxRows; ++r) {
#pragma unroll
    for (int c = 0; c < D / kBox; ++c)
      tma_load_4d(dst + c * R * kBox * 2 + r * BoxRows * kBox * 2, &m.box,
                  bar, c * kBox, h, r0 + r * BoxRows, b);
    if constexpr (has_tail<D>())
      tma_load_4d(dst + tail_at<D, R>() + r * BoxRows * kTail * 2, &m.tail,
                  bar, D - kTail, h, r0 + r * BoxRows, b);
  }
}

// wgmma shared-memory descriptor of a tile written by TMA with the
// 128-byte swizzle: start address, leading and stride byte offsets (in
// 16-byte units) and the swizzle mode (1 = 128 bytes) in bits 62-63.
//   K-major operand: rows of 128 bytes, 8-row groups 1024 bytes apart
//     (SBO); LBO unused.  The k-th 16-column step starts 32 bytes
//     further into the swizzle atom, or in the next 64-column box.
//   MN-major operand (the B of a product whose K runs over a tile's
//     rows): each row's 64 columns are one 128-byte row, 8-row groups
//     1024 bytes apart (SBO), the next 64 columns one box further (LBO).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// The same for a 16-column tail box, written with the 32-byte swizzle
// (mode 3): rows of 32 bytes, 8-row groups 256 bytes apart (SBO), for
// either use.  K-major, one 16-deep k step is the whole 32-byte row;
// MN-major (K over the box's rows), its 16 columns are the whole row.  So
// neither use steps to a next 32-byte atom across, which is what LBO
// would give: it is set to the same 256 bytes.
__device__ __forceinline__ uint64_t smem_desc32(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(256 >> 4) << 16) |
         ((uint64_t)(256 >> 4) << 32) | (3ull << 62);
}

// Descriptor of k step kk (columns 16 kk .. 16 kk + 15) of a K-major
// operand whose rows start at row ro of an R-row tile of D columns.
// Steps in a 64-column box start 32 bytes further into its swizzle atom;
// the tail's single step is its own box.
template <int D, int R>
__device__ __forceinline__ uint64_t kmajor(uint32_t tile, int ro, int kk) {
  if (has_tail<D>() && kk == D / 16 - 1)
    return smem_desc32(tile + tail_at<D, R>() + ro * kTail * 2);
  return smem_desc(tile + (kk / 4) * R * kBox * 2 + ro * kBox * 2 +
                       (kk % 4) * 32,
                   16, 1024);
}

// D (64 x 128, float32) += A (64 x 16, bf16, shared, K-major) *
// B (16 x 128, bf16, shared, K-major), both by descriptor; scale_d 0
// overwrites D.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x 112, float32) += A (64 x 16, bf16, shared, K-major) *
// B (16 x 112, bf16, shared, K-major), both by descriptor; scale_d 0
// overwrites D.
__device__ __forceinline__ void wgmma_ss_n112(float (&d)[56], uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %58, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n112k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55"
      "}, %56, %57, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x 64, float32) += A (64 x 16, bf16, shared, K-major) *
// B (16 x 64, bf16, shared, K-major), both by descriptor; scale_d 0
// overwrites D.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x 32, float32) += A (64 x 16, bf16, shared, K-major) *
// B (16 x 32, bf16, shared, K-major), both by descriptor; scale_d 0
// overwrites D.
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x N, float32) += A (64 x 16, bf16, shared, K-major) * B (16 x N,
// bf16, shared, MN-major: the descriptor's transpose bit), N 64 or 32:
// the products whose A is a tile handed over through shared memory.
__device__ __forceinline__ void wgmma_sst_n64(float (&d)[32], uint64_t da,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}
__device__ __forceinline__ void wgmma_sst_n32(float (&d)[16], uint64_t da,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(da), "l"(db), "r"(1));
}

// S (64 x N, float32) of one k step, by N: 128, 112 or 64 keys.
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da,
                                         uint64_t db, int scale_d) {
  if constexpr (N == 128) {
    wgmma_ss_n128(d, da, db, scale_d);
  } else if constexpr (N == 112) {
    wgmma_ss_n112(d, da, db, scale_d);
  } else {
    static_assert(N == 64, "key tile: 128, 112 or 64 keys");
    wgmma_ss_n64(d, da, db, scale_d);
  }
}

// D (64 x 192, float32) += A (64 x 16, bf16, registers) * B (16 x 192,
// bf16, shared, MN-major: the descriptor's transpose bit).
__device__ __forceinline__ void wgmma_rs_n192(float (&d)[96],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71,"
      "%72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87,"
      "%88, %89, %90, %91, %92, %93, %94, %95"
      "}, {%96, %97, %98, %99}, %100, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 128, float32) += A (64 x 16, bf16, registers) * B (16 x 128,
// bf16, shared, MN-major: the descriptor's transpose bit).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 64, float32) += A (64 x 16, bf16, registers) * B (16 x 64,
// bf16, shared, MN-major: the descriptor's transpose bit).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 16, float32) += A (64 x 16, bf16, registers) * B (16 x 16,
// bf16, shared, MN-major: the descriptor's transpose bit).
__device__ __forceinline__ void wgmma_rs_n16(float (&d)[8],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// Registers [At, At + N) of an accumulator, as an accumulator of N.
template <int N, int At, int M>
__device__ __forceinline__ auto part(float (&r)[M]) -> float (&)[N] {
  static_assert(At + N <= M, "part past the accumulator");
  return *reinterpret_cast<float(*)[N]>(r + At);
}

// acc (64 x D, float32, the m64nD accumulator layout) += A (64 x 16,
// registers) * B (16 x D, MN-major): rows [r, r + 16) of an R-row tile of
// D columns.  A 64-column box is one wgmma, the two of D 128 one n128 and
// the three of D 192 one n192 (LBO steps from box to box, R * 128 bytes);
// the tail box an n16 into the accumulator's last 8 registers, its
// columns 64-79.
template <int D, int R>
__device__ __forceinline__ void wgmma_rs_tile(float (&acc)[D / 2],
                                              const uint32_t (&a)[4],
                                              uint32_t tile, int r) {
  const uint64_t db = smem_desc(tile + r * kBox * 2, R * kBox * 2, 1024);
  if constexpr (D == 192) {
    wgmma_rs_n192(acc, a, db);
  } else if constexpr (D == 128) {
    wgmma_rs_n128(acc, a, db);
  } else {
    wgmma_rs_n64(part<32, 0>(acc), a, db);
    if constexpr (has_tail<D>())
      wgmma_rs_n16(part<8, 32>(acc), a,
                   smem_desc32(tile + tail_at<D, R>() + r * kTail * 2));
  }
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The wgmma accumulator layout (m64nN, float32), from the PTX ISA's
// fragment figure: thread t of a warpgroup holds, for each 8-column block
// j, registers 4j..4j+3 at
//   rows wgmma_row(t) (4j, 4j + 1) and wgmma_row(t) + 8 (4j + 2, 4j + 3),
//   columns 8j + wgmma_col(t) (4j, 4j + 2) and 8j + wgmma_col(t) + 1.
// Warp w of the warpgroup owns rows 16w..16w+15; a quad of lanes shares
// its two rows.  The A-from-registers operand of a 16-deep k step kk is
// registers 8kk..8kk+7 of such an accumulator, packed in pairs.
__host__ __device__ __forceinline__ int wgmma_row(int t) {
  return (t / 32) * 16 + (t % 32) / 4;
}
__host__ __device__ __forceinline__ int wgmma_col(int t) {
  return 2 * (t % 4);
}

// An accumulator of N / 8 column blocks -> bf16 pairs in wgmma's
// A-operand layout, N / 16 k steps of four registers.
template <int N>
__device__ __forceinline__ void pack_a(const float (&acc)[N / 2],
                                       uint32_t (&a)[N / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[kk][i] = pack_bf16(acc[8 * kk + 2 * i], acc[8 * kk + 2 * i + 1]);
}

// A 32-bit store to shared memory, for tiles that wgmma then reads: the
// writers fence (fence_async_smem) before the barrier that hands the tile
// over, since wgmma reads shared memory through the async proxy.
__device__ __forceinline__ void sts_u32(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.u32 [%0], %1;" ::"r"(addr), "r"(v) : "memory");
}
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}
// Named barrier `id` (1-15; 0 is __syncthreads) over `n` threads.
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(n) : "memory");
}

// Byte offset of bf16 element (r, c) of a tile of 64-column rows written
// with the 128-byte swizzle (1024-byte aligned): 16-byte chunk c / 8 of
// row r lies at chunk (c / 8) ^ (r % 8), as TMA writes it and as a
// descriptor of swizzle mode 1 reads it.
__host__ __device__ __forceinline__ uint32_t swizzle128(int r, int c) {
  return r * 128 + ((((c >> 3) ^ (r & 7))) << 4) + (c & 7) * 2;
}

// --- host --------------------------------------------------------------
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the CUDA runtime, so the
// library needs no -lcuda.
inline EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// 4-D map of a contiguous (B, S, H, D) bf16 tensor as (D, H, S, B), boxes
// of `cols` columns x 1 head x `rows` rows x 1 batch with the given
// swizzle, rows past S read as zeros.
inline bool encode(EncodeTiled fn, CUtensorMap* map, const void* base,
                   int B, int S, int H, int D, int rows, int cols,
                   CUtensorMapSwizzle swizzle) {
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)S,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)H * D * 2,
                                 (cuuint64_t)S * H * D * 2};
  const cuuint32_t box[4] = {(cuuint32_t)cols, 1, (cuuint32_t)rows, 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
            const_cast<void*>(base), dims, strides, box, estr,
            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The maps load_tile reads, boxes of `rows` rows: 64 columns with the
// 128-byte swizzle and, for D 80, the last 16 with the 32-byte one.
template <int D>
inline bool encode_head(EncodeTiled fn, HeadMaps* m, const void* base,
                        int B, int S, int H, int rows) {
  return encode(fn, &m->box, base, B, S, H, D, rows, kBox,
                CU_TENSOR_MAP_SWIZZLE_128B) &&
         (!has_tail<D>() || encode(fn, &m->tail, base, B, S, H, D, rows,
                                   kTail, CU_TENSOR_MAP_SWIZZLE_32B));
}

// The device's SM count, read once.
inline int sm_count() {
  static int cached = 0;
  if (cached == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&cached, cudaDevAttrMultiProcessorCount, dev);
  }
  return cached;
}

}  // namespace sm90
