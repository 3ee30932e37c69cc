// Causal or non-causal GQA attention with an online softmax (forward):
// the Hopper instance, for bfloat16 with head dim 64 or 128.
//
// Replaces, beside csrc/flash_attention.cu (which keeps every other dtype
// and head dim), the Pallas TPU kernel
//   src/repro/kernels/flash_attention/flash_attention.py::
//   flash_attention_kernel (body _kernel; wrapper ops.py::
//   flash_attention_pallas).
// It computes what csrc/flash_attention.cu computes (the model path's
// models/layers.py::blocked_attention): for query row i of batch b and
// head h, against KV head h / G (G = Hq / Hkv),
//   s_j = <q_i, k_j> * D^-0.5 in float32, masked where causal and
//         j > i + (Skv - Sq) (the model's offset; the Pallas body has none),
//   running max m, running sum l and accumulator acc kept in registers,
//   p_j = exp(s_j - m) rounded to bfloat16 before P.V, l summing the
//         unrounded p,
//   out_i = acc / max(l, 1e-30) in bfloat16; a row with no key gives 0.
// Ragged Sq and Skv are masked in the kernel: no padding.
//
// What bounds it on the H100: operations.  At Yi-6B's prefill shape
// (B 2, S 4096, 32/4 heads of 128, causal) the work is about 2.75e11 FLOP
// on the tensor cores (0.278 ms at the bf16 peak) against 151 MB of q, k,
// v and output (0.045 ms) and 5.4e8 exps (0.128 ms on the
// special-function units).
//
// Design (FlashAttention-3's shape).  A persistent grid, one CTA of 384
// threads per SM, walks the (128-row q tile, q head, batch) tiles,
// longest causal tiles first.  A CTA is two consumer warpgroups of 64 q
// rows each and a producer warpgroup, which hands its registers to the
// consumers (setmaxnreg: 24 against 240 a thread).  One producer thread
// loads each tile's q once and keeps 128-key K and V tiles in flight
// through a 2-stage ring in shared memory (160 KB with q), all by TMA:
// 4-D maps over (D, H, S, B), one head per box, 64 columns a box with the
// 128-byte swizzle, so a 128-wide head is two boxes; rows past S come
// back as zeros.  Full and empty mbarriers guard q and each K and V
// stage; the ring runs on across tiles, so the next tile's loads overlap
// this one's last products and epilogue.  Each consumer warpgroup, per
// K/V tile:
//   S = Q K^T by wgmma.m64n128k16, both operands from shared memory by
//     descriptor, float32 accumulator in registers.  The accumulator's
//     layout gives each thread two rows (wgmma_row/wgmma_col), so the
//     row max and sum are quad shuffles and no score touches shared
//     memory;
//   the softmax runs in registers with ex2.approx, scale * log2 e folded
//     into one FMA; only tiles that cross the causal diagonal or the
//     ragged key edge are masked;
//   P is packed to bfloat16 pairs in registers: the accumulator layout of
//     S is the register layout of wgmma's A operand, so O += P V is
//     wgmma.m64nDk16 with A from registers and V (keys, D) from shared
//     memory as the MN-major B operand (the descriptor's transpose bit).
//     O stays in registers and is rescaled there.
// Overlap: S of tile kt is issued with P.V of tile kt - 1, and the
// softmax of tile kt runs while the tensor cores do that P.V (and the
// other warpgroup's products).
// Training: when the caller gives an lse buffer, the epilogue also writes
// each row's log-sum-exp for the backward (csrc/flash_attention_bwd.cu);
// serving passes none and skips the store.
#include "common.cuh"

#include <cuda.h>   // CUtensorMap and its enums; the encoder comes from the
                    // runtime's driver entry point, so nothing links libcuda
#include <cuda_bf16.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kBQ = 128;             // q rows per tile
constexpr int kBK = 128;             // keys per K/V tile
constexpr int kStages = 2;           // K/V ring depth
constexpr int kConsumers = 256;      // two warpgroups of 64 q rows
constexpr int kThreads = kConsumers + 128;  // + the producer warpgroup
constexpr int kBox = 64;             // bf16 columns per TMA box (128 bytes)
constexpr int kHalfBytes = kBQ * kBox * 2;  // one 128-row x 64-column box
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// 128-row tile of a head of D columns: D / 64 boxes of 16 KB
template <int D>
__host__ __device__ constexpr int tile_bytes() {
  return (D / kBox) * kHalfBytes;
}

template <int D>
constexpr size_t smem_bytes() {
  // q, the K and V rings, 2 + 4 * kStages mbarriers, and slack to align
  // the base to 1024 bytes (the 128-byte swizzle's period)
  return (size_t)(1 + 2 * kStages) * tile_bytes<D>() + 8 * (2 + 4 * kStages)
         + 1024;
}

// --- PTX wrappers ------------------------------------------------------
// (smem_u32 and the mbarrier wrappers are in common.cuh)

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

// wgmma shared-memory descriptor of a tile written by TMA with the
// 128-byte swizzle: start address, leading and stride byte offsets (in
// 16-byte units) and the swizzle mode (1 = 128 bytes) in bits 62-63.
//   K-major operand (Q, K): rows of 128 bytes, 8-row groups 1024 bytes
//     apart (SBO); LBO unused.  The k-th 16-column step starts 32 bytes
//     further into the swizzle atom, or in the next 64-column box.
//   MN-major operand (V as B of P.V): each key's 64 columns are one 128-
//     byte row, 8-key groups 1024 bytes apart (SBO), the next 64 columns
//     one box (16 KB) further (LBO).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
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

// The q tiles, longest first (the last causal tiles walk the most keys),
// dealt to the persistent CTAs in a snake: round r gives tile
// r * G + c to CTA c on even rounds and r * G + G - 1 - c on odd ones, so
// each CTA's sum of tile lengths is about the same.
struct Tile {
  int qt, h, b;
};

__device__ __forceinline__ bool tile_at(int round, int n_qt, int Hq, int B,
                                        Tile& t) {
  const int G = gridDim.x;
  const int c = (round & 1) ? G - 1 - blockIdx.x : blockIdx.x;
  const int i = round * G + c;
  if (i >= n_qt * Hq * B) return false;
  t.qt = n_qt - 1 - i / (Hq * B);
  t.h = i % Hq;                    // neighbouring tiles share KV heads
  t.b = (i / Hq) % B;
  return true;
}

// K/V tiles q tile qt walks: all, or up to its last real row's diagonal
__device__ __forceinline__ int kv_tiles(int qt, int Sq, int Skv,
                                        int causal) {
  const int last_row = min((qt + 1) * kBQ, Sq) - 1;
  const int k_end = causal ? min(Skv, last_row + Skv - Sq + 1) : Skv;
  return (k_end + kBK - 1) / kBK;
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_attention_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                                const __grid_constant__ CUtensorMap tk,
                                const __grid_constant__ CUtensorMap tv,
                                bf16* __restrict__ out,
                                float* __restrict__ lse,
                                float* __restrict__ o32, int B, int Sq,
                                int Skv, int Hq, int Hkv, int causal,
                                float scale_log2) {
  constexpr int kBoxes = D / kBox;
  constexpr int kTile = tile_bytes<D>();
  constexpr int kO = D / 2;          // O registers a thread (m64nD)
  extern __shared__ unsigned char smem_raw[];
  const uint32_t s_q = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t s_k = s_q + kTile;                // kStages tiles
  const uint32_t s_v = s_k + kStages * kTile;      // kStages tiles
  const uint32_t bars = s_v + kStages * kTile;
  const uint32_t full_q = bars, empty_q = bars + 8;
  auto full_k = [&](int s) { return bars + 8 * (2 + s); };
  auto full_v = [&](int s) { return bars + 8 * (2 + kStages + s); };
  auto empty_k = [&](int s) { return bars + 8 * (2 + 2 * kStages + s); };
  auto empty_v = [&](int s) { return bars + 8 * (2 + 3 * kStages + s); };
  const int n_qt = (Sq + kBQ - 1) / kBQ;
  const int group = Hq / Hkv;
  const int off = Skv - Sq;                    // q row i sits at i + off

  if (threadIdx.x == 0) {
    mbar_init(full_q, 1);
    mbar_init(empty_q, kConsumers);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full_k(s), 1);
      mbar_init(full_v(s), 1);
      mbar_init(empty_k(s), kConsumers);
      mbar_init(empty_v(s), kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // --- producer: one thread issues every TMA load ---------------------
    // (the warpgroup hands its registers to the consumers).  The ring's
    // stage and phase run on across tiles, so the next tile's q and first
    // K/V tiles load while the consumers finish this one.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;");
    if (threadIdx.x == kConsumers) {
      Tile t;
      int it = 0;                                // K/V tiles issued so far
      for (int round = 0; tile_at(round, n_qt, Hq, B, t); ++round) {
        mbar_wait(empty_q, (round & 1) ^ 1);
        mbar_expect_tx(full_q, kTile);
#pragma unroll
        for (int c = 0; c < kBoxes; ++c)
          tma_load_4d(s_q + c * kHalfBytes, &tq, full_q, c * kBox, t.h,
                      t.qt * kBQ, t.b);
        const int n_kt = kv_tiles(t.qt, Sq, Skv, causal);
        for (int kt = 0; kt < n_kt; ++kt, ++it) {
          const int s = it % kStages;
          const uint32_t parity = ((it / kStages) & 1) ^ 1;
          mbar_wait(empty_k(s), parity);
          mbar_expect_tx(full_k(s), kTile);
#pragma unroll
          for (int c = 0; c < kBoxes; ++c)
            tma_load_4d(s_k + s * kTile + c * kHalfBytes, &tk, full_k(s),
                        c * kBox, t.h / group, kt * kBK, t.b);
          mbar_wait(empty_v(s), parity);
          mbar_expect_tx(full_v(s), kTile);
#pragma unroll
          for (int c = 0; c < kBoxes; ++c)
            tma_load_4d(s_v + s * kTile + c * kHalfBytes, &tv, full_v(s),
                        c * kBox, t.h / group, kt * kBK, t.b);
        }
      }
    }
    return;
  }

  // --- consumers: warpgroup wg owns q rows 64 wg .. 64 wg + 63 of a tile --
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;");
  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
  const int cq = wgmma_col(t);
  const uint32_t q_wg = s_q + wg * 64 * kBox * 2;  // 64 rows of 128 bytes

  // state of the tile in hand
  float o[kO];
  float m0, m1, l0, l1;
  int lim0, lim1, wg_pos;

  // S = Q K^T of stage s into sc (64 x 128 per warpgroup), committed
  auto issue_s = [&](float (&sc)[64], int s) {
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t step = (kk / 4) * kHalfBytes + (kk % 4) * 32;
      wgmma_ss_n128(sc, smem_desc(q_wg + step, 16, 1024),
                    smem_desc(s_k + s * kTile + step, 16, 1024), kk > 0);
    }
    wgmma_commit();
  };
  // O += P V of stage s, committed
  auto issue_pv = [&](const uint32_t (&pa)[8][4], int s) {
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const uint64_t dv = smem_desc(s_v + s * kTile + kk * 16 * kBox * 2,
                                    kHalfBytes, 1024);
      if constexpr (D == 128) wgmma_rs_n128(o, pa[kk], dv);
      else wgmma_rs_n64(o, pa[kk], dv);
    }
    wgmma_commit();
  };
  // Online softmax of K/V tile kt's scores, in place (sc becomes p), in
  // log2 units; updates m and the thread's share of l and returns the
  // rescale factors of O's two rows in f0, f1.
  auto softmax = [&](float (&sc)[64], int kt, float& f0, float& f1) {
    const int k0 = kt * kBK;
    // mask only tiles that cross the ragged key edge or the diagonal
    if (k0 + kBK > Skv || (causal && k0 + kBK - 1 > wg_pos)) {
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = k0 + 8 * j + cq + e;
          if (col > lim0) sc[4 * j + e] = -CUDART_INF_F;
          if (col > lim1) sc[4 * j + 2 + e] = -CUDART_INF_F;
        }
    }
    float mx0 = -CUDART_INF_F, mx1 = -CUDART_INF_F;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      mx0 = fmaxf(mx0, fmaxf(sc[4 * j], sc[4 * j + 1]));
      mx1 = fmaxf(mx1, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
    }
#pragma unroll
    for (int w = 1; w <= 2; w <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(FULL_MASK, mx0, w));
      mx1 = fmaxf(mx1, __shfl_xor_sync(FULL_MASK, mx1, w));
    }
    const float n0 = fmaxf(m0, mx0 * scale_log2);
    const float n1 = fmaxf(m1, mx1 * scale_log2);
    // a row with no key yet keeps everything at zero
    const float u0 = n0 == -CUDART_INF_F ? 0.f : n0;
    const float u1 = n1 == -CUDART_INF_F ? 0.f : n1;
    f0 = ex2(m0 - u0);
    f1 = ex2(m1 - u1);
    m0 = n0;
    m1 = n1;
    float r0 = 0.f, r1 = 0.f;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      sc[4 * j] = ex2(fmaf(sc[4 * j], scale_log2, -u0));
      sc[4 * j + 1] = ex2(fmaf(sc[4 * j + 1], scale_log2, -u0));
      sc[4 * j + 2] = ex2(fmaf(sc[4 * j + 2], scale_log2, -u1));
      sc[4 * j + 3] = ex2(fmaf(sc[4 * j + 3], scale_log2, -u1));
      r0 += sc[4 * j] + sc[4 * j + 1];
      r1 += sc[4 * j + 2] + sc[4 * j + 3];
    }
    l0 = fmaf(l0, f0, r0);   // the thread's share of the row sums
    l1 = fmaf(l1, f1, r1);
  };
  // O's rows times the factors of the last softmax
  auto rescale = [&](float f0, float f1) {
#pragma unroll
    for (int j = 0; j < kO / 4; ++j) {
      o[4 * j] *= f0;
      o[4 * j + 1] *= f0;
      o[4 * j + 2] *= f1;
      o[4 * j + 3] *= f1;
    }
  };
  // p (float) -> bf16 pairs in wgmma's A-operand layout
  auto pack = [&](const float (&sc)[64], uint32_t (&pa)[8][4]) {
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pa[kk][i] = pack_bf16(sc[8 * kk + 2 * i], sc[8 * kk + 2 * i + 1]);
  };
  Tile tile;
  int it = 0;                                    // K/V tiles consumed
  for (int round = 0; tile_at(round, n_qt, Hq, B, tile); ++round) {
    const int row0 = tile.qt * kBQ + wg * 64 + wgmma_row(t);  // and + 8
    // last key each of the thread's rows may see
    lim0 = causal ? min(Skv - 1, row0 + off) : Skv - 1;
    lim1 = causal ? min(Skv - 1, row0 + 8 + off) : Skv - 1;
    wg_pos = tile.qt * kBQ + wg * 64 + off;     // first row's position
    const int n_kt = kv_tiles(tile.qt, Sq, Skv, causal);
#pragma unroll
    for (int i = 0; i < kO; ++i) o[i] = 0.f;
    m0 = m1 = -CUDART_INF_F;
    l0 = l1 = 0.f;

    // Tile kt's softmax runs while the tensor cores do tile kt - 1's
    // P.V: S_kt and P_{kt-1} V_{kt-1} are issued together (O is rescaled
    // by tile kt - 1's factors between the two), S_kt is awaited first,
    // and P_kt is packed once P_{kt-1} V_{kt-1} is done.  q is released
    // to the producer once the tile's last S is in.
    float sc[64], f0, f1;
    uint32_t pa[8][4];
    mbar_wait(full_q, round & 1);
    if (n_kt == 0) {
      mbar_arrive(empty_q);
    } else {
      const int s = it % kStages;
      mbar_wait(full_k(s), (it / kStages) & 1);
      issue_s(sc, s);
      wgmma_wait<0>();
      fence_regs(sc);
      mbar_arrive(empty_k(s));
      if (n_kt == 1) mbar_arrive(empty_q);
      softmax(sc, 0, f0, f1);        // f = 0: O is still 0
      pack(sc, pa);
    }
    for (int kt = 1; kt < n_kt; ++kt) {
      const int s = (it + kt) % kStages, sp = (it + kt - 1) % kStages;
      mbar_wait(full_k(s), ((it + kt) / kStages) & 1);
      mbar_wait(full_v(sp), ((it + kt - 1) / kStages) & 1);
      issue_s(sc, s);
      rescale(f0, f1);               // under S_kt
      issue_pv(pa, sp);
      wgmma_wait<1>();               // S_kt is in
      fence_regs(sc);
      mbar_arrive(empty_k(s));
      if (kt == n_kt - 1) mbar_arrive(empty_q);
      softmax(sc, kt, f0, f1);       // under P_{kt-1} V_{kt-1}
      wgmma_wait<0>();               // P_{kt-1} V_{kt-1} is in
      fence_regs(o);
      mbar_arrive(empty_v(sp));
      pack(sc, pa);
    }
    if (n_kt > 0) {
      const int sp = (it + n_kt - 1) % kStages;
      mbar_wait(full_v(sp), ((it + n_kt - 1) / kStages) & 1);
      rescale(f0, f1);
      issue_pv(pa, sp);
      wgmma_wait<0>();
      fence_regs(o);
      mbar_arrive(empty_v(sp));
    }
    it += n_kt;

    // out = O / max(l, 1e-30), bf16 pairs straight from registers
#pragma unroll
    for (int w = 1; w <= 2; w <<= 1) {
      l0 += __shfl_xor_sync(FULL_MASK, l0, w);
      l1 += __shfl_xor_sync(FULL_MASK, l1, w);
    }
    if (lse != nullptr && (t & 3) == 0) {
      // the rows' log-sum-exp for the backward: m and l are in log2
      // units; +inf for a row with no key, whose weights are then 0
      float* lrow = lse + ((int64_t)tile.b * Hq + tile.h) * Sq;
      if (row0 < Sq)
        lrow[row0] = l0 > 0.f ? (m0 + log2f(l0)) * kLn2 : CUDART_INF_F;
      if (row0 + 8 < Sq)
        lrow[row0 + 8] = l1 > 0.f ? (m1 + log2f(l1)) * kLn2 : CUDART_INF_F;
    }
    const float i0 = 1.f / fmaxf(l0, 1e-30f), i1 = 1.f / fmaxf(l1, 1e-30f);
    const int64_t at =
        (((int64_t)tile.b * Sq + row0) * Hq + tile.h) * D + cq;
    const int64_t down = (int64_t)8 * Hq * D;     // row0 + 8
    bf16* o0 = out + at;
    // training: the same float32 values before rounding, for the
    // backward's D = rowsum(dO * O)
    float* of = o32 == nullptr ? nullptr : o32 + at;
#pragma unroll
    for (int j = 0; j < kO / 4; ++j) {
      const float2 a = make_float2(o[4 * j] * i0, o[4 * j + 1] * i0);
      const float2 c = make_float2(o[4 * j + 2] * i1, o[4 * j + 3] * i1);
      if (row0 < Sq) {
        *reinterpret_cast<__nv_bfloat162*>(o0 + 8 * j) =
            __floats2bfloat162_rn(a.x, a.y);
        if (of != nullptr) *reinterpret_cast<float2*>(of + 8 * j) = a;
      }
      if (row0 + 8 < Sq) {
        *reinterpret_cast<__nv_bfloat162*>(o0 + down + 8 * j) =
            __floats2bfloat162_rn(c.x, c.y);
        if (of != nullptr) *reinterpret_cast<float2*>(of + down + 8 * j) = c;
      }
    }
  }
}

// --- host --------------------------------------------------------------
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime's driver entry point, so
// the library needs no -lcuda.
EncodeTiled encoder() {
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
// of 64 columns x 1 head x 128 rows x 1 batch, 128-byte swizzle, rows
// past S read as zeros.
bool encode(EncodeTiled fn, CUtensorMap* map, const void* base, int B,
            int S, int H, int D) {
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)S,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)H * D * 2,
                                 (cuuint64_t)S * H * D * 2};
  const cuuint32_t box[4] = {kBox, 1, kBQ, 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
            const_cast<void*>(base), dims, strides, box, estr,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* out,
           float* lse, float* o32, int B, int Sq, int Skv, int Hq, int Hkv,
           int causal, float scale, cudaStream_t stream) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
  // with no keys the kernel loads no K/V tile: its maps stay blank
  CUtensorMap tq{}, tk{}, tv{};
  if (!encode(fn, &tq, q, B, Sq, Hq, D) ||
      (Skv > 0 && (!encode(fn, &tk, k, B, Skv, Hkv, D) ||
                   !encode(fn, &tv, v, B, Skv, Hkv, D))))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_sm90_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = (Sq + kBQ - 1) / kBQ * Hq * B;
  const int ctas = min(tiles, sms);                 // one CTA per SM
  flash_attention_sm90_kernel<D><<<ctas, kThreads, smem, stream>>>(
      tq, tk, tv, static_cast<bf16*>(out), lse, o32, B, Sq, Skv, Hq, Hkv,
      causal, scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q (B, Sq, Hq, D), k and v (B, Skv, Hkv, D) -> out (B, Sq, Hq, D), all
// contiguous bfloat16 with 16-byte aligned q, k, v, and, for the
// backward, where lse is not null, each row's float32 log-sum-exp into lse
// (B, Hq, Sq), and where o32 is not null, out's float32 values before
// rounding into o32 (B, Sq, Hq, D).  Requires D 64 or 128, Hq % Hkv == 0
// and, if causal, Sq <= Skv.  Returns cudaGetLastError() after the launch
// (0 on success), or the error that kept it from launching.
extern "C" int flash_attention_sm90_launch(const void* q, const void* k,
                                           const void* v, void* out,
                                           void* lse, void* o32, int B,
                                           int Sq, int Skv, int Hq, int Hkv,
                                           int D, int causal, float scale,
                                           void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  float* f = static_cast<float*>(o32);
  if (D == 128)
    return launch<128>(q, k, v, out, l, f, B, Sq, Skv, Hq, Hkv, causal,
                       scale, s);
  if (D == 64)
    return launch<64>(q, k, v, out, l, f, B, Sq, Skv, Hq, Hkv, causal,
                      scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
