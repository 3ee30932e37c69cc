// Causal or non-causal GQA attention, the backward (dq, dk, dv): the
// Hopper instance, for bfloat16 with head dim 64, 80, 128 or 192.
//
// The backward of csrc/flash_attention_sm90.cu, which replaces the Pallas
// TPU kernel src/repro/kernels/flash_attention/flash_attention.py::
// flash_attention_kernel.  The JAX package has no backward Pallas kernel:
// its LM trains through jax.grad of the plain
// models/layers.py::blocked_attention.  This kernel computes what
// csrc/flash_attention_bwd.cu computes (which keeps float32 and every
// other head dim): for query row i of batch b and head h, against KV
// head h / G (G = Hq / Hkv), with the causal rule j <= i + q_offset
// (q_offset the absolute position of query row 0: Skv - Sq for the
// model's own sequence, a context-parallel shard's first position for a
// shard whose keys are all-gathered over the whole sequence),
//   P_ij  = exp(s_ij * scale - LSE_i), LSE_i the forward's row log-sum-exp;
//   D_i   = rowsum(dO_i * O_i) from the forward's float32 output O;
//   dP_ij = <dO_i, v_j>,  dS_ij = P_ij (dP_ij - D_i);
//   dv_j  = sum_i bf16(P_ij) dO_i,
//   dk_j  = scale * sum_i bf16(dS_ij) q_i,  dq_i = scale * sum_j bf16(dS_ij) k_j,
// every accumulator float32, dk and dv summed over the G query heads of
// each KV head inside the kernel (no atomics: the same bits every call).
//
// What bounds it on the H100: operations.  At Yi-6B's train shape (B 2,
// S 4096, 32/4 heads of 128, causal) the five products of the gradient
// (S and dP, then dv, dk, dq) are 6.9e11 FLOP, 0.70 ms at the bf16
// tensor-core peak, against about 250 MB of q, k, v, O, dO and the three
// gradients (0.07 ms).  This design recomputes S and dP in its dq pass,
// seven products (0.97 ms at peak), the price of a result without atomics.
// At Nemotron-4-340B's (B 2, S 4096, 96/8 heads of 192) the five are
// 3.09e12 FLOP (3.13 ms), the seven 4.38 ms, against about 1.6 GB.
//
// Design (FlashAttention-3's backward, kept deterministic).  Three
// launches:
//   1. D_i into a float32 buffer (B, Hq, Sq), a warp per row.
//   2. dk, dv: a persistent grid over (128-key tile, KV head, batch)
//      tiles, key tile 0 (the longest causal walk at any q_offset)
//      first, dealt in a snake to as many CTAs as keep the rounds per CTA
//      at their least, so each CTA's sum of walk lengths is about the
//      same.  A key tile past every row's position (a shard whose
//      q_offset is below Skv - Sq) walks no q tile and writes zeros.
//      A CTA is two consumer warpgroups of 64 keys each and a producer
//      warpgroup, which hands its registers to the consumers
//      (setmaxnreg).  One
//      producer thread loads the tile's K and V once and keeps the 64-row
//      q and dO tiles of the G query heads in flight through a ring in
//      shared memory, all by TMA (64-column boxes, the 128-byte swizzle;
//      at D 80 a 16-column tail box with the 32-byte swizzle beside the
//      64-column one, as in the forward; rows past S read as zeros); a
//      second producer warp writes each q
//      tile's LSE (in log2 units, +inf past Sq) and D beside it.  Per q
//      tile each consumer warpgroup computes
//        S^T = K Q^T and dP^T = V dO^T by wgmma.m64n64k16, both operands
//          K-major from shared memory: keys are the accumulator's rows and
//          q rows its columns, so a thread's columns' LSE and D are read
//          from the stage's rows;
//        P^T = ex2(S^T scale log2 e - LSE_2) and dS^T = P^T (dP^T - D) in
//          registers, masked only on tiles that cross the diagonal;
//        dV += P^T dO and dK += dS^T Q by wgmma with A from registers (the
//          accumulator layout of S^T is wgmma's A-operand layout, as in
//          the forward) and dO and Q as MN-major B operands.
//      At D 80 the products whose K is D (S^T, dP^T, and the dq pass's S
//      and dP) take four k steps over the 128-byte boxes and one over the
//      tail box; those whose N is D (dV, dK, dQ) an n64 over the
//      64-column box and an n16 over the tail into the accumulator's last
//      8 registers, which keeps the m64nD layout for the epilogue.
//      dK and dV stay in registers over the whole walk of the G heads and
//      are stored as bfloat16 pairs straight from them.
//      At D 192 the two would take 192 float32 a thread: there the two
//      warpgroups share a 64-key tile, each computing half of S^T and dP^T
//      and owning half of dK's and dV's columns, with P^T and dS^T handed
//      over through shared memory (flash_bwd_dkdv_wide_kernel, below).
//   3. dq: a persistent grid over (128-row q tile, q head, batch) tiles,
//      longest causal walk first, the forward's shape: Q and dO loaded
//      once a tile, 64-key K and V tiles through a TMA ring; S = Q K^T
//      and dP = dO V^T by wgmma, P and dS in registers with each row's
//      LSE and D, dQ += dS K with dS from registers and K MN-major (at
//      D 192 one m64n192k16 a k step, LBO stepping over K's three boxes:
//      dQ's 96 float32 a thread beside S and dP, 32 + 32).
#include <type_traits>

#include "sm90.cuh"   // TMA, wgmma, descriptors, the tensor-map encoder

namespace {

using namespace sm90;

constexpr int kRows = 64;            // rows a TMA box and a warpgroup
constexpr int kConsumers = 256;      // two warpgroups
constexpr int kThreads = kConsumers + 128;  // + the producer warpgroup
constexpr int kKeys = 128;           // keys a dk/dv tile
constexpr int kQRows = 128;          // q rows a dq tile
constexpr int kStagesQ = 2;          // the dk/dv kernel's q/dO ring
constexpr int kStagesKV = 2;         // the dq kernel's K/V ring
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
constexpr int kDotThreads = 256;

// Tile i of n, dealt in a snake: round r gives tile r * G + c to CTA c on
// even rounds and r * G + G - 1 - c on odd ones.
__device__ __forceinline__ int snake(int round, int n) {
  const int G = gridDim.x;
  const int c = (round & 1) ? G - 1 - blockIdx.x : blockIdx.x;
  const int i = round * G + c;
  return i < n ? i : -1;
}

// --- 1. D = rowsum(dO * O) ----------------------------------------------
__global__ void __launch_bounds__(kDotThreads)
    flash_bwd_dot_sm90_kernel(const float* __restrict__ out,
                              const bf16* __restrict__ dout,
                              float* __restrict__ dd, int B, int Sq, int Hq,
                              int D) {
  const int lane = threadIdx.x & 31;
  const int64_t rows = (int64_t)B * Sq * Hq;
  const int64_t row = (int64_t)blockIdx.x * (kDotThreads / 32) +
                      threadIdx.x / 32;   // ((b * Sq + i) * Hq + h)
  if (row >= rows) return;
  const float* o = out + row * D;
  const bf16* g = dout + row * D;
  float sum = 0.f;
  for (int d = lane; d < D; d += 32)
    sum = fmaf(o[d], __bfloat162float(g[d]), sum);
#pragma unroll
  for (int w = 16; w > 0; w >>= 1) sum += __shfl_xor_sync(FULL_MASK, sum, w);
  if (lane == 0) {
    const int h = row % Hq;
    const int64_t bi = row / Hq;          // b * Sq + i
    const int i = bi % Sq;
    const int64_t b = bi / Sq;
    dd[(b * Hq + h) * Sq + i] = sum;
  }
}

// --- 2. dk, dv -----------------------------------------------------------
template <int D>
constexpr size_t dkdv_smem() {
  // K and V (128 rows), the q and dO ring (64 rows a stage), each stage's
  // 64 LSEs and Ds, 2 + 2 kStagesQ mbarriers, and slack to align the base
  // to 1024 bytes
  return 2 * (size_t)tile_bytes<D, kKeys>() +
         2 * (size_t)kStagesQ * tile_bytes<D, kRows>() +
         (size_t)kStagesQ * 2 * kRows * 4 + 8 * (2 + 2 * kStagesQ) + 1024;
}

// The first q tile whose rows see key k0 (n_qt or more: none, and the
// key tile's dk and dv are stored as the zeros they start at)
__device__ __forceinline__ int q_first(int k0, int causal, int off) {
  return causal ? max(0, k0 - off) / kRows : 0;
}

// The dk/dv mbarriers at bars: K/V full and empty, then NS full and NS
// empty q/dO stages.
template <int NS>
__device__ __forceinline__ void dkdv_bars_init(uint32_t bars) {
  if (threadIdx.x == 0) {
    mbar_init(bars, 1);
    mbar_init(bars + 8, kConsumers);
    for (int s = 0; s < NS; ++s) {
      mbar_init(bars + 8 * (2 + s), 1 + 32);  // the TMA thread, the rows' warp
      mbar_init(bars + 8 * (2 + NS + s), kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
}

// The dk/dv producer warpgroup over KT-key tiles and an NS-stage q/dO
// ring (it hands its registers to the consumers): thread 0 of its first
// warp issues every TMA load (a tile's K and V once, then the 64-row q
// and dO tiles of the G query heads from the first q tile whose rows see
// the tile; rows past S read as zeros); its second warp writes each
// stage's LSEs (in log2 units, +inf past Sq) and Ds beside them.  Both
// walk the same tiles and stages; the ring runs on across tiles.
template <int D, int KT, int NS>
__device__ __forceinline__ void dkdv_producer(
    const HeadMaps& tq, const HeadMaps& tk, const HeadMaps& tv,
    const HeadMaps& tdo, const float* __restrict__ lse,
    const float* __restrict__ dd, uint32_t s_k, uint32_t s_v, uint32_t s_q,
    uint32_t s_do, float* rows, uint32_t bars, int B, int Sq, int Skv,
    int Hq, int Hkv, int causal, int off) {
  constexpr int kQTile = tile_bytes<D, kRows>();
  constexpr int kKTile = tile_bytes<D, KT>();
  const uint32_t kv_full = bars, kv_empty = bars + 8;
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kProducerRegs));
  const int warp = (threadIdx.x - kConsumers) / 32, lane = threadIdx.x % 32;
  if (warp > 1 || (warp == 0 && lane != 0)) return;
  const int G = Hq / Hkv;
  const int n_qt = (Sq + kRows - 1) / kRows;
  const int n_tiles = (Skv + KT - 1) / KT * Hkv * B;
  int it = 0;                                    // q tiles issued so far
  for (int round = 0;; ++round) {
    const int i = snake(round, n_tiles);
    if (i < 0) break;
    const int kt = i / (Hkv * B), hk = i % Hkv, b = (i / Hkv) % B;
    if (warp == 0) {
      mbar_wait(kv_empty, (round & 1) ^ 1);
      mbar_expect_tx(kv_full, 2 * kKTile);
      load_tile<D, KT, kRows>(s_k, tk, kv_full, hk, kt * KT, b);
      load_tile<D, KT, kRows>(s_v, tv, kv_full, hk, kt * KT, b);
    }
    const int qf = q_first(kt * KT, causal, off);
    for (int g = 0; g < G; ++g) {
      const int h = hk * G + g;
      for (int qt = qf; qt < n_qt; ++qt, ++it) {
        const int s = it % NS;
        const uint32_t full = bars + 8 * (2 + s), empty = full + 8 * NS;
        mbar_wait(empty, ((it / NS) & 1) ^ 1);
        if (warp == 0) {
          mbar_expect_tx(full, 2 * kQTile);
          load_tile<D, kRows, kRows>(s_q + s * kQTile, tq, full, h,
                                     qt * kRows, b);
          load_tile<D, kRows, kRows>(s_do + s * kQTile, tdo, full, h,
                                     qt * kRows, b);
        } else {
          const int64_t at = ((int64_t)b * Hq + h) * Sq;
#pragma unroll
          for (int r = lane; r < kRows; r += 32) {
            const int row = qt * kRows + r;
            rows[s * 2 * kRows + r] =
                row < Sq ? lse[at + row] * kLog2e : CUDART_INF_F;
            rows[s * 2 * kRows + kRows + r] = row < Sq ? dd[at + row] : 0.f;
          }
          mbar_arrive(full);
        }
      }
    }
  }
}

// dk = scale dK, dv = dV of keys key0 and key0 + 8 (the thread's
// accumulator rows), columns c0 + 8 j (and + 1), N / 4 column blocks:
// bf16 pairs straight from the m64n(2N) accumulator's registers.
template <int N>
__device__ __forceinline__ void store_dkdv(bf16* dk, bf16* dv,
                                           const float (&dka)[N],
                                           const float (&dva)[N], int b,
                                           int key0, int hk, int c0,
                                           int Skv, int Hkv, int D,
                                           float scale) {
  const int64_t at = (((int64_t)b * Skv + key0) * Hkv + hk) * D + c0;
  const int64_t down = (int64_t)8 * Hkv * D;        // key0 + 8
#pragma unroll
  for (int j = 0; j < N / 4; ++j) {
    if (key0 < Skv) {
      *reinterpret_cast<__nv_bfloat162*>(dk + at + 8 * j) =
          __floats2bfloat162_rn(dka[4 * j] * scale, dka[4 * j + 1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dv + at + 8 * j) =
          __floats2bfloat162_rn(dva[4 * j], dva[4 * j + 1]);
    }
    if (key0 + 8 < Skv) {
      *reinterpret_cast<__nv_bfloat162*>(dk + at + down + 8 * j) =
          __floats2bfloat162_rn(dka[4 * j + 2] * scale,
                                dka[4 * j + 3] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dv + at + down + 8 * j) =
          __floats2bfloat162_rn(dva[4 * j + 2], dva[4 * j + 3]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dkdv_sm90_kernel(const __grid_constant__ HeadMaps tq,
                               const __grid_constant__ HeadMaps tk,
                               const __grid_constant__ HeadMaps tv,
                               const __grid_constant__ HeadMaps tdo,
                               const float* __restrict__ lse,
                               const float* __restrict__ dd,
                               bf16* __restrict__ dk, bf16* __restrict__ dv,
                               int B, int Sq, int Skv, int Hq, int Hkv,
                               int causal, float scale, float scale_log2,
                               int q_offset) {
  constexpr int kQTile = tile_bytes<D, kRows>();
  constexpr int kKTile = tile_bytes<D, kKeys>();
  constexpr int kO = D / 2;          // dK, dV registers a thread (m64nD)
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t s_k = (raw + 1023) & ~1023u;
  const uint32_t s_v = s_k + kKTile;
  const uint32_t s_q = s_v + kKTile;                // kStagesQ tiles
  const uint32_t s_do = s_q + kStagesQ * kQTile;    // kStagesQ tiles
  const uint32_t s_rows = s_do + kStagesQ * kQTile;  // 64 LSE, 64 D a stage
  float* rows = reinterpret_cast<float*>(smem_raw + (s_rows - raw));
  const uint32_t bars = s_rows + kStagesQ * 2 * kRows * 4;
  const uint32_t kv_full = bars, kv_empty = bars + 8;
  auto full = [&](int s) { return bars + 8 * (2 + s); };
  auto empty = [&](int s) { return bars + 8 * (2 + kStagesQ + s); };
  const int G = Hq / Hkv, off = q_offset;   // q row i sits at i + off
  const int n_kt = (Skv + kKeys - 1) / kKeys;
  const int n_qt = (Sq + kRows - 1) / kRows;
  const int n_tiles = n_kt * Hkv * B;

  dkdv_bars_init<kStagesQ>(bars);
  if (threadIdx.x >= kConsumers) {
    dkdv_producer<D, kKeys, kStagesQ>(tq, tk, tv, tdo, lse, dd, s_k, s_v,
                                      s_q, s_do, rows, bars, B, Sq, Skv, Hq,
                                      Hkv, causal, off);
    return;
  }

  // --- consumers: warpgroup wg owns keys 64 wg .. 64 wg + 63 of a tile ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kConsumerRegs));
  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
  const int cq = wgmma_col(t), rq = wgmma_row(t);
  float dka[kO], dva[kO];
  int it = 0;                                    // q tiles consumed
  for (int round = 0;; ++round) {
    const int i = snake(round, n_tiles);
    if (i < 0) break;
    const int kt = i / (Hkv * B), hk = i % Hkv, b = (i / Hkv) % B;
    const int k0 = kt * kKeys + wg * kRows;      // the warpgroup's first key
    const int key0 = k0 + rq;                    // the thread's, and + 8
    const int qf = q_first(kt * kKeys, causal, off), n_q = n_qt - qf;
#pragma unroll
    for (int j = 0; j < kO; ++j) dka[j] = dva[j] = 0.f;
    mbar_wait(kv_full, round & 1);

    for (int n = 0; n < G * n_q; ++n, ++it) {
      const int qt = qf + n % n_q;
      const int s = it % kStagesQ;
      const uint32_t qs = s_q + s * kQTile, dos = s_do + s * kQTile;
      mbar_wait(full(s), (it / kStagesQ) & 1);
      // S^T = K Q^T, dP^T = V dO^T (64 keys x 64 q rows each)
      float st[32], dpt[32];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss_n64(st, kmajor<D, kKeys>(s_k, wg * kRows, kk),
                     kmajor<D, kRows>(qs, 0, kk), kk > 0);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss_n64(dpt, kmajor<D, kKeys>(s_v, wg * kRows, kk),
                     kmajor<D, kRows>(dos, 0, kk), kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(st);
      fence_regs(dpt);
      // P^T and dS^T in place; a thread's columns are q rows 8j + cq + e
      const float* l2 = rows + s * 2 * kRows;
      const float* ds = l2 + kRows;
      const int q0 = qt * kRows;
      const bool edge = causal && k0 + kRows - 1 > q0 + off;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = 8 * j + cq + e;
          const float lc = l2[col], dc = ds[col];
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int x = 4 * j + 2 * r + e;
            float p = ex2(fmaf(st[x], scale_log2, -lc));
            if (edge && key0 + 8 * r > q0 + col + off) p = 0.f;
            st[x] = p;
            dpt[x] = p * (dpt[x] - dc);
          }
        }
      uint32_t pa[4][4], sa[4][4];
      pack_a<64>(st, pa);        // P rounded to bf16, as the forward's P.V
      pack_a<64>(dpt, sa);       // dS rounded to bf16
      // dV += P^T dO, dK += dS^T Q over the tile's 64 q rows
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kRows / 16; ++kk)
        wgmma_rs_tile<D, kRows>(dva, pa[kk], dos, kk * 16);
#pragma unroll
      for (int kk = 0; kk < kRows / 16; ++kk)
        wgmma_rs_tile<D, kRows>(dka, sa[kk], qs, kk * 16);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dva);
      fence_regs(dka);
      mbar_arrive(empty(s));
    }
    mbar_arrive(kv_empty);
    store_dkdv<kO>(dk, dv, dka, dva, b, key0, hk, cq, Skv, Hkv, D, scale);
  }
}

// --- 2, at head dim 192 ----------------------------------------------------
// A 128-key tile would keep dK and dV at m64n192 in each warpgroup's
// registers: 96 + 96 float32 a thread beside S^T and dP^T (32 + 32), past
// the 255 a thread can have.  So the two consumer warpgroups share one
// 64-key tile and split each q tile's work between them:
//   S^T and dP^T (64 keys x 64 q rows): warpgroup wg computes q rows
//     32 wg .. 32 wg + 31 of both (wgmma.m64n32k16, twelve k steps over
//     the three 64-column boxes), P^T and dS^T in registers, and hands
//     them over rounded to bf16 into two 64 x 64 tiles in shared memory
//     (keys as rows, the 128-byte swizzle: wgmma's K-major A operand);
//   dV += P^T dO and dK += dS^T Q: warpgroup wg owns columns 96 wg .. 96
//     wg + 95 of both (48 + 48 float32 a thread), A the hand-over tiles,
//     B the stage's dO and Q (MN-major), four k steps over the stage's 64
//     q rows, each an m64n64k16 over a whole box (0 for warpgroup 0, 2
//     for 1) and an m64n32k16 over half of box 1 (the first or second 64
//     bytes of its 128-byte rows: the descriptor's swizzle is taken on
//     the address, as a K-major k step's 32-byte offsets are).
// The hand-over tiles are double-buffered (q tile g of the walk writes
// pair g % 2) and one named barrier a q tile joins the two warpgroups:
// before it each has written and fenced its halves (wgmma reads them
// through the async proxy) and waited for its own dK/dV products of q
// tile g - 1, so no warpgroup overwrites a pair the other still reads.
// Each warpgroup issues S^T and dP^T of q tile g + 1 before its softmax
// of tile g, which runs under them and under the dK/dV products of tile
// g - 1.  Shared memory: K and V (48 KB), the hand-over pairs (32 KB) and
// kStagesW q/dO stages (48 KB each): 227 KB at 3 stages.
constexpr int kKeysW = 64;           // keys a D 192 dk/dv tile
constexpr int kColsW = 96;           // dK, dV columns a warpgroup at D 192
// the D 192 q/dO ring: at least 3, since q tile g + 1's S^T and dP^T are
// issued before the stage of q tile g - 1 goes back to the producer
constexpr int kStagesW = 3;
constexpr int kHand = 64 * 64 * 2;   // a 64 x 64 bf16 hand-over tile

template <int D>
constexpr size_t dkdv_wide_smem() {
  // K and V (64 rows), two hand-over pairs, the q and dO ring, each
  // stage's 64 LSEs and Ds, 2 + 2 kStagesW mbarriers, alignment slack
  return 2 * (size_t)tile_bytes<D, kKeysW>() + 4 * (size_t)kHand +
         2 * (size_t)kStagesW * tile_bytes<D, kRows>() +
         (size_t)kStagesW * 2 * kRows * 4 + 8 * (2 + 2 * kStagesW) + 1024;
}
static_assert(kStagesW >= 3, "the D 192 ring: three stages or more");
static_assert(dkdv_wide_smem<192>() <= 232448,
              "the D 192 dk/dv plan: at most 227 KB of shared memory");

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dkdv_wide_kernel(const __grid_constant__ HeadMaps tq,
                               const __grid_constant__ HeadMaps tk,
                               const __grid_constant__ HeadMaps tv,
                               const __grid_constant__ HeadMaps tdo,
                               const float* __restrict__ lse,
                               const float* __restrict__ dd,
                               bf16* __restrict__ dk, bf16* __restrict__ dv,
                               int B, int Sq, int Skv, int Hq, int Hkv,
                               int causal, float scale, float scale_log2,
                               int q_offset) {
  static_assert(D == 2 * kColsW && D % kBox == 0, "D 192: three boxes");
  constexpr int kQTile = tile_bytes<D, kRows>();
  constexpr int kKTile = tile_bytes<D, kKeysW>();
  constexpr int kBoxT = kRows * kBox * 2;   // a box of a 64-row tile (LBO)
  constexpr int kN = kColsW / 2;            // dK, dV registers a thread
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t s_k = (raw + 1023) & ~1023u;
  const uint32_t s_v = s_k + kKTile;
  const uint32_t s_hand = s_v + kKTile;             // 2 x (P^T, dS^T)
  const uint32_t s_q = s_hand + 4 * kHand;          // kStagesW tiles
  const uint32_t s_do = s_q + kStagesW * kQTile;    // kStagesW tiles
  const uint32_t s_rows = s_do + kStagesW * kQTile;  // 64 LSE, 64 D a stage
  float* rows = reinterpret_cast<float*>(smem_raw + (s_rows - raw));
  const uint32_t bars = s_rows + kStagesW * 2 * kRows * 4;
  const uint32_t kv_full = bars, kv_empty = bars + 8;
  auto full = [&](int s) { return bars + 8 * (2 + s); };
  auto empty = [&](int s) { return bars + 8 * (2 + kStagesW + s); };
  const int G = Hq / Hkv, off = q_offset;   // q row i sits at i + off
  const int n_qt = (Sq + kRows - 1) / kRows;
  const int n_tiles = (Skv + kKeysW - 1) / kKeysW * Hkv * B;

  dkdv_bars_init<kStagesW>(bars);
  if (threadIdx.x >= kConsumers) {
    dkdv_producer<D, kKeysW, kStagesW>(tq, tk, tv, tdo, lse, dd, s_k, s_v,
                                       s_q, s_do, rows, bars, B, Sq, Skv,
                                       Hq, Hkv, causal, off);
    return;
  }

  // --- consumers: warpgroup wg, q rows 32 wg.. of S^T, columns 96 wg.. ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kConsumerRegs));
  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
  const int cq = wgmma_col(t), rq = wgmma_row(t);
  float dka[kN], dva[kN];
  float sa0[16], da0[16], sa1[16], da1[16];     // S^T, dP^T of two q tiles

  // S^T and dP^T of the warpgroup's 32 q rows of stage s, committed
  auto issue_sdp = [&](float (&st)[16], float (&dpt)[16], int s) {
    const uint32_t qs = s_q + s * kQTile, dos = s_do + s * kQTile;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n32(st, kmajor<D, kKeysW>(s_k, 0, kk),
                   kmajor<D, kRows>(qs, 32 * wg, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n32(dpt, kmajor<D, kKeysW>(s_v, 0, kk),
                   kmajor<D, kRows>(dos, 32 * wg, kk), kk > 0);
    wgmma_commit();
  };
  // dV += P^T dO, dK += dS^T Q over stage s's 64 q rows and the
  // warpgroup's 96 columns, A from hand-over pair h; committed.  Both
  // warpgroups issue the same products (ptxas serializes wgmma whose
  // shape depends on the warpgroup): an n64 over a whole box (0 or 2)
  // into registers 0-31 and an n32 over half of box 1 (its 128-byte
  // rows' first or second 64 bytes) into registers 32-47
  const uint32_t box64 = wg * 2 * kBoxT, half32 = kBoxT + wg * 64;
  auto issue_dkv = [&](int s, int h) {
    const uint32_t qs = s_q + s * kQTile, dos = s_do + s * kQTile;
    const uint32_t pt = s_hand + h * 2 * kHand, dst = pt + kHand;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kRows / 16; ++kk) {
      const uint64_t ap = kmajor<64, 64>(pt, 0, kk);
      const uint64_t as = kmajor<64, 64>(dst, 0, kk);
      const uint32_t r = kk * 16 * kBox * 2;     // q rows 16 kk ..
      wgmma_sst_n64(part<32, 0>(dva), ap,
                    smem_desc(dos + box64 + r, kBoxT, 1024));
      wgmma_sst_n32(part<16, 32>(dva), ap,
                    smem_desc(dos + half32 + r, kBoxT, 1024));
      wgmma_sst_n64(part<32, 0>(dka), as,
                    smem_desc(qs + box64 + r, kBoxT, 1024));
      wgmma_sst_n32(part<16, 32>(dka), as,
                    smem_desc(qs + half32 + r, kBoxT, 1024));
    }
    wgmma_commit();
  };

  int it = 0;                                    // q tiles consumed
  for (int round = 0;; ++round) {
    const int i = snake(round, n_tiles);
    if (i < 0) break;
    const int kt = i / (Hkv * B), hk = i % Hkv, b = (i / Hkv) % B;
    const int k0 = kt * kKeysW;
    const int key0 = k0 + rq;                    // the thread's, and + 8
    const int qf = q_first(k0, causal, off), n_q = n_qt - qf;
    const int n_steps = n_q > 0 ? G * n_q : 0;
#pragma unroll
    for (int j = 0; j < kN; ++j) dka[j] = dva[j] = 0.f;
    mbar_wait(kv_full, round & 1);

    // q tile n of the walk (g = it + n overall): its S^T and dP^T were
    // issued into st and dpt, and the next tile's go into nst and ndpt
    // unless n is the last.  Before step n the pending wgmma groups are
    // S^T, dP^T of n, then (past the first) dK, dV of n - 1.  ``first``
    // and ``more`` are compile-time flags, so every wait's count is known
    // where it stands: ptxas serializes wgmma around a wait whose count
    // it cannot place.
    auto step = [&](auto first, auto more, float (&st)[16],
                    float (&dpt)[16], float (&nst)[16], float (&ndpt)[16],
                    int n) {
      constexpr bool kMore = decltype(more)::value;
      const int g = it + n, s = g % kStagesW;
      if constexpr (decltype(first)::value) {    // S^T, dP^T of n are in
        wgmma_wait<0>();
      } else {
        wgmma_wait<1>();
      }
      fence_regs(st);
      fence_regs(dpt);
      if constexpr (kMore) {
        const int s1 = (g + 1) % kStagesW;
        mbar_wait(full(s1), ((g + 1) / kStagesW) & 1);
        issue_sdp(nst, ndpt, s1);
      }
      // P^T and dS^T rounded to bf16 straight into hand-over pair g % 2
      // (written nowhere else: ptxas serializes wgmma whose accumulator
      // registers other instructions write), under the dK/dV products of
      // q tile n - 1, which read the other pair.  A thread's columns are q
      // rows 32 wg + 8 j + cq + e of the stage, its rows keys key0 + 8 r.
      const float* l2 = rows + s * 2 * kRows;
      const float* ds = l2 + kRows;
      const int q0 = (qf + n % n_q) * kRows;
      const bool edge = causal && k0 + kKeysW - 1 > q0 + off;
      const uint32_t pt = s_hand + (g & 1) * 2 * kHand, dst = pt + kHand;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = 32 * wg + 8 * j + cq;
        const float2 lc = make_float2(l2[col], l2[col + 1]);
        const float2 dc = make_float2(ds[col], ds[col + 1]);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int x = 4 * j + 2 * r, key = key0 + 8 * r;
          float p0 = ex2(fmaf(st[x], scale_log2, -lc.x));
          float p1 = ex2(fmaf(st[x + 1], scale_log2, -lc.y));
          if (edge && key > q0 + col + off) p0 = 0.f;
          if (edge && key > q0 + col + 1 + off) p1 = 0.f;
          const uint32_t at = swizzle128(rq + 8 * r, col);
          sts_u32(pt + at, pack_bf16(p0, p1));
          sts_u32(dst + at, pack_bf16(p0 * (dpt[x] - dc.x),
                                      p1 * (dpt[x + 1] - dc.y)));
        }
      }
      // the dK/dV products of q tile n - 1 are in: its stage goes back,
      // and past the barrier the other warpgroup may write their pair
      if constexpr (kMore) {
        wgmma_wait<1>();
      } else {
        wgmma_wait<0>();
      }
      fence_regs(dka);
      fence_regs(dva);
      if (n > 0) mbar_arrive(empty((g - 1) % kStagesW));
      fence_async_smem();
      bar_sync(1, kConsumers);                   // both halves are written
      issue_dkv(s, g & 1);
    };
    const std::true_type yes{};
    const std::false_type no{};

    if (n_steps > 0) {
      mbar_wait(full(it % kStagesW), (it / kStagesW) & 1);
      issue_sdp(sa0, da0, it % kStagesW);
      if (n_steps == 1) {
        step(yes, no, sa0, da0, sa1, da1, 0);
      } else {
        step(yes, yes, sa0, da0, sa1, da1, 0);
        int n = 1;
        for (; n + 2 < n_steps; n += 2) {
          step(no, yes, sa1, da1, sa0, da0, n);
          step(no, yes, sa0, da0, sa1, da1, n + 1);
        }
        if (n + 1 < n_steps) {
          step(no, yes, sa1, da1, sa0, da0, n);
          step(no, no, sa0, da0, sa1, da1, n + 1);
        } else {
          step(no, no, sa1, da1, sa0, da0, n);
        }
      }
    }
    wgmma_wait<0>();                             // the last dK, dV are in
    fence_regs(dka);
    fence_regs(dva);
    if (n_steps > 0) mbar_arrive(empty((it + n_steps - 1) % kStagesW));
    it += n_steps;
    mbar_arrive(kv_empty);
    // registers 0-31: box 0 or 2's columns; 32-47: half of box 1's
    store_dkdv<32>(dk, dv, part<32, 0>(dka), part<32, 0>(dva), b, key0, hk,
                   wg * 2 * kBox + cq, Skv, Hkv, D, scale);
    store_dkdv<16>(dk, dv, part<16, 32>(dka), part<16, 32>(dva), b, key0, hk,
                   kBox + wg * kBox / 2 + cq, Skv, Hkv, D, scale);
  }
}

// --- 3. dq ---------------------------------------------------------------
template <int D>
constexpr size_t dq_smem() {
  // Q and dO (128 rows), the K and V ring (64 keys a stage), 2 + 2
  // kStagesKV mbarriers, and slack to align the base to 1024 bytes
  return 2 * (size_t)tile_bytes<D, kQRows>() +
         2 * (size_t)kStagesKV * tile_bytes<D, kRows>() +
         8 * (2 + 2 * kStagesKV) + 1024;
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dq_sm90_kernel(const __grid_constant__ HeadMaps tq,
                             const __grid_constant__ HeadMaps tk,
                             const __grid_constant__ HeadMaps tv,
                             const __grid_constant__ HeadMaps tdo,
                             const float* __restrict__ lse,
                             const float* __restrict__ dd,
                             bf16* __restrict__ dq, int B, int Sq, int Skv,
                             int Hq, int Hkv, int causal, float scale,
                             float scale_log2, int q_offset) {
  constexpr int kQT = tile_bytes<D, kQRows>();
  constexpr int kKT = tile_bytes<D, kRows>();
  constexpr int kO = D / 2;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t s_q = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t s_do = s_q + kQT;
  const uint32_t s_k = s_do + kQT;                 // kStagesKV tiles
  const uint32_t s_v = s_k + kStagesKV * kKT;      // kStagesKV tiles
  const uint32_t bars = s_v + kStagesKV * kKT;
  const uint32_t full_q = bars, empty_q = bars + 8;
  auto full_kv = [&](int s) { return bars + 8 * (2 + s); };
  auto empty_kv = [&](int s) { return bars + 8 * (2 + kStagesKV + s); };
  const int group = Hq / Hkv, off = q_offset;
  const int n_qt = (Sq + kQRows - 1) / kQRows;
  const int n_tiles = n_qt * Hq * B;
  // tile i: the last q tiles (the longest causal walks) first, neighbours
  // sharing a KV head
  auto tile_of = [&](int i, int& qt, int& h, int& b) {
    qt = n_qt - 1 - i / (Hq * B);
    h = i % Hq;
    b = (i / Hq) % B;
  };
  // 64-key tiles q tile qt walks: all, or up to its last row's diagonal
  auto kv_tiles = [&](int qt) {
    const int last_row = min((qt + 1) * kQRows, Sq) - 1;
    const int k_end = causal ? min(Skv, last_row + off + 1) : Skv;
    return (k_end + kRows - 1) / kRows;
  };

  if (threadIdx.x == 0) {
    mbar_init(full_q, 1);
    mbar_init(empty_q, kConsumers);
    for (int s = 0; s < kStagesKV; ++s) {
      mbar_init(full_kv(s), 1);
      mbar_init(empty_kv(s), kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // --- producer: one thread issues every TMA load ----------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kProducerRegs));
    if (threadIdx.x == kConsumers) {
      int it = 0;                                // K/V tiles issued so far
      for (int round = 0;; ++round) {
        const int i = snake(round, n_tiles);
        if (i < 0) break;
        int qt, h, b;
        tile_of(i, qt, h, b);
        mbar_wait(empty_q, (round & 1) ^ 1);
        mbar_expect_tx(full_q, 2 * kQT);
        load_tile<D, kQRows, kRows>(s_q, tq, full_q, h, qt * kQRows, b);
        load_tile<D, kQRows, kRows>(s_do, tdo, full_q, h, qt * kQRows, b);
        const int n_kt = kv_tiles(qt);
        for (int kt = 0; kt < n_kt; ++kt, ++it) {
          const int s = it % kStagesKV;
          mbar_wait(empty_kv(s), ((it / kStagesKV) & 1) ^ 1);
          mbar_expect_tx(full_kv(s), 2 * kKT);
          load_tile<D, kRows, kRows>(s_k + s * kKT, tk, full_kv(s),
                                     h / group, kt * kRows, b);
          load_tile<D, kRows, kRows>(s_v + s * kKT, tv, full_kv(s),
                                     h / group, kt * kRows, b);
        }
      }
    }
    return;
  }

  // --- consumers: warpgroup wg owns q rows 64 wg .. 64 wg + 63 of a tile --
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kConsumerRegs));
  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
  const int cq = wgmma_col(t), rq = wgmma_row(t);
  float dqa[kO];
  int it = 0;                                    // K/V tiles consumed
  for (int round = 0;; ++round) {
    const int i = snake(round, n_tiles);
    if (i < 0) break;
    int qt, h, b;
    tile_of(i, qt, h, b);
    const int row0 = qt * kQRows + wg * kRows + rq;   // and row0 + 8
    const int64_t at_r = ((int64_t)b * Hq + h) * Sq;
    // the rows' LSE in log2 units (+inf past Sq: P = 0) and D
    const float l0 = row0 < Sq ? lse[at_r + row0] * kLog2e : CUDART_INF_F;
    const float l1 =
        row0 + 8 < Sq ? lse[at_r + row0 + 8] * kLog2e : CUDART_INF_F;
    const float d0 = row0 < Sq ? dd[at_r + row0] : 0.f;
    const float d1 = row0 + 8 < Sq ? dd[at_r + row0 + 8] : 0.f;
    // last key each of the thread's rows may see
    const int lim0 = causal ? min(Skv - 1, row0 + off) : Skv - 1;
    const int lim1 = causal ? min(Skv - 1, row0 + 8 + off) : Skv - 1;
    const int wg_pos = qt * kQRows + wg * kRows + off;  // first row's key
    const int n_kt = kv_tiles(qt);
#pragma unroll
    for (int j = 0; j < kO; ++j) dqa[j] = 0.f;
    mbar_wait(full_q, round & 1);
    if (n_kt == 0) mbar_arrive(empty_q);
    for (int kt = 0; kt < n_kt; ++kt) {
      const int s = (it + kt) % kStagesKV;
      const uint32_t ks = s_k + s * kKT, vs = s_v + s * kKT;
      mbar_wait(full_kv(s), ((it + kt) / kStagesKV) & 1);
      // S = Q K^T, dP = dO V^T (64 q rows x 64 keys each)
      float sc[32], dp[32];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss_n64(sc, kmajor<D, kQRows>(s_q, wg * kRows, kk),
                     kmajor<D, kRows>(ks, 0, kk), kk > 0);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss_n64(dp, kmajor<D, kQRows>(s_do, wg * kRows, kk),
                     kmajor<D, kRows>(vs, 0, kk), kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);
      fence_regs(dp);
      if (kt == n_kt - 1) mbar_arrive(empty_q);   // done with Q and dO
      // dS in place of S; masked only on tiles that cross the ragged key
      // edge or the diagonal
      const int k0 = kt * kRows;
      const bool edge = k0 + kRows > Skv || (causal && k0 + kRows - 1 > wg_pos);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = k0 + 8 * j + cq + e;
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int x = 4 * j + 2 * r + e;
            float p = ex2(fmaf(sc[x], scale_log2, -(r ? l1 : l0)));
            if (edge && col > (r ? lim1 : lim0)) p = 0.f;
            sc[x] = p * (dp[x] - (r ? d1 : d0));
          }
        }
      uint32_t sa[4][4];
      pack_a<64>(sc, sa);        // dS rounded to bf16
      // dQ += dS K over the tile's 64 keys
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kRows / 16; ++kk)
        wgmma_rs_tile<D, kRows>(dqa, sa[kk], ks, kk * 16);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dqa);
      mbar_arrive(empty_kv(s));
    }
    it += n_kt;

    // dq = scale dQ, bf16 pairs straight from registers
    const int64_t at = (((int64_t)b * Sq + row0) * Hq + h) * D + cq;
    const int64_t down = (int64_t)8 * Hq * D;         // row0 + 8
#pragma unroll
    for (int j = 0; j < kO / 4; ++j) {
      if (row0 < Sq)
        *reinterpret_cast<__nv_bfloat162*>(dq + at + 8 * j) =
            __floats2bfloat162_rn(dqa[4 * j] * scale, dqa[4 * j + 1] * scale);
      if (row0 + 8 < Sq)
        *reinterpret_cast<__nv_bfloat162*>(dq + at + down + 8 * j) =
            __floats2bfloat162_rn(dqa[4 * j + 2] * scale,
                                  dqa[4 * j + 3] * scale);
    }
  }
}

// --- host --------------------------------------------------------------
// As few CTAs as keep each one's rounds at their least (ceil(tiles /
// SMs)): with the snake, a CTA's tiles then pair long walks with short.
inline int persistent_ctas(int tiles) {
  const int sms = sm_count();
  const int rounds = (tiles + sms - 1) / sms;
  return (tiles + rounds - 1) / rounds;
}

template <int D>
int launch(const void* q, const void* k, const void* v, const float* out,
           const void* dout, const float* lse, float* dd, void* dq,
           void* dk, void* dv, int B, int Sq, int Skv, int Hq, int Hkv,
           int causal, float scale, int q_offset, cudaStream_t stream) {
  const int64_t rows = (int64_t)B * Sq * Hq;
  const int per = kDotThreads / 32;
  flash_bwd_dot_sm90_kernel<<<(unsigned)((rows + per - 1) / per),
                              kDotThreads, 0, stream>>>(
      out, static_cast<const bf16*>(dout), dd, B, Sq, Hq, D);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (Skv == 0)          // no key: dq is 0, dk and dv are empty
    return static_cast<int>(cudaMemsetAsync(
        dq, 0, (size_t)rows * D * sizeof(bf16), stream));
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
  HeadMaps tq{}, tk{}, tv{}, tdo{};
  if (!encode_head<D>(fn, &tq, q, B, Sq, Hq, kRows) ||
      !encode_head<D>(fn, &tdo, dout, B, Sq, Hq, kRows) ||
      !encode_head<D>(fn, &tk, k, B, Skv, Hkv, kRows) ||
      !encode_head<D>(fn, &tv, v, B, Skv, Hkv, kRows))
    return static_cast<int>(cudaErrorInvalidValue);
  // the dk/dv pass: 64-key tiles split between the warpgroups at D 192,
  // 128-key tiles of 64 keys a warpgroup below it
  constexpr bool wide = D == 192;
  const void* dkdv;
  int kv_smem;
  if constexpr (wide) {
    dkdv = reinterpret_cast<const void*>(flash_bwd_dkdv_wide_kernel<D>);
    kv_smem = (int)dkdv_wide_smem<D>();
  } else {
    dkdv = reinterpret_cast<const void*>(flash_bwd_dkdv_sm90_kernel<D>);
    kv_smem = (int)dkdv_smem<D>();
  }
  static int set_kv = 0, set_q = 0;
  err = allow_smem(dkdv, kv_smem, set_kv);
  if (err == cudaSuccess)
    err = allow_smem(reinterpret_cast<const void*>(
                         flash_bwd_dq_sm90_kernel<D>),
                     (int)dq_smem<D>(), set_q);
  if (err != cudaSuccess) return static_cast<int>(err);
  const float scale_log2 = scale * kLog2e;
  const int key_tile = wide ? kKeysW : kKeys;
  const int kv_tiles = (Skv + key_tile - 1) / key_tile * Hkv * B;
  if constexpr (wide) {
    flash_bwd_dkdv_wide_kernel<D>
        <<<persistent_ctas(kv_tiles), kThreads, kv_smem, stream>>>(
            tq, tk, tv, tdo, lse, dd, static_cast<bf16*>(dk),
            static_cast<bf16*>(dv), B, Sq, Skv, Hq, Hkv, causal, scale,
            scale_log2, q_offset);
  } else {
    flash_bwd_dkdv_sm90_kernel<D>
        <<<persistent_ctas(kv_tiles), kThreads, kv_smem, stream>>>(
            tq, tk, tv, tdo, lse, dd, static_cast<bf16*>(dk),
            static_cast<bf16*>(dv), B, Sq, Skv, Hq, Hkv, causal, scale,
            scale_log2, q_offset);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int q_tiles = (Sq + kQRows - 1) / kQRows * Hq * B;
  flash_bwd_dq_sm90_kernel<D>
      <<<persistent_ctas(q_tiles), kThreads, dq_smem<D>(), stream>>>(
          tq, tk, tv, tdo, lse, dd, static_cast<bf16*>(dq), B, Sq, Skv, Hq,
          Hkv, causal, scale, scale_log2, q_offset);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The backward of flash_attention_sm90_launch, with the arguments of
// flash_attention_bwd_launch: q (B, Sq, Hq, D), k and v (B, Skv, Hkv, D)
// and dout (B, Sq, Hq, D), contiguous bfloat16 (dtype 1) with 16-byte
// aligned q, k, v and dout (read by TMA), the forward's float32 output
// out (B, Sq, Hq, D) and its lse (B, Hq, Sq) -> dq, dk, dv of the inputs'
// shapes in bfloat16, using dd (B, Hq, Sq) float32 as scratch.  Query row
// i sits at position i + q_offset, the forward's (q_offset comes last,
// after the stream).  Requires D 64, 80, 128 or 192, B, Sq >= 1,
// Hq % Hkv == 0 and q_offset >= 0.  Returns the first launch error (0 on success).
extern "C" int flash_attention_bwd_sm90_launch(
    const void* q, const void* k, const void* v, const void* out,
    const void* dout, const void* lse, void* dd, void* dq, void* dk,
    void* dv, int B, int Sq, int Skv, int Hq, int Hkv, int D, int dtype,
    int causal, float scale, void* stream, int q_offset) {
  if (dtype != 1 || B < 1 || Sq < 1 || q_offset < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* o = static_cast<const float*>(out);
  const float* l = static_cast<const float*>(lse);
  float* d = static_cast<float*>(dd);
  if (D == 192)
    return launch<192>(q, k, v, o, dout, l, d, dq, dk, dv, B, Sq, Skv, Hq,
                       Hkv, causal, scale, q_offset, st);
  if (D == 128)
    return launch<128>(q, k, v, o, dout, l, d, dq, dk, dv, B, Sq, Skv, Hq,
                       Hkv, causal, scale, q_offset, st);
  if (D == 80)
    return launch<80>(q, k, v, o, dout, l, d, dq, dk, dv, B, Sq, Skv, Hq,
                      Hkv, causal, scale, q_offset, st);
  if (D == 64)
    return launch<64>(q, k, v, o, dout, l, d, dq, dk, dv, B, Sq, Skv, Hq,
                      Hkv, causal, scale, q_offset, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
