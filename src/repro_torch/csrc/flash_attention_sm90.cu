// Causal or non-causal GQA attention with an online softmax (forward):
// the Hopper instance, for bfloat16 with head dim 64, 80, 128 or 192.
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
//         j > i + q_offset, q_offset the absolute position of query row 0
//         (the model's Skv - Sq by default, a shard's first position under
//         context parallelism; the Pallas body has none),
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
// special-function units).  At Zamba2-2.7B's (32/32 heads of 80) the
// products shrink to 1.72e11 FLOP (0.174 ms) and the exps stay.  At
// Nemotron-4-340B's (96/8 heads of 192) they are 1.24e12 FLOP (1.25 ms)
// against 1.6e9 exps (0.385 ms) and 654 MB (0.195 ms).
//
// Design (FlashAttention-3's shape).  A persistent grid, one CTA of 384
// threads per SM, walks the (128-row q tile, q head, batch) tiles,
// longest causal tiles first.  A CTA is two consumer warpgroups of 64 q
// rows each and a producer warpgroup, which hands its registers to the
// consumers (setmaxnreg: 24 against 240 a thread).  One producer thread
// loads each tile's q once and keeps BK-key K and V tiles in flight
// through a ring in shared memory, all by TMA: 4-D maps over (D, H, S,
// B), one head per box, 64 columns a box with the 128-byte swizzle, so a
// 128-wide head is two boxes and a 192-wide one three; rows past S come
// back as zeros.  A head of 80 (Zamba2, HuBERT) is one 64-column box and
// a 16-column tail box with the 32-byte swizzle, whose atom is exactly
// one 16-deep k step.  The shared-memory plan (sm90.cuh, tile_bytes; at
// most 227 KB a block):
//   D 64, 128: BK 128, 2 stages (160 KB with q at D 128);
//   D 80:      BK 128 (16 + 4 KB a tile), 3 stages in 140 KB with q;
//   D 192:     BK 112 (key_tile: a 128-key tile is 48 KB, and q with two
//              K and two V stages would be 240 KB), 42 KB a tile, 2
//              stages: 48 + 4 x 42 = 216 KB with q.
// Full and empty mbarriers guard q and each K and V stage; the ring runs
// on across tiles, so the next tile's loads overlap this one's last
// products and epilogue.  Each consumer warpgroup, per K/V tile:
//   S = Q K^T by wgmma.m64nBKk16 over D / 16 k steps, both operands
//     from shared memory by descriptor (at D 80 four steps over the
//     128-byte boxes and one over the tail's 32-byte ones), float32
//     accumulator in registers.  The accumulator's
//     layout gives each thread two rows (wgmma_row/wgmma_col), so the
//     row max and sum are quad shuffles and no score touches shared
//     memory;
//   the softmax runs in registers with ex2.approx, scale * log2 e folded
//     into one FMA; only tiles that cross the causal diagonal of one of
//     the warpgroup's rows or the ragged key edge are masked (with BK
//     112 a 128-row tile's diagonal crosses two or three key tiles);
//   P is packed to bfloat16 pairs in registers: the accumulator layout of
//     S is the register layout of wgmma's A operand, so O += P V is
//     wgmma.m64nDk16 with A from registers and V (keys, D) from shared
//     memory as the MN-major B operand (the descriptor's transpose bit),
//     BK / 16 k steps;
//     at D 80 each k step is an n64 over the 64-column box and an n16
//     over the tail box into O's last 8 registers (columns 64-79), so O
//     keeps the m64nD layout and the epilogue stores it as one.
//     O stays in registers and is rescaled there: at D 192, 96 float32 a
//     thread beside S's 56 and P's 28.
// Overlap: S of tile kt is issued with P.V of tile kt - 1, and the
// softmax of tile kt runs while the tensor cores do that P.V (and the
// other warpgroup's products).
// Training: when the caller gives an lse buffer, the epilogue also writes
// each row's log-sum-exp for the backward (csrc/flash_attention_bwd_sm90.cu,
// which reads it with the float32 output); serving passes none and skips
// the store.
#include "sm90.cuh"   // TMA, wgmma, descriptors, the tensor-map encoder

namespace {

using namespace sm90;

constexpr int kBQ = 128;             // q rows per tile
constexpr int kConsumers = 256;      // two warpgroups of 64 q rows
constexpr int kThreads = kConsumers + 128;  // + the producer warpgroup
constexpr int kSmemMax = 232448;     // dynamic shared memory a block may have
constexpr int kBK192 = 112;          // keys per K/V tile at D 192

// Keys per K/V tile: 128, but at D 192 kBK192 (FlashAttention-3's 112),
// since a 128-key tile of 192 columns is 48 KB and q with two K and two V
// stages would be 240 KB.
template <int D>
__host__ __device__ constexpr int key_tile() {
  return D == 192 ? kBK192 : 128;
}

// K/V ring depth: the tail's smaller tiles leave room for a third stage;
// at D 192 as many stages as fit beside q (up to 3)
template <int D>
__host__ __device__ constexpr int stages() {
  constexpr int fit = (kSmemMax - 1024 - 8 * 14 - tile_bytes<D, kBQ>()) /
                      (2 * tile_bytes<D, key_tile<D>()>());
  return D == 192 ? (fit < 3 ? fit : 3) : has_tail<D>() ? 3 : 2;
}

template <int D>
constexpr size_t smem_bytes() {
  // q, the K and V rings, 2 + 4 stages mbarriers, and slack to align the
  // base to 1024 bytes (the 128-byte swizzle's period)
  return (size_t)tile_bytes<D, kBQ>() +
         (size_t)2 * stages<D>() * tile_bytes<D, key_tile<D>()>() +
         8 * (2 + 4 * stages<D>()) + 1024;
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

// K/V tiles of BK keys that q tile qt (kBQ rows) walks: all, or up to
// its last real row's diagonal (row i sits at position i + off), the last
// one partial where Skv or the diagonal ends inside it
template <int BK>
__device__ __forceinline__ int kv_tiles(int qt, int Sq, int Skv, int causal,
                                        int off) {
  const int last_row = min((qt + 1) * kBQ, Sq) - 1;
  const int k_end = causal ? min(Skv, last_row + off + 1) : Skv;
  return (k_end + BK - 1) / BK;
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_attention_sm90_kernel(const __grid_constant__ HeadMaps tq,
                                const __grid_constant__ HeadMaps tk,
                                const __grid_constant__ HeadMaps tv,
                                bf16* __restrict__ out,
                                float* __restrict__ lse,
                                float* __restrict__ o32, int B, int Sq,
                                int Skv, int Hq, int Hkv, int causal,
                                float scale_log2, int off) {
  constexpr int kBK = key_tile<D>();
  constexpr int kStages = stages<D>();
  constexpr int kQTile = tile_bytes<D, kBQ>();
  constexpr int kTile = tile_bytes<D, kBK>();   // a K or V stage
  constexpr int kO = D / 2;          // O registers a thread (m64nD)
  constexpr int kS = kBK / 2;        // S registers a thread (m64nBK)
  extern __shared__ unsigned char smem_raw[];
  const uint32_t s_q = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t s_k = s_q + kQTile;               // kStages tiles
  const uint32_t s_v = s_k + kStages * kTile;      // kStages tiles
  const uint32_t bars = s_v + kStages * kTile;
  const uint32_t full_q = bars, empty_q = bars + 8;
  auto full_k = [&](int s) { return bars + 8 * (2 + s); };
  auto full_v = [&](int s) { return bars + 8 * (2 + kStages + s); };
  auto empty_k = [&](int s) { return bars + 8 * (2 + 2 * kStages + s); };
  auto empty_v = [&](int s) { return bars + 8 * (2 + 3 * kStages + s); };
  const int n_qt = (Sq + kBQ - 1) / kBQ;
  const int group = Hq / Hkv;

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
        mbar_expect_tx(full_q, kQTile);
        load_tile<D, kBQ, kBQ>(s_q, tq, full_q, t.h, t.qt * kBQ, t.b);
        const int n_kt = kv_tiles<kBK>(t.qt, Sq, Skv, causal, off);
        for (int kt = 0; kt < n_kt; ++kt, ++it) {
          const int s = it % kStages;
          const uint32_t parity = ((it / kStages) & 1) ^ 1;
          mbar_wait(empty_k(s), parity);
          mbar_expect_tx(full_k(s), kTile);
          load_tile<D, kBK, kBK>(s_k + s * kTile, tk, full_k(s),
                                 t.h / group, kt * kBK, t.b);
          mbar_wait(empty_v(s), parity);
          mbar_expect_tx(full_v(s), kTile);
          load_tile<D, kBK, kBK>(s_v + s * kTile, tv, full_v(s),
                                 t.h / group, kt * kBK, t.b);
        }
      }
    }
    return;
  }

  // --- consumers: warpgroup wg owns q rows 64 wg .. 64 wg + 63 of a tile --
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;");
  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
  const int cq = wgmma_col(t);

  // state of the tile in hand
  float o[kO];
  float m0, m1, l0, l1;
  int lim0, lim1, wg_pos;

  // S = Q K^T of stage s into sc (64 x kBK per warpgroup), committed
  auto issue_s = [&](float (&sc)[kS], int s) {
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<kBK>(sc, kmajor<D, kBQ>(s_q, wg * 64, kk),
                    kmajor<D, kBK>(s_k + s * kTile, 0, kk), kk > 0);
    wgmma_commit();
  };
  // O += P V of stage s, committed
  auto issue_pv = [&](const uint32_t (&pa)[kBK / 16][4], int s) {
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
      wgmma_rs_tile<D, kBK>(o, pa[kk], s_v + s * kTile, kk * 16);
    wgmma_commit();
  };
  // Online softmax of K/V tile kt's scores, in place (sc becomes p), in
  // log2 units; updates m and the thread's share of l and returns the
  // rescale factors of O's two rows in f0, f1.
  auto softmax = [&](float (&sc)[kS], int kt, float& f0, float& f1) {
    const int k0 = kt * kBK;
    // mask only tiles that cross the ragged key edge or the diagonal of
    // one of the warpgroup's rows (its first row sees the fewest keys);
    // with kBK < kBQ the diagonal of a q tile crosses two or more
    if (k0 + kBK > Skv || (causal && k0 + kBK - 1 > wg_pos)) {
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = k0 + 8 * j + cq + e;
          if (col > lim0) sc[4 * j + e] = -CUDART_INF_F;
          if (col > lim1) sc[4 * j + 2 + e] = -CUDART_INF_F;
        }
    }
    float mx0 = -CUDART_INF_F, mx1 = -CUDART_INF_F;
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) {
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
    for (int j = 0; j < kBK / 8; ++j) {
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
  Tile tile;
  int it = 0;                                    // K/V tiles consumed
  for (int round = 0; tile_at(round, n_qt, Hq, B, tile); ++round) {
    const int row0 = tile.qt * kBQ + wg * 64 + wgmma_row(t);  // and + 8
    // last key each of the thread's rows may see
    lim0 = causal ? min(Skv - 1, row0 + off) : Skv - 1;
    lim1 = causal ? min(Skv - 1, row0 + 8 + off) : Skv - 1;
    wg_pos = tile.qt * kBQ + wg * 64 + off;     // first row's position
    const int n_kt = kv_tiles<kBK>(tile.qt, Sq, Skv, causal, off);
#pragma unroll
    for (int i = 0; i < kO; ++i) o[i] = 0.f;
    m0 = m1 = -CUDART_INF_F;
    l0 = l1 = 0.f;

    // Tile kt's softmax runs while the tensor cores do tile kt - 1's
    // P.V: S_kt and P_{kt-1} V_{kt-1} are issued together (O is rescaled
    // by tile kt - 1's factors between the two), S_kt is awaited first,
    // and P_kt is packed once P_{kt-1} V_{kt-1} is done.  q is released
    // to the producer once the tile's last S is in.
    float sc[kS], f0, f1;
    uint32_t pa[kBK / 16][4];
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
      pack_a<kBK>(sc, pa);
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
      pack_a<kBK>(sc, pa);
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
template <int D>
int launch(const void* q, const void* k, const void* v, void* out,
           float* lse, float* o32, int B, int Sq, int Skv, int Hq, int Hkv,
           int causal, float scale, int q_offset, cudaStream_t stream) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
  // with no keys the kernel loads no K/V tile: its maps stay blank
  HeadMaps tq{}, tk{}, tv{};
  if (!encode_head<D>(fn, &tq, q, B, Sq, Hq, kBQ) ||
      (Skv > 0 &&
       (!encode_head<D>(fn, &tk, k, B, Skv, Hkv, key_tile<D>()) ||
        !encode_head<D>(fn, &tv, v, B, Skv, Hkv, key_tile<D>()))))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_sm90_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = (Sq + kBQ - 1) / kBQ * Hq * B;
  const int ctas = min(tiles, sm_count());          // one CTA per SM
  flash_attention_sm90_kernel<D><<<ctas, kThreads, smem, stream>>>(
      tq, tk, tv, static_cast<bf16*>(out), lse, o32, B, Sq, Skv, Hq, Hkv,
      causal, scale * kLog2e, q_offset);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q (B, Sq, Hq, D), k and v (B, Skv, Hkv, D) -> out (B, Sq, Hq, D), all
// contiguous bfloat16 with 16-byte aligned q, k, v, and, for the
// backward, where lse is not null, each row's float32 log-sum-exp into lse
// (B, Hq, Sq), and where o32 is not null, out's float32 values before
// rounding into o32 (B, Sq, Hq, D).  Query row i sits at position
// i + q_offset (the model's default is Skv - Sq); q_offset comes last, after
// the stream, so the arguments before it keep the positions of the
// interface without it.  Requires D 64, 80, 128 or 192, Hq % Hkv == 0 and
// q_offset >= 0.  Returns cudaGetLastError() after the launch (0 on
// success), or the error that kept it from launching.
extern "C" int flash_attention_sm90_launch(const void* q, const void* k,
                                           const void* v, void* out,
                                           void* lse, void* o32, int B,
                                           int Sq, int Skv, int Hq, int Hkv,
                                           int D, int causal, float scale,
                                           void* stream, int q_offset) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  float* f = static_cast<float*>(o32);
  if (q_offset < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (D == 192)
    return launch<192>(q, k, v, out, l, f, B, Sq, Skv, Hq, Hkv, causal,
                       scale, q_offset, s);
  if (D == 128)
    return launch<128>(q, k, v, out, l, f, B, Sq, Skv, Hq, Hkv, causal,
                       scale, q_offset, s);
  if (D == 80)
    return launch<80>(q, k, v, out, l, f, B, Sq, Skv, Hq, Hkv, causal,
                      scale, q_offset, s);
  if (D == 64)
    return launch<64>(q, k, v, out, l, f, B, Sq, Skv, Hq, Hkv, causal,
                      scale, q_offset, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
