// Causal or non-causal GQA attention with an online softmax (forward).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/flash_attention/flash_attention.py::
//   flash_attention_kernel (body _kernel; wrapper ops.py::
//   flash_attention_pallas).
// It computes what the JAX package's model path computes with
// models/layers.py::blocked_attention: for query row i of batch b and
// head h, against KV head h / G (G = Hq / Hkv),
//   s_j = <q_i, k_j> * D^-0.5 in float32,  masked where causal and
//         j > i + q_offset, q_offset the absolute position of query row 0:
//         the model's Skv - Sq by default, a shard's first position under
//         context parallelism (the Pallas body has no offset; it agrees
//         with the model only when Sq == Skv),
//   running max m, running sum l and accumulator acc kept on chip,
//   p_j = exp(s_j - m) rounded to v's dtype before P.V (as the Pallas body
//         and blocked_attention do), l summing the unrounded p,
//   out_i = acc / max(l, 1e-30), stored in q's dtype.
// Inputs are float32 or bfloat16; scores, softmax state and accumulator
// are float32.  The kernel masks the ragged Sq / Skv edges of its tiles
// itself, so no padding and no Skv % tile limit.
//
// What bounds it on the H100: operations.  At Yi-6B's prefill shape
// (B 2, S 4096, 32/4 heads of 128, bf16) the causal work is about
// 2.75e11 FLOP against about 151 MB of q, k, v and output.  In float32
// every product is three TF32 products on the tensor cores (split TF32,
// below), so its floor is 3 x FLOP at the 495 TFLOP/s dense TF32 rate:
// 0.104 ms at (1, 1,024, 8/2 heads of 512, full), where the float32 FMA
// rate (67 TFLOP/s) would give 0.256 ms and the first, scalar float32
// design took 4.04 ms.
//
// No score, weight or partial sum goes through device memory.  When the
// caller gives an lse buffer (training), each row's log-sum-exp
// m + log(l) is written for the backward (csrc/flash_attention_bwd.cu);
// serving passes none and skips the store.  The q
// tiles are launched longest-first (the last causal tiles walk the most
// keys), so short tiles fill in behind them.
//
// bfloat16 design.  One CTA of 256 threads (8 warps) per (64-row q tile,
// q head, batch).  The q tile stays in shared memory; the CTA walks
// 64-row K/V tiles up to the causal diagonal, staging each in dynamic
// shared memory.  Per K/V tile:
//   scores S = Q K^T on the tensor cores (WMMA 16x16x16 fragments with
//     float32 accumulation, two 16 x 16 blocks per warp);
//   online softmax: 4 threads per q row reduce its 64 scores by shuffles
//     and keep the row's m and l in registers across tiles; they write p
//     (rounded to v's dtype) and the rescale factor exp(m_old - m_new) to
//     shared memory;
//   P.V on the tensor cores into a float32 tile in shared memory; thread
//     (ty, tx) keeps the output accumulator of rows ty + 16a and columns
//     tx + 16c in registers (4 x 8 up to D = 128, 4 x 16 up to D = 256)
//     and rescales it there.
// Head dims past 256 (any D, as the Pallas body takes): the output
// columns are split into nd = ceil(D / 256) chunks of Dc <= 256 columns
// (a multiple of 16), one CTA per (q tile, head, batch, chunk), each
// keeping its chunk's accumulator in registers as above.  Each such CTA
// computes the scores over all of D, in slices of 256 columns: per K/V
// tile it stages the q and k slices in turn and adds each slice's part
// to the same score accumulators, then stages only its chunk's columns
// of v.  The chunks repeat the score work, nd times in all, and the
// shared memory is that of D = 256.  D <= 256 is one chunk and one slice,
// and runs as before: the q tile is staged once.
//
// float32 design (csrc/tf32.cuh).  The first design ran scalar FMAs, 2
// of them a shared-memory load, so it was bound by shared memory at a
// fraction of even the FMA rate (8.2x SDPA at D 512).  Now every product
// runs on mma.sync m16n8k8 in split TF32 (hi.hi + hi.lo + lo.hi), fed by
// a 2-slot cp.async ring of 64-row, 64-column pieces, so the next
// stage's copies run under this stage's products.  Two kernels:
//   D <= 128 (flash_attention_f32_rows_kernel): 128 q rows a CTA, each
//     warp owning 16 rows whole (scores against all 64 keys of a tile,
//     softmax, output over all D), q resident, p in registers; 139,264
//     bytes of shared memory;
//   D > 128 (flash_attention_f32_kernel): 64 q rows a CTA; the two warps
//     of each row group split a tile's keys for S and the output columns
//     for P.V, sharing p through shared memory, so the scores are
//     computed once per tile whatever D is and one CTA holds up to 512
//     output columns (128 accumulators a thread); past 512 the columns
//     go in chunks of at most 512 to separate CTAs, each repeating the
//     scores (no shape on a path of this repository is that wide);
//     104,960 bytes of shared memory (ring 69,632, the split p tile
//     34,816, a row exchange 512).
// What bounds them now is the issue of the splits and the fragment loads
// beside the mma.sync products (mma.sync reaches about 325 of the 495
// TFLOP/s on this card; scripts/tf32_split_bench.cu), not device memory.
#include "common.cuh"
#include "tf32.cuh"

#include <cuda_bf16.h>
#include <mma.h>

namespace {

using bf16 = __nv_bfloat16;
namespace wmma = nvcuda::wmma;

constexpr int kBQ = 64;        // q rows per CTA
constexpr int kBK = 64;        // keys per K/V tile
constexpr int kThreads = 256;  // a 16 x 16 grid of threads, 8 warps
constexpr int kMaxD = 256;     // widest slice of q and k, widest chunk
// Accumulator columns per thread: kCols = 8 up to Dc = 128 and 16 up to
// Dc = 256 (Nemotron-4's 192), each a template instance of the kernels;
// the wide one runs one CTA per SM for its registers and shared memory.
// (Those two are the bfloat16 kernel's; the float32 one takes output
// chunks of up to kMaxDF32 columns and scores over all of D at once.)
constexpr int kMaxDF32 = 512;

// --- shared-memory layouts --------------------------------------------
// (float32: csrc/tf32.cuh's ring, a p tile and a row exchange)
// bfloat16 route: tiles padded with zeros to a multiple of 16 columns
// (WMMA's k step), rows 8 bf16 (16 bytes) longer than that to stagger
// them across the banks; scores (kBQ, kBK + 4) f32, p (kBQ, kBK + 8)
// bf16, P.V (kBQ, D16 + 4) f32.  Every fragment pointer is 32-byte
// aligned, as WMMA requires.
__host__ __device__ inline int pad16(int d) { return (d + 15) / 16 * 16; }
__host__ __device__ inline int bf16_stride(int d) { return pad16(d) + 8; }
constexpr int kSStride = kBK + 4;
constexpr int kPStride = kBK + 8;
__host__ __device__ inline int o_stride(int d) { return pad16(d) + 4; }
__host__ __device__ inline size_t align128(size_t n) {
  return (n + 127) / 128 * 128;
}

// sw: the q and k tiles' width, min(D, kMaxD); dc: the v tile's and the
// output chunk's width
inline size_t smem_bf16(int sw, int dc) {
  return 2 * align128(sizeof(bf16) * kBQ * bf16_stride(sw)) +
         align128(sizeof(bf16) * kBQ * bf16_stride(dc)) +
         align128(sizeof(float) * kBQ * kSStride) +
         align128(sizeof(bf16) * kBQ * kPStride) +
         align128(sizeof(float) * kBQ * o_stride(dc)) +
         2 * sizeof(float) * kBQ;
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void put(float* p, float x) { *p = x; }
__device__ __forceinline__ void put(bf16* p, float x) {
  *p = __float2bfloat16(x);
}

// Stage rows [r0, r0 + rows) of head hd of a (B, S, H, D) tensor,
// columns [c0, c0 + n), into rows of stride ld (element type Dst), zero
// beyond S and, up to width, beyond the n columns.
template <typename Src, typename Dst>
__device__ __forceinline__ void stage(Dst* dst, const Src* __restrict__ src,
                                      int b, int r0, int S, int H, int hd,
                                      int D, int c0, int n, int width,
                                      int ld, int rows) {
  for (int idx = threadIdx.x; idx < rows * width; idx += kThreads) {
    const int r = idx / width, d = idx - r * width;
    const int s = r0 + r;
    float x = 0.f;
    if (s < S && d < n)
      x = to_f(src[(((int64_t)b * S + s) * H + hd) * D + c0 + d]);
    put(dst + r * ld + d, x);
  }
}

// bfloat16 staging of columns [c0, c0 + n) into rows of stride ld padded
// with zeros to width (a multiple of 16): 16-byte copies where D % 8 == 0
// (so c0 and n are multiples of 8 too) and the tensor is 16-byte aligned,
// else one element at a time.
__device__ __forceinline__ void stage_bf16(bf16* dst,
                                           const bf16* __restrict__ src,
                                           int b, int r0, int S, int H,
                                           int hd, int D, int c0, int n,
                                           int width, int ld, int rows,
                                           bool vec) {
  if (!vec) {
    stage(dst, src, b, r0, S, H, hd, D, c0, n, width, ld, rows);
    return;
  }
  const int cpr = width / 8;   // 16-byte chunks per row
  for (int idx = threadIdx.x; idx < rows * cpr; idx += kThreads) {
    const int r = idx / cpr, c = idx - r * cpr;
    const int s = r0 + r;
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (s < S && c * 8 < n)
      x = *reinterpret_cast<const uint4*>(
          src + (((int64_t)b * S + s) * H + hd) * D + c0 + c * 8);
    *reinterpret_cast<uint4*>(dst + r * ld + c * 8) = x;
  }
}

// One tile's online-softmax step for q row `qpos`, by 4 lanes (spart) of
// 16 scores each: reads the row's unscaled dot products from s_row,
// writes p (rounded to P) to p_row, updates m_run and l_run, and returns
// the rescale factor of the row's accumulator.
template <typename P>
__device__ __forceinline__ float softmax_tile(const float* s_row, P* p_row,
                                              float scale, int k0, int Skv,
                                              int causal, int qpos,
                                              int spart, float& m_run,
                                              float& l_run) {
  float s_loc[16];
  float mx = -CUDART_INF_F;
#pragma unroll
  for (int e = 0; e < 16; ++e) {
    const int c = spart * 16 + e;
    const int kpos = k0 + c;
    const bool ok = kpos < Skv && (!causal || kpos <= qpos);
    s_loc[e] = ok ? s_row[c] * scale : -CUDART_INF_F;
    mx = fmaxf(mx, s_loc[e]);
  }
  mx = fmaxf(mx, __shfl_xor_sync(FULL_MASK, mx, 1));
  mx = fmaxf(mx, __shfl_xor_sync(FULL_MASK, mx, 2));
  const float m_new = fmaxf(m_run, mx);
  // no valid key yet: keep everything at zero
  const float cf = (m_new == -CUDART_INF_F) ? 1.f : expf(m_run - m_new);
  float sum = 0.f;
#pragma unroll
  for (int e = 0; e < 16; ++e) {
    const float p =
        (s_loc[e] == -CUDART_INF_F) ? 0.f : expf(s_loc[e] - m_new);
    sum += p;
    put(p_row + spart * 16 + e, p);
  }
  sum += __shfl_xor_sync(FULL_MASK, sum, 1);
  sum += __shfl_xor_sync(FULL_MASK, sum, 2);
  l_run = l_run * cf + sum;
  m_run = m_new;
  return cf;
}

// out rows ty + 16a, columns d0 + tx + 16c (< d0 + dn):
// acc / max(l, 1e-30); the same float32 values into o32 unless it is null
template <int kCols, typename T>
__device__ __forceinline__ void store_out(T* __restrict__ out,
                                          float* __restrict__ o32,
                                          const float (&acc)[4][kCols],
                                          const float* lsum, int b, int q0,
                                          int Sq, int Hq, int h, int D,
                                          int d0, int dn, int ty, int tx) {
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int r = ty + 16 * a;
    const int s = q0 + r;
    if (s >= Sq) continue;
    const float l = lsum[r];
    const int64_t at = (((int64_t)b * Sq + s) * Hq + h) * D + d0;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int d = tx + 16 * c;
      if (d >= dn) continue;
      const float x = acc[a][c] / l;
      put(out + at + d, x);
      if (o32 != nullptr) o32[at + d] = x;
    }
  }
}

struct Tile {
  int qt, h, b, hk, q0, off, n_kt;
  int d0, dn;   // this CTA's output columns [d0, d0 + dn)
};

__device__ __forceinline__ Tile tile_of(int Sq, int Skv, int Hq, int Hkv,
                                        int D, int Dc, int causal,
                                        int q_offset) {
  Tile t;
  const int nd = (D + Dc - 1) / Dc;
  t.qt = gridDim.x - 1 - blockIdx.x;   // longest tiles first
  t.h = blockIdx.y;
  t.b = blockIdx.z / nd;
  t.d0 = blockIdx.z % nd * Dc;
  t.dn = min(Dc, D - t.d0);
  t.hk = t.h / (Hq / Hkv);
  t.q0 = t.qt * kBQ;
  t.off = q_offset;                    // q row i sits at i + off
  // keys this tile needs: all, or up to its last real row's diagonal
  const int last_row = min(t.q0 + kBQ, Sq) - 1;
  const int k_end = causal ? min(Skv, last_row + t.off + 1) : Skv;
  t.n_kt = (k_end + kBK - 1) / kBK;
  return t;
}

// The row's log-sum-exp of its scaled scores, m + log(l), for the
// backward (+inf for a row with no key, so that its recomputed weights
// are 0); written by the CTA of the first output chunk only.
__device__ __forceinline__ void store_lse(float* __restrict__ lse,
                                          const Tile& t, int Sq, int Hq,
                                          int srow, float m_run,
                                          float l_run) {
  const int s = t.q0 + srow;
  if (t.d0 == 0 && s < Sq)
    lse[((int64_t)t.b * Hq + t.h) * Sq + s] =
        l_run > 0.f ? m_run + logf(l_run) : CUDART_INF_F;
}

// --- float32: split TF32 on the tensor cores (csrc/tf32.cuh) -------------
// One CTA of 8 warps per (64-row q tile, q head, batch, output chunk of
// at most kMaxDF32 columns).  Warp (rg, cg) = (warp % 4, warp / 4) owns q
// rows 16 rg .. 16 rg + 15.  Per K/V tile of 64 keys:
//   scores: from ceil(D / 64) stages [q slice | k slice] of 64 columns,
//     the warp sums S over all of D for its rows against keys
//     32 cg .. 32 cg + 31 (16 accumulators a thread);
//   softmax: the two warps of a row group swap their rows' partial maxima
//     through shared memory (one 64-thread barrier), so both hold the
//     row's running max; each keeps the sum of its own keys' p (added at
//     the end) and writes its p, split into hi and lo, to a shared
//     (64, 64) tile;
//   P.V: from ceil(Dc / 128) stages of 128 v columns, the warp adds
//     P (16 x 64, read from the tile) times its 64 of them to its output
//     accumulators, columns 128 j + 64 cg .. + 63 of stage j, kept in
//     registers across the walk (32 floats a thread a stage, 128 at
//     D 512).
// The score phase runs once per tile whatever D is: past D 64 the output
// columns are split across the column pair, not across CTAs.
template <int kNV>   // 128-column V stages a tile at most: Dc <= 128 kNV
__global__ void __launch_bounds__(tf32::kThreads, 1)
    flash_attention_f32_kernel(const float* __restrict__ q,
                               const float* __restrict__ k,
                               const float* __restrict__ v,
                               float* __restrict__ out,
                               float* __restrict__ lse,
                               float* __restrict__ o32, int Sq, int Skv,
                               int Hq, int Hkv, int D, int causal,
                               float scale, int Dc, int q_offset, int vec) {
  using namespace tf32;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* p_hi = reinterpret_cast<float*>(smem_raw) + kStages * kSlot;
  float* p_lo = p_hi + kTile;   // p of the tile, split: (64, kPLd) each
  float* red = p_lo + kTile;    // (2, 64): the warps' row maxima, then sums

  const Tile t = tile_of(Sq, Skv, Hq, Hkv, D, Dc, causal, q_offset);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int rg = warp & 3, cg = warp >> 2;
  const int row0 = rg * 16 + g;               // rows row0, row0 + 8
  const int nd = (D + kPiece - 1) / kPiece;   // score stages a tile
  const int nv = (t.dn + 127) / 128;          // V stages a tile
  const int per = nd + nv, total = t.n_kt * per;
  const int cend = t.d0 + t.dn;

  auto ring = make_ring(reinterpret_cast<float*>(smem_raw),
                        [=](int s, float* slot) {
    if (s >= total) return;
    const int kt = s / per, r = s - kt * per, k0 = kt * kBK;
    if (r < nd) {
      load_piece(slot, 0, q, t.b, t.q0, Sq, Hq, t.h, D, r * kPiece, D, vec);
      load_piece(slot, 1, k, t.b, k0, Skv, Hkv, t.hk, D, r * kPiece, D,
                 vec);
    } else {
      const int c0 = t.d0 + (r - nd) * 2 * kPiece;
      load_piece(slot, 0, v, t.b, k0, Skv, Hkv, t.hk, D, c0, cend, vec);
      load_piece(slot, 1, v, t.b, k0, Skv, Hkv, t.hk, D, c0 + kPiece, cend,
                 vec);
    }
  });

  float o[8 * kNV][4];
#pragma unroll
  for (int n = 0; n < 8 * kNV; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m_run[2] = {-CUDART_INF_F, -CUDART_INF_F}, l_run[2] = {0.f, 0.f};

  for (int kt = 0; kt < t.n_kt; ++kt) {
    const int k0 = kt * kBK;
    float sc[4][4];
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[n][e] = 0.f;
    for (int i = 0; i < nd; ++i) {
      const float* slot = ring.next();
      dot_nt(sc, slot + rg * 16 * kSlotLd, kSlotLd,
             slot + kPiece + cg * 32 * kSlotLd, g, tq);
    }
    // scaled and masked scores, and the warp's part of each row's max
    float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kpos = k0 + cg * 32 + n * 8 + 2 * tq + (e & 1);
        const int qpos = t.q0 + row0 + 8 * (e >> 1) + t.off;
        const bool ok = kpos < Skv && (!causal || kpos <= qpos);
        sc[n][e] = ok ? sc[n][e] * scale : -CUDART_INF_F;
        mx[e >> 1] = fmaxf(mx[e >> 1], sc[n][e]);
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(FULL_MASK, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(FULL_MASK, mx[i], 2));
    }
    if (tq == 0) {
      red[cg * kBQ + row0] = mx[0];
      red[cg * kBQ + row0 + 8] = mx[1];
    }
    pair_sync(rg);
    float cf[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = row0 + 8 * i;
      const float m_new = fmaxf(m_run[i], fmaxf(red[r], red[kBQ + r]));
      // no valid key yet: keep everything at zero
      cf[i] = m_new == -CUDART_INF_F ? 1.f : expf(m_run[i] - m_new);
      m_run[i] = m_new;
    }
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p[e] = sc[n][e] == -CUDART_INF_F ? 0.f
                                         : expf(sc[n][e] - m_run[e >> 1]);
        sum[e >> 1] += p[e];
      }
      const int at = row0 * kPLd + cg * 32 + n * 8 + 2 * tq;
      store_split(p_hi, p_lo, at, p[0], p[1]);
      store_split(p_hi, p_lo, at + 8 * kPLd, p[2], p[3]);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      sum[i] += __shfl_xor_sync(FULL_MASK, sum[i], 1);
      sum[i] += __shfl_xor_sync(FULL_MASK, sum[i], 2);
      l_run[i] = l_run[i] * cf[i] + sum[i];
    }
#pragma unroll
    for (int n = 0; n < 8 * kNV; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[n][e] *= cf[e >> 1];
    // P.V; the barrier in ring.next() makes the pair's p visible
#pragma unroll
    for (int j = 0; j < kNV; ++j)
      if (j < nv) {
        const float* slot = ring.next();
        dot_nn(o + 8 * j, p_hi + rg * 16 * kPLd, p_lo + rg * 16 * kPLd,
               slot + cg * kPiece, g, tq);
      }
  }

  // each row's sum over both warps' keys (the pair's last reads of red
  // were before the last stage's barrier)
  if (tq == 0) {
    red[cg * kBQ + row0] = l_run[0];
    red[cg * kBQ + row0 + 8] = l_run[1];
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = row0 + 8 * i, s = t.q0 + r;
    if (s >= Sq) continue;
    const float l_sum = red[r] + red[kBQ + r];
    const float l = fmaxf(l_sum, 1e-30f);
    if (lse != nullptr && t.d0 == 0 && cg == 0 && tq == 0)
      lse[((int64_t)t.b * Hq + t.h) * Sq + s] =
          l_sum > 0.f ? m_run[i] + logf(l_sum) : CUDART_INF_F;
    const int64_t at = (((int64_t)t.b * Sq + s) * Hq + t.h) * D;
#pragma unroll
    for (int j = 0; j < kNV; ++j)
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int d = t.d0 + j * 128 + cg * 64 + n * 8 + 2 * tq + e;
          if (d >= cend) continue;
          const float x = o[8 * j + n][2 * i + e] / l;
          out[at + d] = x;
          if (o32 != nullptr) o32[at + d] = x;
        }
  }
}

// --- float32, D <= 128: whole rows a warp ---------------------------------
// One CTA of 8 warps per (128-row q tile, q head, batch); warp w owns q
// rows 16 w .. 16 w + 15 whole: their scores against all 64 keys of a
// K/V tile, their softmax (no exchange between warps) and their output
// over all D columns.  The q tile stays in shared memory for the walk;
// per K/V tile one stage brings the k tile (64 keys x D) and one the v
// tile, two barriers a tile.  p never leaves the registers: a score
// accumulator tile, split, is the A fragment of the P.V step over its 8
// keys (k permuted), and v's B fragments read its rows 2t and 2t + 1
// (v rows of stride kVLd = 132, 4 mod 8, so a warp's reads hit 32 banks).
// Against the column-pair kernel above it reads each k and v tile once
// for 128 q rows, not 64, and takes no p tile through shared memory.
constexpr int kBQR = 128;   // q rows a CTA of the rows kernel
constexpr int kVLd = 132;   // row stride of a staged v tile
template <int kDT>   // 64-column blocks of D: D <= 64 kDT
__global__ void __launch_bounds__(tf32::kThreads, 1)
    flash_attention_f32_rows_kernel(const float* __restrict__ q,
                                    const float* __restrict__ k,
                                    const float* __restrict__ v,
                                    float* __restrict__ out,
                                    float* __restrict__ lse,
                                    float* __restrict__ o32, int Sq,
                                    int Skv, int Hq, int Hkv, int D,
                                    int causal, float scale, int q_offset,
                                    int vec) {
  using namespace tf32;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* qs = reinterpret_cast<float*>(smem_raw);   // (128, kSlotLd)
  float* ring_base = qs + kBQR * kSlotLd;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQR;   // longest first
  const int h = blockIdx.y, b = blockIdx.z, hk = h / (Hq / Hkv);
  const int last_row = min(q0 + kBQR, Sq) - 1;
  const int k_end = causal ? min(Skv, last_row + q_offset + 1) : Skv;
  const int n_kt = (k_end + kBK - 1) / kBK;
  const int total = 2 * n_kt;   // a k stage and a v stage a tile
  const int row0 = warp * 16 + g;   // rows row0, row0 + 8 of the tile

  auto ring = make_ring(ring_base, [=](int s, float* slot) {
    if (s == 0)   // the q tile comes with the first stage
#pragma unroll
      for (int half = 0; half < 2; ++half)
#pragma unroll
        for (int p = 0; p < kDT; ++p)
          load_piece(qs + half * kRows * kSlotLd, p, q, b,
                     q0 + half * kRows, Sq, Hq, h, D, p * kPiece, D, vec);
    if (s >= total) return;
    const bool vs = s & 1;
#pragma unroll
    for (int p = 0; p < kDT; ++p)
      load_piece(slot, p, vs ? v : k, b, (s >> 1) * kBK, Skv, Hkv, hk, D,
                 p * kPiece, D, vec, kRows, vs ? kVLd : kSlotLd);
  });

  float o[8 * kDT][4];
#pragma unroll
  for (int n = 0; n < 8 * kDT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m_run[2] = {-CUDART_INF_F, -CUDART_INF_F}, l_run[2] = {0.f, 0.f};

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kBK;
    float sc[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[n][e] = 0.f;
    {
      const float* ks = ring.next();
      const float* qa = qs + warp * 16 * kSlotLd;
#pragma unroll
      for (int kk = 0; kk < 8 * kDT; ++kk) {
        FragA fa;
        load_a_perm(fa, qa + kk * 8, kSlotLd, g, tq);
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          FragB fb;
          load_b_perm(fb, ks + n * 8 * kSlotLd + kk * 8, kSlotLd, g, tq);
          mma3(sc[n], fa, fb);
        }
      }
    }
    // scale, mask, and the rows' online softmax (each row's 64 keys sit
    // in the 4 lanes of a quad)
    float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kpos = k0 + n * 8 + 2 * tq + (e & 1);
        const int qpos = q0 + row0 + 8 * (e >> 1) + q_offset;
        const bool ok = kpos < Skv && (!causal || kpos <= qpos);
        sc[n][e] = ok ? sc[n][e] * scale : -CUDART_INF_F;
        mx[e >> 1] = fmaxf(mx[e >> 1], sc[n][e]);
      }
    float cf[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(FULL_MASK, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(FULL_MASK, mx[i], 2));
      const float m_new = fmaxf(m_run[i], mx[i]);
      // no valid key yet: keep everything at zero
      cf[i] = m_new == -CUDART_INF_F ? 1.f : expf(m_run[i] - m_new);
      m_run[i] = m_new;
    }
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sc[n][e] = sc[n][e] == -CUDART_INF_F
                       ? 0.f : expf(sc[n][e] - m_run[e >> 1]);
        sum[e >> 1] += sc[n][e];
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      sum[i] += __shfl_xor_sync(FULL_MASK, sum[i], 1);
      sum[i] += __shfl_xor_sync(FULL_MASK, sum[i], 2);
      l_run[i] = l_run[i] * cf[i] + sum[i];
    }
    // P.V into a fresh partial (fold() says why), then o = o cf + it
    float part[8 * kDT][4];
#pragma unroll
    for (int n = 0; n < 8 * kDT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) part[n][e] = 0.f;
    {
      const float* vsl = ring.next();
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        FragA fa;
        frag_of(fa, sc[j]);
#pragma unroll
        for (int n = 0; n < 8 * kDT; ++n) {
          FragB fb;
          load_b_rows(fb, vsl + j * 8 * kVLd + n * 8, kVLd, g, tq);
          mma3(part[n], fa, fb);
        }
      }
    }
#pragma unroll
    for (int n = 0; n < 8 * kDT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        o[n][e] = fmaf(o[n][e], cf[e >> 1], part[n][e]);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int s = q0 + row0 + 8 * i;
    if (s >= Sq) continue;
    const float l = fmaxf(l_run[i], 1e-30f);
    if (lse != nullptr && tq == 0)
      lse[((int64_t)b * Hq + h) * Sq + s] =
          l_run[i] > 0.f ? m_run[i] + logf(l_run[i]) : CUDART_INF_F;
    const int64_t at = (((int64_t)b * Sq + s) * Hq + h) * D;
#pragma unroll
    for (int n = 0; n < 8 * kDT; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int d = n * 8 + 2 * tq + e;
        if (d >= D) continue;
        const float x = o[n][2 * i + e] / l;
        out[at + d] = x;
        if (o32 != nullptr) o32[at + d] = x;
      }
  }
}

// --- bfloat16: tensor cores (WMMA) -------------------------------------
template <int kCols>
__global__ void __launch_bounds__(kThreads, kCols <= 8 ? 2 : 1)
    flash_attention_bf16_kernel(const bf16* __restrict__ q,
                                const bf16* __restrict__ k,
                                const bf16* __restrict__ v,
                                bf16* __restrict__ out,
                                float* __restrict__ lse,
                                float* __restrict__ o32, int Sq, int Skv,
                                int Hq, int Hkv, int D, int causal,
                                float scale, int Dc, int q_offset) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const bool sliced = D > kMaxD;
  const int ld = bf16_stride(min(D, kMaxD));
  const int ldv = bf16_stride(Dc), old = o_stride(Dc);
  unsigned char* p = smem_raw;
  bf16* qs = reinterpret_cast<bf16*>(p);      // (kBQ, ld)
  p += align128(sizeof(bf16) * kBQ * ld);
  bf16* ks = reinterpret_cast<bf16*>(p);      // (kBK, ld)
  p += align128(sizeof(bf16) * kBQ * ld);
  bf16* vs = reinterpret_cast<bf16*>(p);      // (kBK, ldv)
  p += align128(sizeof(bf16) * kBQ * ldv);
  float* ss = reinterpret_cast<float*>(p);    // (kBQ, kSStride) scores
  p += align128(sizeof(float) * kBQ * kSStride);
  bf16* pb = reinterpret_cast<bf16*>(p);      // (kBQ, kPStride) p
  p += align128(sizeof(bf16) * kBQ * kPStride);
  float* os = reinterpret_cast<float*>(p);    // (kBQ, old) P.V of the tile
  p += align128(sizeof(float) * kBQ * old);
  float* corr = reinterpret_cast<float*>(p);  // (kBQ)
  float* lsum = corr + kBQ;                   // (kBQ)

  const Tile t = tile_of(Sq, Skv, Hq, Hkv, D, Dc, causal, q_offset);
  const int tid = threadIdx.x, warp = tid >> 5;
  const int ty = tid >> 4, tx = tid & 15;
  const int srow = tid >> 2, spart = tid & 3;
  const int sqpos = t.q0 + srow + t.off;
  const int wr = warp >> 1, wc = warp & 1;   // warp's 16-row block, half
  const int v16 = pad16(t.dn);                // the v tile's width
  const bool vec = D % 8 == 0 &&
                   ((reinterpret_cast<uintptr_t>(q) |
                     reinterpret_cast<uintptr_t>(k) |
                     reinterpret_cast<uintptr_t>(v)) & 15) == 0;

  if (!sliced)
    stage_bf16(qs, q, t.b, t.q0, Sq, Hq, t.h, D, 0, D, pad16(D), ld, kBQ,
               vec);
  float acc[4][kCols];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[a][c] = 0.f;
  float m_run = -CUDART_INF_F, l_run = 0.f;

  for (int kt = 0; kt < t.n_kt; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();   // the previous tile is done with ks, vs and os
    if (!sliced)
      stage_bf16(ks, k, t.b, k0, Skv, Hkv, t.hk, D, 0, D, pad16(D), ld, kBK,
                 vec);
    stage_bf16(vs, v, t.b, k0, Skv, Hkv, t.hk, D, t.d0, t.dn, v16, ldv, kBK,
               vec);
    __syncthreads();

    // S = Q K^T: warp (wr, wc) computes key blocks 2wc and 2wc + 1
    {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> c0, c1;
      wmma::fill_fragment(c0, 0.f);
      wmma::fill_fragment(c1, 0.f);
      for (int s0 = 0; s0 < D; s0 += kMaxD) {   // one slice unless sliced
        const int n = min(kMaxD, D - s0);
        if (sliced) {
          if (s0 > 0) __syncthreads();   // done with the slice before
          stage_bf16(qs, q, t.b, t.q0, Sq, Hq, t.h, D, s0, n, pad16(n), ld,
                     kBQ, vec);
          stage_bf16(ks, k, t.b, k0, Skv, Hkv, t.hk, D, s0, n, pad16(n), ld,
                     kBK, vec);
          __syncthreads();
        }
        for (int kk = 0; kk < pad16(n) / 16; ++kk) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>
              fa;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>
              f0, f1;
          wmma::load_matrix_sync(fa, qs + wr * 16 * ld + kk * 16, ld);
          wmma::load_matrix_sync(f0, ks + (2 * wc) * 16 * ld + kk * 16, ld);
          wmma::load_matrix_sync(f1, ks + (2 * wc + 1) * 16 * ld + kk * 16,
                                 ld);
          wmma::mma_sync(c0, fa, f0, c0);
          wmma::mma_sync(c1, fa, f1, c1);
        }
      }
      float* s0 = ss + wr * 16 * kSStride + 2 * wc * 16;
      wmma::store_matrix_sync(s0, c0, kSStride, wmma::mem_row_major);
      wmma::store_matrix_sync(s0 + 16, c1, kSStride, wmma::mem_row_major);
    }
    __syncthreads();

    const float cf = softmax_tile(ss + srow * kSStride, pb + srow * kPStride,
                                  scale, k0, Skv, causal, sqpos, spart,
                                  m_run, l_run);
    if (spart == 0) corr[srow] = cf;
    __syncthreads();

    // P.V of this tile into os: warp (wr, wc) takes column blocks wc,
    // wc + 2, ...
    for (int cb = wc; cb < v16 / 16; cb += 2) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> co;
      wmma::fill_fragment(co, 0.f);
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
        wmma::load_matrix_sync(fa, pb + wr * 16 * kPStride + kk * 16,
                               kPStride);
        wmma::load_matrix_sync(fb, vs + kk * 16 * ldv + cb * 16, ldv);
        wmma::mma_sync(co, fa, fb, co);
      }
      wmma::store_matrix_sync(os + wr * 16 * old + cb * 16, co, old,
                              wmma::mem_row_major);
    }
    __syncthreads();

#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int r = ty + 16 * a;
      const float c = corr[r];
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int d = tx + 16 * j;
        if (d < t.dn) acc[a][j] = fmaf(acc[a][j], c, os[r * old + d]);
      }
    }
  }

  if (spart == 0) lsum[srow] = fmaxf(l_run, 1e-30f);
  if (lse != nullptr && spart == 0)
    store_lse(lse, t, Sq, Hq, srow, m_run, l_run);
  __syncthreads();
  store_out<kCols>(out, o32, acc, lsum, t.b, t.q0, Sq, Hq, t.h, D, t.d0,
                   t.dn, ty, tx);
}

template <typename T, typename K>
int launch(K kernel, size_t smem, const void* q, const void* k,
           const void* v, void* out, float* lse, float* o32, int B, int Sq,
           int Skv, int Hq, int Hkv, int D, int causal, float scale, int Dc,
           int q_offset, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Sq + kBQ - 1) / kBQ, Hq, B * ((D + Dc - 1) / Dc));
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), lse, o32, Sq, Skv,
      Hq, Hkv, D, causal, scale, Dc, q_offset);
  return static_cast<int>(cudaGetLastError());
}

// The float32 kernel: its shared memory is the ring, the split p tile and
// the (2, 64) row exchange, whatever D is (104,960 bytes).
template <typename K>
int launch_f32(K kernel, int& set, const void* q, const void* k,
               const void* v, void* out, float* lse, float* o32, int B,
               int Sq, int Skv, int Hq, int Hkv, int D, int causal,
               float scale, int Dc, int q_offset, int vec,
               cudaStream_t stream) {
  const size_t smem =
      tf32::kRingBytes + sizeof(float) * (2 * tf32::kTile + 2 * kBQ);
  const cudaError_t err =
      allow_smem(reinterpret_cast<const void*>(kernel), (int)smem, set);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Sq + kBQ - 1) / kBQ, Hq, B * ((D + Dc - 1) / Dc));
  kernel<<<grid, tf32::kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), lse, o32, Sq,
      Skv, Hq, Hkv, D, causal, scale, Dc, q_offset, vec);
  return static_cast<int>(cudaGetLastError());
}

// The rows kernel: the resident q tile and the ring (139,264 bytes).
template <typename K>
int launch_rows(K kernel, int& set, const void* q, const void* k,
                const void* v, void* out, void* lse, void* o32, int B,
                int Sq, int Skv, int Hq, int Hkv, int D, int causal,
                float scale, int q_offset, int vec, cudaStream_t stream) {
  const size_t smem = sizeof(float) * kBQR * tf32::kSlotLd +
                      tf32::kRingBytes;
  const cudaError_t err =
      allow_smem(reinterpret_cast<const void*>(kernel), (int)smem, set);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Sq + kBQR - 1) / kBQR, Hq, B);
  kernel<<<grid, tf32::kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out),
      static_cast<float*>(lse), static_cast<float*>(o32), Sq, Skv, Hq, Hkv,
      D, causal, scale, q_offset, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q (B, Sq, Hq, D), k and v (B, Skv, Hkv, D) -> out (B, Sq, Hq, D), all
// contiguous, of float32 (dtype 0) or bfloat16 (dtype 1), and, for the
// backward, where lse is not null, each row's float32 log-sum-exp into lse
// (B, Hq, Sq), and where o32 is not null, out's float32 values before
// rounding into o32 (B, Sq, Hq, D) (a bfloat16 call's; a float32 call's
// out is its own).  Query row i sits at position i + q_offset (the
// model's default is Skv - Sq); q_offset comes last, after the stream, so
// the arguments before it keep the positions of the interface without it.
// Requires Hq % Hkv == 0, D >= 1 and q_offset >= 0.  Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, void* lse,
                                      void* o32, int B, int Sq, int Skv,
                                      int Hq, int Hkv, int D, int dtype,
                                      int causal, float scale, void* stream,
                                      int q_offset) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D < 1 || q_offset < 0) return static_cast<int>(cudaErrorInvalidValue);
  // output chunk width: D itself up to kMaxD, else an even split of D
  // into the fewest chunks of at most kMaxD columns, rounded up to 16
  const int nd = (D + kMaxD - 1) / kMaxD;
  const int Dc = nd == 1 ? D : pad16((D + nd - 1) / nd);
  const int sw = D < kMaxD ? D : kMaxD;
  const bool wide = Dc > 128;
  if (dtype == 1)
    return launch<bf16>(wide ? flash_attention_bf16_kernel<16>
                             : flash_attention_bf16_kernel<8>,
                        smem_bf16(sw, Dc), q, k, v, out,
                        static_cast<float*>(lse), static_cast<float*>(o32),
                        B, Sq, Skv, Hq, Hkv, D, causal, scale, Dc,
                        q_offset, s);
  const int vec = D % 4 == 0 &&
                  ((reinterpret_cast<uintptr_t>(q) |
                    reinterpret_cast<uintptr_t>(k) |
                    reinterpret_cast<uintptr_t>(v)) & 15) == 0;
  if (D <= 2 * tf32::kPiece) {   // float32, whole rows a warp
    static int set1 = 0, set2 = 0;
    return D <= tf32::kPiece
               ? launch_rows(flash_attention_f32_rows_kernel<1>, set1, q, k,
                             v, out, lse, o32, B, Sq, Skv, Hq, Hkv, D,
                             causal, scale, q_offset, vec, s)
               : launch_rows(flash_attention_f32_rows_kernel<2>, set2, q, k,
                             v, out, lse, o32, B, Sq, Skv, Hq, Hkv, D,
                             causal, scale, q_offset, vec, s);
  }
  // float32 past D 128: chunks of at most kMaxDF32 columns, the same even
  // split, each a CTA of the column-pair kernel
  const int ndf = (D + kMaxDF32 - 1) / kMaxDF32;
  const int Dcf = ndf == 1 ? D : pad16((D + ndf - 1) / ndf);
  const int nv = (Dcf + 127) / 128;
  auto go = [&](auto kernel, int& set) {
    return launch_f32(kernel, set, q, k, v, out, static_cast<float*>(lse),
                      static_cast<float*>(o32), B, Sq, Skv, Hq, Hkv, D,
                      causal, scale, Dcf, q_offset, vec, s);
  };
  static int set2 = 0, set4 = 0;   // D > 128: two or more V stages
  return nv <= 2 ? go(flash_attention_f32_kernel<2>, set2)
                 : go(flash_attention_f32_kernel<4>, set4);
}
