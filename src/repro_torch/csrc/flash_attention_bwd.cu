// Causal or non-causal GQA attention: the backward (dq, dk, dv), the
// general instance, for every dtype and head dim that the Hopper one
// (csrc/flash_attention_bwd_sm90.cu: bf16, head dim 64 or 128) does not
// take.
//
// The backward of the forward kernels csrc/flash_attention.cu and
// csrc/flash_attention_sm90.cu, which replace the Pallas TPU kernel
//   src/repro/kernels/flash_attention/flash_attention.py::
//   flash_attention_kernel.
// The JAX package has no backward Pallas kernel: its LM trains through
// jax.grad of the plain models/layers.py::blocked_attention.  This kernel
// computes that gradient (held on the card against the autograd of the
// port's plain version, kernels/flash_attention/ref.py).  For query row i
// of batch b and head h, against KV head h / G (G = Hq / Hkv), with the
// forward's causal rule (key j visible where j <= i + q_offset, q_offset
// the absolute position of query row 0: Skv - Sq for the model's own
// sequence, a context-parallel shard's first position otherwise):
//   P_ij  = exp(s_ij * scale - LSE_i),  s_ij = <q_i, k_j>, LSE_i the row's
//           log-sum-exp the forward wrote (so P is the normalised softmax);
//   D_i   = rowsum(dO_i * O_i), O_i the forward's float32 output row
//           before its rounding to the input dtype (the plain version's
//           autograd takes D from that same float32 O; from the rounded
//           bfloat16 O, D's error alone can be as large as dq itself in
//           the first causal rows, where dq is a near-cancelling sum of a
//           few keys' terms);
//   dP_ij = <dO_i, v_j>,  dS_ij = P_ij (dP_ij - D_i);
//   dv_j  = sum_i round(P_ij) dO_i     (P rounded to v's dtype, as the
//           forward rounds p before P.V),
//   dk_j  = scale * sum_i dS_ij q_i,   dq_i = scale * sum_j dS_ij k_j,
// dk and dv summed over the G query heads of each KV head inside the
// kernel.  Inputs and outputs are float32 or bfloat16; every product and
// sum is float32.
//
// What bounds it on the H100: operations.  At Yi-6B's train shape (B 2,
// S 4096, 32/4 heads of 128, bf16, causal) the five products (S and dP
// twice, dv, dk, dq) are about 6.9e11 FLOP (0.70 ms at the bf16
// tensor-core peak) against about 250 MB of q, k, v, o, dO and the three
// gradients.  In float32 each product is three TF32 products (split
// TF32, below), so the floor is 3 x FLOP at the 495 TFLOP/s dense TF32
// rate: 0.078 ms at (2, 1,000, 8/2 heads of 80, full), where the float32
// FMA rate gives 0.19 ms and the first, scalar float32 design took
// 2.2 ms.
//
// Design (FlashAttention-2's split into two passes, no atomics, so the
// result is the same bit for bit on every run).  Three launches:
//   1. D_i = rowsum(dO_i * O_i), a warp per row, into a float32 buffer
//      (B, Hq, Sq), from the float32 O the forward wrote beside its output;
//   2. dk, dv: one CTA of 256 threads per (64-key tile, KV head, batch);
//      it keeps its tile's dk and dv accumulators in registers while it
//      walks the G query heads and, for each, the 64-row q tiles that see
//      its keys (none for a tile past every row's position, which then
//      stores zeros);
//   3. dq: one CTA per (64-row q tile, q head, batch), longest causal
//      tiles first, walking the K/V tiles its rows see.
// Per (q tile, K/V tile) both recompute S = Q K^T and dP = dO V^T, then P
// and dS element by element from the LSE and D of the tile's rows.
//   bfloat16: every product on the tensor cores (WMMA 16 x 16 x 16 with
//     float32 accumulators, as the general forward), P and dS rounded to
//     bfloat16 as the A operands of the accumulating products, the
//     accumulators kept as fragments in registers over the whole walk;
//     the first version, float32 on scalar FMAs, took 88 ms at Yi's train
//     shape, more than the plain autograd;
//   float32 (csrc/tf32.cuh): all five products on mma.sync m16n8k8 in
//     split TF32 (hi.hi + hi.lo + lo.hi), fed by a 2-slot cp.async ring
//     of 64-row, 64-column pieces of q, k, v and dO; the score-side
//     operands split in registers as their fragments are loaded, P and dS
//     split once into hi and lo planes in shared memory to be the A
//     operands of the accumulating products.  Pass 2 runs 32-key CTAs
//     (twice the CTAs of 64-key ones) of two groups of 4 warps, which take
//     alternate q tiles of the walk, each with its own ring and planes
//     (208,896 bytes), and add their dk and dv in a fixed order at the
//     end; in a group, warp w has keys 16 (w % 2) .. + 15 against q rows
//     32 (w / 2) .. + 31 for S^T and dP^T, and dv (w < 2) or dk (w >= 2)
//     over all 64 rows.  Pass 3 runs 64-row CTAs of 8 warps (4 row groups
//     x 2 key halves, 104,448 bytes).  The first float32 design ran every
//     product on scalar FMAs, 2 a shared-memory load: bound by shared
//     memory, 4.4x SDPA's backward at D 80.  What bounds this one is the
//     issue of the splits and fragment loads beside the products (as the
//     forward's note says), and at small Skv x Hkv the parallelism of
//     pass 2.
// Head dims past 128 (any D): output columns in chunks of at most 128,
// one CTA per chunk, each recomputing S and dP over all of D (bfloat16:
// over slices of 128 columns of D staged in turn, as the general forward
// does past 256; float32: the ring's slices).
#include "common.cuh"
#include "tf32.cuh"

#include <cuda_bf16.h>
#include <mma.h>

namespace {

using bf16 = __nv_bfloat16;
namespace wmma = nvcuda::wmma;

constexpr int kBQ = 64;        // q rows per tile
constexpr int kBK = 64;        // keys per tile
constexpr int kThreads = 256;  // a 16 x 16 grid of threads
constexpr int kMaxD = 128;     // widest staged slice, widest output chunk

__host__ __device__ inline int pad16(int d) { return (d + 15) / 16 * 16; }

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

struct Shape {
  int B, Sq, Skv, Hq, Hkv, D, causal;
  int off;      // q_offset: query row i sits at position i + off
  float scale;
  int Dc, nd;   // output chunk width and count
  int ld;       // row stride of the staged q, k, v, dO tiles
};

// --- 1. D = rowsum(dO * O) ----------------------------------------------
template <typename T>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dot_kernel(const float* __restrict__ out,
                         const T* __restrict__ dout, float* __restrict__ dd,
                         int B, int Sq, int Hq, int D) {
  const int lane = threadIdx.x & 31;
  const int64_t rows = (int64_t)B * Sq * Hq;
  const int64_t row = (int64_t)blockIdx.x * (kThreads / 32) +
                      threadIdx.x / 32;   // ((b * Sq + i) * Hq + h)
  if (row >= rows) return;
  const float* o = out + row * D;
  const T* g = dout + row * D;
  float sum = 0.f;
  for (int d = lane; d < D; d += 32) sum = fmaf(o[d], to_f(g[d]), sum);
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

// --- 2. dk, dv (float32: split TF32 on the tensor cores, csrc/tf32.cuh) ---
// One CTA per (32-key tile, KV head, batch, output chunk): 32 keys, not
// 64, so that the grid has twice the CTAs (at (2, 1,000, 8/2 heads)
// 64-key tiles made only 64).  Its work is the walk over the G query
// heads of its KV head and, for each, the 64-row q tiles that see its
// keys; two groups of 4 warps take alternate steps of that walk, each
// with its own ring and tiles (so an SM runs 8 warps on 32 keys), and
// their dk and dv are added in a fixed order at the end.  Per q tile, in
// a group:
//   S^T = K Q^T and dP^T = V dO^T, from ceil(D / 64) stage pairs
//     [k slice | q slice], [v slice | dO slice]: warp w's keys
//     16 (w % 2) .. + 15 against q rows 32 (w / 2) .. + 31;
//   P^T = exp(S^T scale - LSE) and dS^T = P^T (dP^T - D) element by
//     element (each thread's LSE and D of its 8 q rows read from device
//     memory as the tile starts, under the score stages), split into hi
//     and lo planes of two shared (32, 64) tiles;
//   dv += P^T dO (warps 0, 1) and dk += dS^T Q (warps 2, 3) for keys
//     16 (w % 2) .. + 15, from ceil(Dc / 64) stages [dO columns | q
//     columns] over all 64 q rows, into accumulators kept in registers
//     across the walk (32 floats a thread a stage).
constexpr int kGroupKV = 128;   // threads of a group, 2 groups a CTA
constexpr int kBKT = 32;   // keys a CTA of the float32 dk/dv pass
// floats of a group's share of shared memory: its ring and four (32, 64)
// planes (P^T and dS^T, hi and lo)
constexpr int kGroupFloats =
    tf32::kStages * tf32::kSlot + 4 * kBKT * tf32::kPLd;
template <int kNV>   // 64-column stages at most: Dc <= 64 kNV
__global__ void __launch_bounds__(2 * kGroupKV, 1)
    flash_bwd_dkdv_f32_kernel(const float* __restrict__ q,
                              const float* __restrict__ k,
                              const float* __restrict__ v,
                              const float* __restrict__ dout,
                              const float* __restrict__ lse,
                              const float* __restrict__ dd,
                              float* __restrict__ dk, float* __restrict__ dv,
                              Shape s, int vec) {
  using tf32::kPiece;
  using tf32::kPLd;
  using tf32::kSlotLd;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int grp = threadIdx.x / kGroupKV;
  float* ring_base = reinterpret_cast<float*>(smem_raw) + grp * kGroupFloats;
  float* pt_hi = ring_base + tf32::kStages * tf32::kSlot;   // (32, kPLd)
  float* pt_lo = pt_hi + kBKT * kPLd;                       // P^T
  float* ds_hi = pt_lo + kBKT * kPLd;                       // dS^T
  float* ds_lo = ds_hi + kBKT * kPLd;
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int kg = warp & 1, qg = warp >> 1;   // keys 16 kg, q rows 32 qg
  const int k0 = blockIdx.x * kBKT, hk = blockIdx.y;
  const int b = blockIdx.z / s.nd;
  const int d0 = blockIdx.z % s.nd * s.Dc, dn = min(s.Dc, s.D - d0);
  const int G = s.Hq / s.Hkv, off = s.off;
  const int n_qt = (s.Sq + kBQ - 1) / kBQ;
  // q tiles whose rows see this tile's first key
  const int qt_first = s.causal ? min(n_qt, max(0, k0 - off) / kBQ) : 0;
  const int nq = n_qt - qt_first, iters = G * nq;
  // this group's steps of the walk: grp, grp + 2, ...
  const int my_iters = (iters - grp + 1) / 2;
  const int nd = (s.D + kPiece - 1) / kPiece;
  const int nv = (dn + kPiece - 1) / kPiece;
  const int per = 2 * nd + nv, total = my_iters * per;
  const int cend = d0 + dn;

  auto ring = tf32::make_ring<kGroupKV>(ring_base, [=](int st, float* slot) {
    if (st >= total) return;
    const int it = grp + 2 * (st / per), r = st % per;
    const int h = hk * G + it / nq, q0 = (qt_first + it % nq) * kBQ;
    if (r < 2 * nd) {
      const int c0 = (r >> 1) * kPiece;
      const bool sv = r & 1;   // the dP^T stage
      tf32::load_piece<kGroupKV>(slot, 0, sv ? v : k, b, k0, s.Skv,
                                   s.Hkv, hk, s.D, c0, s.D, vec, kBKT);
      tf32::load_piece<kGroupKV>(slot, 1, sv ? dout : q, b, q0, s.Sq,
                                   s.Hq, h, s.D, c0, s.D, vec);
    } else {
      const int c0 = d0 + (r - 2 * nd) * kPiece;
      tf32::load_piece<kGroupKV>(slot, 0, dout, b, q0, s.Sq, s.Hq, h, s.D,
                                   c0, cend, vec);
      tf32::load_piece<kGroupKV>(slot, 1, q, b, q0, s.Sq, s.Hq, h, s.D,
                                   c0, cend, vec);
    }
  });

  float acc[8 * kNV][4];   // dv (warps 0, 1) or dk (warps 2, 3)
#pragma unroll
  for (int n = 0; n < 8 * kNV; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  // the A operand of this warp's gradient, rows of its 16 keys
  const float* a_hi = (qg == 0 ? pt_hi : ds_hi) + kg * 16 * kPLd;
  const float* a_lo = (qg == 0 ? pt_lo : ds_lo) + kg * 16 * kPLd;

  for (int my = 0; my < my_iters; ++my) {
    const int it = grp + 2 * my;
    const int h = hk * G + it / nq, q0 = (qt_first + it % nq) * kBQ;
    float lse_c[4][2], dd_c[4][2];   // of q rows q0 + 32 qg + 8 n + 2 tq + e
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int qc = q0 + qg * 32 + n * 8 + 2 * tq + e;
        const int64_t at = ((int64_t)b * s.Hq + h) * s.Sq + qc;
        lse_c[n][e] = qc < s.Sq ? lse[at] : CUDART_INF_F;
        dd_c[n][e] = qc < s.Sq ? dd[at] : 0.f;
      }
    float sct[4][4] = {}, dpt[4][4] = {};
    for (int i = 0; i < nd; ++i) {
      const float* slot = ring.next();
      tf32::dot_nt(sct, slot + kg * 16 * kSlotLd, kSlotLd,
                   slot + kPiece + qg * 32 * kSlotLd, g, tq);
      slot = ring.next();
      tf32::dot_nt(dpt, slot + kg * 16 * kSlotLd, kSlotLd,
                   slot + kPiece + qg * 32 * kSlotLd, g, tq);
    }
    // P^T and dS^T; masked entries (past Sq or Skv, above the causal
    // diagonal) are 0.  The next stage's barrier publishes them.
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      float p[4], ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kpos = k0 + kg * 16 + g + 8 * (e >> 1);
        const int qpos = q0 + qg * 32 + n * 8 + 2 * tq + (e & 1);
        const bool ok = qpos < s.Sq && kpos < s.Skv &&
                        (!s.causal || kpos <= qpos + off);
        p[e] = ok ? expf(sct[n][e] * s.scale - lse_c[n][e & 1]) : 0.f;
        ds[e] = p[e] * (dpt[n][e] - dd_c[n][e & 1]);
      }
      const int at = (kg * 16 + g) * kPLd + qg * 32 + n * 8 + 2 * tq;
      tf32::store_split(pt_hi, pt_lo, at, p[0], p[1]);
      tf32::store_split(pt_hi, pt_lo, at + 8 * kPLd, p[2], p[3]);
      tf32::store_split(ds_hi, ds_lo, at, ds[0], ds[1]);
      tf32::store_split(ds_hi, ds_lo, at + 8 * kPLd, ds[2], ds[3]);
    }
#pragma unroll
    for (int j = 0; j < kNV; ++j)
      if (j < nv) {
        const float* slot = ring.next();
        tf32::dot_nn(acc + 8 * j, a_hi, a_lo, slot + qg * kPiece, g, tq);
      }
  }

  // group 1 hands its sums to group 0 through slot 0 of its own ring,
  // which group 0 adds to its own: the same order every run.  The group's
  // barrier comes first: when the group's stage count is odd, its last
  // stage sits in slot 0, and a warp still reading it must be done
  // before any warp of the group overwrites it.
  float* xfer = reinterpret_cast<float*>(smem_raw) + kGroupFloats +
                (threadIdx.x % kGroupKV) * (32 * kNV);
  if (grp == 1) {
    tf32::group_sync<kGroupKV>();
#pragma unroll
    for (int n = 0; n < 8 * kNV; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) xfer[4 * n + e] = acc[n][e];
  }
  __syncthreads();
  if (grp == 1) return;
#pragma unroll
  for (int n = 0; n < 8 * kNV; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] += xfer[4 * n + e];
  float* out = qg == 0 ? dv : dk;
  const float mult = qg == 0 ? 1.f : s.scale;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = k0 + kg * 16 + g + 8 * i;
    if (key >= s.Skv) continue;
    float* o = out + (((int64_t)b * s.Skv + key) * s.Hkv + hk) * s.D;
#pragma unroll
    for (int j = 0; j < kNV; ++j)
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int d = d0 + j * kPiece + n * 8 + 2 * tq + e;
          if (d < cend) o[d] = acc[8 * j + n][2 * i + e] * mult;
        }
  }
}

// --- 3. dq (float32: split TF32 on the tensor cores) ------------------------
// One CTA of 8 warps per (64-row q tile, q head, batch, output chunk),
// longest causal tiles first, walking the K/V tiles its rows see.  Warp
// (rg, cg) = (warp % 4, warp / 4) owns q rows 16 rg .. 16 rg + 15.  Per
// K/V tile: S = Q K^T and dP = dO V^T from stage pairs [q slice |
// k slice], [dO slice | v slice] (its rows against keys 32 cg .. + 31),
// dS = P (dP - D) (the rows' LSE and D held in registers), split into the
// hi and lo planes of a shared (64, 64) tile, then dq += dS K from
// ceil(Dc / 128) stages of 128 k columns, the warp's 64 of each.
template <int kNV>   // 128-column K stages at most: Dc <= 128 kNV
__global__ void __launch_bounds__(tf32::kThreads, 2)
    flash_bwd_dq_f32_kernel(const float* __restrict__ q,
                            const float* __restrict__ k,
                            const float* __restrict__ v,
                            const float* __restrict__ dout,
                            const float* __restrict__ lse,
                            const float* __restrict__ dd,
                            float* __restrict__ dq, Shape s, int vec) {
  using tf32::kPiece;
  using tf32::kPLd;
  using tf32::kSlotLd;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* ring_base = reinterpret_cast<float*>(smem_raw);
  float* ds_hi = ring_base + tf32::kStages * tf32::kSlot;   // (64, kPLd)
  float* ds_lo = ds_hi + tf32::kTile;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int rg = warp & 3, cg = warp >> 2;
  const int row0 = rg * 16 + g;                        // rows row0, +8
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;   // longest first
  const int h = blockIdx.y, hk = h / (s.Hq / s.Hkv);
  const int b = blockIdx.z / s.nd;
  const int d0 = blockIdx.z % s.nd * s.Dc, dn = min(s.Dc, s.D - d0);
  const int last_row = min(q0 + kBQ, s.Sq) - 1;
  const int k_end = s.causal ? min(s.Skv, last_row + s.off + 1) : s.Skv;
  const int n_kt = (k_end + kBK - 1) / kBK;
  const int nd = (s.D + kPiece - 1) / kPiece, nv = (dn + 127) / 128;
  const int per = 2 * nd + nv, total = n_kt * per;
  const int cend = d0 + dn;

  auto ring = tf32::make_ring(ring_base, [=](int st, float* slot) {
    if (st >= total) return;
    const int kt = st / per, r = st - kt * per, k0 = kt * kBK;
    if (r < 2 * nd) {
      const int c0 = (r >> 1) * kPiece;
      const bool sv = r & 1;   // the dP stage
      tf32::load_piece(slot, 0, sv ? dout : q, b, q0, s.Sq, s.Hq, h, s.D,
                       c0, s.D, vec);
      tf32::load_piece(slot, 1, sv ? v : k, b, k0, s.Skv, s.Hkv, hk, s.D,
                       c0, s.D, vec);
    } else {
      const int c0 = d0 + (r - 2 * nd) * 2 * kPiece;
      tf32::load_piece(slot, 0, k, b, k0, s.Skv, s.Hkv, hk, s.D, c0, cend,
                       vec);
      tf32::load_piece(slot, 1, k, b, k0, s.Skv, s.Hkv, hk, s.D,
                       c0 + kPiece, cend, vec);
    }
  });

  float lse_r[2], dd_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + row0 + 8 * i;
    const int64_t at = ((int64_t)b * s.Hq + h) * s.Sq + row;
    lse_r[i] = row < s.Sq ? lse[at] : CUDART_INF_F;
    dd_r[i] = row < s.Sq ? dd[at] : 0.f;
  }
  float acc[8 * kNV][4];
#pragma unroll
  for (int n = 0; n < 8 * kNV; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kBK;
    float sc[4][4] = {}, dp[4][4] = {};
    for (int i = 0; i < nd; ++i) {
      const float* slot = ring.next();
      tf32::dot_nt(sc, slot + rg * 16 * kSlotLd, kSlotLd,
                   slot + kPiece + cg * 32 * kSlotLd, g, tq);
      slot = ring.next();
      tf32::dot_nt(dp, slot + rg * 16 * kSlotLd, kSlotLd,
                   slot + kPiece + cg * 32 * kSlotLd, g, tq);
    }
    // dS; masked entries 0.  The next stage's barrier publishes it.
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      float ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kpos = k0 + cg * 32 + n * 8 + 2 * tq + (e & 1);
        const int qpos = q0 + row0 + 8 * (e >> 1);
        const bool ok = qpos < s.Sq && kpos < s.Skv &&
                        (!s.causal || kpos <= qpos + s.off);
        const float p =
            ok ? expf(sc[n][e] * s.scale - lse_r[e >> 1]) : 0.f;
        ds[e] = p * (dp[n][e] - dd_r[e >> 1]);
      }
      const int at = row0 * kPLd + cg * 32 + n * 8 + 2 * tq;
      tf32::store_split(ds_hi, ds_lo, at, ds[0], ds[1]);
      tf32::store_split(ds_hi, ds_lo, at + 8 * kPLd, ds[2], ds[3]);
    }
#pragma unroll
    for (int j = 0; j < kNV; ++j)
      if (j < nv) {
        const float* slot = ring.next();
        tf32::dot_nn(acc + 8 * j, ds_hi + rg * 16 * kPLd,
                     ds_lo + rg * 16 * kPLd, slot + cg * kPiece, g, tq);
      }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + row0 + 8 * i;
    if (row >= s.Sq) continue;
    float* o = dq + (((int64_t)b * s.Sq + row) * s.Hq + h) * s.D;
#pragma unroll
    for (int j = 0; j < kNV; ++j)
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int d = d0 + j * 128 + cg * 64 + n * 8 + 2 * tq + e;
          if (d < cend) o[d] = acc[8 * j + n][2 * i + e] * s.scale;
        }
  }
}

// The float32 passes: D, then dk and dv (32-key CTAs of two 4-warp
// groups, each with its ring and four (32, 64) planes: 208,896 bytes),
// then dq (64-row CTAs of 8 warps, the ring and two (64, 64) planes:
// 104,448 bytes).
template <typename KV, typename Q>
int launch_f32(KV kv_kernel, Q q_kernel, int& set_kv, int& set_q,
               const float* q, const float* k, const float* v,
               const float* out, const float* dout, const float* lse,
               float* dd, float* dq, float* dk, float* dv, Shape s,
               int vec, cudaStream_t stream) {
  const size_t smem = tf32::kRingBytes + 2 * sizeof(float) * tf32::kTile;
  const size_t smem_kv = 2 * sizeof(float) * kGroupFloats;
  const int64_t rows = (int64_t)s.B * s.Sq * s.Hq;
  const int per = kThreads / 32;
  flash_bwd_dot_kernel<float><<<(unsigned)((rows + per - 1) / per),
                                kThreads, 0, stream>>>(out, dout, dd, s.B,
                                                       s.Sq, s.Hq, s.D);
  cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess)
    err = allow_smem(reinterpret_cast<const void*>(kv_kernel), (int)smem_kv,
                     set_kv);
  if (err == cudaSuccess)
    err = allow_smem(reinterpret_cast<const void*>(q_kernel), (int)smem,
                     set_q);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (s.Skv > 0) {
    const dim3 grid((s.Skv + kBKT - 1) / kBKT, s.Hkv, s.B * s.nd);
    kv_kernel<<<grid, 2 * kGroupKV, smem_kv, stream>>>(q, k, v, dout, lse,
                                                       dd, dk, dv, s, vec);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((s.Sq + kBQ - 1) / kBQ, s.Hq, s.B * s.nd);
  q_kernel<<<grid, tf32::kThreads, smem, stream>>>(q, k, v, dout, lse, dd,
                                                   dq, s, vec);
  return static_cast<int>(cudaGetLastError());
}


// --- bfloat16: tensor cores (WMMA 16 x 16 x 16, float32 accumulators) ---
// The same two passes with every product on the tensor cores.  Tiles are
// staged as bfloat16, padded with zeros to a multiple of 16 columns (the
// k step), rows 8 elements (16 bytes) longer than that to stagger them
// across the banks.  S and dP go to float32 tiles in shared memory, P
// (rounded) and dS to bfloat16 tiles, the A operands of the accumulating
// products: P^T and dS^T as column-major fragments of the same tiles.
// Warp (wr, wc) of the 8 owns accumulator row block wr (16 rows) and
// column blocks wc, wc + 2, ... of the output chunk, kept as fragments in
// registers across the whole walk (four of dk and four of dv, or four of
// dq); the epilogue stages them through shared memory to scale, round
// and store them.
constexpr int kSLdB = kBK + 4;   // float32 S and dP tiles
constexpr int kPLd = kBK + 8;    // bfloat16 P and dS tiles

__host__ __device__ inline int bf16_ld(int d) { return pad16(d) + 8; }
__host__ __device__ inline int out_ld(int d) { return pad16(d) + 4; }
__host__ __device__ inline size_t align128(size_t n) {
  return (n + 127) / 128 * 128;
}

struct SmemB {
  bf16 *qs, *dos, *ks, *vs;   // (64, ld) each
  float *ss, *dps;            // (64, kSLdB): S, dP; together the
                              // epilogue's (64, out_ld) float32 tile
  bf16 *pb, *dsb;             // (64, kPLd): P rounded, dS
  float *lse, *dd;            // (64)
};

__device__ __forceinline__ SmemB carve_bf16(unsigned char* raw, int ld) {
  const size_t tile = align128(sizeof(bf16) * kBQ * ld);
  unsigned char* p = raw;
  SmemB m;
  m.qs = reinterpret_cast<bf16*>(p);
  m.dos = reinterpret_cast<bf16*>(p += tile);
  m.ks = reinterpret_cast<bf16*>(p += tile);
  m.vs = reinterpret_cast<bf16*>(p += tile);
  m.ss = reinterpret_cast<float*>(p += tile);
  m.dps = m.ss + kBQ * kSLdB;
  m.pb = reinterpret_cast<bf16*>(p += align128(sizeof(float) * 2 * kBQ *
                                               kSLdB));
  m.dsb = reinterpret_cast<bf16*>(p += align128(sizeof(bf16) * kBQ * kPLd));
  m.lse = reinterpret_cast<float*>(p += align128(sizeof(bf16) * kBQ * kPLd));
  m.dd = m.lse + kBQ;
  return m;
}

inline size_t smem_bytes_bf16(int ld) {
  return 4 * align128(sizeof(bf16) * kBQ * ld) +
         align128(sizeof(float) * 2 * kBQ * kSLdB) +
         2 * align128(sizeof(bf16) * kBQ * kPLd) + 2 * sizeof(float) * kBQ;
}

// Stage rows [r0, r0 + rows) of head hd, columns [c0, c0 + n), as
// bfloat16 into rows of stride ld, zero past S and from n up to
// pad16(n): 16-byte copies where vec (D % 8 == 0, so c0 and n are
// multiples of 8, and the tensors 16-byte aligned), else one element at
// a time.
__device__ __forceinline__ void stage_b(bf16* dst,
                                        const bf16* __restrict__ src, int b,
                                        int r0, int S, int H, int hd, int D,
                                        int c0, int n, int ld, int rows,
                                        bool vec) {
  const int width = pad16(n);
  if (vec) {
    const int cpr = width / 8;   // 16-byte pieces a row
    for (int idx = threadIdx.x; idx < rows * cpr; idx += kThreads) {
      const int r = idx / cpr, c = idx - r * cpr;
      const int s = r0 + r;
      uint4 x = make_uint4(0u, 0u, 0u, 0u);
      if (s < S && c * 8 < n)
        x = *reinterpret_cast<const uint4*>(
            src + (((int64_t)b * S + s) * H + hd) * D + c0 + c * 8);
      *reinterpret_cast<uint4*>(dst + r * ld + c * 8) = x;
    }
    return;
  }
  for (int idx = threadIdx.x; idx < rows * width; idx += kThreads) {
    const int r = idx / width, d = idx - r * width;
    const int s = r0 + r;
    dst[r * ld + d] = s < S && d < n
        ? src[(((int64_t)b * S + s) * H + hd) * D + c0 + d]
        : __float2bfloat16(0.f);
  }
}

// LSE and D of q rows [q0, q0 + 64) of head h (+inf and 0 past Sq).
__device__ __forceinline__ void stage_rows_b(const SmemB& m,
                                             const float* __restrict__ lse,
                                             const float* __restrict__ dd,
                                             int b, int h, int q0,
                                             const Shape& s) {
  for (int i = threadIdx.x; i < kBQ; i += kThreads) {
    const int row = q0 + i;
    const int64_t at = ((int64_t)b * s.Hq + h) * s.Sq + row;
    m.lse[i] = row < s.Sq ? lse[at] : CUDART_INF_F;
    m.dd[i] = row < s.Sq ? dd[at] : 0.f;
  }
}

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16,
                             wmma::row_major>;
using FragAt = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16,
                              wmma::col_major>;
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16,
                             wmma::row_major>;
using FragBt = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16,
                              wmma::col_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

// S = Q K^T and dP = dO V^T into ss and dps: warp (wr, wc) computes key
// blocks 2wc and 2wc + 1 of row block wr; sliced as the float32 route.
__device__ void scores_b(const SmemB& m, const bf16* q, const bf16* k,
                         const bf16* v, const bf16* dout, int b, int h,
                         int hk, int q0, int k0, const Shape& s, bool vec) {
  const int warp = threadIdx.x >> 5, wr = warp >> 1, wc = warp & 1;
  const bool sliced = s.D > kMaxD;
  FragC c0, c1, d0, d1;
  wmma::fill_fragment(c0, 0.f);
  wmma::fill_fragment(c1, 0.f);
  wmma::fill_fragment(d0, 0.f);
  wmma::fill_fragment(d1, 0.f);
  for (int s0 = 0; s0 < s.D; s0 += kMaxD) {   // one slice unless sliced
    const int n = min(kMaxD, s.D - s0);
    if (sliced) {
      __syncthreads();   // done with the slice before
      stage_b(m.qs, q, b, q0, s.Sq, s.Hq, h, s.D, s0, n, s.ld, kBQ, vec);
      stage_b(m.dos, dout, b, q0, s.Sq, s.Hq, h, s.D, s0, n, s.ld, kBQ,
              vec);
      stage_b(m.ks, k, b, k0, s.Skv, s.Hkv, hk, s.D, s0, n, s.ld, kBK, vec);
      stage_b(m.vs, v, b, k0, s.Skv, s.Hkv, hk, s.D, s0, n, s.ld, kBK, vec);
      __syncthreads();
    }
    for (int kk = 0; kk < pad16(n) / 16; ++kk) {
      FragA fa;
      FragBt f0, f1;
      wmma::load_matrix_sync(fa, m.qs + wr * 16 * s.ld + kk * 16, s.ld);
      wmma::load_matrix_sync(f0, m.ks + 2 * wc * 16 * s.ld + kk * 16, s.ld);
      wmma::load_matrix_sync(f1, m.ks + (2 * wc + 1) * 16 * s.ld + kk * 16,
                             s.ld);
      wmma::mma_sync(c0, fa, f0, c0);
      wmma::mma_sync(c1, fa, f1, c1);
      wmma::load_matrix_sync(fa, m.dos + wr * 16 * s.ld + kk * 16, s.ld);
      wmma::load_matrix_sync(f0, m.vs + 2 * wc * 16 * s.ld + kk * 16, s.ld);
      wmma::load_matrix_sync(f1, m.vs + (2 * wc + 1) * 16 * s.ld + kk * 16,
                             s.ld);
      wmma::mma_sync(d0, fa, f0, d0);
      wmma::mma_sync(d1, fa, f1, d1);
    }
  }
  float* so = m.ss + wr * 16 * kSLdB + 2 * wc * 16;
  float* po = m.dps + wr * 16 * kSLdB + 2 * wc * 16;
  wmma::store_matrix_sync(so, c0, kSLdB, wmma::mem_row_major);
  wmma::store_matrix_sync(so + 16, c1, kSLdB, wmma::mem_row_major);
  wmma::store_matrix_sync(po, d0, kSLdB, wmma::mem_row_major);
  wmma::store_matrix_sync(po + 16, d1, kSLdB, wmma::mem_row_major);
}

// P (rounded to bfloat16, as the forward rounds p) into pb and dS into
// dsb; masked entries 0.
__device__ __forceinline__ void softmax_grad_b(const SmemB& m, int q0,
                                               int k0, const Shape& s) {
  const int off = s.off;
  for (int idx = threadIdx.x; idx < kBQ * kBK; idx += kThreads) {
    const int r = idx / kBK, c = idx - r * kBK;
    const int qpos = q0 + r, kpos = k0 + c;
    const bool ok = qpos < s.Sq && kpos < s.Skv &&
                    (!s.causal || kpos <= qpos + off);
    const float p =
        ok ? expf(m.ss[r * kSLdB + c] * s.scale - m.lse[r]) : 0.f;
    m.pb[r * kPLd + c] = __float2bfloat16(p);
    m.dsb[r * kPLd + c] =
        __float2bfloat16(p * (m.dps[r * kSLdB + c] - m.dd[r]));
  }
}

// The accumulator fragments (row block wr, column blocks wc + 2i) times
// mult, stored as bfloat16 to rows [r0, r0 + 64) of head hd, columns
// [d0, d0 + dn), through the float32 tile at m.ss.
__device__ __forceinline__ void store_frags(const SmemB& m,
                                            FragC (&acc)[4], float mult,
                                            bf16* __restrict__ dst, int b,
                                            int r0, int S, int H, int hd,
                                            int D, int d0, int dn) {
  const int warp = threadIdx.x >> 5, wr = warp >> 1, wc = warp & 1;
  const int ncb = pad16(dn) / 16, ldo = out_ld(dn);
  __syncthreads();   // every warp is done with ss and dps
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int cb = wc + 2 * i;
    if (cb < ncb)
      wmma::store_matrix_sync(m.ss + wr * 16 * ldo + cb * 16, acc[i], ldo,
                              wmma::mem_row_major);
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < kBQ * dn; idx += kThreads) {
    const int r = idx / dn, d = idx - r * dn;
    const int row = r0 + r;
    if (row < S)
      dst[(((int64_t)b * S + row) * H + hd) * D + d0 + d] =
          __float2bfloat16(m.ss[r * ldo + d] * mult);
  }
}

__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dkdv_bf16_kernel(const bf16* __restrict__ q,
                               const bf16* __restrict__ k,
                               const bf16* __restrict__ v,
                               const bf16* __restrict__ dout,
                               const float* __restrict__ lse,
                               const float* __restrict__ dd,
                               bf16* __restrict__ dk, bf16* __restrict__ dv,
                               Shape s, int vec) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const SmemB m = carve_bf16(smem_raw, s.ld);
  const bool sliced = s.D > kMaxD;
  const int warp = threadIdx.x >> 5, wr = warp >> 1, wc = warp & 1;
  const int k0 = blockIdx.x * kBK, hk = blockIdx.y;
  const int b = blockIdx.z / s.nd;
  const int d0 = blockIdx.z % s.nd * s.Dc, dn = min(s.Dc, s.D - d0);
  const int ncb = pad16(dn) / 16;
  const int G = s.Hq / s.Hkv, off = s.off;
  const int n_qt = (s.Sq + kBQ - 1) / kBQ;
  const int qt_first = s.causal ? max(0, k0 - off) / kBQ : 0;

  if (!sliced) {
    stage_b(m.ks, k, b, k0, s.Skv, s.Hkv, hk, s.D, 0, s.D, s.ld, kBK, vec);
    stage_b(m.vs, v, b, k0, s.Skv, s.Hkv, hk, s.D, 0, s.D, s.ld, kBK, vec);
  }
  FragC acc_k[4], acc_v[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    wmma::fill_fragment(acc_k[i], 0.f);
    wmma::fill_fragment(acc_v[i], 0.f);
  }

  for (int g = 0; g < G; ++g) {
    const int h = hk * G + g;
    for (int qt = qt_first; qt < n_qt; ++qt) {
      const int q0 = qt * kBQ;
      __syncthreads();   // the previous tile is done with every buffer
      if (!sliced) {
        stage_b(m.qs, q, b, q0, s.Sq, s.Hq, h, s.D, 0, s.D, s.ld, kBQ, vec);
        stage_b(m.dos, dout, b, q0, s.Sq, s.Hq, h, s.D, 0, s.D, s.ld, kBQ,
                vec);
      }
      stage_rows_b(m, lse, dd, b, h, q0, s);
      __syncthreads();
      scores_b(m, q, k, v, dout, b, h, hk, q0, k0, s, vec);
      __syncthreads();
      softmax_grad_b(m, q0, k0, s);
      if (sliced) {   // this CTA's output columns of q and dO
        __syncthreads();
        stage_b(m.qs, q, b, q0, s.Sq, s.Hq, h, s.D, d0, dn, s.ld, kBQ, vec);
        stage_b(m.dos, dout, b, q0, s.Sq, s.Hq, h, s.D, d0, dn, s.ld, kBQ,
                vec);
      }
      __syncthreads();
      // dv += P^T dO, dk += dS^T Q: A = P^T, dS^T (keys x q rows) read
      // column-major from the (q rows x keys) tiles
#pragma unroll
      for (int kk = 0; kk < kBQ / 16; ++kk) {
        FragAt pa, sa;
        wmma::load_matrix_sync(pa, m.pb + kk * 16 * kPLd + wr * 16, kPLd);
        wmma::load_matrix_sync(sa, m.dsb + kk * 16 * kPLd + wr * 16, kPLd);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int cb = wc + 2 * i;
          if (cb < ncb) {
            FragB fb;
            wmma::load_matrix_sync(fb, m.dos + kk * 16 * s.ld + cb * 16,
                                   s.ld);
            wmma::mma_sync(acc_v[i], pa, fb, acc_v[i]);
            wmma::load_matrix_sync(fb, m.qs + kk * 16 * s.ld + cb * 16,
                                   s.ld);
            wmma::mma_sync(acc_k[i], sa, fb, acc_k[i]);
          }
        }
      }
    }
  }
  store_frags(m, acc_k, s.scale, dk, b, k0, s.Skv, s.Hkv, hk, s.D, d0, dn);
  store_frags(m, acc_v, 1.f, dv, b, k0, s.Skv, s.Hkv, hk, s.D, d0, dn);
}

__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dq_bf16_kernel(const bf16* __restrict__ q,
                             const bf16* __restrict__ k,
                             const bf16* __restrict__ v,
                             const bf16* __restrict__ dout,
                             const float* __restrict__ lse,
                             const float* __restrict__ dd,
                             bf16* __restrict__ dq, Shape s, int vec) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const SmemB m = carve_bf16(smem_raw, s.ld);
  const bool sliced = s.D > kMaxD;
  const int warp = threadIdx.x >> 5, wr = warp >> 1, wc = warp & 1;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;   // longest first
  const int h = blockIdx.y, hk = h / (s.Hq / s.Hkv);
  const int b = blockIdx.z / s.nd;
  const int d0 = blockIdx.z % s.nd * s.Dc, dn = min(s.Dc, s.D - d0);
  const int ncb = pad16(dn) / 16;
  const int last_row = min(q0 + kBQ, s.Sq) - 1;
  const int k_end = s.causal ? min(s.Skv, last_row + s.off + 1) : s.Skv;
  const int n_kt = (k_end + kBK - 1) / kBK;

  if (!sliced) {
    stage_b(m.qs, q, b, q0, s.Sq, s.Hq, h, s.D, 0, s.D, s.ld, kBQ, vec);
    stage_b(m.dos, dout, b, q0, s.Sq, s.Hq, h, s.D, 0, s.D, s.ld, kBQ, vec);
  }
  stage_rows_b(m, lse, dd, b, h, q0, s);
  FragC acc[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) wmma::fill_fragment(acc[i], 0.f);

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();   // the previous tile is done with every buffer
    if (!sliced) {
      stage_b(m.ks, k, b, k0, s.Skv, s.Hkv, hk, s.D, 0, s.D, s.ld, kBK, vec);
      stage_b(m.vs, v, b, k0, s.Skv, s.Hkv, hk, s.D, 0, s.D, s.ld, kBK, vec);
    }
    __syncthreads();
    scores_b(m, q, k, v, dout, b, h, hk, q0, k0, s, vec);
    __syncthreads();
    softmax_grad_b(m, q0, k0, s);
    if (sliced) {   // this CTA's output columns of k
      __syncthreads();
      stage_b(m.ks, k, b, k0, s.Skv, s.Hkv, hk, s.D, d0, dn, s.ld, kBK, vec);
    }
    __syncthreads();
    // dq += dS K
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      FragA sa;
      wmma::load_matrix_sync(sa, m.dsb + wr * 16 * kPLd + kk * 16, kPLd);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int cb = wc + 2 * i;
        if (cb < ncb) {
          FragB fb;
          wmma::load_matrix_sync(fb, m.ks + kk * 16 * s.ld + cb * 16, s.ld);
          wmma::mma_sync(acc[i], sa, fb, acc[i]);
        }
      }
    }
  }
  store_frags(m, acc, s.scale, dq, b, q0, s.Sq, s.Hq, h, s.D, d0, dn);
}

// Launch the three passes: D, then dk and dv (kv_kernel), then dq
// (q_kernel), the last two with smem bytes of dynamic shared memory and
// the trailing kernel arguments ``extra``.
template <typename T, typename KV, typename Q, typename... Extra>
int launch(KV kv_kernel, Q q_kernel, size_t smem, int& set_kv, int& set_q,
           const void* q, const void* k, const void* v, const void* out,
           const void* dout, const float* lse, float* dd, void* dq,
           void* dk, void* dv, Shape s, cudaStream_t stream,
           Extra... extra) {
  const T* tq = static_cast<const T*>(q);
  const T* tk = static_cast<const T*>(k);
  const T* tv = static_cast<const T*>(v);
  const T* tdo = static_cast<const T*>(dout);
  const int64_t rows = (int64_t)s.B * s.Sq * s.Hq;
  const int per = kThreads / 32;
  flash_bwd_dot_kernel<T><<<(unsigned)((rows + per - 1) / per), kThreads,
                            0, stream>>>(static_cast<const float*>(out),
                                         tdo, dd, s.B, s.Sq, s.Hq, s.D);
  cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess)
    err = allow_smem(reinterpret_cast<const void*>(kv_kernel), (int)smem,
                     set_kv);
  if (err == cudaSuccess)
    err = allow_smem(reinterpret_cast<const void*>(q_kernel), (int)smem,
                     set_q);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (s.Skv > 0) {
    const dim3 grid((s.Skv + kBK - 1) / kBK, s.Hkv, s.B * s.nd);
    kv_kernel<<<grid, kThreads, smem, stream>>>(
        tq, tk, tv, tdo, lse, dd, static_cast<T*>(dk), static_cast<T*>(dv),
        s, extra...);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((s.Sq + kBQ - 1) / kBQ, s.Hq, s.B * s.nd);
  q_kernel<<<grid, kThreads, smem, stream>>>(tq, tk, tv, tdo, lse, dd,
                                             static_cast<T*>(dq), s,
                                             extra...);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The backward of flash_attention_launch / flash_attention_sm90_launch:
// q (B, Sq, Hq, D), k and v (B, Skv, Hkv, D) and the gradient dout
// (B, Sq, Hq, D) of the forward's output, all contiguous of one dtype,
// float32 (dtype 0) or bfloat16 (dtype 1), the forward's output out
// (B, Sq, Hq, D) in float32 (a bfloat16 call's values before rounding,
// its o32), and its lse (B, Hq, Sq) float32 -> dq, dk, dv of the inputs'
// shapes and dtype, using dd (B, Hq, Sq) float32 as scratch.  Query row
// i sits at position i + q_offset, the forward's (q_offset comes last,
// after the stream).  Requires B, Sq >= 1, Hq % Hkv == 0, D >= 1 and
// q_offset >= 0.  Returns the first launch error (0 on success).
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* out,
    const void* dout, const void* lse, void* dd, void* dq, void* dk,
    void* dv, int B, int Sq, int Skv, int Hq, int Hkv, int D, int dtype,
    int causal, float scale, void* stream, int q_offset) {
  if (D < 1 || B < 1 || Sq < 1 || q_offset < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Shape s;
  s.B = B; s.Sq = Sq; s.Skv = Skv; s.Hq = Hq; s.Hkv = Hkv; s.D = D;
  s.causal = causal; s.scale = scale; s.off = q_offset;
  // output chunks: D itself up to kMaxD, else an even split of D into the
  // fewest chunks of at most kMaxD columns, rounded up to 16
  s.nd = (D + kMaxD - 1) / kMaxD;
  s.Dc = s.nd == 1 ? D : pad16((D + s.nd - 1) / s.nd);
  const int sw = D < kMaxD ? D : kMaxD;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* d = static_cast<float*>(dd);
  if (dtype == 1) {
    static int set_kv = 0, set_q = 0;
    s.ld = bf16_ld(sw);
    const int vec = D % 8 == 0 &&
                    ((reinterpret_cast<uintptr_t>(q) |
                      reinterpret_cast<uintptr_t>(k) |
                      reinterpret_cast<uintptr_t>(v) |
                      reinterpret_cast<uintptr_t>(dout)) & 15) == 0;
    return launch<bf16>(flash_bwd_dkdv_bf16_kernel, flash_bwd_dq_bf16_kernel,
                        smem_bytes_bf16(s.ld), set_kv, set_q, q, k, v, out,
                        dout, l, d, dq, dk, dv, s, st, vec);
  }
  const int vec = D % 4 == 0 &&
                  ((reinterpret_cast<uintptr_t>(q) |
                    reinterpret_cast<uintptr_t>(k) |
                    reinterpret_cast<uintptr_t>(v) |
                    reinterpret_cast<uintptr_t>(dout)) & 15) == 0;
  s.ld = 0;   // unused: the float32 kernels stage through the ring
  const float *fq = static_cast<const float*>(q),
              *fk = static_cast<const float*>(k),
              *fv = static_cast<const float*>(v),
              *fo = static_cast<const float*>(out),
              *fdo = static_cast<const float*>(dout);
  float *fdq = static_cast<float*>(dq), *fdk = static_cast<float*>(dk),
        *fdv = static_cast<float*>(dv);
  // chunks of at most kMaxD = 128 columns: one or two 64-column dk/dv
  // stages, one 128-column dq stage
  if (s.Dc <= 64) {
    static int set_kv = 0, set_q = 0;
    return launch_f32(flash_bwd_dkdv_f32_kernel<1>,
                      flash_bwd_dq_f32_kernel<1>, set_kv, set_q, fq, fk, fv,
                      fo, fdo, l, d, fdq, fdk, fdv, s, vec, st);
  }
  static int set_kv = 0, set_q = 0;
  return launch_f32(flash_bwd_dkdv_f32_kernel<2>, flash_bwd_dq_f32_kernel<1>,
                    set_kv, set_q, fq, fk, fv, fo, fdo, l, d, fdq, fdk, fdv,
                    s, vec, st);
}
