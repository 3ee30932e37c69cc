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
//         j > i + (Skv - Sq)   (the Pallas body has no Skv - Sq offset; it
//         agrees with the model only when Sq == Skv),
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
// 2.75e11 FLOP against about 151 MB of q, k, v and output.
//
// Design.  One CTA of 256 threads (8 warps) per (64-row q tile, q head,
// batch).  The q tile stays in shared memory; the CTA walks 64-row K/V
// tiles up to the causal diagonal, staging each in dynamic shared memory.
// Per K/V tile:
//   scores S = Q K^T: in bfloat16 on the tensor cores (WMMA 16x16x16
//     fragments with float32 accumulation, two 16 x 16 blocks per warp);
//     in float32 by scalar FMAs, thread (ty, tx) of a 16 x 16 grid
//     computing the 4 x 4 scores of rows ty + 16a and keys tx + 16b from
//     rows of odd stride, so the 16 keys of a warp hit 16 banks;
//   online softmax: 4 threads per q row reduce its 64 scores by shuffles
//     and keep the row's m and l in registers across tiles; they write p
//     (rounded to v's dtype) and the rescale factor exp(m_old - m_new) to
//     shared memory;
//   P.V: in bfloat16 on the tensor cores into a float32 tile in shared
//     memory, in float32 by scalar FMAs; either way thread (ty, tx) keeps
//     the output accumulator of rows ty + 16a and columns tx + 16c in
//     registers (4 x 8 up to D = 128, 4 x 16 up to D = 256) and rescales
//     it there.
// No score, weight or partial sum goes through device memory.  When the
// caller gives an lse buffer (training), each row's log-sum-exp
// m + log(l) is written for the backward (csrc/flash_attention_bwd.cu);
// serving passes none and skips the store.  The q
// tiles are launched longest-first (the last causal tiles walk the most
// keys), so short tiles fill in behind them.
//
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
#include "common.cuh"

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

// --- shared-memory layouts --------------------------------------------
// float32 route: q, k, v tiles of row stride f32_stride(D) (odd), scores
// and p in one (kBQ, kBK + 1) tile.
__host__ __device__ inline int f32_stride(int d) {
  return (d % 2 == 0) ? d + 1 : d;
}
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
inline size_t smem_f32(int sw, int dc) {
  return sizeof(float) *
         (size_t)(kBQ * f32_stride(sw) + kBK * f32_stride(sw) +
                  kBK * f32_stride(dc) + kBQ * (kBK + 1) + 2 * kBQ);
}

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
                                        int D, int Dc, int causal) {
  Tile t;
  const int nd = (D + Dc - 1) / Dc;
  t.qt = gridDim.x - 1 - blockIdx.x;   // longest tiles first
  t.h = blockIdx.y;
  t.b = blockIdx.z / nd;
  t.d0 = blockIdx.z % nd * Dc;
  t.dn = min(Dc, D - t.d0);
  t.hk = t.h / (Hq / Hkv);
  t.q0 = t.qt * kBQ;
  t.off = Skv - Sq;                    // q row i sits at i + off
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

// --- float32: scalar FMAs ----------------------------------------------
template <int kCols>
__global__ void __launch_bounds__(kThreads)
    flash_attention_f32_kernel(const float* __restrict__ q,
                               const float* __restrict__ k,
                               const float* __restrict__ v,
                               float* __restrict__ out,
                               float* __restrict__ lse,
                               float* __restrict__ o32, int Sq, int Skv,
                               int Hq, int Hkv, int D, int causal,
                               float scale, int Dc) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* smem = reinterpret_cast<float*>(smem_raw);
  const bool sliced = D > kMaxD;
  const int dp = f32_stride(min(D, kMaxD)), dv = f32_stride(Dc);
  constexpr int ps_ld = kBK + 1;
  float* qs = smem;                   // (kBQ, dp)
  float* ks = qs + kBQ * dp;          // (kBK, dp)
  float* vs = ks + kBK * dp;          // (kBK, dv)
  float* ps = vs + kBK * dv;          // (kBQ, ps_ld) scores, then p
  float* corr = ps + kBQ * ps_ld;     // (kBQ) rescale factor of the tile
  float* lsum = corr + kBQ;           // (kBQ) final row sums

  const Tile t = tile_of(Sq, Skv, Hq, Hkv, D, Dc, causal);
  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;
  const int srow = tid >> 2, spart = tid & 3;   // softmax lanes
  const int sqpos = t.q0 + srow + t.off;

  if (!sliced) stage(qs, q, t.b, t.q0, Sq, Hq, t.h, D, 0, D, D, dp, kBQ);
  float acc[4][kCols];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[a][c] = 0.f;
  float m_run = -CUDART_INF_F, l_run = 0.f;

  for (int kt = 0; kt < t.n_kt; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();   // the previous tile's P.V is done with vs and ps
    if (!sliced) stage(ks, k, t.b, k0, Skv, Hkv, t.hk, D, 0, D, D, dp, kBK);
    stage(vs, v, t.b, k0, Skv, Hkv, t.hk, D, t.d0, t.dn, t.dn, dv, kBK);
    __syncthreads();

    float sc[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[a][j] = 0.f;
    for (int c0 = 0; c0 < D; c0 += kMaxD) {   // one slice unless sliced
      const int n = min(kMaxD, D - c0);
      if (sliced) {
        if (c0 > 0) __syncthreads();   // done with the slice before
        stage(qs, q, t.b, t.q0, Sq, Hq, t.h, D, c0, n, n, dp, kBQ);
        stage(ks, k, t.b, k0, Skv, Hkv, t.hk, D, c0, n, n, dp, kBK);
        __syncthreads();
      }
      for (int d = 0; d < n; ++d) {
        float qv[4], kv[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) qv[a] = qs[(ty + 16 * a) * dp + d];
#pragma unroll
        for (int j = 0; j < 4; ++j) kv[j] = ks[(tx + 16 * j) * dp + d];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            sc[a][j] = fmaf(qv[a], kv[j], sc[a][j]);
      }
    }
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        ps[(ty + 16 * a) * ps_ld + tx + 16 * j] = sc[a][j];
    __syncthreads();

    float* row = ps + srow * ps_ld;
    const float cf = softmax_tile(row, row, scale, k0, Skv, causal, sqpos,
                                  spart, m_run, l_run);
    if (spart == 0) corr[srow] = cf;
    __syncthreads();

    const int kn = min(kBK, Skv - k0);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const float c = corr[ty + 16 * a];
#pragma unroll
      for (int j = 0; j < kCols; ++j) acc[a][j] *= c;
    }
    for (int j = 0; j < kn; ++j) {
      float pv[4], vv[kCols];
#pragma unroll
      for (int a = 0; a < 4; ++a) pv[a] = ps[(ty + 16 * a) * ps_ld + j];
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int d = tx + 16 * c;
        vv[c] = d < t.dn ? vs[j * dv + d] : 0.f;
      }
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < kCols; ++c)
          acc[a][c] = fmaf(pv[a], vv[c], acc[a][c]);
    }
  }

  if (spart == 0) lsum[srow] = fmaxf(l_run, 1e-30f);
  if (lse != nullptr && spart == 0)
    store_lse(lse, t, Sq, Hq, srow, m_run, l_run);
  __syncthreads();
  store_out<kCols>(out, o32, acc, lsum, t.b, t.q0, Sq, Hq, t.h, D, t.d0,
                   t.dn, ty, tx);
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
                                float scale, int Dc) {
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

  const Tile t = tile_of(Sq, Skv, Hq, Hkv, D, Dc, causal);
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
           cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Sq + kBQ - 1) / kBQ, Hq, B * ((D + Dc - 1) / Dc));
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), lse, o32, Sq, Skv,
      Hq, Hkv, D, causal, scale, Dc);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q (B, Sq, Hq, D), k and v (B, Skv, Hkv, D) -> out (B, Sq, Hq, D), all
// contiguous, of float32 (dtype 0) or bfloat16 (dtype 1), and, for the
// backward, where lse is not null, each row's float32 log-sum-exp into lse
// (B, Hq, Sq), and where o32 is not null, out's float32 values before
// rounding into o32 (B, Sq, Hq, D) (a bfloat16 call's; a float32 call's
// out is its own).  Requires Hq % Hkv == 0, D >= 1 and, if causal,
// Sq <= Skv.  Returns cudaGetLastError() after the launch (0 on success).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, void* lse,
                                      void* o32, int B, int Sq, int Skv,
                                      int Hq, int Hkv, int D, int dtype,
                                      int causal, float scale,
                                      void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D < 1) return static_cast<int>(cudaErrorInvalidValue);
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
                        B, Sq, Skv, Hq, Hkv, D, causal, scale, Dc, s);
  return launch<float>(wide ? flash_attention_f32_kernel<16>
                            : flash_attention_f32_kernel<8>,
                       smem_f32(sw, Dc), q, k, v, out,
                       static_cast<float*>(lse), static_cast<float*>(o32),
                       B, Sq, Skv, Hq, Hkv, D, causal, scale, Dc, s);
}
