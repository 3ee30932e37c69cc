// Split-TF32 tensor-core products and their staging, for the float32
// routes of the general flash attention kernels (csrc/flash_attention.cu
// forward, csrc/flash_attention_bwd.cu backward).
//
// Arithmetic.  Each float32 operand x is split into hi (x rounded to
// nearest at tf32's 11 significant bits by Veltkamp's split: three
// float32 operations at the FP32 pipe's full rate, where
// cvt.rna.tf32.f32 is slower; scripts/tf32_split_bench.cu times both)
// and lo = x - hi, which the tensor core reads truncated to 11
// significant bits (it drops a tf32 operand's low 13 bits, as that
// script shows).  A product a.b is lo.hi + hi.lo + hi.hi on mma.sync
// m16n8k8 (tf32 in, float32 accumulators), the small terms first; lo.lo
// (about 2^-22 of |a||b|) is dropped.  Operands read from the ring are
// split in registers as their fragments are loaded; P and dS are split
// once, by the warp that computes them, into hi and lo planes in shared
// memory, or stay in registers (the rows kernel, frag_of).  Each term's
// product is exact, and each stage's sum goes to a fresh partial that
// float32 adds fold in (fold() says why), so the result is float32
// attention to a few float32 ulps of each sum: the CPU test
// tests/test_torch_flash_split_tf32.py holds a numpy copy of this
// arithmetic (the mma's additions cut toward zero, as
// scripts/tf32_split_bench.cu measures them) to the kernels' 1e-5 bar
// against JAX, and one tf32 product alone, or whole chains without fresh
// partials, miss it.
//
// Staging.  Every operand tile reaches shared memory as 64-row pieces of
// 64 float32 columns (q rows or keys, columns of D), two pieces a stage,
// through a ring of kStages = 2 slots filled by cp.async (16-byte copies
// where the rows allow, else 4-byte ones; rows and columns past the
// tensor are zero-filled), so the next stage's copies run under this
// stage's products.  A slot's rows are kSlotLd = 136 floats
// (136 = 8 mod 32): the 64-bit fragment loads of k-contiguous operands
// (rows g, columns 2t and 2t + 1 for the 8 groups g and 4 lanes t of a
// warp, k permuted inside each 8-wide step) and the 32-bit loads of
// k-major B operands (rows t and t + 4, column g) hit 32 distinct banks.
// P and dS planes (written from accumulators, read as A operands with k
// in order) use kPLd = 68 (4 mod 8) for the same reason.
//
// What was tried and measured slower on the H100 (in turns with these
// sources, as chip_smoke.py --ab times two designs): every ring piece
// split once into hi and lo planes as it lands (it doubles the
// shared-memory traffic);
// 32-column pieces in a 4-deep ring, or a 3-deep ring of 64;
// separate accumulators for the small terms; hi and lo of P side by side
// (16-byte stores); the q tile resident with p unsplit in shared memory.
#pragma once
#include "common.cuh"

namespace tf32 {

constexpr int kThreads = 256;            // 8 warps: 4 row groups x 2
constexpr int kRows = 64;                // rows of a piece, of a tile
constexpr int kPiece = 64;               // columns of a piece
constexpr int kSlotLd = 2 * kPiece + 8;  // row stride of a ring slot
constexpr int kSlot = kRows * kSlotLd;   // floats of a slot
constexpr int kStages = 2;               // ring depth
constexpr int kPLd = kRows + 4;          // row stride of P and dS tiles
constexpr int kTile = kRows * kPLd;      // floats of a P or dS plane
constexpr size_t kRingBytes = sizeof(float) * kStages * kSlot;

struct FragA { uint32_t hi[4], lo[4]; };   // 16 x 8, row-major
struct FragB { uint32_t hi[2], lo[2]; };   // 8 x 8, column-major

// x = hi + lo: hi is x rounded to nearest at 11 significant bits
// (Veltkamp's split, three float32 operations at the full FP32 rate,
// where cvt.rna.tf32.f32 runs on a slower pipe), lo = x - hi exactly;
// the tensor core reads the top 19 bits of a tf32 operand, so lo enters
// the products truncated to 11 significant bits.  The _rn intrinsics
// keep the compiler from contracting the split into FMAs.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  const float c = __fmul_rn(x, 8193.f);   // 2^13 + 1
  const float h = __fsub_rn(c, __fsub_rn(c, x));
  hi = __float_as_uint(h);
  lo = __float_as_uint(__fsub_rn(x, h));
}

__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]),
        "r"(b[1]));
}

// c += a b in split TF32: lo.hi + hi.lo + hi.hi
__device__ __forceinline__ void mma3(float (&c)[4], const FragA& a,
                                     const FragB& b) {
  mma(c, a.lo, b.hi);
  mma(c, a.hi, b.lo);
  mma(c, a.hi, b.hi);
}

// Fragment loads; g = lane / 4, t = lane % 4.  The *_perm pair reads k
// permuted inside the 8-wide step (mma k index t from column 2t, t + 4
// from 2t + 1), so both halves come in one 64-bit load; it is used only
// for products whose A and B are both k-contiguous.
// A (16 x 8): element (r, k) at p[r * ld + k].
__device__ __forceinline__ void load_a_perm(FragA& f, const float* p, int ld,
                                            int g, int t) {
  const float2 x = *reinterpret_cast<const float2*>(p + g * ld + 2 * t);
  const float2 y =
      *reinterpret_cast<const float2*>(p + (g + 8) * ld + 2 * t);
  split(x.x, f.hi[0], f.lo[0]);
  split(y.x, f.hi[1], f.lo[1]);
  split(x.y, f.hi[2], f.lo[2]);
  split(y.y, f.hi[3], f.lo[3]);
}

// B (8 x 8): element (k, n) at p[n * ld + k].
__device__ __forceinline__ void load_b_perm(FragB& f, const float* p, int ld,
                                            int g, int t) {
  const float2 x = *reinterpret_cast<const float2*>(p + g * ld + 2 * t);
  split(x.x, f.hi[0], f.lo[0]);
  split(x.y, f.hi[1], f.lo[1]);
}

// A (16 x 8), k in order, already split: element (r, k) of the hi and lo
// planes at hi[r * kPLd + k], lo[r * kPLd + k].
__device__ __forceinline__ void load_a_split(FragA& f, const float* hi,
                                             const float* lo, int g, int t) {
  const int at[4] = {g * kPLd + t, (g + 8) * kPLd + t, g * kPLd + t + 4,
                     (g + 8) * kPLd + t + 4};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f.hi[i] = __float_as_uint(hi[at[i]]);
    f.lo[i] = __float_as_uint(lo[at[i]]);
  }
}

// B (8 x 8), k in order: element (k, n) at p[k * ld + n].
__device__ __forceinline__ void load_b(FragB& f, const float* p, int ld,
                                       int g, int t) {
  split(p[t * ld + g], f.hi[0], f.lo[0]);
  split(p[(t + 4) * ld + g], f.hi[1], f.lo[1]);
}

// B (8 x 8) with k permuted as in the *_perm loaders, k-major: element
// (k, n) at p[k * ld + n], so mma k index t is row 2t, t + 4 row 2t + 1
// (ld = 4 mod 8 puts a warp's 32 reads in 32 banks).
__device__ __forceinline__ void load_b_rows(FragB& f, const float* p, int ld,
                                            int g, int t) {
  split(p[2 * t * ld + g], f.hi[0], f.lo[0]);
  split(p[(2 * t + 1) * ld + g], f.hi[1], f.lo[1]);
}

// The A fragment (16 x 8, k permuted) of an accumulator tile c
// (rows g, g + 8, columns 2t, 2t + 1), split: an output of one product
// becomes the A operand of the next without leaving the registers.
__device__ __forceinline__ void frag_of(FragA& f, const float (&c)[4]) {
  split(c[0], f.hi[0], f.lo[0]);
  split(c[2], f.hi[1], f.lo[1]);
  split(c[1], f.hi[2], f.lo[2]);
  split(c[3], f.hi[3], f.lo[3]);
}

// Two neighbouring values of a P or dS tile (an accumulator's c0, c1 or
// c2, c3), split once by the warp that made them, into the hi and lo
// planes at offset at.
__device__ __forceinline__ void store_split(float* hi, float* lo, int at,
                                            float x0, float x1) {
  uint32_t h0, l0, h1, l1;
  split(x0, h0, l0);
  split(x1, h1, l1);
  *reinterpret_cast<float2*>(hi + at) =
      make_float2(__uint_as_float(h0), __uint_as_float(h1));
  *reinterpret_cast<float2*>(lo + at) =
      make_float2(__uint_as_float(l0), __uint_as_float(l1));
}

// The tensor cores add each product to the accumulator with its low bits
// truncated, a bias that grows with the number of products a sum takes:
// every stage's products go to a fresh partial, which float32 adds (round
// to nearest) then fold into the running sums.
template <int kN = 4>
__device__ __forceinline__ void fold(float (*c)[4],
                                     const float (&part)[kN][4]) {
#pragma unroll
  for (int n = 0; n < kN; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[n][e] += part[n][e];
}

// c[n] (16 x 8 each, n < 4) += A (16 x 64) B (64 x 32), both operands
// k-contiguous: A's 16 rows of stride lda at a, B's 32 rows (n = 8n' + g)
// of stride kSlotLd at b.
__device__ __forceinline__ void dot_nt(float (*c)[4], const float* a,
                                       int lda, const float* b, int g,
                                       int t) {
  float part[4][4] = {};
#pragma unroll
  for (int kk = 0; kk < kPiece / 8; ++kk) {
    FragA fa;
    load_a_perm(fa, a + kk * 8, lda, g, t);
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      FragB fb;
      load_b_perm(fb, b + n * 8 * kSlotLd + kk * 8, kSlotLd, g, t);
      mma3(part[n], fa, fb);
    }
  }
  fold(c, part);
}

// c[n] (n < 8) += A (16 x 64) B (64 x 64): A split in the planes hi, lo
// (rows of stride kPLd), B a piece's k-major rows (stride kSlotLd).
__device__ __forceinline__ void dot_nn(float (*c)[4], const float* hi,
                                       const float* lo, const float* b,
                                       int g, int t) {
  float part[kPiece / 8][4] = {};
#pragma unroll
  for (int kk = 0; kk < kRows / 8; ++kk) {
    FragA fa;
    load_a_split(fa, hi + kk * 8, lo + kk * 8, g, t);
#pragma unroll
    for (int n = 0; n < kPiece / 8; ++n) {
      FragB fb;
      load_b(fb, b + kk * 8 * kSlotLd + n * 8, kSlotLd, g, t);
      mma3(part[n], fa, fb);
    }
  }
  fold<kPiece / 8>(c, part);
}

// --- cp.async ------------------------------------------------------------
__device__ __forceinline__ void cp16(float* dst, const float* src,
                                     int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(
                   smem_u32(dst)), "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp4(float* dst, const float* src,
                                    int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(
                   smem_u32(dst)), "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// Copy rows [r0, r0 + min(64, nr)) of head hd of batch b of a
// (B, S, H, D) float32 tensor, columns [c0, c0 + 64) below climit, into
// columns [64 p, 64 p + 64) of a slot (rows of stride ld), by the kT
// threads of the CTA; zeros
// past S and climit.  vec: D % 4 == 0 and the tensor 16-byte aligned (c0
// and climit are then multiples of 4): thread i copies the 16-byte
// chunks (i % 16) of rows i / 16, i / 16 + kT / 16, ...
template <int kT = kThreads>
__device__ __forceinline__ void load_piece(float* slot, int p,
                                           const float* __restrict__ x,
                                           int b, int r0, int S, int H,
                                           int hd, int D, int c0,
                                           int climit, bool vec,
                                           int nr = kRows,
                                           int ld = kSlotLd) {
  float* dst = slot + kPiece * p;
  const int tid = threadIdx.x % kT;   // the thread's place in its group
  const int rows = min(S - r0, nr), cols = climit - c0;
  const int64_t rs = (int64_t)H * D;
  const float* src = x + (((int64_t)b * S + r0) * H + hd) * D + c0;
  if (vec) {
    const int c = (tid & 15) * 4;
    const int n = clamp_int(cols - c, 0, 4) * 4;
#pragma unroll
    for (int r = tid >> 4; r < kRows; r += kT / 16) {
      const bool ok = r < rows && n > 0;
      cp16(dst + r * ld + c, ok ? src + r * rs + c : x, ok ? n : 0);
    }
  } else {
    for (int i = tid; i < kRows * kPiece; i += kT) {
      const int r = i >> 6, c = i & 63;
      const bool ok = r < rows && c < cols;
      cp4(dst + r * ld + c, ok ? src + r * rs + c : x, ok ? 4 : 0);
    }
  }
}

// The barrier of a thread's group: the whole CTA (kT = kThreads), or one
// of two groups of kT threads (named barriers 1 and 2).
template <int kT>
__device__ __forceinline__ void group_sync() {
  if (kT == kThreads) {
    __syncthreads();
  } else if (threadIdx.x < kT) {
    asm volatile("bar.sync 1, %0;" ::"n"(kT) : "memory");
  } else {
    asm volatile("bar.sync 2, %0;" ::"n"(kT) : "memory");
  }
}

// The ring of a group of kT threads: stage s lives in slot s % kStages.
// next() waits for stage s, makes it visible to the group, lets `issue`
// start stage s + kStages - 1 into the slot that stage s - 1 has just
// freed, and returns stage s's slot.  issue(s) fills a slot (two
// load_piece calls) or, past the last stage, nothing; a group is
// committed either way, so cp_wait counts stay uniform.
template <int kT, typename Issue>
struct Ring {
  float* base;
  Issue issue;
  int s = 0;

  __device__ __forceinline__ Ring(float* ring, Issue fn)
      : base(ring), issue(fn) {
#pragma unroll 1
    for (int i = 0; i < kStages - 1; ++i) {
      issue(i, base + i * kSlot);
      cp_commit();
    }
  }

  __device__ __forceinline__ const float* next() {
    cp_wait<kStages - 2>();
    group_sync<kT>();
    const int ahead = s + kStages - 1;
    issue(ahead, base + (ahead % kStages) * kSlot);
    cp_commit();
    return base + (s++ % kStages) * kSlot;
  }
};

template <int kT = kThreads, typename Issue>
__device__ __forceinline__ Ring<kT, Issue> make_ring(float* ring, Issue fn) {
  return Ring<kT, Issue>(ring, fn);
}

// Barrier of the two warps (64 threads) of row group rg, named 1 + rg;
// immediate ids, so that the kernel reserves 5 barriers and not all 16.
__device__ __forceinline__ void pair_sync(int rg) {
  switch (rg) {
    case 0: asm volatile("bar.sync 1, 64;" ::: "memory"); break;
    case 1: asm volatile("bar.sync 2, 64;" ::: "memory"); break;
    case 2: asm volatile("bar.sync 3, 64;" ::: "memory"); break;
    default: asm volatile("bar.sync 4, 64;" ::: "memory"); break;
  }
}

}  // namespace tf32
