// Masked multi-head neighbourhood attention, forward and backward
// (TGAT eq. 5-7).
//
// The forward replaces the Pallas TPU kernel
//   src/repro/kernels/temporal_attn/temporal_attn.py::temporal_attn_kernel
//   (body _kernel; wrapper ops.py::temporal_attn_pallas, whose N padding to
//   a tile is not needed here).
// The backward has no Pallas counterpart: the JAX package differentiates
// only the plain layer (src/repro/models/gnn.py, the use_pallas=False
// branch), so this kernel is held against that autodiff.
//
// Forward, for each target n and head h over its K sampled neighbours:
//   s_j = <q[n,h], k[n,j,h]> * Dh^-0.5, or -1e30 where mask[n,j] is false
//   p_j = mask ? exp(s_j - max_j s_j) : 0,  a_j = p_j / max(sum_j p_j, 1e-30)
//   out[n,h] = sum_j a_j v[n,j,h]
// so a target with no valid neighbour gets a zero row.  Any K and Dh are
// taken, as by the Pallas body.
//
// Backward, given dout[n,h]:
//   dv_j = a_j dout,  da_j = <dout, v_j>,  D = sum_j a_j da_j,
//   ds_j = a_j (da_j - D),  dq = Dh^-0.5 sum_j ds_j k_j,  dk_j = Dh^-0.5 ds_j q
// A masked neighbour has a_j = 0, so it gets zero gradients, and a target
// with no valid neighbour gets zeros everywhere, as the plain version's
// `where` gives.  The mask gets no gradient.
//
// What bounds both on the H100: bytes.  The forward reads each target's q
// row and K rows of k and v once (2K+1 rows of H*Dh floats); the backward
// reads q, dout, k and v (2K+2 rows) and writes dq, dk and dv (2K+1
// rows).  Both do a few flops per float moved, far below the card's
// balance.  At the training path's shapes (H = 2, Dh = 50, K = 10, N up
// to 18,000 targets) a forward launch moves about 151 MB and a backward
// about 310 MB; at the serving hop (1,280 targets) a forward moves 11 MB,
// 3.4 us at the memory's rate, so there a launch is bound by the latency
// of its loads.
//
// Forward design (redesigned for Hopper): the bytes of a target come to
// shared memory in one go, and a warp computes on one target while the
// next one's bytes arrive.
//  * A target's q row (H*Dh floats) and its k and v slabs (K rows of
//    H*Dh floats each, contiguous: 4,000 bytes each at H 2, Dh 50, K 10)
//    are copied by three 1-D TMA bulk copies (cp.async.bulk), issued by
//    one lane and completing on an mbarrier, so every byte of the target
//    is in flight before any arithmetic and the copy costs the warp no
//    instructions and no registers.  Inputs that are not 16-byte aligned
//    (H*Dh not a multiple of 4, or an offset view) are copied by the
//    warp's lanes instead, into the same stages.
//  * Each warp owns a ring of kStages = 2 stages and walks its targets
//    (w, w + W, w + 2W, ... for W warps in the grid) so that the copy of
//    the next target is in flight while it computes on this one; its CTA
//    of 4 warps thus holds 4 targets' compute and 4 targets' copies.  The
//    grid is one wave (persistent CTAs): at the shapes above a warp's
//    ring is 17 KB, 3 CTAs (12 warps, 24 stages, 200 KB) fit an SM, and
//    the wave is 1,584 warps: 1 target a warp at 1,280 targets, 1-2 at
//    1,800, 7-8 at 12,000 and 11-12 at 18,000.
//  * Scores: lane p computes score p = (j, h) of the chunk's K*H, one dot
//    product of Dh from shared memory (float2 loads for an even Dh), no
//    shuffle chain; a masked neighbour's dot is skipped.  The masked
//    softmax runs across those lanes: when K*H fits the warp and H is a
//    power of two, by butterfly shuffles over the lanes of one head
//    (offsets 16 down to H); otherwise each lane reads its head's scores
//    back from shared memory.  P.V runs the lanes over the H*Dh output
//    columns (pairs of them for an even Dh), each summing the chunk's rows
//    of v.  A Dh that is a multiple of 32 puts the lanes' k rows in one
//    bank: correct, but the score loop is then slower.
//  * K > 32, or a target whose slabs exceed a stage's budget (kStageFloats,
//    16 KB), is taken in chunks of kc <= 32 neighbours with an online
//    softmax: a per-head running max and sum and an accumulator row in the
//    warp's shared memory, rescaled by exp(m_old - m_new) per chunk.  So
//    any K and Dh are taken, up to a ring that fits one block (H*Dh in the
//    thousands of floats).
//  The mask of a chunk's neighbours is loaded by lane j one item ahead and
//  kept in a register, so its load also overlaps the compute before it.
//  What sets the pace is the warp's compute, not the copies: on the H100
//  a first form of this kernel (scalar loads, a lane per head for the
//  softmax) ran about as long with its copies removed as with its compute
//  removed, and longer than either whole; hence the float2 loads, the
//  shuffles and no division on the item walk.  A ring of one stage (24
//  warps an SM) or of three (8 warps) moved it by a few per cent.
//
// Backward design: one warp per (target, head).  For K <= 32 and Dh <= 128
// lane l holds q and dout elements l, l+32, ... in registers; each of the
// K dot products is a lane-local partial sum reduced by butterfly
// shuffles, and lane j keeps score j, so the masked max, exp and sum are
// warp reductions in float32 registers.  Wider shapes take a second
// instance that keeps q, dout and the K scores in shared memory and loops
// over Dh in steps of 32 lanes.  Both recompute the scores instead of
// reading a max and a sum saved by the forward: they must read every k
// row anyway (dq sums over them), so the recompute costs no
// device-memory bytes.  Each (target, head) owns its q, k and v rows, so
// every gradient element is written by exactly one lane: no atomics, and
// the result is deterministic.
#include "common.cuh"

namespace {

constexpr int kWarpsPerBlock = 4;
constexpr int kMaxPerLane = 4;     // backward register instance: Dh <= 128
constexpr float kMasked = -1e30f;
constexpr int kStages = 2;         // forward: a warp's ring of stages
constexpr int kStageFloats = 4096; // forward: a stage's budget (16 KB)
constexpr int kBwdGroup = 8;       // wide backward: rows' loads in flight

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(FULL_MASK, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(FULL_MASK, x, o));
  return x;
}

__host__ __device__ __forceinline__ int round4(int x) { return (x + 3) & ~3; }

// --- forward -------------------------------------------------------------
// A warp's shared memory, in floats (every part 16-byte aligned):
//   2 mbarriers (4 floats) | kStages stages of q, k chunk, v chunk |
//   scores (kc*H) | probabilities (kc*H) | accumulator row (H*Dh) |
//   max, sum, rescale, new max (4H) | the chunk's mask (32 ints)
__host__ __device__ __forceinline__ int stage_floats(int hd, int kc) {
  return round4(hd) + 2 * round4(kc * hd);
}

__host__ __device__ __forceinline__ int fwd_warp_floats(int hd, int heads,
                                                        int kc) {
  return 4 + kStages * stage_floats(hd, kc) + 2 * round4(kc * heads) +
         round4(hd) + round4(4 * heads) + 32;
}

__device__ __forceinline__ void bulk_load(float* dst, const float* src,
                                          int bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(bar) : "memory");
}

// <a, b> over n floats of shared memory, four partial sums in flight; by
// float2 when n is even (a and b then 8-byte aligned)
__device__ __forceinline__ float dot_row(const float* a, const float* b,
                                         int n) {
  float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
  if ((n & 1) == 0) {
    const float2* a2 = reinterpret_cast<const float2*>(a);
    const float2* b2 = reinterpret_cast<const float2*>(b);
    const int n2 = n >> 1;
    int i = 0;
    for (; i + 2 <= n2; i += 2) {
      const float2 x0 = a2[i], y0 = b2[i], x1 = a2[i + 1], y1 = b2[i + 1];
      s0 = fmaf(x0.x, y0.x, s0);
      s1 = fmaf(x0.y, y0.y, s1);
      s2 = fmaf(x1.x, y1.x, s2);
      s3 = fmaf(x1.y, y1.y, s3);
    }
    if (i < n2) {
      const float2 x0 = a2[i], y0 = b2[i];
      s0 = fmaf(x0.x, y0.x, s0);
      s1 = fmaf(x0.y, y0.y, s1);
    }
  } else {
    int d = 0;
    for (; d + 4 <= n; d += 4) {
      s0 = fmaf(a[d], b[d], s0);
      s1 = fmaf(a[d + 1], b[d + 1], s1);
      s2 = fmaf(a[d + 2], b[d + 2], s2);
      s3 = fmaf(a[d + 3], b[d + 3], s3);
    }
    for (; d < n; ++d) s0 = fmaf(a[d], b[d], s0);
  }
  return (s0 + s1) + (s2 + s3);
}

struct FwdArgs {
  const float* q;      // (N, H, Dh)
  const float* k;      // (N, K, H, Dh)
  const float* v;      // (N, K, H, Dh)
  const bool* mask;    // (N, K)
  float* out;          // (N, H, Dh)
  int n, heads, kn, dh, kc;
  int bulk;            // 1: TMA bulk copies (16-byte aligned rows)
  float scale;
};

// A warp's item: target tgt, neighbours [j0, j0 + kcur).  The warp walks
// targets w0, w0 + nw, ... and each target's chunks in order, so the
// next item is one step on (no division).
struct Item {
  int tgt, j0, kcur;
};

__device__ __forceinline__ Item next_item(const FwdArgs& a, Item it,
                                          int nw) {
  it.j0 += it.kcur;
  if (it.j0 == a.kn) {
    it.j0 = 0;
    it.tgt += nw;
  }
  it.kcur = min(a.kc, a.kn - it.j0);
  return it;
}

// Copy item `it` into stage `st` (q, then the k chunk, then the v chunk)
// and complete `bar`'s phase when it has landed.
__device__ __forceinline__ void issue(const FwdArgs& a, const Item& it,
                                      float* st, uint32_t bar, int lane) {
  const int hd = a.heads * a.dh;
  float* sq = st;
  float* sk = st + round4(hd);
  float* sv = sk + round4(a.kc * hd);
  const int64_t row = ((int64_t)it.tgt * a.kn + it.j0) * hd;
  if (a.bulk) {
    if (lane == 0) {
      const int slab = 4 * it.kcur * hd;
      mbar_expect_tx(bar, 4 * hd + 2 * slab);
      bulk_load(sq, a.q + (int64_t)it.tgt * hd, 4 * hd, bar);
      bulk_load(sk, a.k + row, slab, bar);
      bulk_load(sv, a.v + row, slab, bar);
    }
    return;
  }
  for (int i = lane; i < hd; i += 32) sq[i] = a.q[(int64_t)it.tgt * hd + i];
  for (int i = lane; i < it.kcur * hd; i += 32) {
    sk[i] = a.k[row + i];
    sv[i] = a.v[row + i];
  }
  __syncwarp();
  if (lane == 0) mbar_arrive(bar);
}

__device__ __forceinline__ int mask_of(const FwdArgs& a, const Item& it,
                                       int lane) {
  return lane < it.kcur && a.mask[(int64_t)it.tgt * a.kn + it.j0 + lane];
}

__global__ void __launch_bounds__(32 * kWarpsPerBlock)
    temporal_attn_kernel(FwdArgs a) {
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x & 31;
  const int wpc = blockDim.x >> 5;
  const int nw = gridDim.x * wpc;
  const int w0 = blockIdx.x * wpc + (threadIdx.x >> 5);
  if (w0 >= a.n) return;                  // warp-uniform
  const int H = a.heads, dh = a.dh, hd = H * dh, kc = a.kc;
  const int stage_f = stage_floats(hd, kc);
  float* base = smem + (threadIdx.x >> 5) * fwd_warp_floats(hd, H, kc);
  uint64_t* bars = reinterpret_cast<uint64_t*>(base);
  float* stages = base + 4;
  float* sc = stages + kStages * stage_f;  // scores of the chunk
  float* sp = sc + round4(kc * H);         // their probabilities
  float* acc = sp + round4(kc * H);        // running P.V row
  float* mh = acc + round4(hd);            // running max per head
  float* lh = mh + H;                      // running sum per head
  float* al = lh + H;                      // this chunk's rescale per head
  float* mn = al + H;                      // this chunk's new max per head
  int* mk = reinterpret_cast<int*>(mh + round4(4 * H));
  const bool pairs2 = (dh & 1) == 0;       // P.V by float2 columns
  // the softmax by shuffles when a chunk's K*H scores fit the warp's lanes
  // and the heads divide it (H a power of two)
  const bool fast = kc * H <= 32 && (H & (H - 1)) == 0;
  if (lane == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) mbar_init(smem_u32(&bars[s]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncwarp();

  // items: the ring holds this one and the kStages - 1 after it
  Item it{w0, 0, min(kc, a.kn)};
  Item ahead = it;
  for (int s = 0; s < kStages - 1; ++s) {
    if (ahead.tgt >= a.n) break;
    issue(a, ahead, stages + s * stage_f, smem_u32(&bars[s]), lane);
    ahead = next_item(a, ahead, nw);
  }
  int m_cur = mask_of(a, it, lane);
  for (int t = 0; it.tgt < a.n; ++t) {
    if (ahead.tgt < a.n) {
      const int s = (t + kStages - 1) % kStages;
      issue(a, ahead, stages + s * stage_f, smem_u32(&bars[s]), lane);
    }
    const Item nx = next_item(a, it, nw);
    // the next item's mask, in flight during this item's compute
    const int m_next = nx.tgt < a.n ? mask_of(a, nx, lane) : 0;
    mk[lane] = m_cur;
    const float* st = stages + (t % kStages) * stage_f;
    const float* sq = st;
    const float* sk = st + round4(hd);
    const float* sv = sk + round4(kc * hd);
    mbar_wait(smem_u32(&bars[t % kStages]), (t / kStages) & 1);
    __syncwarp();
    const bool first = it.j0 == 0, last = it.j0 + it.kcur == a.kn;
    const int np = it.kcur * H;

    // scores: lane p takes (j, h) = (p / H, p % H), row p of the k chunk
    for (int p = lane; p < np; p += 32) {
      const int j = p / H, h = p - j * H;
      sc[p] = mk[j] ? dot_row(sq + h * dh, sk + p * dh, dh) * a.scale
                    : -CUDART_INF_F;
    }
    __syncwarp();
    // masked softmax, online across chunks
    if (fast) {
      // lane p holds score p; lanes p, p ^ H, ... share head p % H
      float s = lane < np ? sc[lane] : -CUDART_INF_F;
      float mx = s;
      for (int o = 16; o >= H; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(FULL_MASK, mx, o));
      const int h = lane & (H - 1);
      const float m_old = first ? -CUDART_INF_F : mh[h];
      mx = fmaxf(mx, m_old);
      const float e = s == -CUDART_INF_F ? 0.f : expf(s - mx);
      float sum = e;
      for (int o = 16; o >= H; o >>= 1)
        sum += __shfl_xor_sync(FULL_MASK, sum, o);
      if (lane < np) sp[lane] = e;
      __syncwarp();
      if (lane < H) {
        const float alpha =
            first || mx == -CUDART_INF_F ? 0.f : expf(m_old - mx);
        const float l = (first ? 0.f : lh[h] * alpha) + sum;
        mh[h] = mx;
        al[h] = alpha;
        lh[h] = last ? 1.f / fmaxf(l, 1e-30f) : l;   // the last: 1 / sum
      }
    } else {
      // every lane finds its head's max over the chunk's broadcast
      // scores and takes its own exp ...
      for (int p = lane; p < np; p += 32) {
        const int j = p / H, h = p - j * H;
        float mx = first ? -CUDART_INF_F : mh[h];
#pragma unroll 4
        for (int i = 0; i < it.kcur; ++i) mx = fmaxf(mx, sc[i * H + h]);
        const float s = sc[p];
        sp[p] = s == -CUDART_INF_F ? 0.f : expf(s - mx);
        if (j == 0) mn[h] = mx;
      }
      __syncwarp();
      // ... then a lane per head sums them and moves the running state
      for (int h = lane; h < H; h += 32) {
        float sum = 0.f;
#pragma unroll 4
        for (int i = 0; i < it.kcur; ++i) sum += sp[i * H + h];
        const float mx = mn[h];
        const float alpha =
            first || mx == -CUDART_INF_F ? 0.f : expf(mh[h] - mx);
        const float l = (first ? 0.f : lh[h] * alpha) + sum;
        mh[h] = mx;
        al[h] = alpha;
        lh[h] = last ? 1.f / fmaxf(l, 1e-30f) : l;   // the last: 1 / sum
      }
    }
    __syncwarp();
    // P.V: lanes over the H*Dh output columns (pairs of them for an even
    // Dh, which never straddle a head)
    const int64_t orow = (int64_t)it.tgt * hd;
    if (pairs2) {
      for (int c = 2 * lane; c < hd; c += 64) {
        const int h = c / dh;
        float2 o = make_float2(0.f, 0.f);
        if (!first) {
          o = *reinterpret_cast<const float2*>(acc + c);
          o.x *= al[h];
          o.y *= al[h];
        }
#pragma unroll 4
        for (int j = 0; j < it.kcur; ++j) {
          const float pj = sp[j * H + h];
          const float2 vv = *reinterpret_cast<const float2*>(sv + j * hd + c);
          o.x = fmaf(pj, vv.x, o.x);
          o.y = fmaf(pj, vv.y, o.y);
        }
        if (last) {
          o.x *= lh[h];
          o.y *= lh[h];
          *reinterpret_cast<float2*>(a.out + orow + c) = o;
        } else {
          *reinterpret_cast<float2*>(acc + c) = o;
        }
      }
    } else {
      for (int c = lane; c < hd; c += 32) {
        const int h = c / dh;
        float o = first ? 0.f : acc[c] * al[h];
#pragma unroll 4
        for (int j = 0; j < it.kcur; ++j)
          o = fmaf(sp[j * H + h], sv[j * hd + c], o);
        if (last)
          a.out[orow + c] = o * lh[h];
        else
          acc[c] = o;
      }
    }
    __syncwarp();                          // the stage and mk are free
    m_cur = m_next;
    it = nx;
    if (ahead.tgt < a.n) ahead = next_item(a, ahead, nw);
  }
}

// --- backward ------------------------------------------------------------
__global__ void temporal_attn_bwd_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const bool* __restrict__ mask,
    const float* __restrict__ dout, int n, int heads, int kn, int dh,
    float scale, float* __restrict__ dq, float* __restrict__ dk,
    float* __restrict__ dv) {
  const int lane = threadIdx.x & 31;
  const int w = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (w >= n * heads) return;
  const int t = w / heads, h = w % heads;
  const int per_lane = (dh + 31) >> 5;
  float qr[kMaxPerLane], gr[kMaxPerLane];
#pragma unroll
  for (int e = 0; e < kMaxPerLane; ++e) {
    const int d = lane + 32 * e;
    const bool in = e < per_lane && d < dh;
    qr[e] = in ? q[(int64_t)w * dh + d] : 0.f;
    gr[e] = in ? dout[(int64_t)w * dh + d] : 0.f;
  }
  const int64_t row0 = ((int64_t)t * kn * heads + h) * dh;
  const int64_t row_step = (int64_t)heads * dh;
  // pass 1: lane j keeps score j and da_j = <dout, v_j>
  float my_s = kMasked, my_da = 0.f;
  bool my_m = false;
  for (int j = 0; j < kn; ++j) {
    const float* kr = k + row0 + j * row_step;
    const float* vr = v + row0 + j * row_step;
    float ps = 0.f, pd = 0.f;
#pragma unroll
    for (int e = 0; e < kMaxPerLane; ++e) {
      const int d = lane + 32 * e;
      if (e < per_lane && d < dh) {
        ps += qr[e] * kr[d];
        pd += gr[e] * vr[d];
      }
    }
    const float s = warp_sum(ps) * scale;
    const float da = warp_sum(pd);
    const bool m = mask[(int64_t)t * kn + j];
    if (lane == j) {
      my_s = m ? s : kMasked;
      my_m = m;
      my_da = da;
    }
  }
  const float mx = warp_max(lane < kn ? my_s : -CUDART_INF_F);
  const float p = (lane < kn && my_m) ? expf(my_s - mx) : 0.f;
  const float a = p / fmaxf(warp_sum(p), 1e-30f);
  const float dsum = warp_sum(a * my_da);
  const float ds = a * (my_da - dsum);
  // pass 2: dv_j and dk_j row by row, dq accumulated in registers
  float acc[kMaxPerLane] = {0.f, 0.f, 0.f, 0.f};
  for (int j = 0; j < kn; ++j) {
    const float aj = __shfl_sync(FULL_MASK, a, j);
    const float dsj = __shfl_sync(FULL_MASK, ds, j);
    const float* kr = k + row0 + j * row_step;
    float* dkr = dk + row0 + j * row_step;
    float* dvr = dv + row0 + j * row_step;
#pragma unroll
    for (int e = 0; e < kMaxPerLane; ++e) {
      const int d = lane + 32 * e;
      if (e < per_lane && d < dh) {
        acc[e] += dsj * kr[d];
        dkr[d] = scale * dsj * qr[e];
        dvr[d] = aj * gr[e];
      }
    }
  }
#pragma unroll
  for (int e = 0; e < kMaxPerLane; ++e) {
    const int d = lane + 32 * e;
    if (e < per_lane && d < dh) dq[(int64_t)w * dh + d] = scale * acc[e];
  }
}

// Backward for K > 32 or Dh > 128: q, dout, the mask, the K scores and a
// dq row of a warp's (target, head) in its shared memory, Dh in steps of
// 32 lanes, the k and v rows of kBwdGroup neighbours in flight at a time
// in both passes (a walk row by row waits for each row in turn).
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
    temporal_attn_bwd_wide_kernel(
        const float* __restrict__ q, const float* __restrict__ k,
        const float* __restrict__ v, const bool* __restrict__ mask,
        const float* __restrict__ dout, int n, int heads, int kn, int dh,
        float scale, float* __restrict__ dq, float* __restrict__ dk,
        float* __restrict__ dv) {
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x & 31;
  const int wpc = blockDim.x >> 5;
  const int w = blockIdx.x * wpc + (threadIdx.x >> 5);
  if (w >= n * heads) return;
  float* sa = smem + (threadIdx.x >> 5) * (3 * kn + 3 * dh);
  float* sda = sa + kn;                   // da_j
  float* sds = sda + kn;                  // ds_j
  float* sq = sds + kn;                   // q row
  float* sg = sq + dh;                    // dout row
  float* sdq = sg + dh;                   // dq row, summed over the groups
  const int t = w / heads, h = w % heads;
  for (int d = lane; d < dh; d += 32) {
    sq[d] = q[(int64_t)w * dh + d];
    sg[d] = dout[(int64_t)w * dh + d];
  }
  for (int j = lane; j < kn; j += 32)     // the mask, until pass 1
    sa[j] = mask[(int64_t)t * kn + j] ? 1.f : 0.f;
  __syncwarp();
  const int64_t row0 = ((int64_t)t * kn * heads + h) * dh;
  const int64_t row_step = (int64_t)heads * dh;
  // pass 1: s_j (masked: -inf) and da_j
  for (int j0 = 0; j0 < kn; j0 += kBwdGroup) {
    float ps[kBwdGroup], pd[kBwdGroup];
#pragma unroll
    for (int b = 0; b < kBwdGroup; ++b) ps[b] = pd[b] = 0.f;
    for (int d = lane; d < dh; d += 32) {
      const float qd = sq[d], gd = sg[d];
      float kr[kBwdGroup], vr[kBwdGroup];
#pragma unroll
      for (int b = 0; b < kBwdGroup; ++b) {
        const int64_t o = row0 + (j0 + b) * row_step + d;
        kr[b] = j0 + b < kn ? k[o] : 0.f;
        vr[b] = j0 + b < kn ? v[o] : 0.f;
      }
#pragma unroll
      for (int b = 0; b < kBwdGroup; ++b) {
        ps[b] = fmaf(qd, kr[b], ps[b]);
        pd[b] = fmaf(gd, vr[b], pd[b]);
      }
    }
#pragma unroll
    for (int b = 0; b < kBwdGroup; ++b) {
      if (j0 + b >= kn) break;            // warp-uniform
      const float s = warp_sum(ps[b]) * scale;
      const float da = warp_sum(pd[b]);
      if (lane == 0) {
        sa[j0 + b] = sa[j0 + b] != 0.f ? s : -CUDART_INF_F;
        sda[j0 + b] = da;
      }
    }
  }
  __syncwarp();
  float mx = -CUDART_INF_F;
  for (int j = lane; j < kn; j += 32) mx = fmaxf(mx, sa[j]);
  mx = warp_max(mx);
  float sum = 0.f;
  for (int j = lane; j < kn; j += 32) {
    const float p = sa[j] == -CUDART_INF_F ? 0.f : expf(sa[j] - mx);
    sa[j] = p;
    sum += p;
  }
  const float inv = 1.f / fmaxf(warp_sum(sum), 1e-30f);
  float dsum = 0.f;
  for (int j = lane; j < kn; j += 32) {
    const float a = sa[j] * inv;
    sa[j] = a;
    dsum = fmaf(a, sda[j], dsum);
  }
  dsum = warp_sum(dsum);
  for (int j = lane; j < kn; j += 32) sds[j] = sa[j] * (sda[j] - dsum);
  __syncwarp();
  // pass 2: a group of rows at a time, its k loads in flight together and
  // each row's dk and dv written across Dh before the next group, so that
  // the 32-byte sectors a row shares between its column chunks are
  // written close together in time (with the column chunks outermost
  // they came apart, and the stores took most of the kernel's time); dq
  // sums in the warp's shared memory, each lane over its own columns
  for (int d = lane; d < dh; d += 32) sdq[d] = 0.f;
  for (int j0 = 0; j0 < kn; j0 += kBwdGroup) {
    for (int d = lane; d < dh; d += 32) {
      const float qd = sq[d], gd = sg[d];
      float kr[kBwdGroup];
#pragma unroll
      for (int b = 0; b < kBwdGroup; ++b)
        kr[b] = j0 + b < kn ? k[row0 + (j0 + b) * row_step + d] : 0.f;
      float acc = 0.f;
#pragma unroll
      for (int b = 0; b < kBwdGroup; ++b) {
        if (j0 + b >= kn) break;
        const int64_t o = row0 + (j0 + b) * row_step + d;
        const float dsj = sds[j0 + b];
        acc = fmaf(dsj, kr[b], acc);
        dk[o] = scale * dsj * qd;
        dv[o] = sa[j0 + b] * gd;
      }
      sdq[d] += acc;
    }
  }
  for (int d = lane; d < dh; d += 32)
    dq[(int64_t)w * dh + d] = scale * sdq[d];
}

// Up to kWarpsPerBlock warps a CTA, each with warp_bytes of shared memory,
// the kernel's opt-in raised to their total; wpc = 0 when one warp's
// share does not fit a block.
cudaError_t warps_fitting(const void* kernel, int warp_bytes, int& set,
                          int& wpc) {
  wpc = min(kWarpsPerBlock, smem_block_limit() / warp_bytes);
  if (wpc < 1) return cudaErrorInvalidValue;
  return allow_smem(kernel, wpc * warp_bytes, set);
}

}  // namespace

// q (N, H, Dh), k and v (N, K, H, Dh), mask (N, K) -> out (N, H, Dh), all
// contiguous float32 / bool.  Any K and Dh whose warp ring fits a block
// (H*Dh in the thousands of floats; cudaErrorInvalidValue past that).
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int temporal_attn_launch(const float* q, const float* k,
                                    const float* v, const bool* mask, int n,
                                    int heads, int kn, int dh, float scale,
                                    float* out, void* stream) {
  const int hd = heads * dh;
  FwdArgs a{q, k, v, mask, out, n, heads, kn, dh, 0, 0, scale};
  a.kc = min(min(kn, 32),
             max(1, (kStageFloats - round4(hd)) / (2 * hd)));
  const auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  a.bulk = hd % 4 == 0 && aligned(q) && aligned(k) && aligned(v);
  static int smem_set = 0;
  int wpc = 0;
  const int warp_bytes = 4 * fwd_warp_floats(hd, heads, a.kc);
  const void* fn = reinterpret_cast<const void*>(temporal_attn_kernel);
  cudaError_t err = warps_fitting(fn, warp_bytes, smem_set, wpc);
  if (err != cudaSuccess) return static_cast<int>(err);
  // one wave of CTAs, as many as fit the card at this shared memory
  static int wave_bytes = -1, wave = 0;
  if (wave_bytes != wpc * warp_bytes) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    // all of the SM's unified memory as shared memory, so that as many
    // rings as it holds run at once
    err = cudaFuncSetAttribute(
        fn, cudaFuncAttributePreferredSharedMemoryCarveout,
        cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, temporal_attn_kernel, 32 * wpc, wpc * warp_bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    wave = sms * max(per_sm, 1);
    wave_bytes = wpc * warp_bytes;
  }
  const int grid = min((n + wpc - 1) / wpc, wave);
  temporal_attn_kernel<<<grid, 32 * wpc, wpc * warp_bytes,
                         static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// Backward of temporal_attn_launch: q (N, H, Dh), k and v (N, K, H, Dh),
// mask (N, K) and dout (N, H, Dh) -> dq (N, H, Dh), dk and dv (N, K, H, Dh),
// all contiguous float32 / bool.  K <= 32 with Dh <= 128 takes the
// register instance; any other K and Dh the shared-memory one, if a
// warp's 3K + 3Dh floats fit a block (cudaErrorInvalidValue otherwise).
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int temporal_attn_bwd_launch(const float* q, const float* k,
                                        const float* v, const bool* mask,
                                        const float* dout, int n, int heads,
                                        int kn, int dh, float scale,
                                        float* dq, float* dk, float* dv,
                                        void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kn <= 32 && dh <= 32 * kMaxPerLane) {
    const dim3 block(32 * kWarpsPerBlock);
    const dim3 grid((n * heads + kWarpsPerBlock - 1) / kWarpsPerBlock);
    temporal_attn_bwd_kernel<<<grid, block, 0, st>>>(
        q, k, v, mask, dout, n, heads, kn, dh, scale, dq, dk, dv);
    return static_cast<int>(cudaGetLastError());
  }
  static int smem_set = 0;
  int wpc = 0;
  const int warp_bytes = 4 * (3 * kn + 3 * dh);
  const cudaError_t err = warps_fitting(
      reinterpret_cast<const void*>(temporal_attn_bwd_wide_kernel),
      warp_bytes, smem_set, wpc);
  if (err != cudaSuccess) return static_cast<int>(err);
  temporal_attn_bwd_wide_kernel<<<(n * heads + wpc - 1) / wpc, 32 * wpc,
                                  wpc * warp_bytes, st>>>(
      q, k, v, mask, dout, n, heads, kn, dh, scale, dq, dk, dv);
  return static_cast<int>(cudaGetLastError());
}
