// Mamba-1 selective scan: the backward, float32.
//
// The backward of csrc/selective_scan.cu, which replaces the Pallas TPU
// kernel src/repro/kernels/selective_scan/selective_scan.py::
// selective_scan_kernel.  The JAX package has no backward Pallas kernel:
// its LM trains through jax.grad of the chunked lax.scan in
// models/mamba.py::_mamba1_scan_y.  This kernel computes that gradient
// (held on the card against the autograd of the port's plain loop,
// kernels/selective_scan/ref.py).  For each batch row b, channel d and
// state n, with a_t = exp(dt_t A[d, n]) and u_t = dt_t x_t,
//   h_t = a_t h_{t-1} + u_t B_t[n],   y_t = sum_n h_t[n] C_t[n],
// and G_t = dL/dh_t, swept from t = L - 1 down to 0 from G = dh_last:
//   G_t     += dy_t C_t[n]
//   dC_t[n] += dy_t h_t[n]          (summed over the Din channels)
//   dB_t[n] += G_t[n] u_t           (summed over the Din channels)
//   dx_t     = dt_t sum_n G_t[n] B_t[n]
//   ddt_t    = x_t sum_n G_t[n] B_t[n] + sum_n G_t[n] h_{t-1}[n] a_t A[n]
//   dA[d, n] += G_t[n] h_{t-1}[n] a_t dt_t   (summed over b and t)
//   G_{t-1}  = a_t G_t,  and dh0 = G_{-1}.
//
// What bounds it on the H100: the bytes, about 1.3 GB of (B, L, Din)
// float32 reads (dt, x, dy) and writes (dx, ddt) at Falcon-Mamba-7B's
// train shape (B 2, L 4096, Din 8192, N 16), 0.40 ms.  The states must be
// recomputed (below), so each state and step takes two exps, 2.1e9, 0.51
// ms on the special-function units: the floor of this design.  Past that
// it is bound by instruction issue and the shared-memory and shuffle
// pipe: about 26 instructions a state and step (two recomputations, the
// sweep, the sums over channels), 0.9 ms of the card's issue slots.
//
// Design.  The sweep needs h_{t-1} in reverse order.  Storing every state
// would take (B, L, Din, N) float32, 4.3 GB a layer at Falcon's train
// shape, and inverting the recurrence (dividing by a_t) is unstable, so
// the forward stores the state before every chunk of 64 steps (67 MB a
// layer) and this kernel recomputes each chunk's states from it:
//   - a thread owns 2 neighbouring channels and 4 states of each, 4
//     lanes a channel pair's 16 states (N > 16 in groups of 16, one sweep
//     each), a CTA of 128 threads 64 channels of one batch row.  So one
//     8-byte read brings a step's dt (or x, dy) of both channels and one
//     16-byte read its 4 states' B_t (or C_t), and each step's dB and dC
//     terms are first summed over the thread's two channels in registers.
//     At 96 KB of shared memory two CTAs share an SM, and at Falcon's
//     shape the 256 CTAs run in one wave;
//   - chunks are taken last first.  A chunk's dt, x, B_t (one cp.async
//     group) and dy, C_t (a second) come to shared memory; a first pass
//     from its stored state, which needs only the first group, keeps the
//     state before every 8 steps in shared memory while the second group
//     lands; then for each 8-step group, last first, the 8 states and
//     their exp(dt A) are recomputed into registers and the group is
//     swept backward with them: two exps a state and step.  A full group
//     is unrolled with no branch between its steps;
//   - exp(dt A) is ex2.approx(dt A log2 e), the forward's own
//     expression, so the recomputed states equal the forward's bit for
//     bit;
//   - the sums run after each group's sweep, for its 8 steps at once, so
//     their shuffles overlap: du and dta (for dx and ddt) over a channel
//     pair's 4 lanes by a reduce-scatter that leaves each lane two
//     steps to write; each step's dB and dC terms over a warp's 8
//     channel pairs by a reduce-scatter that leaves the lanes of pair p
//     step p's sums, then over the CTA's 4 warps in order through shared
//     memory, into a per-CTA partial (B, Din / 64, L, N) in device
//     memory; dA's per-thread sums go to a per-batch-row partial (B, Din,
//     N).  A second launch sums the partials in order, so two calls give
//     the same bits.
#include "common.cuh"

#include <type_traits>

namespace {

constexpr int kCh = 2;                         // channels a thread
constexpr int kPer = 4;                        // states a thread
constexpr int kPairs = kCh * kPer;             // (channel, state) pairs
constexpr int kGroup = 16;                     // states a sweep
constexpr int kLanes = kGroup / kPer;          // lanes a channel pair
constexpr int kChannels = 64;                  // channels a CTA
constexpr int kThreads = kChannels / kCh * kLanes;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 64;             // steps per stored state (forward)
constexpr int kSub = 8;                // steps recomputed into registers
constexpr int kSubs = kChunk / kSub;
constexpr float kLog2e = 1.4426950408889634f;
static_assert(kPer == 4 && kCh == 2 && 32 / kLanes == kSub,
              "the sums' lane rounds assume 4 states and 2 channels a "
              "thread, and a warp's 8 channel pairs one step each");

struct Smem {
  float dt[kChunk][kChannels];
  float x[kChunk][kChannels];
  float dy[kChunk][kChannels];
  float b[kChunk][kGroup];
  float c[kChunk][kGroup];
  float sub[kSubs][kPairs][kThreads];  // the state before each 8 steps
  // a group's dB (0 .. 15) and dC (16 .. 31) sums over each warp's
  // channels, by (step, warp); two buffers, so one barrier a group
  float red[2][kSub][kWarps][2 * kGroup];
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Rounds of a reduce-scatter of a lane's M values: in each, over the
// lanes that differ in lane bit kMask, the lane keeps half of its values
// (the upper half where its bit is set) and adds the partner's copy of
// that half.  After rounds over lane bits m1 > m2 > ... the lane holds,
// in v[0 .. M / 2^r), the sums of the block of its values at offset
// sum_j (bit m_j of the lane) M / 2^j.
template <int kHalf, int kMask, int M>
__device__ __forceinline__ void halve(float (&v)[M], int lane) {
  const bool hi = lane & kMask;
#pragma unroll
  for (int i = 0; i < kHalf; ++i) {
    const float keep = hi ? v[i + kHalf] : v[i];
    const float send = hi ? v[i] : v[i + kHalf];
    v[i] = keep + __shfl_xor_sync(FULL_MASK, send, kMask);
  }
}

// cp.async of `bytes` (4 or 16) from src to shared dst.
template <int bytes>
__device__ __forceinline__ void cp_async(void* dst, const float* src,
                                         bool ok) {
  const uint32_t d = smem_u32(dst);
  if constexpr (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(d),
                 "l"(src), "r"(ok ? 16 : 0) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(d),
                 "l"(src), "r"(ok ? 4 : 0) : "memory");
}

// Copy steps [t0, t0 + tn) of the (B, L, W) rows at src, columns c0 ..
// c0 + n (zero from W on), into dst[t][0 .. n); vec: 16-byte copies (W %
// 4 == 0, c0 % 4 == 0, src 16-byte aligned).
template <int n>
__device__ __forceinline__ void stage_rows(float (*dst)[n],
                                           const float* __restrict__ src,
                                           int64_t row0, int tn, int W,
                                           int c0, bool vec) {
  if (vec) {
    for (int i = threadIdx.x; i < tn * (n / 4); i += kThreads) {
      const int t = i / (n / 4), c = 4 * (i % (n / 4));
      const bool ok = c0 + c < W;
      const float* g = src + (row0 + t) * W + c0 + c;
      cp_async<16>(&dst[t][c], ok ? g : src, ok);
    }
  } else {
    for (int i = threadIdx.x; i < tn * n; i += kThreads) {
      const int t = i / n, c = i % n;
      const bool ok = c0 + c < W;
      const float* g = src + (row0 + t) * W + c0 + c;
      cp_async<4>(&dst[t][c], ok ? g : src, ok);
    }
  }
}

// kMulti: N > 16, more than one group of states, each adding its part of
// dx and ddt to what the groups before it wrote
template <bool kMulti>
__global__ void __launch_bounds__(kThreads, 2)
    selective_scan_bwd_kernel(const float* __restrict__ dt,
                              const float* __restrict__ x,
                              const float* __restrict__ A,
                              const float* __restrict__ Bt,
                              const float* __restrict__ Ct,
                              const float* __restrict__ ckpt,
                              const float* __restrict__ dy,
                              const float* __restrict__ dh_last, int L,
                              int Din, int N, float* __restrict__ ddt,
                              float* __restrict__ dx,
                              float* __restrict__ dh0,
                              float* __restrict__ part_bc,
                              float* __restrict__ part_a, int vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q = tid % kLanes;            // the thread's state quad
  const int c0 = tid / kLanes * kCh;     // its first channel in the CTA
  const int n0 = q * kPer;               // its first state in the group
  const int b = blockIdx.y, blk = blockIdx.x, n_blk = gridDim.x;
  const int B = gridDim.y;
  const int d0 = blk * kChannels;
  const int n_chunks = (L + kChunk - 1) / kChunk;
  // this CTA's partials of dB (kind 0) and dC (kind 1): (L, N) each
  float* part_b = part_bc + (((int64_t)0 * B + b) * n_blk + blk) * L * N;
  float* part_c = part_bc + (((int64_t)1 * B + b) * n_blk + blk) * L * N;

  for (int n_base = 0; n_base < N; n_base += kGroup) {
    // pair j: channel d0 + c0 + j / kPer, state n_base + n0 + j % kPer
    float an[kPairs], a2[kPairs], g[kPairs], da[kPairs];
#pragma unroll
    for (int j = 0; j < kPairs; ++j) {
      const int d = d0 + c0 + j / kPer, n = n_base + n0 + j % kPer;
      const bool ok = d < Din && n < N;
      an[j] = ok ? A[(int64_t)d * N + n] : 0.f;
      a2[j] = an[j] * kLog2e;
      g[j] = ok ? dh_last[((int64_t)b * Din + d) * N + n] : 0.f;
      da[j] = 0.f;
    }

    for (int c = n_chunks - 1; c >= 0; --c) {
      const int t0 = c * kChunk, tn = min(kChunk, L - t0);
      const int64_t row0 = (int64_t)b * L + t0;
      __syncthreads();   // the chunk before is done with the buffers
      stage_rows<kChannels>(sm.dt, dt, row0, tn, Din, d0, vec);
      stage_rows<kChannels>(sm.x, x, row0, tn, Din, d0, vec);
      stage_rows<kGroup>(sm.b, Bt, row0, tn, N, n_base, vec);
      asm volatile("cp.async.commit_group;" ::: "memory");
      stage_rows<kChannels>(sm.dy, dy, row0, tn, Din, d0, vec);
      stage_rows<kGroup>(sm.c, Ct, row0, tn, N, n_base, vec);
      asm volatile("cp.async.commit_group;" ::: "memory");
      float h[kPairs];
#pragma unroll
      for (int j = 0; j < kPairs; ++j) {
        const int d = d0 + c0 + j / kPer, n = n_base + n0 + j % kPer;
        h[j] = d < Din && n < N
            ? ckpt[(((int64_t)b * n_chunks + c) * Din + d) * N + n] : 0.f;
      }
      asm volatile("cp.async.wait_group 1;" ::: "memory");   // dt, x, B
      __syncthreads();

      // a step's inputs from shared memory: dt and x of the thread's two
      // channels (one 8-byte read each), its four states' B_t (one
      // 16-byte read)
      auto pair2 = [&](const float (*m)[kChannels], int t) {
        return *reinterpret_cast<const float2*>(&m[t][c0]);
      };
      auto quad = [&](const float (*m)[kGroup], int t) {
        return *reinterpret_cast<const float4*>(&m[t][n0]);
      };
      // h_t from h_{t-1} for the thread's pairs, with each a_t into e
      auto advance = [&](int t, const float (&prev)[kPairs],
                         float (&next)[kPairs], float (&e)[kPairs]) {
        const float2 dtt = pair2(sm.dt, t), xt = pair2(sm.x, t);
        const float4 bv = quad(sm.b, t);
        const float dts[kCh] = {dtt.x, dtt.y};
        const float us[kCh] = {dtt.x * xt.x, dtt.y * xt.y};
        const float bb[kPer] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
        for (int j = 0; j < kPairs; ++j) {
          e[j] = ex2(dts[j / kPer] * a2[j]);
          next[j] = fmaf(e[j], prev[j], us[j / kPer] * bb[j % kPer]);
        }
      };

      // pass 1: the state before every kSub steps of the chunk (each
      // thread reads back only its own slots); full groups unrolled
      for (int s0 = 0; s0 < tn; s0 += kSub) {
#pragma unroll
        for (int j = 0; j < kPairs; ++j) sm.sub[s0 / kSub][j][tid] = h[j];
        float e[kPairs];
        if (s0 + kSub <= tn) {
#pragma unroll
          for (int k = 0; k < kSub; ++k) advance(s0 + k, h, h, e);
        } else {
          for (int t = s0; t < tn; ++t) advance(t, h, h, e);
        }
      }
      asm volatile("cp.async.wait_group 0;" ::: "memory");   // dy, C
      __syncthreads();

      // pass 2: the kSub-step group of steps [s0, s0 + sn), its states
      // and exp(dt A) recomputed forward into registers, then swept
      // backward; a full group (kFull, all but a ragged last one) has no
      // branch between its steps.  The sweep keeps each step's dB and dC
      // terms (summed over the thread's two channels) and its dx and ddt
      // sums; the sums over lanes come after it, for all 8 steps at once.
      auto group = [&](auto full, int s) {
        constexpr bool kFull = decltype(full)::value;
        const int s0 = s * kSub, sn = kFull ? kSub : min(kSub, tn - s0);
        float hist[kSub + 1][kPairs], ea[kSub][kPairs];
#pragma unroll
        for (int j = 0; j < kPairs; ++j) hist[0][j] = sm.sub[s][j][tid];
#pragma unroll
        for (int k = 0; k < kSub; ++k) {
          if (!kFull && k >= sn) break;
          advance(s0 + k, hist[k], hist[k + 1], ea[k]);
        }
        // v: step k's dB terms (state i at k * 8 + i) and dC terms (at
        // k * 8 + 4 + i); w: its du and dta by channel (k * 4 + cc and
        // k * 4 + 2 + cc)
        float v[kSub * 2 * kPer], w[kSub * 2 * kCh];
#pragma unroll
        for (int k = kSub - 1; k >= 0; --k) {
          if (!kFull && k >= sn) {
#pragma unroll
            for (int i = 0; i < 2 * kPer; ++i) v[k * 2 * kPer + i] = 0.f;
#pragma unroll
            for (int i = 0; i < 2 * kCh; ++i) w[k * 2 * kCh + i] = 0.f;
            continue;
          }
          const int t = s0 + k;
          const float2 dtt = pair2(sm.dt, t), xt = pair2(sm.x, t);
          const float2 dyt = pair2(sm.dy, t);
          const float4 bv = quad(sm.b, t), cv = quad(sm.c, t);
          const float dts[kCh] = {dtt.x, dtt.y};
          const float dys[kCh] = {dyt.x, dyt.y};
          const float us[kCh] = {dtt.x * xt.x, dtt.y * xt.y};
          const float bb[kPer] = {bv.x, bv.y, bv.z, bv.w};
          const float cc[kPer] = {cv.x, cv.y, cv.z, cv.w};
          float* vk = v + k * 2 * kPer;
          float* wk = w + k * 2 * kCh;
#pragma unroll
          for (int j = 0; j < kPairs; ++j) {
            const int ch = j / kPer, i = j % kPer;
            g[j] = fmaf(dys[ch], cc[i], g[j]);
            const float tb = g[j] * us[ch];
            const float tc = dys[ch] * hist[k + 1][j];
            const float tu = g[j] * bb[i];
            vk[i] = ch == 0 ? tb : vk[i] + tb;
            vk[kPer + i] = ch == 0 ? tc : vk[kPer + i] + tc;
            wk[ch] = i == 0 ? tu : wk[ch] + tu;
            g[j] *= ea[k][j];                   // G_{t-1} = a_t G_t
            const float gd = g[j] * hist[k][j];  // dL/da_t * a_t
            const float ta = gd * an[j];
            wk[kCh + ch] = i == 0 ? ta : wk[kCh + ch] + ta;
            da[j] = fmaf(gd, dts[ch], da[j]);
          }
        }
        // dx, ddt: du and dta over the channel pair's 4 lanes (lane bits
        // 1, 0); lane q then holds steps 2q and 2q + 1
        halve<16, 2>(w, lane);
        halve<8, 1>(w, lane);
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          const int k = 2 * q + kk;
          if (!kFull && k >= sn) continue;
          const int t = s0 + k;
          const float2 dtt = pair2(sm.dt, t), xt = pair2(sm.x, t);
          const float dts[kCh] = {dtt.x, dtt.y}, xs[kCh] = {xt.x, xt.y};
#pragma unroll
          for (int ch = 0; ch < kCh; ++ch) {
            const int d = d0 + c0 + ch;
            if (d >= Din) continue;
            const float du = w[kk * 2 * kCh + ch];
            const float dta = w[kk * 2 * kCh + kCh + ch];
            const int64_t at = ((int64_t)b * L + t0 + t) * Din + d;
            float vx = du * dts[ch], vdt = fmaf(du, xs[ch], dta);
            if (kMulti && n_base > 0) {   // earlier state groups added theirs
              vx += dx[at];
              vdt += ddt[at];
            }
            dx[at] = vx;
            ddt[at] = vdt;
          }
        }
        // dB, dC: over the warp's 8 channel pairs (lane bits 4, 3, 2); the
        // lanes of pair p then hold step p's 8 sums of their 4 states
        halve<32, 16>(v, lane);
        halve<16, 8>(v, lane);
        halve<8, 4>(v, lane);
        float (*red)[kWarps][2 * kGroup] = sm.red[s & 1];
        {
          const int k = lane / kLanes;
          *reinterpret_cast<float4*>(&red[k][warp][n0]) =
              make_float4(v[0], v[1], v[2], v[3]);
          *reinterpret_cast<float4*>(&red[k][warp][kGroup + n0]) =
              make_float4(v[4], v[5], v[6], v[7]);
        }
        __syncthreads();
        // the group's sums over the CTA's warps, in order: warp w takes
        // steps w, w + kWarps, ..., lane j kind j / 16 and state j % 16
        const int n = n_base + lane % kGroup;
        for (int k = warp; k < sn && n < N; k += kWarps) {
          float sum = 0.f;
#pragma unroll
          for (int w2 = 0; w2 < kWarps; ++w2) sum += red[k][w2][lane];
          (lane < kGroup ? part_b : part_c)[(int64_t)(t0 + s0 + k) * N + n] =
              sum;
        }
      };
      for (int s = (tn - 1) / kSub; s >= 0; --s) {
        if (s * kSub + kSub <= tn) group(std::true_type{}, s);
        else group(std::false_type{}, s);
      }
    }

#pragma unroll
    for (int j = 0; j < kPairs; ++j) {
      const int d = d0 + c0 + j / kPer, n = n_base + n0 + j % kPer;
      if (d < Din && n < N) {
        const int64_t at = ((int64_t)b * Din + d) * N + n;
        dh0[at] = g[j];
        part_a[at] = da[j];
      }
    }
  }
}

// dB, dC (B, L, N) as the sums of the per-CTA partials over the channel
// blocks, and dA (Din, N) as the sum of the per-row partials over B, each
// in a fixed order.
__global__ void __launch_bounds__(256)
    selective_scan_bwd_sum_kernel(const float* __restrict__ part_bc,
                                  const float* __restrict__ part_a, int B,
                                  int L, int Din, int N, int n_blk,
                                  float* __restrict__ dB,
                                  float* __restrict__ dC,
                                  float* __restrict__ dA) {
  const int64_t LN = (int64_t)L * N;
  const int64_t n_bc = 2 * B * LN, n_a = (int64_t)Din * N;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       i < n_bc + n_a; i += (int64_t)gridDim.x * blockDim.x) {
    if (i < n_bc) {
      const int64_t kind_b = i / LN, tn = i % LN;   // kind * B + b
      const float* p = part_bc + kind_b * n_blk * LN + tn;
      float sum = 0.f;
      for (int blk = 0; blk < n_blk; ++blk) sum += p[blk * LN];
      const int64_t b = kind_b % B;
      (kind_b < B ? dB : dC)[b * LN + tn] = sum;
    } else {
      const int64_t j = i - n_bc;
      float sum = 0.f;
      for (int b = 0; b < B; ++b) sum += part_a[b * n_a + j];
      dA[j] = sum;
    }
  }
}

}  // namespace

// Channel blocks of the partials for this Din and N (the wrapper sizes
// part_bc as (2, B, blocks, L, N) float32).
extern "C" int selective_scan_bwd_blocks(int Din, int N) {
  (void)N;
  return (Din + kChannels - 1) / kChannels;
}

// The backward of selective_scan_launch: the forward's inputs dt and x
// (B, L, Din), A (Din, N), Bt and Ct (B, L, N), its stored states ckpt
// (B, ceil(L / 64), Din, N; ckpt_every, the chunk they were stored at,
// must be 64), and the gradients of its outputs dy
// (B, L, Din) and dh_last (B, Din, N) -> ddt, dx (B, L, Din), dA (Din, N),
// dB, dC (B, L, N), dh0 (B, Din, N), using part_bc (2, B, blocks, L, N)
// and part_a (B, Din, N) as scratch; all contiguous float32, B, L >= 1.
// Returns the first launch error (0 on success).
extern "C" int selective_scan_bwd_launch(
    const float* dt, const float* x, const float* A, const float* Bt,
    const float* Ct, const float* ckpt, int ckpt_every, const float* dy,
    const float* dh_last, int B, int L, int Din, int N, float* ddt,
    float* dx, float* dA, float* dB, float* dC, float* dh0, float* part_bc,
    float* part_a, void* stream) {
  if (B < 1 || L < 1 || Din < 1 || N < 1 || ckpt_every != kChunk)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uintptr_t addr = reinterpret_cast<uintptr_t>(dt) |
                         reinterpret_cast<uintptr_t>(x) |
                         reinterpret_cast<uintptr_t>(dy) |
                         reinterpret_cast<uintptr_t>(Bt) |
                         reinterpret_cast<uintptr_t>(Ct);
  const int vec = Din % 4 == 0 && N % 4 == 0 && (addr & 15) == 0;
  const size_t smem = sizeof(Smem);
  static int set[2] = {0, 0};
  const bool multi = N > kGroup;
  const void* kernel =
      multi ? reinterpret_cast<const void*>(selective_scan_bwd_kernel<true>)
            : reinterpret_cast<const void*>(selective_scan_bwd_kernel<false>);
  cudaError_t err = allow_smem(kernel, (int)smem, set[multi]);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(selective_scan_bwd_blocks(Din, N), B);
  if (multi)
    selective_scan_bwd_kernel<true><<<grid, kThreads, smem, s>>>(
        dt, x, A, Bt, Ct, ckpt, dy, dh_last, L, Din, N, ddt, dx, dh0,
        part_bc, part_a, vec);
  else
    selective_scan_bwd_kernel<false><<<grid, kThreads, smem, s>>>(
        dt, x, A, Bt, Ct, ckpt, dy, dh_last, L, Din, N, ddt, dx, dh0,
        part_bc, part_a, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t total = 2 * (int64_t)B * L * N + (int64_t)Din * N;
  const int64_t want = (total + 255) / 256;
  const int blocks = (int)(want < 132 * 16 ? want : 132 * 16);
  selective_scan_bwd_sum_kernel<<<blocks, 256, 0, s>>>(
      part_bc, part_a, B, L, Din, N, (int)grid.x, dB, dC, dA);
  return static_cast<int>(cudaGetLastError());
}
