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
// train shape (B 2, L 4096, Din 8192, N 16), 0.40 ms, against 0.26 ms for
// the 1.1e9 exps the gradient needs on the special-function units.  As
// written it takes three exps a state and step (see below), 0.77 ms.
//
// Design.  The sweep needs h_{t-1} in reverse order.  Storing every state
// would take (B, L, Din, N) float32, 4.3 GB a layer at Falcon's train
// shape, and inverting the recurrence (dividing by a_t) is unstable, so
// the forward stores the state before every chunk of 64 steps (67 MB a
// layer) and this kernel recomputes each chunk's states from it:
//   - the thread layout is the forward's: kLanes threads a channel (2 up
//     to N 16, 4 up to 32, 8 beyond), 8 states each, a CTA of 128
//     threads owning 128 / kLanes channels of one batch row; N > 64 in
//     groups of 64 states, one sweep each;
//   - chunks are taken last first.  A chunk's dt, x, dy, B_t and C_t are
//     staged in shared memory; a first pass from its stored state keeps
//     the state before every 8 steps in shared memory; then for each
//     8-step group, last first, the 8 states are recomputed into
//     registers and the group is swept backward.  So each state is
//     computed twice and its exp three times, and no state leaves the SM;
//   - exp(dt A) is ex2.approx(dt A log2 e), the forward's own
//     expression, so the recomputed states equal the forward's bit for
//     bit;
//   - sums over Din in a fixed order, no atomics: each step's dB and dC
//     terms of the CTA's channels go through shared memory and are
//     summed per (step, state) into a per-CTA partial (B, Din / channels,
//     L, N) in device memory; dA's per-thread sums into a per-batch-row
//     partial (B, Din, N).  A second launch sums the partials in order,
//     so two calls give the same bits;
//   - sums over the states (dx, ddt) are shuffles over a channel's lanes,
//     and the channel's first lane writes them.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kPer = 8;                // states per thread
constexpr int kChunk = 64;             // steps per stored state (forward)
constexpr int kSub = 8;                // steps recomputed into registers
constexpr int kSubs = kChunk / kSub;
constexpr float kLog2e = 1.4426950408889634f;

template <int kLanes>
struct Smem {
  static constexpr int kMaxN = kPer * kLanes;
  static constexpr int kChannels = kThreads / kLanes;
  float dt[kChunk][kChannels];
  float x[kChunk][kChannels];
  float dy[kChunk][kChannels];
  float b[kChunk][kMaxN];
  float c[kChunk][kMaxN];
  float sub[kSubs][kPer][kThreads];    // the state before each 8 steps
  // a group's dB (0) and dC (1) terms by (step, state, channel)
  float red[kSub][2][kMaxN][kChannels + 1];
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

template <int kLanes>
__global__ void __launch_bounds__(kThreads, 1)
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
                              float* __restrict__ part_a) {
  using S = Smem<kLanes>;
  constexpr int kChannels = S::kChannels;
  constexpr int kMaxN = S::kMaxN;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  S& sm = *reinterpret_cast<S*>(smem_raw);

  const int tid = threadIdx.x;
  const int ch = tid / kLanes;
  const int n0 = tid % kLanes * kPer;    // the thread's first state
  const int b = blockIdx.y, blk = blockIdx.x, n_blk = gridDim.x;
  const int B = gridDim.y;
  const int d0 = blk * kChannels;
  const int d = d0 + ch;
  const bool live = d < Din;
  const int n_chunks = (L + kChunk - 1) / kChunk;
  // this CTA's partials of dB (kind 0) and dC (kind 1): (L, N) each
  float* part_b = part_bc + (((int64_t)0 * B + b) * n_blk + blk) * L * N;
  float* part_c = part_bc + (((int64_t)1 * B + b) * n_blk + blk) * L * N;

  for (int n_base = 0; n_base < N; n_base += kMaxN) {
    const bool first = n_base == 0;
    float a2[kPer], an[kPer], g[kPer], da[kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int n = n_base + n0 + i;
      const bool ok = live && n < N;
      const int64_t at = ((int64_t)b * Din + d) * N + n;
      an[i] = ok ? A[(int64_t)d * N + n] : 0.f;
      a2[i] = an[i] * kLog2e;
      g[i] = ok ? dh_last[at] : 0.f;
      da[i] = 0.f;
    }

    for (int c = n_chunks - 1; c >= 0; --c) {
      const int t0 = c * kChunk, tn = min(kChunk, L - t0);
      __syncthreads();   // the chunk before is done with the buffers
      for (int i = tid; i < tn * kChannels; i += kThreads) {
        const int t = i / kChannels, cc = i % kChannels;
        const bool ok = d0 + cc < Din;
        const int64_t at = ((int64_t)b * L + t0 + t) * Din + d0 + cc;
        sm.dt[t][cc] = ok ? dt[at] : 0.f;
        sm.x[t][cc] = ok ? x[at] : 0.f;
        sm.dy[t][cc] = ok ? dy[at] : 0.f;
      }
      for (int i = tid; i < tn * kMaxN; i += kThreads) {
        const int t = i / kMaxN, nn = i % kMaxN;
        const bool ok = n_base + nn < N;
        const int64_t at = ((int64_t)b * L + t0 + t) * N + n_base + nn;
        sm.b[t][nn] = ok ? Bt[at] : 0.f;
        sm.c[t][nn] = ok ? Ct[at] : 0.f;
      }
      float h[kPer];
      {
        const float* cp = ckpt + (((int64_t)b * n_chunks + c) * Din + d) * N;
#pragma unroll
        for (int i = 0; i < kPer; ++i) {
          const int n = n_base + n0 + i;
          h[i] = live && n < N ? cp[n] : 0.f;
        }
      }
      __syncthreads();

      // pass 1: the state before every kSub steps of the chunk (each
      // thread reads back only its own slots)
      for (int t = 0; t < tn; ++t) {
        if (t % kSub == 0) {
#pragma unroll
          for (int i = 0; i < kPer; ++i) sm.sub[t / kSub][i][tid] = h[i];
        }
        const float dtt = sm.dt[t][ch];
        const float u = dtt * sm.x[t][ch];
#pragma unroll
        for (int i = 0; i < kPer; ++i)
          h[i] = fmaf(ex2(dtt * a2[i]), h[i], u * sm.b[t][n0 + i]);
      }

      // pass 2: each kSub-step group, last first
      for (int s = (tn - 1) / kSub; s >= 0; --s) {
        const int s0 = s * kSub, sn = min(kSub, tn - s0);
        float hb[kPer], hist[kSub][kPer];
#pragma unroll
        for (int i = 0; i < kPer; ++i) hb[i] = sm.sub[s][i][tid];
#pragma unroll
        for (int k = 0; k < kSub; ++k) {
          if (k < sn) {
            const int t = s0 + k;
            const float dtt = sm.dt[t][ch];
            const float u = dtt * sm.x[t][ch];
#pragma unroll
            for (int i = 0; i < kPer; ++i) {
              const float prev = k == 0 ? hb[i] : hist[k > 0 ? k - 1 : 0][i];
              hist[k][i] = fmaf(ex2(dtt * a2[i]), prev, u * sm.b[t][n0 + i]);
            }
          }
        }
#pragma unroll
        for (int k = kSub - 1; k >= 0; --k) {
          if (k >= sn) continue;
          const int t = s0 + k;
          const float dtt = sm.dt[t][ch], xt = sm.x[t][ch];
          const float dyt = sm.dy[t][ch];
          const float u = dtt * xt;
          float du = 0.f, dta = 0.f;
#pragma unroll
          for (int i = 0; i < kPer; ++i) {
            const float bn = sm.b[t][n0 + i], cn = sm.c[t][n0 + i];
            const float prev = k == 0 ? hb[i] : hist[k > 0 ? k - 1 : 0][i];
            g[i] = fmaf(dyt, cn, g[i]);
            sm.red[k][0][n0 + i][ch] = g[i] * u;
            sm.red[k][1][n0 + i][ch] = dyt * hist[k][i];
            du = fmaf(g[i], bn, du);
            const float e = ex2(dtt * a2[i]);
            const float gd = g[i] * prev * e;     // dL/da_t * a_t
            dta = fmaf(gd, an[i], dta);
            da[i] = fmaf(gd, dtt, da[i]);
            g[i] *= e;
          }
#pragma unroll
          for (int w = 1; w < kLanes; w <<= 1) {
            du += __shfl_xor_sync(FULL_MASK, du, w);
            dta += __shfl_xor_sync(FULL_MASK, dta, w);
          }
          if (live && n0 == 0) {
            const int64_t at = ((int64_t)b * L + t0 + t) * Din + d;
            float vx = du * dtt, vdt = fmaf(du, xt, dta);
            if (!first) {   // the groups of states before added theirs
              vx += dx[at];
              vdt += ddt[at];
            }
            dx[at] = vx;
            ddt[at] = vdt;
          }
        }
        __syncthreads();
        // the group's dB and dC terms summed over the CTA's channels
        for (int i = tid; i < sn * 2 * kMaxN; i += kThreads) {
          const int k = i / (2 * kMaxN), r = i % (2 * kMaxN);
          const int kind = r / kMaxN, nn = r % kMaxN;
          if (n_base + nn >= N) continue;
          const float* row = sm.red[k][kind][nn];
          float sum = 0.f;
          for (int cc = 0; cc < kChannels; ++cc) sum += row[cc];
          (kind == 0 ? part_b : part_c)[(int64_t)(t0 + s0 + k) * N + n_base +
                                        nn] = sum;
        }
        __syncthreads();   // red is free for the next group
      }
    }

#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int n = n_base + n0 + i;
      if (live && n < N) {
        const int64_t at = ((int64_t)b * Din + d) * N + n;
        dh0[at] = g[i];
        part_a[at] = da[i];
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

template <int kLanes>
int launch(const float* dt, const float* x, const float* A, const float* Bt,
           const float* Ct, const float* ckpt, const float* dy,
           const float* dh_last, int B, int L, int Din, int N, float* ddt,
           float* dx, float* dA, float* dB, float* dC, float* dh0,
           float* part_bc, float* part_a, cudaStream_t stream) {
  const size_t smem = sizeof(Smem<kLanes>);
  static int set = 0;
  cudaError_t err = allow_smem(
      reinterpret_cast<const void*>(selective_scan_bwd_kernel<kLanes>),
      (int)smem, set);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_blk = (Din + Smem<kLanes>::kChannels - 1) /
                    Smem<kLanes>::kChannels;
  selective_scan_bwd_kernel<kLanes><<<dim3(n_blk, B), kThreads, smem,
                                      stream>>>(
      dt, x, A, Bt, Ct, ckpt, dy, dh_last, L, Din, N, ddt, dx, dh0, part_bc,
      part_a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t total = 2 * (int64_t)B * L * N + (int64_t)Din * N;
  const int64_t want = (total + 255) / 256;
  const int blocks = (int)(want < 132 * 16 ? want : 132 * 16);
  selective_scan_bwd_sum_kernel<<<blocks, 256, 0, stream>>>(
      part_bc, part_a, B, L, Din, N, n_blk, dB, dC, dA);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Channel blocks of the partials for this Din and N (the wrapper sizes
// part_bc as (2, B, blocks, L, N) float32).
extern "C" int selective_scan_bwd_blocks(int Din, int N) {
  const int channels = N <= 16 ? 64 : (N <= 32 ? 32 : 16);
  return (Din + channels - 1) / channels;
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
  if (N <= 16)
    return launch<2>(dt, x, A, Bt, Ct, ckpt, dy, dh_last, B, L, Din, N, ddt,
                     dx, dA, dB, dC, dh0, part_bc, part_a, s);
  if (N <= 32)
    return launch<4>(dt, x, A, Bt, Ct, ckpt, dy, dh_last, B, L, Din, N, ddt,
                     dx, dA, dB, dC, dh0, part_bc, part_a, s);
  return launch<8>(dt, x, A, Bt, Ct, ckpt, dy, dh_last, B, L, Din, N, ddt,
                   dx, dA, dB, dC, dh0, part_bc, part_a, s);
}
