// Mamba-1 selective scan (forward), float32.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/selective_scan/selective_scan.py::
//   selective_scan_kernel (body _kernel; wrapper ops.py::
//   selective_scan_pallas, whose padding of L to a chunk is not needed:
//   the padded steps have dt = 0 and change nothing).
// The model path it serves is models/mamba.py::_mamba1_scan_y.  For each
// batch row b and channel d, with state h[n] (n < N):
//   h_t[n] = exp(dt_t A[d, n]) h_{t-1}[n] + (dt_t x_t) B_t[n]
//   y_t    = sum_n h_t[n] C_t[n]
// from h_0 = h0[b, d]; the kernel writes y (B, L, Din) and h_last.
// exp is the accurate expf (not __expf), to hold 1e-5 against float32.
//
// What bounds it on the H100: bytes.  At Falcon-Mamba-7B's prefill shape
// (B 2, L 4096, Din 8192, N 16) it must read dt and x and write y (about
// 805 MB; B_t and C_t add 1 MB), while the 1.07e9 exps and about 6 flops
// per state element come to roughly the same time on the special-function
// units and less on the float32 pipes.
//
// Design: the state never leaves registers.  Four lanes share one (b, d)
// channel, lane l holding states n = l, l + 4, l + 8, l + 12 (N <= 16),
// so y_t is a two-step shuffle reduction and the card holds 4 x B x Din
// threads (enough warps to hide the loads at B = 2).  A CTA of 128
// threads owns 32 channels of one batch row and walks L in chunks of 64
// steps: it stages the chunk's dt and x columns (128-byte rows) and the
// B_t and C_t rows, which all its channels share, in shared memory with
// every load in flight at once, runs the 64 steps from there, and writes
// the chunk's y from shared memory in 128-byte rows.
#include "common.cuh"

namespace {

constexpr int kLanes = 4;              // threads per channel
constexpr int kChannels = 32;          // channels per CTA
constexpr int kThreads = kLanes * kChannels;
constexpr int kMaxN = 16;
constexpr int kPerLane = kMaxN / kLanes;
constexpr int kChunk = 64;             // time steps staged at once

__global__ void __launch_bounds__(kThreads)
    selective_scan_kernel(const float* __restrict__ dt,
                          const float* __restrict__ x,
                          const float* __restrict__ A,
                          const float* __restrict__ Bt,
                          const float* __restrict__ Ct,
                          const float* __restrict__ h0, int L, int Din,
                          int N, float* __restrict__ y,
                          float* __restrict__ h_last) {
  __shared__ float s_dt[kChunk][kChannels];
  __shared__ float s_x[kChunk][kChannels];
  __shared__ float s_y[kChunk][kChannels];
  __shared__ float s_b[kChunk][kMaxN];
  __shared__ float s_c[kChunk][kMaxN];

  const int tid = threadIdx.x;
  const int ch = tid / kLanes, lane = tid % kLanes;
  const int b = blockIdx.y;
  const int d0 = blockIdx.x * kChannels;
  const int d = d0 + ch;
  const bool live = d < Din;

  float a[kPerLane], h[kPerLane];
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) {
    const int n = lane + kLanes * i;
    const bool ok = live && n < N;
    a[i] = ok ? A[(int64_t)d * N + n] : 0.f;
    h[i] = ok ? h0[((int64_t)b * Din + d) * N + n] : 0.f;
  }

  for (int t0 = 0; t0 < L; t0 += kChunk) {
    const int tn = min(kChunk, L - t0);
    __syncthreads();   // the previous chunk's y is written out
    for (int idx = tid; idx < kChunk * kChannels; idx += kThreads) {
      const int t = idx / kChannels, c = idx % kChannels;
      const bool ok = t < tn && d0 + c < Din;
      const int64_t g = ((int64_t)b * L + t0 + t) * Din + d0 + c;
      s_dt[t][c] = ok ? dt[g] : 0.f;
      s_x[t][c] = ok ? x[g] : 0.f;
    }
    for (int idx = tid; idx < tn * N; idx += kThreads) {
      const int t = idx / N, n = idx % N;
      const int64_t g = ((int64_t)b * L + t0 + t) * N + n;
      s_b[t][n] = Bt[g];
      s_c[t][n] = Ct[g];
    }
    __syncthreads();
    for (int t = 0; t < tn; ++t) {
      const float dtt = s_dt[t][ch];
      const float u = dtt * s_x[t][ch];
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < kPerLane; ++i) {
        const int n = lane + kLanes * i;
        if (n < N) {
          h[i] = expf(dtt * a[i]) * h[i] + u * s_b[t][n];
          part += h[i] * s_c[t][n];
        }
      }
      part += __shfl_xor_sync(FULL_MASK, part, 1);
      part += __shfl_xor_sync(FULL_MASK, part, 2);
      if (lane == 0) s_y[t][ch] = part;
    }
    __syncthreads();
    for (int idx = tid; idx < tn * kChannels; idx += kThreads) {
      const int t = idx / kChannels, c = idx % kChannels;
      if (d0 + c < Din) y[((int64_t)b * L + t0 + t) * Din + d0 + c] =
          s_y[t][c];
    }
  }

#pragma unroll
  for (int i = 0; i < kPerLane; ++i) {
    const int n = lane + kLanes * i;
    if (live && n < N) h_last[((int64_t)b * Din + d) * N + n] = h[i];
  }
}

}  // namespace

// dt and x (B, L, Din), A (Din, N), Bt and Ct (B, L, N), h0 (B, Din, N) ->
// y (B, L, Din), h_last (B, Din, N); all contiguous float32, N <= 16.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int selective_scan_launch(const float* dt, const float* x,
                                     const float* A, const float* Bt,
                                     const float* Ct, const float* h0, int B,
                                     int L, int Din, int N, float* y,
                                     float* h_last, void* stream) {
  const dim3 grid((Din + kChannels - 1) / kChannels, B);
  selective_scan_kernel<<<grid, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      dt, x, A, Bt, Ct, h0, L, Din, N, y, h_last);
  return static_cast<int>(cudaGetLastError());
}
