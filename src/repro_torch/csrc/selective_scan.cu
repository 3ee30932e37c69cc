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
//
// What bounds it on the H100: the exps.  At Falcon-Mamba-7B's prefill
// shape (B 2, L 4096, Din 8192, N 16) there are 1.07e9 of them, 0.257 ms
// on the special-function units (16 a clock per SM), against 809 MB of
// dt, x and y (0.2415 ms) and about 4 float32 instructions per state
// element, which take half the exps' time on the FMA pipes.
//
// Design.
//   - exp on the special-function unit: A' = A log2 e is taken once per
//     state, and exp(dt A) is ex2.approx(dt A'), one FMUL and one MUFU op
//     where expf takes about ten instructions.  Held to 1e-5 against the
//     float32 reference on the card with A down to -16 and dt up to 1.
//   - kLanes threads per channel, each holding 8 states in registers: 2
//     for N <= 16 (Falcon-Mamba's 16), 4 for N <= 32 and 8 beyond, so a
//     group holds 16, 32 or 64 states (states past N are padded with A' =
//     0, B = C = 0 and h = 0, which stay exactly 0).  y_t is a shuffle
//     reduction over the channel's lanes, and its first lane writes it.
//     A CTA of 128 threads owns 128 / kLanes channels of one batch row.
//     The B_t and C_t rows, which all its channels share, are read from
//     shared memory as float4 broadcasts: 8 states cost 4 LDS.128.  Time
//     steps are unrolled by 8.  With one warp per scheduler (one thread
//     per channel) the exps' time added to the other work instead of
//     hiding under it; two threads per channel give each scheduler two
//     warps, and ran faster on the card than one or four at N = 16.
//   - N > 64 (the widest instance only): the states are taken in groups
//     of 64, one pass over L per group, and each pass adds its part of
//     y_t to what the passes before it wrote (the same thread owns y_t in
//     every pass, so no atomics and a fixed order).
//   - Overlap: the CTA walks L in chunks of 64 steps through two buffers;
//     while it scans one chunk, cp.async brings the next chunk's dt and x
//     columns and B_t and C_t rows.  Two barriers per chunk.
// L is not split across CTAs: B x Din recurrences fill the card.
// Training: when the caller gives a ckpt buffer, each chunk's starting
// state is stored too (67 MB a layer at Falcon's train shape), from
// which the backward (csrc/selective_scan_bwd.cu) recomputes the states
// a chunk at a time; serving passes none and skips the store.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kPer = 8;                // states per thread
constexpr int kChunk = 64;             // time steps per buffer
constexpr int kBufs = 2;               // buffers in the ring
constexpr float kLog2e = 1.4426950408889634f;

// kLanes threads per channel: kMaxN = 8 kLanes states a group,
// kChannels = 128 / kLanes channels a CTA
template <int kLanes>
struct Buffer {
  static constexpr int kMaxN = kPer * kLanes;
  static constexpr int kChannels = kThreads / kLanes;
  float dt[kChunk][kChannels];
  float x[kChunk][kChannels];
  float b[kChunk][kMaxN];
  float c[kChunk][kMaxN];
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// cp.async of `bytes` (4 or 16) from src to shared dst; zero-fills dst
// where !ok (src is then only a valid address, not read).
template <int bytes>
__device__ __forceinline__ void cp_async(void* dst, const float* src,
                                         bool ok) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  if constexpr (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(d),
                 "l"(src), "r"(ok ? 16 : 0) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(d),
                 "l"(src), "r"(ok ? 4 : 0) : "memory");
}

// Issue the copies of steps [t0, t0 + tn) into buf: dt and x columns
// d0..d0 + kChannels (zero past Din), and columns n_base.. n_base + kMaxN
// of the B_t and C_t rows (zero past N, so the padding states stay 0).
// vec: 16-byte copies (Din % 4 == 0 and N % 4 == 0, every pointer 16-byte
// aligned).
template <int kLanes>
__device__ __forceinline__ void stage(Buffer<kLanes>& buf,
                                      const float* __restrict__ dt,
                                      const float* __restrict__ x,
                                      const float* __restrict__ Bt,
                                      const float* __restrict__ Ct, int b,
                                      int t0, int tn, int L, int Din, int d0,
                                      int N, int n_base, bool vec) {
  constexpr int kChannels = Buffer<kLanes>::kChannels;
  constexpr int kMaxN = Buffer<kLanes>::kMaxN;
  const int tid = threadIdx.x;
  const int64_t row0 = (int64_t)b * L + t0;
  if (vec) {
    constexpr int kq = kChannels / 4;          // 16-byte pieces a row
    for (int i = tid; i < tn * kq; i += kThreads) {
      const int t = i / kq, c = 4 * (i % kq);
      const bool ok = d0 + c < Din;
      const int64_t g = (row0 + t) * Din + d0 + c;
      cp_async<16>(&buf.dt[t][c], ok ? dt + g : dt, ok);
      cp_async<16>(&buf.x[t][c], ok ? x + g : x, ok);
    }
    constexpr int nq = kMaxN / 4;
    for (int i = tid; i < tn * nq; i += kThreads) {
      const int t = i / nq, n = 4 * (i % nq);
      const bool ok = n_base + n < N;
      const int64_t g = (row0 + t) * N + n_base + n;
      cp_async<16>(&buf.b[t][n], ok ? Bt + g : Bt, ok);
      cp_async<16>(&buf.c[t][n], ok ? Ct + g : Ct, ok);
    }
  } else {
    for (int i = tid; i < tn * kChannels; i += kThreads) {
      const int t = i / kChannels, c = i % kChannels;
      const bool ok = d0 + c < Din;
      const int64_t g = (row0 + t) * Din + d0 + c;
      cp_async<4>(&buf.dt[t][c], ok ? dt + g : dt, ok);
      cp_async<4>(&buf.x[t][c], ok ? x + g : x, ok);
    }
    for (int i = tid; i < tn * kMaxN; i += kThreads) {
      const int t = i / kMaxN, n = i % kMaxN;
      const bool ok = n_base + n < N;
      const int64_t g = (row0 + t) * N + n_base + n;
      cp_async<4>(&buf.b[t][n], ok ? Bt + g : Bt, ok);
      cp_async<4>(&buf.c[t][n], ok ? Ct + g : Ct, ok);
    }
  }
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// one CTA per SM is enough to fill the card, so all registers
template <int kLanes>
__global__ void __launch_bounds__(kThreads, 1)
    selective_scan_kernel(const float* __restrict__ dt,
                          const float* __restrict__ x,
                          const float* __restrict__ A,
                          const float* __restrict__ Bt,
                          const float* __restrict__ Ct,
                          const float* __restrict__ h0, int L, int Din,
                          int N, float* __restrict__ y,
                          float* __restrict__ h_last,
                          float* __restrict__ ckpt, int vec) {
  using Buf = Buffer<kLanes>;
  constexpr int kChannels = Buf::kChannels;
  constexpr int kMaxN = Buf::kMaxN;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Buf* bufs = reinterpret_cast<Buf*>(smem_raw);   // kBufs buffers

  const int tid = threadIdx.x;
  const int ch = tid / kLanes;
  const int n0 = tid % kLanes * kPer;    // the thread's first state
  const int b = blockIdx.y;
  const int d0 = blockIdx.x * kChannels;
  const int d = d0 + ch;
  const bool live = d < Din;
  const int n_chunks = (L + kChunk - 1) / kChunk;
  float* ycol = y + (int64_t)b * L * Din + d;

  // one pass over L per group of kMaxN states; only the widest instance
  // has more than one
  for (int n_base = 0; n_base < N; n_base += kMaxN) {
    const bool first = n_base == 0;
    float a[kPer], h[kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int n = n_base + n0 + i;
      const bool ok = live && n < N;
      a[i] = ok ? A[(int64_t)d * N + n] * kLog2e : 0.f;
      h[i] = ok ? h0[((int64_t)b * Din + d) * N + n] : 0.f;
    }

    // chunk c into its buffer; a chunk past the end commits an empty group
    auto fetch = [&](int c) {
      if (c < n_chunks)
        stage<kLanes>(bufs[c % kBufs], dt, x, Bt, Ct, b, c * kChunk,
                      min(kChunk, L - c * kChunk), L, Din, d0, N, n_base,
                      vec);
      else
        asm volatile("cp.async.commit_group;" ::: "memory");
    };
    for (int c = 0; c < kBufs - 1; ++c) fetch(c);
    for (int c = 0; c < n_chunks; ++c) {
      const int t0 = c * kChunk, tn = min(kChunk, L - t0), k = c % kBufs;
      fetch(c + kBufs - 1);
      // every group but the newest kBufs - 1 is in: chunk c has landed
      asm volatile("cp.async.wait_group %0;" ::"n"(kBufs - 1) : "memory");
      __syncthreads();
      const Buf& cur = bufs[k];
      float* yrow = ycol + (int64_t)t0 * Din;
      if (ckpt != nullptr) {   // the state before chunk c, for the backward
        float* cp = ckpt + (((int64_t)b * n_chunks + c) * Din + d) * N;
#pragma unroll
        for (int i = 0; i < kPer; ++i) {
          const int n = n_base + n0 + i;
          if (live && n < N) cp[n] = h[i];
        }
      }
#pragma unroll 8
      for (int t = 0; t < tn; ++t) {
        const float dtt = cur.dt[t][ch];
        const float u = dtt * cur.x[t][ch];
        float bb[kPer], cc[kPer];
#pragma unroll
        for (int i = 0; i < kPer; i += 4) {
          const float4 vb =
              *reinterpret_cast<const float4*>(&cur.b[t][n0 + i]);
          const float4 vc =
              *reinterpret_cast<const float4*>(&cur.c[t][n0 + i]);
          bb[i] = vb.x; bb[i + 1] = vb.y; bb[i + 2] = vb.z; bb[i + 3] = vb.w;
          cc[i] = vc.x; cc[i + 1] = vc.y; cc[i + 2] = vc.z; cc[i + 3] = vc.w;
        }
        float part[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int i = 0; i < kPer; ++i) {
          h[i] = fmaf(ex2(dtt * a[i]), h[i], u * bb[i]);
          part[i % 4] = fmaf(h[i], cc[i], part[i % 4]);
        }
        float yt = (part[0] + part[1]) + (part[2] + part[3]);
#pragma unroll
        for (int w = 1; w < kLanes; w <<= 1)
          yt += __shfl_xor_sync(FULL_MASK, yt, w);
        if (live && n0 == 0) {
          if (kMaxN == 64 && !first) yt += yrow[(int64_t)t * Din];
          yrow[(int64_t)t * Din] = yt;
        }
      }
      __syncthreads();   // everyone is done with bufs[k] before it refills
    }

#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int n = n_base + n0 + i;
      if (live && n < N) h_last[((int64_t)b * Din + d) * N + n] = h[i];
    }
  }
}

template <int kLanes>
int launch(const float* dt, const float* x, const float* A, const float* Bt,
           const float* Ct, const float* h0, int B, int L, int Din, int N,
           float* y, float* h_last, float* ckpt, int vec,
           cudaStream_t stream) {
  const size_t smem = kBufs * sizeof(Buffer<kLanes>);
  cudaError_t err = cudaFuncSetAttribute(
      selective_scan_kernel<kLanes>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int channels = Buffer<kLanes>::kChannels;
  const dim3 grid((Din + channels - 1) / channels, B);
  selective_scan_kernel<kLanes><<<grid, kThreads, smem, stream>>>(
      dt, x, A, Bt, Ct, h0, L, Din, N, y, h_last, ckpt, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dt and x (B, L, Din), A (Din, N), Bt and Ct (B, L, N), h0 (B, Din, N) ->
// y (B, L, Din), h_last (B, Din, N); all contiguous float32, any N >= 1.
// Where ckpt is not null (training), the state before every chunk of 64
// steps goes to ckpt (B, ceil(L / 64), Din, N) for the backward
// (csrc/selective_scan_bwd.cu); the caller passes the chunk it sized ckpt
// for as ckpt_every, and any other than 64 is refused.  Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int selective_scan_launch(const float* dt, const float* x,
                                     const float* A, const float* Bt,
                                     const float* Ct, const float* h0, int B,
                                     int L, int Din, int N, float* y,
                                     float* h_last, float* ckpt,
                                     int ckpt_every, void* stream) {
  if (ckpt != nullptr && ckpt_every != kChunk)
    return static_cast<int>(cudaErrorInvalidValue);
  const uintptr_t addr = reinterpret_cast<uintptr_t>(dt) |
                         reinterpret_cast<uintptr_t>(x) |
                         reinterpret_cast<uintptr_t>(Bt) |
                         reinterpret_cast<uintptr_t>(Ct);
  const int vec = Din % 4 == 0 && N % 4 == 0 && (addr & 15) == 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N <= 16)
    return launch<2>(dt, x, A, Bt, Ct, h0, B, L, Din, N, y, h_last, ckpt,
                     vec, s);
  if (N <= 32)
    return launch<4>(dt, x, A, Bt, Ct, h0, B, L, Din, N, y, h_last, ckpt,
                     vec, s);
  return launch<8>(dt, x, A, Bt, Ct, h0, B, L, Din, N, y, h_last, ckpt,
                   vec, s);
}
