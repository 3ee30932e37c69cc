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
// so a target with no valid neighbour gets a zero row.
//
// Backward, given dout[n,h]:
//   dv_j = a_j dout,  da_j = <dout, v_j>,  D = sum_j a_j da_j,
//   ds_j = a_j (da_j - D),  dq = Dh^-0.5 sum_j ds_j k_j,  dk_j = Dh^-0.5 ds_j q
// A masked neighbour has a_j = 0, so it gets zero gradients, and a target
// with no valid neighbour gets zeros everywhere, as the plain version's
// `where` gives.  The mask gets no gradient.
//
// What bounds both on the H100: bytes.  The forward reads each (target,
// head)'s q row and K rows of k and v once (2K+1 rows of Dh floats); the
// backward reads q, dout, k and v (2K+2 rows) and writes dq, dk and dv
// (2K+1 rows).  Both do a few flops per float moved — far below the card's
// balance.  At the training path's shapes (H = 2, Dh = 50, K = 10, N up to
// 18,000 targets) a backward launch moves about 310 MB.
//
// Design: one warp per (target, head).  Lane l holds q elements l, l+32, …
// (Dh = 50 is one full and one masked element per lane); each of the K dot
// products is a lane-local partial sum reduced by butterfly shuffles, and
// lane j keeps score j, so the masked max, exp and sum are warp reductions
// in float32 registers.  The weighted sum of V then streams the K rows of v
// once more, coalesced, with each weight broadcast by a shuffle.  No score or
// weight goes through device memory.
//
// The backward recomputes the scores instead of reading a max and a sum
// saved by the forward: it must read every k row anyway (dq sums over
// them), so the recompute costs no device-memory bytes, and the forward
// stays as it is.  Each (target, head) owns its q, k and v rows, so every
// gradient element is written by exactly one lane: no atomics, and the
// result is deterministic.
#include "common.cuh"

namespace {

constexpr int kWarpsPerBlock = 4;
constexpr int kMaxPerLane = 4;   // Dh <= 128
constexpr float kMasked = -1e30f;

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

__global__ void temporal_attn_kernel(const float* __restrict__ q,
                                     const float* __restrict__ k,
                                     const float* __restrict__ v,
                                     const bool* __restrict__ mask, int n,
                                     int heads, int kn, int dh, float scale,
                                     float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int w = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (w >= n * heads) return;
  const int t = w / heads, h = w % heads;
  const int per_lane = (dh + 31) >> 5;
  float qr[kMaxPerLane];
#pragma unroll
  for (int e = 0; e < kMaxPerLane; ++e) {
    const int d = lane + 32 * e;
    qr[e] = (e < per_lane && d < dh) ? q[(int64_t)w * dh + d] : 0.f;
  }
  // row (t, j, h) of k / v starts at ((t*K + j)*H + h)*Dh
  const int64_t row0 = ((int64_t)t * kn * heads + h) * dh;
  const int64_t row_step = (int64_t)heads * dh;
  float my_s = kMasked;
  bool my_m = false;
  for (int j = 0; j < kn; ++j) {
    const float* kr = k + row0 + j * row_step;
    float part = 0.f;
#pragma unroll
    for (int e = 0; e < kMaxPerLane; ++e) {
      const int d = lane + 32 * e;
      if (e < per_lane && d < dh) part += qr[e] * kr[d];
    }
    const float s = warp_sum(part) * scale;
    const bool m = mask[(int64_t)t * kn + j];
    if (lane == j) {
      my_s = m ? s : kMasked;
      my_m = m;
    }
  }
  const float mx = warp_max(lane < kn ? my_s : -CUDART_INF_F);
  const float p = (lane < kn && my_m) ? expf(my_s - mx) : 0.f;
  const float a = p / fmaxf(warp_sum(p), 1e-30f);
  float acc[kMaxPerLane] = {0.f, 0.f, 0.f, 0.f};
  for (int j = 0; j < kn; ++j) {
    const float aj = __shfl_sync(FULL_MASK, a, j);
    const float* vr = v + row0 + j * row_step;
#pragma unroll
    for (int e = 0; e < kMaxPerLane; ++e) {
      const int d = lane + 32 * e;
      if (e < per_lane && d < dh) acc[e] += aj * vr[d];
    }
  }
#pragma unroll
  for (int e = 0; e < kMaxPerLane; ++e) {
    const int d = lane + 32 * e;
    if (e < per_lane && d < dh) out[(int64_t)w * dh + d] = acc[e];
  }
}

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

}  // namespace

// q (N, H, Dh), k and v (N, K, H, Dh), mask (N, K) -> out (N, H, Dh), all
// contiguous float32 / bool.  Requires K <= 32 and Dh <= 128.  Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int temporal_attn_launch(const float* q, const float* k,
                                    const float* v, const bool* mask, int n,
                                    int heads, int kn, int dh, float scale,
                                    float* out, void* stream) {
  const dim3 block(32 * kWarpsPerBlock);
  const dim3 grid((n * heads + kWarpsPerBlock - 1) / kWarpsPerBlock);
  temporal_attn_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      q, k, v, mask, n, heads, kn, dh, scale, out);
  return static_cast<int>(cudaGetLastError());
}

// Backward of temporal_attn_launch: q (N, H, Dh), k and v (N, K, H, Dh),
// mask (N, K) and dout (N, H, Dh) -> dq (N, H, Dh), dk and dv (N, K, H, Dh),
// all contiguous float32 / bool, with the forward's limits.  Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int temporal_attn_bwd_launch(const float* q, const float* k,
                                        const float* v, const bool* mask,
                                        const float* dout, int n, int heads,
                                        int kn, int dh, float scale,
                                        float* dq, float* dk, float* dv,
                                        void* stream) {
  const dim3 block(32 * kWarpsPerBlock);
  const dim3 grid((n * heads + kWarpsPerBlock - 1) / kWarpsPerBlock);
  temporal_attn_bwd_kernel<<<grid, block, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      q, k, v, mask, dout, n, heads, kn, dh, scale, dq, dk, dv);
  return static_cast<int>(cudaGetLastError());
}
