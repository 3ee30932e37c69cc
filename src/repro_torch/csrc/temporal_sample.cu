// Paged temporal neighbour sampling, recent and uniform policies
// (GNNFlow §4.2, Algorithm 1).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/temporal_sample/temporal_sample.py::temporal_sample_kernel
//   (bodies _kernel_recent and _kernel_uniform; wrapper ops.py::temporal_sample_pallas).
//
// What bounds it on the H100: bytes.  Per target it reads one page-table
// row, two page descriptors per page and up to C lanes of 13 bytes (+4
// noise bytes for uniform) per page it scans, and does a few compares per
// lane — far below the card's operations-per-byte balance.  At serving
// shapes (N = 128 or 1,280 targets, S = 16, C = 64, K = 10) one launch
// moves well under 10 MB, so launch latency dominates.
//
// Design, one warp per target (the paper's own GPU layout):
//  * the warp gathers its target's page-table row itself (the JAX wrapper
//    did that gather in a separate pass), and walks the S page ids newest
//    first, skipping pages whose [t_min, t_max] misses [t_start, t_end)
//    without touching their lanes;
//  * a page is swept in 32-lane chunks, each lane loading one
//    (nbr, eid, ts, valid) cell, so a chunk is four coalesced loads;
//  * recent: chunks go from lane C-1 down (newest first); in-window lanes
//    are ranked with __ballot_sync/__popc and the walk stops as soon as K
//    neighbours are found — only the pages the answer needs are read;
//  * uniform: a K-entry Gumbel top-k reservoir lives in registers, slot
//    r in lane r, sorted by descending score.  Each chunk's in-window
//    candidates (score = the input noise, in storage lane order) that beat
//    the current K-th score are inserted one at a time by a warp-wide
//    shift; there is no early stop.  The result equals a global top-k
//    (ties keep the lower storage index, like lax.top_k), emitted in
//    descending score so slots [0, count) are the valid ones.
#include "common.cuh"

namespace {

constexpr int kWarpsPerBlock = 4;

struct SampleArgs {
  const int* page_table;    // (n_rows, table_stride) newest-first page ids
  int n_rows, table_stride, scan;
  const float* page_tmin;   // (P,)
  const float* page_tmax;   // (P,)
  int n_pages;
  const int* pages_nbr;     // (P, C)
  const int* pages_eid;     // (P, C)
  const float* pages_ts;    // (P, C)
  const bool* pages_valid;  // (P, C)
  int cap;                  // C, the page width
  const int* targets;       // (N,)
  const float* t_end;       // (N,)
  const float* t_start;     // (N,)
  const bool* tmask;        // (N,)
  const float* noise;       // (N, scan, C), uniform only
  int n, k;
  int* out_nbr;             // (N, K)
  int* out_eid;             // (N, K)
  float* out_ts;            // (N, K)
  bool* out_mask;           // (N, K)
};

// The page id of a target's s-th newest page, or -1 when the target is
// masked, out of range, or has fewer pages.
__device__ __forceinline__ int page_of(const SampleArgs& a, bool alive,
                                       int row, int s) {
  if (!alive) return NULL_ID;
  return a.page_table[(int64_t)row * a.table_stride + s];
}

__device__ __forceinline__ bool page_hit(const SampleArgs& a, int pid,
                                         float t0, float t1) {
  int pc = clamp_int(pid, 0, a.n_pages - 1);
  return a.page_tmin[pc] < t1 && a.page_tmax[pc] >= t0;
}

__global__ void sample_recent_kernel(SampleArgs a) {
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (i >= a.n) return;                         // whole warp leaves together
  const int row = a.targets[i];
  const bool alive = a.tmask[i] && row >= 0 && row < a.n_rows;
  const float t0 = a.t_start[i], t1 = a.t_end[i];
  const unsigned lt_mask = (1u << lane) - 1u;
  int count = 0;
  for (int s = 0; s < a.scan && count < a.k; ++s) {
    const int pid = page_of(a, alive, row, s);
    if (pid == NULL_ID || !page_hit(a, pid, t0, t1)) continue;
    const int64_t base = (int64_t)clamp_int(pid, 0, a.n_pages - 1) * a.cap;
    for (int hi = a.cap - 1; hi >= 0 && count < a.k; hi -= 32) {
      const int j = hi - lane;                  // lane 0 = newest lane
      bool in = false;
      int nbr = NULL_ID, eid = NULL_ID;
      float ts = 0.f;
      if (j >= 0) {
        ts = a.pages_ts[base + j];
        in = a.pages_valid[base + j] && ts >= t0 && ts < t1;
        if (in) {
          nbr = a.pages_nbr[base + j];
          eid = a.pages_eid[base + j];
        }
      }
      const unsigned ballot = __ballot_sync(FULL_MASK, in);
      const int rank = count + __popc(ballot & lt_mask);
      if (in && rank < a.k) {
        const int64_t o = (int64_t)i * a.k + rank;
        a.out_nbr[o] = nbr;
        a.out_eid[o] = eid;
        a.out_ts[o] = ts;
      }
      count += __popc(ballot);
    }
  }
  count = min(count, a.k);
  for (int r = lane; r < a.k; r += 32) {
    const int64_t o = (int64_t)i * a.k + r;
    a.out_mask[o] = r < count;
    if (r >= count) {
      a.out_nbr[o] = NULL_ID;
      a.out_eid[o] = NULL_ID;
      a.out_ts[o] = 0.f;
    }
  }
}

__global__ void sample_uniform_kernel(SampleArgs a) {
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (i >= a.n) return;
  const int row = a.targets[i];
  const bool alive = a.tmask[i] && row >= 0 && row < a.n_rows;
  const float t0 = a.t_start[i], t1 = a.t_end[i];
  // reservoir slot `lane` (valid for lane < K), descending by score
  float r_sc = -CUDART_INF_F, r_ts = 0.f;
  int r_nbr = NULL_ID, r_eid = NULL_ID;
  int count = 0;
  for (int s = 0; s < a.scan; ++s) {
    const int pid = page_of(a, alive, row, s);
    if (pid == NULL_ID || !page_hit(a, pid, t0, t1)) continue;
    const int64_t base = (int64_t)clamp_int(pid, 0, a.n_pages - 1) * a.cap;
    const float* nz = a.noise + ((int64_t)i * a.scan + s) * a.cap;
    for (int lo = 0; lo < a.cap; lo += 32) {    // storage order
      const int j = lo + lane;
      bool in = false;
      float sc = -CUDART_INF_F, ts = 0.f;
      int nbr = NULL_ID, eid = NULL_ID;
      if (j < a.cap) {
        ts = a.pages_ts[base + j];
        in = a.pages_valid[base + j] && ts >= t0 && ts < t1;
        if (in) {
          sc = nz[j];
          nbr = a.pages_nbr[base + j];
          eid = a.pages_eid[base + j];
        }
      }
      unsigned pending = __ballot_sync(FULL_MASK, in);
      count += __popc(pending);
      while (pending) {                         // warp-uniform loop
        const int src = __ffs(pending) - 1;
        pending &= pending - 1;
        const float c_sc = __shfl_sync(FULL_MASK, sc, src);
        const float kth = __shfl_sync(FULL_MASK, r_sc, a.k - 1);
        if (!(c_sc > kth)) continue;            // ties keep the older entry
        const int c_nbr = __shfl_sync(FULL_MASK, nbr, src);
        const int c_eid = __shfl_sync(FULL_MASK, eid, src);
        const float c_ts = __shfl_sync(FULL_MASK, ts, src);
        // insert position = number of reservoir slots scoring >= c_sc
        const int pos = __popc(__ballot_sync(FULL_MASK,
                                             lane < a.k && r_sc >= c_sc));
        const float u_sc = __shfl_up_sync(FULL_MASK, r_sc, 1);
        const int u_nbr = __shfl_up_sync(FULL_MASK, r_nbr, 1);
        const int u_eid = __shfl_up_sync(FULL_MASK, r_eid, 1);
        const float u_ts = __shfl_up_sync(FULL_MASK, r_ts, 1);
        if (lane == pos) {
          r_sc = c_sc; r_nbr = c_nbr; r_eid = c_eid; r_ts = c_ts;
        } else if (lane > pos) {
          r_sc = u_sc; r_nbr = u_nbr; r_eid = u_eid; r_ts = u_ts;
        }
      }
    }
  }
  count = min(count, a.k);
  if (lane < a.k) {
    const int64_t o = (int64_t)i * a.k + lane;
    const bool m = lane < count;
    a.out_mask[o] = m;
    a.out_nbr[o] = m ? r_nbr : NULL_ID;
    a.out_eid[o] = m ? r_eid : NULL_ID;
    a.out_ts[o] = m ? r_ts : 0.f;
  }
}

}  // namespace

// policy: 0 = recent, 1 = uniform.  Returns cudaGetLastError() after the
// launch (0 on success).  Requires 1 <= k (and k <= 32 for uniform, whose
// reservoir is one slot per lane).
extern "C" int temporal_sample_launch(
    const int* page_table, int n_rows, int table_stride, int scan,
    const float* page_tmin, const float* page_tmax, int n_pages,
    const int* pages_nbr, const int* pages_eid, const float* pages_ts,
    const bool* pages_valid, int cap, const int* targets,
    const float* t_end, const float* t_start, const bool* tmask,
    const float* noise, int n, int k, int policy, int* out_nbr,
    int* out_eid, float* out_ts, bool* out_mask, void* stream) {
  SampleArgs a{page_table, n_rows, table_stride, scan, page_tmin,
               page_tmax, n_pages, pages_nbr, pages_eid, pages_ts,
               pages_valid, cap, targets, t_end, t_start, tmask, noise,
               n, k, out_nbr, out_eid, out_ts, out_mask};
  const dim3 block(32 * kWarpsPerBlock);
  const dim3 grid((n + kWarpsPerBlock - 1) / kWarpsPerBlock);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (policy == 0) {
    sample_recent_kernel<<<grid, block, 0, st>>>(a);
  } else {
    sample_uniform_kernel<<<grid, block, 0, st>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}
