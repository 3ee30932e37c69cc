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
// moves well under 10 MB, so latency dominates: the chain of dependent
// loads per target, and for uniform the serial merge of candidates.
//
// Recent, one warp per target (redesigned for Hopper).  The answer is the
// first K in-window lanes of the target's hit pages, newest page first and
// newest lane first; what bounds it is the chain of dependent loads (page
// id, then page descriptors, then lanes, then nbr/eid), for which a walk
// page by page pays four round trips a page.
//  * Lane s loads page slot s's id, then its [t_min, t_max], for 32 slots
//    at once; a ballot gives the hit pages, newest first, so a page whose
//    window misses costs no round trip of its own.
//  * In the same step as the descriptors, the warp loads the ts and valid
//    of the newest non-empty page's two newest chunks (kSpec), before it
//    knows whether that page hits: when it does (a query's hop 0, a train
//    step's roots at their own event times), the first picks need no
//    further round trip.
//  * The rest is walked kRecentBatch (page, chunk) units at a time, one
//    page of 64 lanes: the ts and valid of the batch load together, the
//    in-window lanes are ranked across it with ballots and prefix counts,
//    newest first, and the walk stops once K are found.
//  * Only the K picks load nbr and eid, their loads issued together.
//  So a target whose picks lie in its newest pages takes four or five
//  dependent loads in all, where the walk page by page took four a page.
//  Larger batches (2 pages) and a lazy load of the other descriptors were
//  tried: the first moved too many bytes at 12,000 targets, the second
//  added a round trip wherever the newest page did not suffice.
//  A warp takes one target at 128, 1,280 and 12,000 targets: the chain is
//  latency, which the scheduler overlaps across warps.  At 40 registers a
//  thread 12 CTAs (48 warps) fit an SM, so up to 6,336 targets walk at
//  once: every target of a served batch's hops, and 12,000 in under two
//  waves, where a second target per warp would queue two chains in one
//  instruction stream.
//
// Uniform, W = 4, 2 or 1 warps per target (redesigned for Hopper): the
// answer is the global top-K of the target's in-window candidates by
// (score desc, storage index s*C + j asc), score = the input noise.
//  * W is the most warps per target that still fit every target on the
//    card at once (N <= one wave of 4-warp CTAs: 4; twice that: 2; else
//    1, four targets to a CTA): small launches gain parallelism, large
//    ones do less merging.  On an H100 SXM one wave is 1,188 targets (9
//    CTAs an SM at 56 registers a thread), so the serving hop of 1,280
//    targets and TGAT's hop 0 of 1,800 run W = 2, its hop 1 W = 1.
//  * Lane s loads page slot s's id and [t_min, t_max] for 32 slots at once
//    and a ballot gives the pages that hit, so no page waits on another.
//  * The hit pages' 32-lane chunks are dealt out round-robin to the
//    target's warps in storage order (a skewed window still spreads over
//    all of them).  A warp loads the ts and valid of kBatch chunks
//    together, then the noise of their in-window lanes, then merges them
//    in ascending order: two dependent loads per batch, not per page.
//  * Each warp keeps a K-entry reservoir (score, storage index) in
//    registers, slot r in lane r.  A chunk's lanes are rejected together:
//    one ballot of `score > K-th score`; the lanes it passes are taken
//    lowest first, each checked against the K-th score as it rises, and
//    enter by a warp-wide shift.  With random scores about K(1 + ln(n/K))
//    of n candidates ever enter.  A strict `>` keeps the lower index on
//    ties, since a warp sees its chunks in storage order.
//  * The W*K entries of a target meet in shared memory; each thread ranks
//    one entry against all of them by (score desc, index asc), which is
//    exact since the top-K of a union is the top-K of the union of the
//    top-Ks.  The K winners' nbr, eid and ts are read once, at the end.
#include <climits>

#include "common.cuh"

namespace {

constexpr int kWarpsPerBlock = 4;    // warps of a CTA (both policies)
constexpr int kBatch = 8;            // uniform: chunks a warp loads at once
constexpr int kSpec = 2;             // recent: newest chunks loaded early
constexpr int kRecentBatch = 2;      // recent: (page, chunk) units a batch

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

// Recent: the in-window lanes of one batch of (page, chunk) units,
// newest first, join the K picks: ranks by ballots and prefix counts, then
// the nbr and eid loads of all the batch's picks at once, then the stores.
// off[b] is unit b's lane offset in the page arrays (-1: no lane).
template <int NB>
__device__ __forceinline__ void take_recent(const SampleArgs& a, int i,
                                            float t0, float t1,
                                            const int64_t (&off)[NB],
                                            const float (&ts)[NB],
                                            const bool (&val)[NB],
                                            int& count) {
  const int lane = threadIdx.x & 31;
  const unsigned lt_mask = (1u << lane) - 1u;
  bool pick[NB];
  int rank[NB];
#pragma unroll
  for (int b = 0; b < NB; ++b) {
    const bool in = off[b] >= 0 && val[b] && ts[b] >= t0 && ts[b] < t1;
    const unsigned bal = __ballot_sync(FULL_MASK, in);
    rank[b] = count + __popc(bal & lt_mask);
    pick[b] = in && rank[b] < a.k;
    count += __popc(bal);
  }
  int nbr[NB], eid[NB];
#pragma unroll
  for (int b = 0; b < NB; ++b)
    if (pick[b]) {
      nbr[b] = a.pages_nbr[off[b]];
      eid[b] = a.pages_eid[off[b]];
    }
#pragma unroll
  for (int b = 0; b < NB; ++b)
    if (pick[b]) {
      const int64_t o = (int64_t)i * a.k + rank[b];
      a.out_nbr[o] = nbr[b];
      a.out_eid[o] = eid[b];
      a.out_ts[o] = ts[b];
    }
}

__global__ void __launch_bounds__(32 * kWarpsPerBlock)
sample_recent_kernel(SampleArgs a) {
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (i >= a.n) return;                         // whole warp leaves together
  const int row = a.targets[i];
  const bool alive = a.tmask[i] && row >= 0 && row < a.n_rows;
  const float t0 = a.t_start[i], t1 = a.t_end[i];
  const int C = a.cap, K = a.k;
  const int chunks = (C + 31) >> 5;
  const unsigned lt_mask = (1u << lane) - 1u;
  int count = 0;
  for (int g = 0; g < a.scan && count < K; g += 32) {
    // lane s has slot g + s: its page id, then its [t_min, t_max]; the
    // newest page's newest chunks are loaded in the same step, before
    // it is known to hit
    int pid = NULL_ID;
    if (alive && g + lane < a.scan)
      pid = a.page_table[(int64_t)row * a.table_stride + g + lane];
    const unsigned live = __ballot_sync(FULL_MASK, pid != NULL_ID);
    if (live == 0u) continue;
    const int first = __ffs(live) - 1;
    const int64_t fbase =
        (int64_t)clamp_int(__shfl_sync(FULL_MASK, pid, first), 0,
                           a.n_pages - 1) * C;
    int64_t off[kSpec];
    float ts[kSpec];
    bool val[kSpec];
#pragma unroll
    for (int b = 0; b < kSpec; ++b) {
      const int j = C - 1 - 32 * b - lane;     // lane 0 = newest lane
      off[b] = b < chunks && j >= 0 ? fbase + j : -1;
      ts[b] = 0.f;
      val[b] = false;
      if (off[b] >= 0) {
        ts[b] = a.pages_ts[off[b]];
        val[b] = a.pages_valid[off[b]];
      }
    }
    const bool hit = pid != NULL_ID && page_hit(a, pid, t0, t1);
    const unsigned hits = __ballot_sync(FULL_MASK, hit);
    int skip = 0;                               // units already taken
    if ((hits >> first) & 1u) {
      take_recent<kSpec>(a, i, t0, t1, off, ts, val, count);
      skip = min(chunks, kSpec);
    }
    // the other hit pages, newest first, kRecentBatch (page, chunk) units
    // at a time: the lanes' ts and valid of the whole batch load together
    const int rank = __popc(hits & lt_mask);
    const int units = __popc(hits) * chunks;
    for (int u0 = skip; u0 < units && count < K; u0 += kRecentBatch) {
      int64_t boff[kRecentBatch];
      float bts[kRecentBatch];
      bool bval[kRecentBatch];
#pragma unroll
      for (int b = 0; b < kRecentBatch; ++b) {
        const int u = u0 + b;
        boff[b] = -1;
        bts[b] = 0.f;
        bval[b] = false;
        if (u < units) {                        // warp-uniform
          const int h = u / chunks;
          const int c = u - h * chunks;
          const int src =
              __ffs(__ballot_sync(FULL_MASK, hit && rank == h)) - 1;
          const int p = __shfl_sync(FULL_MASK, pid, src);
          const int j = C - 1 - 32 * c - lane;
          if (j >= 0) {
            boff[b] = (int64_t)clamp_int(p, 0, a.n_pages - 1) * C + j;
            bts[b] = a.pages_ts[boff[b]];
            bval[b] = a.pages_valid[boff[b]];
          }
        }
      }
      take_recent<kRecentBatch>(a, i, t0, t1, boff, bts, bval, count);
    }
  }
  count = min(count, K);
  for (int r = lane; r < K; r += 32) {
    const int64_t o = (int64_t)i * K + r;
    a.out_mask[o] = r < count;
    if (r >= count) {
      a.out_nbr[o] = NULL_ID;
      a.out_eid[o] = NULL_ID;
      a.out_ts[o] = 0.f;
    }
  }
}

// W warps per target, kWarpsPerBlock / W targets per CTA.  kWide (K > 32):
// each warp's reservoir is K entries in dynamic shared memory (scores of
// warp v at [v K, v K + K), then the storage indices the same way).
template <int W, bool kWide>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
sample_uniform_kernel(SampleArgs a) {
  __shared__ float m_sc[kWide ? 1 : kWarpsPerBlock * 32];
  __shared__ int m_idx[kWide ? 1 : kWarpsPerBlock * 32];
  extern __shared__ __align__(16) unsigned char dyn[];
  const int lane = threadIdx.x & 31;
  const int w = (threadIdx.x >> 5) % W;         // warp within the target
  const int grp = (threadIdx.x >> 5) / W;       // target within the CTA
  const int i = blockIdx.x * (kWarpsPerBlock / W) + grp;
  const bool in_range = i < a.n;
  const int row = in_range ? a.targets[i] : -1;
  const bool alive = in_range && a.tmask[i] && row >= 0 && row < a.n_rows;
  const float t0 = in_range ? a.t_start[i] : 0.f;
  const float t1 = in_range ? a.t_end[i] : 0.f;
  const int C = a.cap, K = a.k;
  const int chunks = (C + 31) >> 5;
  const unsigned lt_mask = (1u << lane) - 1u;
  const float* nz_row = a.noise + (int64_t)i * a.scan * C;
  // this warp's reservoir, slot `lane` (lane < K): (score, storage index
  // s*C + j), by descending score, ascending index on ties
  float r_sc = -CUDART_INF_F;
  int r_idx = INT_MAX;
  // kWide: the reservoir in shared memory, slot s at w_sc[s], w_idx[s]
  float* const t_sc = reinterpret_cast<float*>(dyn) + grp * W * K;
  int* const t_idx = reinterpret_cast<int*>(dyn) + kWarpsPerBlock * K
      + grp * W * K;
  float* const w_sc = t_sc + w * K;
  int* const w_idx = t_idx + w * K;
  if constexpr (kWide) {
    for (int s = lane; s < K; s += 32) {
      w_sc[s] = -CUDART_INF_F;
      w_idx[s] = INT_MAX;
    }
    __syncwarp();
  }
  int dealt = 0;                                // units of earlier groups
  for (int g = 0; g < a.scan; g += 32) {
    // all pages of the group in one step: lane s has slot g + s
    int pid = NULL_ID;
    bool hit = false;
    if (alive && g + lane < a.scan) {
      pid = a.page_table[(int64_t)row * a.table_stride + g + lane];
      hit = pid != NULL_ID && page_hit(a, pid, t0, t1);
    }
    const unsigned hits = __ballot_sync(FULL_MASK, hit);
    const int rank = __popc(hits & lt_mask);
    const int units = __popc(hits) * chunks;
    // this warp's units u, u + W, ..., kBatch at a time: the lanes' ts and
    // valid of the whole batch are loaded together, then the noise of
    // their in-window lanes, then the batch is merged
    for (int u0 = ((w - dealt) % W + W) % W; u0 < units;
         u0 += W * kBatch) {
      int at_s[kBatch];
      float sc[kBatch];
      bool val[kBatch];
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        const int u = u0 + b * W;
        at_s[b] = 0;
        val[b] = false;
        sc[b] = 0.f;
        if (u < units) {                        // warp-uniform
          const int h = u / chunks;
          const int c = u - h * chunks;
          const int src = __ffs(__ballot_sync(FULL_MASK, hit && rank == h))
              - 1;
          const int p = __shfl_sync(FULL_MASK, pid, src);
          at_s[b] = (g + src) * C + c * 32;     // storage index of lane 0
          const int j = c * 32 + lane;
          if (j < C) {
            const int64_t o = (int64_t)clamp_int(p, 0, a.n_pages - 1) * C + j;
            sc[b] = a.pages_ts[o];              // ts until scored
            val[b] = a.pages_valid[o];
          }
        }
      }
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        const float ts = sc[b];
        const bool in = val[b] && ts >= t0 && ts < t1;
        sc[b] = in ? nz_row[at_s[b] + lane] : -CUDART_INF_F;
      }
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        if (u0 + b * W >= units) break;
        // one ballot rejects the lanes at or below the K-th score; the
        // rest are taken lowest lane first, each checked against the K-th
        // score as it rises
        float kth;
        if constexpr (kWide)
          kth = w_sc[K - 1];
        else
          kth = __shfl_sync(FULL_MASK, r_sc, K - 1);
        unsigned pass = __ballot_sync(FULL_MASK, sc[b] > kth);
        if constexpr (kWide) {
          while (pass) {
            const int src = __ffs(pass) - 1;
            pass &= pass - 1;
            const float c_sc = __shfl_sync(FULL_MASK, sc[b], src);
            if (!(c_sc > kth)) continue;
            // position = slots scoring >= c_sc, as below
            int pos = 0;
            for (int s0 = 0; s0 < K; s0 += 32) {
              const int sl = s0 + lane;
              pos += __popc(__ballot_sync(FULL_MASK,
                                          sl < K && w_sc[sl] >= c_sc));
            }
            // shift slots pos.. K-2 up by one, the top block first; each
            // block reads all its sources before it writes
            for (int s0 = (K - 1) & ~31; s0 + 31 > pos; s0 -= 32) {
              const int sl = s0 + lane;
              const bool mv = sl > pos && sl < K;
              const float u_sc = mv ? w_sc[sl - 1] : 0.f;
              const int u_idx = mv ? w_idx[sl - 1] : 0;
              __syncwarp();
              if (mv) {
                w_sc[sl] = u_sc;
                w_idx[sl] = u_idx;
              }
              __syncwarp();
            }
            if (lane == 0) {
              w_sc[pos] = c_sc;
              w_idx[pos] = at_s[b] + src;
            }
            __syncwarp();
            kth = w_sc[K - 1];
          }
          continue;
        }
        while (pass) {
          const int src = __ffs(pass) - 1;
          pass &= pass - 1;
          const float c_sc = __shfl_sync(FULL_MASK, sc[b], src);
          if (!(c_sc > kth)) continue;
          // position = reservoir slots scoring >= c_sc: equal scores came
          // earlier in storage order, so they stay ahead
          const int pos = __popc(__ballot_sync(FULL_MASK,
                                               lane < K && r_sc >= c_sc));
          const float u_sc = __shfl_up_sync(FULL_MASK, r_sc, 1);
          const int u_idx = __shfl_up_sync(FULL_MASK, r_idx, 1);
          if (lane == pos) {
            r_sc = c_sc; r_idx = at_s[b] + src;
          } else if (lane > pos) {
            r_sc = u_sc; r_idx = u_idx;
          }
          kth = __shfl_sync(FULL_MASK, r_sc, K - 1);
        }
      }
    }
    dealt += units;
  }

  // Merge the W reservoirs.  The global top-K of the union is the top-K
  // of the union of the per-warp top-Ks; an entry's place is the number
  // of entries ahead of it by (score desc, storage index asc).
  if constexpr (kWide) {
    __syncthreads();
    const int n_ent = W * K;
    int n_live = 0;
    for (int f = 0; f < n_ent; ++f) n_live += t_sc[f] > -CUDART_INF_F;
    const int count = min(n_live, K);
    if (!in_range) return;
    for (int e = w * 32 + lane; e < n_ent; e += 32 * W) {
      const float e_sc = t_sc[e];
      if (!(e_sc > -CUDART_INF_F)) continue;
      const int e_idx = t_idx[e];
      int place = 0;
      for (int f = 0; f < n_ent; ++f) {
        const float f_sc = t_sc[f];
        place += f_sc > e_sc || (f_sc == e_sc && t_idx[f] < e_idx);
      }
      if (place < K) {
        const int pid =
            a.page_table[(int64_t)row * a.table_stride + e_idx / C];
        const int64_t src =
            (int64_t)clamp_int(pid, 0, a.n_pages - 1) * C + e_idx % C;
        const int64_t o = (int64_t)i * K + place;
        a.out_nbr[o] = a.pages_nbr[src];
        a.out_eid[o] = a.pages_eid[src];
        a.out_ts[o] = a.pages_ts[src];
        a.out_mask[o] = true;
      }
    }
    for (int e = count + w * 32 + lane; e < K; e += 32 * W) {
      const int64_t o = (int64_t)i * K + e;
      a.out_nbr[o] = NULL_ID;
      a.out_eid[o] = NULL_ID;
      a.out_ts[o] = 0.f;
      a.out_mask[o] = false;
    }
    return;
  }
  const int m0 = grp * W * 32;                   // this target's entries
  if (lane < K) {
    m_sc[m0 + w * K + lane] = r_sc;
    m_idx[m0 + w * K + lane] = r_idx;
  }
  __syncthreads();
  const int e = w * 32 + lane;                   // entry ranked by this thread
  const int n_ent = W * K;
  const bool live = e < n_ent && m_sc[m0 + e] > -CUDART_INF_F;
  const float e_sc = live ? m_sc[m0 + e] : -CUDART_INF_F;
  const int e_idx = live ? m_idx[m0 + e] : INT_MAX;
  int place = 0, n_live = 0;
  for (int f = 0; f < n_ent; ++f) {
    const float f_sc = m_sc[m0 + f];
    n_live += f_sc > -CUDART_INF_F;
    place += f_sc > e_sc || (f_sc == e_sc && m_idx[m0 + f] < e_idx);
  }
  const int count = min(n_live, K);
  if (!in_range) return;
  if (live && place < K) {
    // the pick's page id again from the page table (cached: read above)
    const int pid = a.page_table[(int64_t)row * a.table_stride + e_idx / C];
    const int64_t src =
        (int64_t)clamp_int(pid, 0, a.n_pages - 1) * C + e_idx % C;
    const int64_t o = (int64_t)i * K + place;
    a.out_nbr[o] = a.pages_nbr[src];
    a.out_eid[o] = a.pages_eid[src];
    a.out_ts[o] = a.pages_ts[src];
    a.out_mask[o] = true;
  }
  if (e >= count && e < K) {
    const int64_t o = (int64_t)i * K + e;
    a.out_nbr[o] = NULL_ID;
    a.out_eid[o] = NULL_ID;
    a.out_ts[o] = 0.f;
    a.out_mask[o] = false;
  }
}

// CTAs of the uniform kernel resident on the device at once (SM count x
// CTAs per SM), read once per device.
int uniform_wave() {
  static int cached[64];
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64) return 1;
  if (cached[dev] == 0) {
    int sms = 1, per_sm = 1;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, sample_uniform_kernel<4, false>, 32 * kWarpsPerBlock, 0);
    cached[dev] = sms * (per_sm > 0 ? per_sm : 1);
  }
  return cached[dev];
}

template <int W>
int launch_uniform(const SampleArgs& a, cudaStream_t st) {
  const int grid = (a.n + kWarpsPerBlock / W - 1) / (kWarpsPerBlock / W);
  if (a.k <= 32) {
    sample_uniform_kernel<W, false><<<grid, 32 * kWarpsPerBlock, 0, st>>>(a);
    return static_cast<int>(cudaGetLastError());
  }
  // K > 32: kWarpsPerBlock reservoirs of K (score, index) pairs
  const int smem = kWarpsPerBlock * a.k * 8;
  static int smem_set = 0;
  const cudaError_t err = allow_smem(
      reinterpret_cast<const void*>(sample_uniform_kernel<W, true>), smem,
      smem_set);
  if (err != cudaSuccess) return static_cast<int>(err);
  sample_uniform_kernel<W, true><<<grid, 32 * kWarpsPerBlock, smem, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// policy: 0 = recent, 1 = uniform.  Returns cudaGetLastError() after the
// launch (0 on success).  Requires 1 <= k; uniform with k > 32 keeps its
// reservoirs in shared memory and needs 4 k * 8 bytes of it
// (cudaErrorInvalidValue past the block's limit).
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
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (policy == 0) {
    sample_recent_kernel<<<(n + kWarpsPerBlock - 1) / kWarpsPerBlock,
                           32 * kWarpsPerBlock, 0, st>>>(a);
  } else {
    // the most warps per target that keep every target in one wave
    const int wave = uniform_wave();
    if (n <= wave) return launch_uniform<4>(a, st);
    if (n <= 2 * wave) return launch_uniform<2>(a, st);
    return launch_uniform<1>(a, st);
  }
  return static_cast<int>(cudaGetLastError());
}
