"""Temporal k-hop neighbourhood sampling (GNNFlow §4.2, Algorithm 1).

Counterpart of ``repro.core.sampling``.  Two interchangeable hops:

  * ``oracle_sample``  — trusted numpy reference walking the dynamic
                         graph's block lists exactly as Algorithm 1;
  * ``sample_khop``    — the k-hop loop over a device mirror of the
                         paged snapshot.  For tensors on the card each
                         hop is one launch of the hand-written
                         ``temporal_sample`` CUDA kernel; on the CPU it
                         is the plain hop ``_hop_plain`` (the port of
                         the JAX package's ``_hop_jnp``).

Stochastic policies (``uniform``, and ``window``, which is uniform with
``t_start = t - window``) take (N, S, C) Gumbel noise in storage lane
order, drawn per hop from a ``torch.Generator``; the CUDA kernel and the
plain hop consume the same noise, so they agree draw for draw.

Bounded work: device paths scan the newest ``scan_pages`` pages per
target; the oracle scans everything.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.dgraph import DynamicGraph, NULL
from repro_torch.core.rand import gumbel_noise
from repro_torch.core.snapshot import GraphSnapshot, build_snapshot
from repro_torch.device import resolve
from repro_torch.kernels.temporal_sample.ops import temporal_sample
from repro_torch.obs import trace

_STOCHASTIC = ("uniform", "window")


# ---------------------------------------------------------------------------
# Sampled-subgraph containers (static shapes, mask-padded)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class SampledLayer:
    """One hop: for each target i, up to K sampled temporal neighbors."""
    dst_nodes: np.ndarray | torch.Tensor    # (N,) int32
    dst_times: np.ndarray | torch.Tensor    # (N,) float32
    dst_mask: np.ndarray | torch.Tensor     # (N,) bool
    nbr_ids: np.ndarray | torch.Tensor      # (N, K) int32
    nbr_eids: np.ndarray | torch.Tensor     # (N, K) int32
    nbr_ts: np.ndarray | torch.Tensor       # (N, K) float32
    mask: np.ndarray | torch.Tensor         # (N, K) bool

    @property
    def fanout(self) -> int:
        return self.nbr_ids.shape[1]


# ---------------------------------------------------------------------------
# Oracle (numpy, exact Algorithm 1 over the block lists)
# ---------------------------------------------------------------------------


def _oracle_one(g: DynamicGraph, node: int, t_end: float, t_start: float,
                k: int, policy: str, rng: np.random.Generator
                ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    nbrs, eids, tss = g.neighbors_in_window(node, t_start, t_end)
    if len(nbrs) == 0:
        return nbrs, eids, tss
    if policy == "recent":
        return nbrs[:k], eids[:k], tss[:k]
    # uniform / window: uniform without replacement among candidates
    take = min(k, len(nbrs))
    sel = rng.choice(len(nbrs), size=take, replace=False)
    return nbrs[sel], eids[sel], tss[sel]


def oracle_sample(g: DynamicGraph, seeds: np.ndarray, seed_ts: np.ndarray,
                  fanouts: Sequence[int], policy: str = "recent",
                  window: float = 0.0, seed: int = 0
                  ) -> List[SampledLayer]:
    """Reference temporal k-hop sampling. Layer l's targets are layer
    l-1's sampled neighbors queried at their edge timestamps."""
    rng = np.random.default_rng(seed)
    targets = np.asarray(seeds, np.int64)
    times = np.asarray(seed_ts, np.float64)
    tmask = np.ones(len(targets), bool)
    layers: List[SampledLayer] = []
    for k in fanouts:
        N = len(targets)
        nbr = np.full((N, k), NULL, np.int64)
        eid = np.full((N, k), NULL, np.int64)
        ts = np.zeros((N, k), np.float64)
        msk = np.zeros((N, k), bool)
        for i in range(N):
            if not tmask[i]:
                continue
            t_end = times[i]
            t_start = t_end - window if (policy == "window" and window > 0) \
                else -np.inf
            a, b, c = _oracle_one(g, int(targets[i]), t_end, t_start, k,
                                  policy, rng)
            m = len(a)
            nbr[i, :m], eid[i, :m], ts[i, :m] = a, b, c
            msk[i, :m] = True
        layers.append(SampledLayer(
            dst_nodes=targets.astype(np.int32),
            dst_times=times.astype(np.float32), dst_mask=tmask.copy(),
            nbr_ids=nbr.astype(np.int32), nbr_eids=eid.astype(np.int32),
            nbr_ts=ts.astype(np.float32), mask=msk))
        targets = nbr.reshape(-1)
        times = ts.reshape(-1)
        tmask = msk.reshape(-1)
    return layers


# ---------------------------------------------------------------------------
# Device path (one kernel launch per hop on the card)
# ---------------------------------------------------------------------------


def _hop_plain(dev, targets, t_end, t_start, tmask, noise, *, k: int,
               policy: str, scan_pages: int):
    """One hop for N targets in plain tensor ops (the CPU path): a gather
    of the newest ``scan_pages`` pages per target, a lane flip to newest
    first, and a masked top-k on a composite score.  ``noise`` is the
    (N, scan_pages, C) storage-order Gumbel noise of the uniform policy.

    Returns (nbr (N,k), eid (N,k), ts (N,k), mask (N,k))."""
    page_table = dev["page_table"]
    pages_ts = dev["pages_ts"]
    N = targets.shape[0]
    page_cap = pages_ts.shape[1]
    in_range = (targets >= 0) & (targets < page_table.shape[0])
    safe_t = targets.clamp(0, page_table.shape[0] - 1).long()
    pt = page_table[safe_t][:, :scan_pages]               # (N, S)
    pvalid = (pt != NULL) & (tmask & in_range)[:, None]
    ptc = pt.clamp(0, pages_ts.shape[0] - 1).long()

    # page lanes, newest first within a page (pages are ascending ts);
    # the page-level t_min/t_max skip is subsumed by the per-lane tests
    nbr = dev["pages_nbr"][ptc].flip(-1)                  # (N, S, C)
    eid = dev["pages_eid"][ptc].flip(-1)
    ts = pages_ts[ptc].flip(-1)
    val = dev["pages_valid"][ptc].flip(-1)

    in_win = (val & pvalid[:, :, None]
              & (ts >= t_start[:, None, None])
              & (ts < t_end[:, None, None]))              # (N, S, C)

    W = scan_pages * page_cap
    nbr_f = nbr.reshape(N, W)
    eid_f = eid.reshape(N, W)
    ts_f = ts.reshape(N, W)
    m_f = in_win.reshape(N, W)                            # newest-first
    if policy == "recent":
        # valid lanes score by newest-first position, invalid strictly
        # below all valid ones (positions < 2^24 are exact in float32)
        idx = torch.arange(W, dtype=torch.float32, device=targets.device)
        score = torch.where(m_f, -idx[None, :], float("-inf"))
    else:
        # uniform among candidates: Gumbel top-k == sampling w/o
        # replacement; the noise follows the lanes into newest-first order
        score = torch.where(m_f, noise.flip(-1).reshape(N, W),
                            float("-inf"))
    if W < k:   # degenerate tiny snapshot: pad the candidate window
        pad = lambda x, v: torch.nn.functional.pad(x, (0, k - W), value=v)
        nbr_f, eid_f, ts_f = pad(nbr_f, NULL), pad(eid_f, NULL), \
            pad(ts_f, 0.0)
        m_f, score = pad(m_f, False), pad(score, float("-inf"))
    order = torch.topk(score, k, dim=-1).indices

    take = lambda x: x.gather(1, order)
    out_m = take(m_f)
    return (torch.where(out_m, take(nbr_f), NULL),
            torch.where(out_m, take(eid_f), NULL),
            torch.where(out_m, take(ts_f), 0.0), out_m)


def _hop(dev, targets, t_end, t_start, tmask, noise, *, k: int,
         policy: str, scan_pages: int):
    if dev["page_table"].is_cuda:
        return temporal_sample(
            dev["page_table"], dev["page_tmin"], dev["page_tmax"],
            dev["pages_nbr"], dev["pages_eid"], dev["pages_ts"],
            dev["pages_valid"], targets, t_end, t_start, tmask, k=k,
            policy=policy, noise=noise, scan=scan_pages)
    return _hop_plain(dev, targets, t_end, t_start, tmask, noise, k=k,
                      policy=policy, scan_pages=scan_pages)


def _khop_impl(dev, seeds, seed_ts, tmask0, generator, *,
               fanouts: Tuple[int, ...], policy: str, window: float,
               scan_pages: int):
    """The k-hop loop: intermediate targets/times/masks stay on the
    device.  Returns a tuple of per-hop layer tuples
    (dst_nodes, dst_times, dst_mask, nbr, eid, ts, mask)."""
    targets, times, tmask = seeds, seed_ts, tmask0
    pol = "uniform" if policy == "window" else policy
    cap = dev["pages_ts"].shape[1]
    layers = []
    for k in fanouts:
        t_end = times
        if policy == "window" and window > 0:
            t_start = times - window
        else:
            t_start = torch.full_like(times, float("-inf"))
        noise = None
        if policy in _STOCHASTIC:
            noise = gumbel_noise(generator, (targets.shape[0], scan_pages,
                                             cap), targets.device)
        nbr, eid, ts, m = _hop(dev, targets, t_end, t_start, tmask, noise,
                               k=k, policy=pol, scan_pages=scan_pages)
        layers.append((targets, times, tmask, nbr, eid, ts, m))
        targets, times, tmask = (nbr.reshape(-1), ts.reshape(-1),
                                 m.reshape(-1))
    return tuple(layers)


def _as(x, dtype, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype)
    np_dtype = {torch.int32: np.int32, torch.float32: np.float32,
                torch.bool: np.bool_}[dtype]
    return torch.from_numpy(np.array(x, np_dtype, ndmin=1)).to(device)


class DeviceMirror:
    """Device-resident mirror of a :class:`GraphSnapshot`.

    Shared by ``TemporalSampler`` and the serving wing's publisher (delta
    scatter when the snapshot's delta chains from the mirrored version,
    full upload otherwise):

    * ``donate=True`` (a single-consumer sampler): scatters write the
      mirror's tensors in place (``index_put_``), so only one consumer
      may hold the returned dict at a time;
    * ``donate=False`` (the serving wing): every ``sync`` that changes
      anything returns a FRESH dict whose changed arrays are fresh
      tensors (copy-on-write at array granularity) — a reader holding a
      previously returned dict keeps a complete, immutable view of that
      version, which is what a versioned query handle pins.

    Uploads always copy: ``torch.from_numpy`` would alias the snapshot's
    host arrays, which ``refresh_snapshot`` mutates in place between
    versions, and on the CPU an aliased mirror would change under a
    pinned handle.  The page descriptors ``page_tmin``/``page_tmax``
    (read by the kernel's page skip) are always mirrored.
    """

    #: pad fill per device array — quantized uploads extend each array
    #: with entries no sampler ever dereferences
    _FILL = dict(page_table=NULL, pages_nbr=NULL, pages_eid=NULL,
                 pages_ts=np.inf, pages_valid=False,
                 page_tmin=np.inf, page_tmax=-np.inf)

    def __init__(self, *, scan_pages: int, donate: bool = True,
                 quantize: bool = False, device=None):
        self.scan_pages = int(scan_pages)
        self.donate = donate
        # quantize=True rounds every device array's leading dimension up
        # to a power of two and pins the page-table width at scan_pages,
        # so the mirrored shapes change O(log n) times as the graph grows
        self.quantize = quantize
        self.device = resolve(device)
        self.dev: Optional[dict] = None   # current device tensors
        self.version = -1                 # snapshot version mirrored
        self.snap_obj = None              # snapshot object mirrored
        self.last_refresh_bytes = 0       # H2D payload of the last sync
        self.total_refresh_bytes = 0

    def _upload(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(
            self.device, copy=True)

    def _target_shape(self, name: str, host: np.ndarray) -> tuple:
        if not self.quantize:
            return host.shape
        rows = 1 << max(3, int(host.shape[0] - 1).bit_length())
        if name == "page_table":
            return (rows, self.scan_pages)
        return (rows,) + host.shape[1:]

    def _quantized(self, name: str, host: np.ndarray) -> np.ndarray:
        tgt = self._target_shape(name, host)
        if tgt == host.shape:
            return host
        out = np.full(tgt, self._FILL[name], host.dtype)
        out[tuple(slice(0, s) for s in host.shape)] = host
        return out

    def _table_cols(self, snap: GraphSnapshot) -> int:
        """Samplers never read past the scan_pages-newest pages, so the
        mirror holds only that prefix of the page table."""
        return min(self.scan_pages, snap.page_table.shape[1])

    def _host_arrays(self, snap: GraphSnapshot) -> dict:
        return dict(
            page_table=snap.page_table[:, :self._table_cols(snap)],
            pages_nbr=snap.nbr, pages_eid=snap.eid, pages_ts=snap.ts,
            pages_valid=snap.valid, page_tmin=snap.page_tmin,
            page_tmax=snap.page_tmax)

    def _upload_full(self, snap: GraphSnapshot) -> None:
        host = self._host_arrays(snap)
        self.dev = {name: self._upload(self._quantized(name, a))
                    for name, a in host.items()}
        self.last_refresh_bytes += sum(a.nbytes for a in host.values())

    def _scatter(self, name: str, host: np.ndarray, rows: np.ndarray,
                 lanes: Optional[np.ndarray] = None) -> None:
        """Mirror the changed entries of ``host``: whole rows, or
        (row, lane) cells when ``lanes`` is given.  Reallocated host
        arrays and deltas covering most of the buffer re-upload the
        array.  The delta's row (and cell) lists are duplicate-free."""
        buf = self.dev[name]
        n = len(rows)
        denom = host.shape[0] if lanes is None else host.size
        tgt = self._target_shape(name, host)
        if tuple(buf.shape) == tgt and n == 0:
            return
        if tuple(buf.shape) != tgt or n * 2 >= denom:
            self.dev[name] = self._upload(self._quantized(name, host))
            self.last_refresh_bytes += host.nbytes
            return
        if not self.donate:
            buf = buf.clone()          # copy-on-write: pinned readers
        rows_t = torch.from_numpy(np.asarray(rows, np.int64)).to(
            self.device)
        if lanes is None:
            upd = host[rows]
            if upd.ndim == 2 and buf.shape[1] != upd.shape[1]:
                # quantized page-table width: pad the gathered rows out
                wide = np.full((n, buf.shape[1]), self._FILL[name],
                               host.dtype)
                wide[:, :upd.shape[1]] = upd
                upd = wide
            buf[rows_t] = self._upload(upd)
            self.last_refresh_bytes += upd.nbytes + n * 4
        else:
            lanes_t = torch.from_numpy(np.asarray(lanes, np.int64)).to(
                self.device)
            upd = host[rows, lanes]
            buf[rows_t, lanes_t] = self._upload(upd)
            self.last_refresh_bytes += upd.nbytes + n * 8
        self.dev[name] = buf

    def sync(self, snap: GraphSnapshot) -> dict:
        """Bring the mirror to ``snap``'s version; returns the device
        dict reflecting exactly that version."""
        if (self.dev is not None and self.snap_obj is snap
                and self.version == snap.version):
            self.last_refresh_bytes = 0   # in sync: nothing transferred
            return self.dev
        self.last_refresh_bytes = 0
        d = snap.delta
        if (self.dev is None or d is None or d.full
                or self.snap_obj is not snap
                or d.base_version != self.version):
            self._upload_full(snap)
        else:
            if not self.donate:
                # fresh dict per version: readers of the previous dict
                # (pinned query handles) keep the old tensors
                self.dev = dict(self.dev)
            self._scatter("page_table",
                          snap.page_table[:, :self._table_cols(snap)],
                          d.table_rows)
            for name, host in (("pages_nbr", snap.nbr),
                               ("pages_eid", snap.eid),
                               ("pages_ts", snap.ts),
                               ("pages_valid", snap.valid)):
                self._scatter(name, host, d.cell_rows, d.cell_lanes)
            # deletions/offloads flip validity outside the appended
            # cells: those pages re-upload their (small) validity rows
            self._scatter("pages_valid", snap.valid, d.valid_rows)
            self._scatter("page_tmin", snap.page_tmin, d.page_rows)
            self._scatter("page_tmax", snap.page_tmax, d.page_rows)
        self.version = snap.version
        self.snap_obj = snap
        self.total_refresh_bytes += self.last_refresh_bytes
        return self.dev


def sample_khop(dev: dict, seeds, seed_ts, *, fanouts: Sequence[int],
                policy: str = "recent", window: float = 0.0,
                scan_pages: int = 16,
                generator: Optional[torch.Generator] = None
                ) -> List[SampledLayer]:
    """k-hop sampling against an explicit device mirror dict (the
    serving read path samples a *pinned* handle's tensors).  Seeds and
    times may be numpy arrays or tensors; every result lives on the
    mirror's device.  ``generator`` (on that device) drives the
    stochastic policies; None means a generator seeded with 0."""
    device = dev["page_table"].device
    targets = _as(seeds, torch.int32, device)
    times = _as(seed_ts, torch.float32, device)
    tmask = torch.ones(targets.shape, dtype=torch.bool, device=device)
    if generator is None and policy in _STOCHASTIC:
        generator = torch.Generator(device=device).manual_seed(0)
    scan = min(int(scan_pages), dev["page_table"].shape[1])
    raw = _khop_impl(dev, targets, times, tmask, generator,
                     fanouts=tuple(int(f) for f in fanouts),
                     policy=policy, window=float(window), scan_pages=scan)
    return [SampledLayer(*h) for h in raw]


class TemporalSampler:
    """The paper's sampler: recent / uniform / window policies, k-hop,
    over a persistent device mirror (in-place delta scatters)."""

    def __init__(self, g_or_snap, fanouts: Sequence[int],
                 policy: str = "recent", window: float = 0.0,
                 scan_pages: int = 16, seed: int = 0, device=None):
        if isinstance(g_or_snap, DynamicGraph):
            self.snap = build_snapshot(g_or_snap)
        else:
            self.snap = g_or_snap
        self.fanouts = tuple(int(f) for f in fanouts)
        if policy not in ("recent", "uniform", "window"):
            raise ValueError(f"unknown sampling policy {policy!r}")
        self.policy = policy
        self.window = float(window)
        self.scan_pages = int(scan_pages)
        self.device = resolve(device)
        self.seed = int(seed)
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        self._mirror = DeviceMirror(scan_pages=self.scan_pages,
                                    donate=True, device=self.device)

    def refresh(self, snap: GraphSnapshot) -> None:
        """Adopt a refreshed snapshot and sync the device mirror."""
        with trace.span("sampler.refresh") as sp:
            self.snap = snap
            self._sync_device()
            sp.set(bytes=self.last_refresh_bytes)

    @property
    def last_refresh_bytes(self) -> int:
        return self._mirror.last_refresh_bytes

    def _sync_device(self) -> dict:
        return self._mirror.sync(self.snap)

    def sample(self, seeds, seed_ts) -> List[SampledLayer]:
        """k-hop sampling; one SampledLayer per fanout entry."""
        with trace.span("sampler.sample", seeds=len(seeds)):
            dev = self._sync_device()
            targets = _as(seeds, torch.int32, self.device)
            times = _as(seed_ts, torch.float32, self.device)
            tmask = torch.ones(targets.shape, dtype=torch.bool,
                               device=self.device)
            scan = min(self.scan_pages, dev["page_table"].shape[1])
            return [SampledLayer(*h) for h in _khop_impl(
                dev, targets, times, tmask, self._gen, fanouts=self.fanouts,
                policy=self.policy, window=self.window, scan_pages=scan)]

    def request_key(self, req_machine: int, seq: int, hop: int
                    ) -> Optional[int]:
        """Order-independent RNG key for one served stochastic hop: a
        deterministic mix of (this sampler's seed, requesting machine,
        that requester's request seq, hop index).  The serving sampler
        is already (machine, rank)-seeded, so the full request
        coordinate determines the draw and concurrent requesters cannot
        perturb each other's.  The JAX package folds the same
        coordinate into a threefry key, a stream torch cannot replay, so
        the draws differ from JAX's while keeping its order
        independence.  Returns None for the deterministic ``recent``
        policy."""
        if self.policy not in _STOCHASTIC:
            return None
        mix = np.random.SeedSequence([self.seed, int(req_machine),
                                      int(seq), int(hop)])
        return int(mix.generate_state(1, np.uint64)[0] >> np.uint64(1))

    def sample_hop(self, targets, times, tmask, k: int, key=None):
        """One hop for (padded) targets; returns (nbr, eid, ts, mask) on
        the sampler's device.  ``key`` (from :meth:`request_key`) seeds
        the hop's Gumbel noise in place of the sampler's own stream."""
        dev = self._sync_device()
        gen = self._gen
        if key is not None:
            gen = torch.Generator(device=self.device).manual_seed(key)
        scan = min(self.scan_pages, dev["page_table"].shape[1])
        [(_, _, _, nbr, eid, ts, m)] = _khop_impl(
            dev, _as(targets, torch.int32, self.device),
            _as(times, torch.float32, self.device),
            _as(tmask, torch.bool, self.device), gen, fanouts=(int(k),),
            policy=self.policy, window=self.window, scan_pages=scan)
        return nbr, eid, ts, m
