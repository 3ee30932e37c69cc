"""Vectorized dynamic device feature cache (GNNFlow §4.3).

Counterpart of ``repro.core.feature_cache``, with the same state and
policies:

  * one *score* per slot; a batch update decrements every occupied score
    (LRU) and resets accessed slots to 0 (LRU) or increments them
    (LFU); FIFO keeps a ring pointer (``clock``);
  * eviction = the R lowest-score slots, ties broken by the lower slot
    index exactly as ``lax.top_k`` breaks them (a stable sort);
  * each update replaces at most ``lambda * capacity`` slots;
  * cache reuse across rounds and restoration at each epoch start.

On the card the lookup is the hand-written ``cache_gather`` kernel;
on the CPU its plain version.  Unlike the JAX state, which is rebuilt
by every update, :func:`cache_update` writes the state's tensors in
place: every tensor handed out (lookups, fetches, round snapshots,
``save_host`` blobs) is a copy, so no reader sees a later update.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import resolve
from repro_torch.kernels.cache_gather.ops import cache_gather
from repro_torch.obs.metrics import MetricRegistry

NULL = -1
_NEG = int(np.iinfo(np.int32).min // 2)
_FIELDS = ("slot_of", "ids", "score", "feats", "clock")


@dataclasses.dataclass
class CacheState:
    slot_of: torch.Tensor    # (M,) int32: id -> slot | -1
    ids: torch.Tensor        # (C,) int32: slot -> id | -1
    score: torch.Tensor      # (C,) int32: policy score
    feats: torch.Tensor      # (C, D)
    clock: torch.Tensor      # () int32 (FIFO insertion counter)

    def clone(self) -> "CacheState":
        return CacheState(*(getattr(self, f).clone() for f in _FIELDS))


def init_cache(capacity: int, dim: int, id_space: int, *, device,
               dtype=torch.float32) -> CacheState:
    i32 = dict(dtype=torch.int32, device=device)
    return CacheState(
        slot_of=torch.full((id_space,), NULL, **i32),
        ids=torch.full((capacity,), NULL, **i32),
        score=torch.full((capacity,), _NEG, **i32),  # empty = worst
        feats=torch.zeros((capacity, dim), dtype=dtype, device=device),
        clock=torch.zeros((), **i32),
    )


def cache_lookup(state: CacheState, ids: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """ids: (N,) int32 (NULL entries miss). Returns (feats (N,D), hit)."""
    return cache_gather(state.slot_of, state.ids, state.feats, ids)


def _dedup_first(ids: torch.Tensor) -> torch.Tensor:
    """Mask selecting the first occurrence of each id (NULLs excluded)."""
    order = torch.sort(ids, stable=True).indices
    sorted_ids = ids[order]
    first = torch.ones_like(sorted_ids, dtype=torch.bool)
    first[1:] = sorted_ids[1:] != sorted_ids[:-1]
    first &= sorted_ids != NULL
    mask = torch.zeros_like(first)
    mask[order] = first              # a permutation: no duplicate writes
    return mask


def cache_update(state: CacheState, ids: torch.Tensor, hit: torch.Tensor,
                 miss_feats: torch.Tensor, *, policy: str,
                 max_replace: int) -> CacheState:
    """Batch access bookkeeping + bounded insertion of missed entries,
    in place on ``state`` (returned for convenience).

    ids: (N,) accessed ids; hit: (N,) from cache_lookup; miss_feats:
    (N, D) feature rows for missed ids (ignored where hit).  At most
    ``max_replace`` (= ceil(lambda*C)) distinct misses are inserted,
    evicting the lowest-score slots.  Every scatter writes only valid,
    duplicate-free indices (the JAX version's ``mode="drop"`` lanes are
    filtered out), so the result is deterministic on the card."""
    C = state.ids.shape[0]
    R = max_replace
    device = state.ids.device
    ids = ids.to(torch.int32)
    score = state.score

    safe = ids.clamp(0, state.slot_of.shape[0] - 1).long()
    slot = state.slot_of[safe].clamp(0, C - 1).long()

    # ---- access bookkeeping on hits ----
    if policy == "lru":
        score = torch.where(state.ids != NULL, score - 1, score)
        touched = torch.where(hit, 0, _NEG).to(torch.int32)
        score = score.scatter_reduce(0, slot, touched, reduce="amax",
                                     include_self=True)
    elif policy == "lfu":
        score = score.scatter_add(0, slot, hit.to(torch.int32))
    # fifo: no access bookkeeping

    # ---- choose up to max_replace distinct misses ----
    miss_ids = torch.where(hit, NULL, ids)
    first = _dedup_first(miss_ids)
    rank = torch.cumsum(first.to(torch.int32), 0) - 1
    chosen = first & (rank < R)
    n_new = int(chosen.sum())        # the insert block's valid prefix
    # chosen lanes in index order (jnp.nonzero(size=R) without the fill)
    cand_idx = torch.sort((~chosen).to(torch.uint8), stable=True).indices[
        :n_new]
    new_ids = ids[cand_idx]
    new_feats = miss_feats[cand_idx].to(state.feats.dtype)

    # ---- eviction targets ----
    if policy == "fifo":
        # ring buffer: the next n_new slots after the pointer
        evict = (state.clock.long() + torch.arange(n_new, device=device)
                 ) % C
        clock = state.clock + n_new
    else:
        # the R lowest-score slots, lower slot index first on ties
        evict = torch.sort(score, stable=True).indices[:R][:n_new]
        clock = state.clock + 1

    # ---- apply: unmap old, map new, write ids/feats/scores ----
    old_ids = state.ids[evict]
    old_ids = old_ids[old_ids != NULL].long()
    state.slot_of[old_ids] = NULL
    state.slot_of[new_ids.long()] = evict.to(torch.int32)
    state.ids[evict] = new_ids
    state.feats[evict] = new_feats
    score[evict] = 1 if policy == "lfu" else 0   # lru: most recent
    state.score = score
    state.clock = clock.to(torch.int32)
    return state


class FeatureCache:
    """Host wrapper: lookup/update + reuse & restoration (§4.3)."""

    def __init__(self, capacity: int, dim: int, id_space: int, *,
                 policy: str = "lru", lam: float = 0.2,
                 dtype=torch.float32, device=None,
                 metrics: Optional[MetricRegistry] = None,
                 name: str = "cache"):
        if policy not in ("lru", "lfu", "fifo"):
            raise ValueError(f"unknown cache policy {policy!r}")
        self.capacity = int(capacity)
        self.dim = int(dim)
        self.policy = policy
        self.max_replace = max(1, int(np.ceil(lam * capacity)))
        self.device = resolve(device)
        self.state = init_cache(capacity, dim, id_space,
                                device=self.device, dtype=dtype)
        self.metrics = metrics if metrics is not None else MetricRegistry()
        self.name = name
        self._c_hits = self.metrics.counter(f"{name}.hits")
        self._c_accesses = self.metrics.counter(f"{name}.accesses")
        self._c_bypassed = self.metrics.counter(f"{name}.bypassed")
        self._c_inserted = self.metrics.counter(f"{name}.inserted")
        self._c_invalidated = self.metrics.counter(f"{name}.invalidated")
        # hit mask of the latest fetch(), aligned with its `ids` arg
        self.last_hit: Optional[np.ndarray] = None
        self._round_snapshot: Optional[CacheState] = None

    def _ids(self, ids) -> torch.Tensor:
        if isinstance(ids, torch.Tensor):
            return ids.to(device=self.device, dtype=torch.int32)
        return torch.from_numpy(np.array(ids, np.int32, ndmin=1)).to(
            self.device)

    # -- core ops ------------------------------------------------------
    def lookup(self, ids) -> Tuple[torch.Tensor, torch.Tensor]:
        ids = self._ids(ids)
        feats, hit = cache_lookup(self.state, ids)
        valid = ids.cpu().numpy() >= 0
        self._c_accesses.add(int(valid.sum()))
        self._c_hits.add(int(hit.cpu().numpy()[valid].sum()))
        return feats, hit

    def update(self, ids, hit, miss_feats) -> None:
        if not isinstance(miss_feats, torch.Tensor):
            miss_feats = torch.from_numpy(np.asarray(miss_feats))
        cache_update(self.state, self._ids(ids), hit.to(self.device),
                     miss_feats.to(self.device), policy=self.policy,
                     max_replace=self.max_replace)

    def invalidate(self, ids) -> int:
        """Drop the listed ids from the cache (write coherence): ingest
        calls this for every id it (re)writes.  Vacated slots get the
        worst policy score so they are refilled first.  Returns the
        number of rows dropped."""
        present = self.probe(ids)
        if not present.any():
            return 0
        hot = np.unique(np.asarray(ids, np.int64)[present])
        slots = self.state.slot_of.cpu().numpy()[hot]
        slots_t = torch.from_numpy(slots.astype(np.int64)).to(self.device)
        hot_t = torch.from_numpy(hot).to(self.device)
        self.state.ids[slots_t] = NULL
        self.state.score[slots_t] = _NEG
        self.state.slot_of[hot_t] = NULL
        self._c_invalidated.add(len(hot))
        return len(hot)

    def probe(self, ids) -> np.ndarray:
        """Host-side membership test: True where the id is currently
        cached.  No stats, no policy bookkeeping.  Reads the whole
        ``slot_of`` map to the host (4 bytes per id of the id space)."""
        ids = np.asarray(ids, np.int64)
        slot_of = self.state.slot_of.cpu().numpy()
        sids = self.state.ids.cpu().numpy()
        safe = np.clip(ids, 0, len(slot_of) - 1)
        slot = slot_of[safe]
        ok = (ids >= 0) & (ids < len(slot_of)) & (slot >= 0)
        return ok & (sids[np.clip(slot, 0, len(sids) - 1)] == ids)

    def fetch(self, ids, fetch_missing, cacheable=None) -> torch.Tensor:
        """lookup -> host-fetch misses via `fetch_missing(ids)` -> update.
        Returns the full (N, D) feature block on the cache's device.

        ``cacheable`` (optional bool mask over ``ids``): False rows are
        fetched through but never inserted, and the hit/access counters
        only cover True rows.

        Request lengths are padded to the next power of two with NULL ids
        (at least 8), as in the JAX version; the padding reaches the
        cache state's bookkeeping but never the returned rows."""
        n = len(ids)
        ids_np = np.asarray(ids, np.int32)
        bucket = max(8, 1 << int(np.ceil(np.log2(max(n, 1)))))
        if bucket != n:
            ids_pad = np.full(bucket, NULL, np.int32)
            ids_pad[:n] = ids_np
        else:
            ids_pad = ids_np
        if cacheable is not None:
            ok = np.zeros(bucket, bool)
            ok[:n] = np.asarray(cacheable, bool)
        else:
            ok = None
        ids_t = self._ids(ids_pad)
        feats, hit = cache_lookup(self.state, ids_t)
        hit_np = hit.cpu().numpy()
        counted = (ids_pad >= 0) if ok is None else ok
        self._c_accesses.add(int(counted.sum()))
        self._c_hits.add(int(hit_np[counted].sum()))
        if ok is not None:
            self._c_bypassed.add(int(((ids_pad >= 0) & ~ok).sum()))
        need = (~hit_np) & (ids_pad >= 0)
        miss_np = np.zeros((bucket, self.dim), np.float32)
        if need.any():
            miss_np[need] = fetch_missing(ids_pad[need])
        miss = torch.from_numpy(miss_np).to(self.device)
        out = torch.where(hit[:, None], feats, miss)
        if ok is None:
            ins_mask = need
            self.update(ids_t, hit, miss)
        else:
            # non-cacheable lanes become NULL so the update never
            # spends a slot (or an eviction) on them
            ins_mask = need & ok
            self.update(np.where(ok, ids_pad, NULL), hit, miss)
        if ins_mask.any():
            self._c_inserted.add(
                min(len(np.unique(ids_pad[ins_mask])), self.max_replace))
        self.last_hit = hit_np[:n]
        return out[:n]

    # -- reuse & restoration (§4.3) -------------------------------------
    def snapshot_round(self) -> None:
        """Call at round start: snapshot for per-epoch restoration."""
        self._round_snapshot = self.state.clone()

    def restore_epoch(self) -> None:
        """Call at each epoch start: undo intra-round pollution."""
        if self._round_snapshot is not None:
            self.state = self._round_snapshot.clone()

    def save_host(self) -> Dict[str, np.ndarray]:
        """Cross-round reuse: export to host memory / disk."""
        return {k: getattr(self.state, k).cpu().numpy().copy()
                for k in _FIELDS}

    @classmethod
    def load_host(cls, blob: Dict[str, np.ndarray], **kw) -> "FeatureCache":
        c = cls(capacity=len(blob["ids"]), dim=blob["feats"].shape[1],
                id_space=len(blob["slot_of"]), **kw)
        c.state = CacheState(**{
            k: torch.from_numpy(np.array(blob[k], copy=True)).to(c.device)
            for k in _FIELDS})
        return c

    # -- stats ----------------------------------------------------------
    @property
    def hits(self) -> int:
        return int(self._c_hits.value)

    @property
    def accesses(self) -> int:
        return int(self._c_accesses.value)

    @property
    def bypassed(self) -> int:
        return int(self._c_bypassed.value)

    @property
    def hit_rate(self) -> float:
        return self.hits / max(self.accesses, 1)

    def reset_stats(self) -> None:
        for c in (self._c_hits, self._c_accesses, self._c_bypassed):
            c.reset()

    def contents(self) -> set:
        ids = self.state.ids.cpu().numpy()
        return set(ids[ids != NULL].tolist())
