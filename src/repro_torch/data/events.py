"""Synthetic CTDG event streams (Reddit/GDELT-like shape parameters).

Power-law degrees via pareto node weights with arbitrary id assignment
(matches the identity-hash partitioning assumption, §4.4). Optional
concept drift: node popularity re-draws over time, so continuous
retraining has something real to adapt to (used by bench_continuous).
Node/edge features are deterministic functions of ids (splittable across
partitions without communication).
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Optional, Tuple

import numpy as np


def _community_of(ids: np.ndarray, seed: int, n_comm: int) -> np.ndarray:
    """Deterministic node -> community map (shared by the generator and
    the feature functions, so features carry the learnable signal)."""
    h = (np.asarray(ids, np.int64) * 2654435761 + seed * 97) % (2 ** 31)
    return h % max(n_comm, 1)


@dataclasses.dataclass
class EventStream:
    src: np.ndarray          # (E,) int64
    dst: np.ndarray          # (E,) int64
    ts: np.ndarray           # (E,) float64, non-decreasing
    n_nodes: int
    d_node: int
    d_edge: int
    bipartite: bool = False
    seed: int = 0
    n_communities: int = 1
    # per-event edge ids, attached by the trainers after ingest assigns
    # them.  Explicit ids survive replay thinning and timestamp ties —
    # the ts->eid search they replace mapped tied timestamps that
    # straddle a batch boundary to the FIRST tied event's id, feeding
    # wrong edge features into TGN raw messages.  None until ingest.
    eid: Optional[np.ndarray] = None

    def __len__(self) -> int:
        return len(self.src)

    def with_eids(self, eids: np.ndarray) -> "EventStream":
        """Same events, with their ingest-assigned edge ids attached."""
        assert len(eids) == len(self.src), (len(eids), len(self.src))
        return dataclasses.replace(
            self, eid=np.asarray(eids, np.int64))

    def slice(self, lo: int, hi: int) -> "EventStream":
        return EventStream(self.src[lo:hi], self.dst[lo:hi],
                           self.ts[lo:hi], self.n_nodes, self.d_node,
                           self.d_edge, self.bipartite, self.seed,
                           self.n_communities,
                           None if self.eid is None else self.eid[lo:hi])

    # deterministic feature generators (id -> vector), usable per shard
    def node_features(self, ids: np.ndarray) -> np.ndarray:
        ids = np.asarray(ids, np.int64)
        rng_mat = _feature_basis(self.seed, self.d_node)
        phase = ids[:, None] * rng_mat[None, :]
        feat = np.sin(phase)
        if self.n_communities > 1:
            comm = _community_of(ids, self.seed, self.n_communities)
            feat = feat + 0.7 * np.cos((comm[:, None] + 1.0)
                                       * rng_mat[None, :])
        return feat.astype(np.float32)

    def edge_features(self, eids: np.ndarray) -> np.ndarray:
        eids = np.asarray(eids, np.int64)
        rng_mat = _feature_basis(self.seed + 1, self.d_edge)
        phase = (eids[:, None] + 0.5) * rng_mat[None, :]
        return np.cos(phase).astype(np.float32)


def _feature_basis(seed: int, dim: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.uniform(0.1, 2.0, dim)


def synth_ctdg(n_nodes: int = 2000, n_events: int = 50_000,
               t_span: float = 100_000.0, d_node: int = 32,
               d_edge: int = 16, alpha: float = 1.5,
               bipartite: bool = False, drift_every: float = 0.0,
               n_communities: int = 8, affinity: float = 0.9,
               seed: int = 0) -> EventStream:
    """Power-law CTDG with community structure: with prob `affinity` a
    destination is drawn from the source's community (gives link
    prediction a learnable neighborhood-overlap signal). With
    drift_every > 0, node weights re-draw every drift_every time units
    (concept drift)."""
    rng = np.random.default_rng(seed)
    ts = np.sort(rng.uniform(0, t_span, n_events))

    if bipartite:
        n_u = n_nodes // 2
        u_ids = np.arange(n_u)
        i_ids = np.arange(n_u, n_nodes)
    else:
        u_ids = i_ids = np.arange(n_nodes)

    comm = _community_of(np.arange(n_nodes), seed, n_communities)

    def draw_weights(r):
        wu = r.pareto(alpha, len(u_ids)) + 1
        wi = r.pareto(alpha, len(i_ids)) + 1
        return wu / wu.sum(), wi / wi.sum()

    def draw_block(r, count, pu, pi):
        s = r.choice(u_ids, count, p=pu)
        d = r.choice(i_ids, count, p=pi)
        if n_communities > 1 and affinity > 0:
            # redirect most edges into the source's community
            within = r.random(count) < affinity
            for c in range(n_communities):
                sel = within & (comm[s] == c)
                pool = i_ids[comm[i_ids] == c]
                if sel.any() and len(pool):
                    wi = pi[np.searchsorted(i_ids, pool)]
                    wi = wi / wi.sum()
                    d[sel] = r.choice(pool, int(sel.sum()), p=wi)
        return s, d

    src = np.empty(n_events, np.int64)
    dst = np.empty(n_events, np.int64)
    if drift_every <= 0:
        pu, pi = draw_weights(rng)
        src[:], dst[:] = draw_block(rng, n_events, pu, pi)
    else:
        epoch_of = (ts // drift_every).astype(np.int64)
        for ep in np.unique(epoch_of):
            sel = epoch_of == ep
            r = np.random.default_rng(seed * 7919 + int(ep))
            pu, pi = draw_weights(r)
            src[sel], dst[sel] = draw_block(r, int(sel.sum()), pu, pi)

    return EventStream(src=src, dst=dst, ts=ts, n_nodes=n_nodes,
                       d_node=d_node, d_edge=d_edge, bipartite=bipartite,
                       seed=seed, n_communities=n_communities)


def incremental_batches(stream: EventStream, interval: float
                        ) -> Iterator[EventStream]:
    """Split a stream into time-interval ingestion batches (paper §3)."""
    if len(stream) == 0:
        return
    t0 = stream.ts[0]
    lo = 0
    while lo < len(stream):
        hi = int(np.searchsorted(stream.ts, t0 + interval, side="left"))
        hi = max(hi, lo + 1)
        yield stream.slice(lo, hi)
        lo = hi
        t0 = stream.ts[min(hi, len(stream) - 1)]
