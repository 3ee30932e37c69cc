"""Online hash partitioning + edge dispatch (GNNFlow §4.4).

Edge-cut model: node n lives on machine ``hash(n) % P`` with the identity
hash (paper's choice: computation-free, and node ids being arbitrary makes
it edge-balanced for power-law graphs — validated in bench/tests). Each
partition owns a DynamicGraph holding the edges incident to its nodes
(undirected edges are dispatched to BOTH endpoint owners, directed to the
source owner) and the feature shards for its nodes/edges.

``Dispatcher`` is the ingestion front-end: it splits each incremental
event batch by owner and forwards sub-batches (the paper does this with
async RPC; in-container the partitions are in-process objects and the
transfer is byte-accounted — DESIGN.md §2).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core.dgraph import DynamicGraph


def owner_of(nodes: np.ndarray, n_parts: int) -> np.ndarray:
    """Identity-hash edge-cut partition assignment."""
    return np.asarray(nodes, np.int64) % n_parts


@dataclasses.dataclass
class PartitionStats:
    edges_per_part: List[int]
    nodes_per_part: List[int]
    bytes_dispatched: int
    edge_balance_cv: float


class GraphPartition:
    """One machine's shard: local dynamic graph + ownership test."""

    def __init__(self, part_id: int, n_parts: int, **dg_kwargs):
        self.part_id = part_id
        self.n_parts = n_parts
        self.graph = DynamicGraph(**dg_kwargs)
        self.local_edges = 0

    def owns(self, nodes: np.ndarray) -> np.ndarray:
        return owner_of(nodes, self.n_parts) == self.part_id

    def add_edges(self, src, dst, ts, eids) -> None:
        self.graph.add_edges(np.asarray(src), np.asarray(dst),
                             np.asarray(ts), np.asarray(eids))
        self.local_edges += len(src)


class Dispatcher:
    """Ingestion path: partition each incremental batch and forward.

    ``partitions`` are the shards hosted in this process; ``n_parts``
    names the GLOBAL partition count when they differ (a multihost
    worker hosts exactly one shard but must split batches over all P
    owners — remote sub-batches are byte-accounted and dropped, their
    owner process applies them from its own copy of the stream).  Edge
    ids are assigned deterministically from the batch order, so every
    process derives the same global ids without coordination."""

    def __init__(self, partitions: Sequence[GraphPartition],
                 undirected: bool = False,
                 n_parts: Optional[int] = None):
        self.partitions = list(partitions)
        self._local = {p.part_id: p for p in self.partitions}
        self._n_parts = (n_parts if n_parts is not None
                         else len(self.partitions))
        self.undirected = undirected
        self.bytes_dispatched = 0
        self._next_eid = 0

    @property
    def n_parts(self) -> int:
        return self._n_parts

    def add_edges(self, src, dst, ts) -> np.ndarray:
        src = np.asarray(src, np.int64)
        dst = np.asarray(dst, np.int64)
        ts = np.asarray(ts, np.float64)
        eids = self._next_eid + np.arange(len(src), dtype=np.int64)
        self._next_eid += len(src)

        if self.undirected:
            # merge both directions time-sorted BEFORE dispatching, so
            # every partition still ingests chronologically (mirrors
            # DynamicGraph.add_edges' own undirected handling)
            s_all = np.concatenate([src, dst])
            d_all = np.concatenate([dst, src])
            t_all = np.concatenate([ts, ts])
            e_all = np.concatenate([eids, eids])
            order = np.argsort(t_all, kind="stable")
            s_all, d_all = s_all[order], d_all[order]
            t_all, e_all = t_all[order], e_all[order]
        else:
            s_all, d_all, t_all, e_all = src, dst, ts, eids
        own = owner_of(s_all, self.n_parts)
        for p in range(self.n_parts):
            sel = own == p
            if not sel.any():
                continue
            # 8B src + 8B dst + 8B ts + 8B eid per event on the wire
            self.bytes_dispatched += int(sel.sum()) * 32
            if p in self._local:
                self._local[p].add_edges(s_all[sel], d_all[sel],
                                         t_all[sel], e_all[sel])
        return eids

    def delete_edges(self, eids) -> int:
        """Route edge deletions to the owner shards.  Owners are not
        derivable from an eid alone, so the deletion set is broadcast
        (paper-style tombstone fan-out, byte-accounted per shard) and
        each hosted partition invalidates the ids it actually stores.
        Returns the number of local arena rows invalidated."""
        eids = np.asarray(list(eids) if not isinstance(eids, np.ndarray)
                          else eids, np.int64)
        if not len(eids):
            return 0
        self.bytes_dispatched += int(len(eids)) * 8 * self.n_parts
        removed = 0
        for part in self.partitions:
            removed += part.graph.delete_edges(eids)
        return removed

    def ingest(self, events, state=None) -> np.ndarray:
        """One continuous-learning ingest step: dispatch the event
        batch's edges to their owner partitions and (optionally) the
        node/edge features to the hash-co-located state service shards
        (``repro.core.feature_store.StateService``) — the paper's
        ingestion front-end in one call. Feature payloads are
        byte-accounted like the edge dispatch. Returns the global edge
        ids assigned to the batch (one per event)."""
        eids = self.add_edges(events.src, events.dst, events.ts)
        if state is not None:
            nodes = np.unique(np.concatenate([events.src, events.dst]))
            state.put_node_feats(nodes, events.node_features(nodes))
            state.register_edges(eids, events.src)
            state.put_edge_feats(eids, events.edge_features(eids))
            self.bytes_dispatched += (int(nodes.size) * events.d_node
                                      + len(eids) * events.d_edge) * 4
        return eids

    def stats(self) -> PartitionStats:
        e = [p.local_edges for p in self.partitions]
        n = [int(p.graph.node_valid[:p.graph.n_nodes].sum())
             for p in self.partitions]
        arr = np.asarray(e, np.float64)
        cv = float(arr.std() / arr.mean()) if arr.mean() else 0.0
        return PartitionStats(edges_per_part=e, nodes_per_part=n,
                              bytes_dispatched=self.bytes_dispatched,
                              edge_balance_cv=cv)
