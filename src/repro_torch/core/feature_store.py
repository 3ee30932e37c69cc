"""State service: node/edge features + TGN node memories behind ONE
access API (GNNFlow §4.4).

Every consumer — ``BatchBuilder``/``FeatureAssembler`` staging, both
trainers, the TGN raw-message commit — reads and writes training state
through the :class:`StateService` protocol, keyed by *global* ids:

    put_node_feats(ids, feats)        get_node_feats(ids)   -> (N, d)
    register_edges(eids, src)         # owner metadata, SPMD-replicated
    put_edge_feats(eids, feats)       get_edge_feats(eids)  -> (N, d)
    put_memory(ids, mem, ts)          get_memory(ids)       -> (mem, ts)
    resident_bytes() / stats()

Two implementations share the surface:

``ReplicatedStateService`` (here)
    Today's behavior and the tier-1 default: P hash partitions all
    hosted in-process, remote traffic *modeled* (byte/call-accounted
    when a read or write crosses ``local_rank``'s partition boundary).
    Each SPMD process derives an identical full replica from the
    deterministic ingest + the replicated step.

``ShardedStateService`` (``repro.dist.state``)
    The paper's placement: a process holds ONLY the partitions it owns
    (compact local rows, ~1/P resident bytes) and serves peers through
    ``feat_get``/``feat_put``/``mem_get``/``mem_put`` ops on
    ``repro.dist.transport``, with the device ``FeatureCache`` mounted
    in front to absorb remote latency.

Storage is host-resident (the paper keeps features in shared host
memory too). Node features and memories are dense arrays indexed by
node id; edge features are stored append-only in edge-id order (new
edges get larger ids), so lookups are O(1) — the paper's "searchsorted
over ascending edge ids" degenerates to direct indexing with our
contiguous id assignment.

The pre-redesign ``DistributedFeatureStore`` surface
(``put_edge_features(eids, src, feats)``, mem-only ``get_memory``,
``get_memory_ts``) was carried as deprecation shims for one PR after
the redesign and has been removed.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np

from repro_torch.core.partition import owner_of

_GROW = 1.5


class _Dense:
    """Growable dense (row -> vector) table with used-row accounting
    (``used`` counts distinct rows ever written — the resident-footprint
    measure ``resident_bytes`` reports, independent of the geometric
    over-allocation)."""

    def __init__(self, dim: int, initial: int = 1024):
        self.dim = dim
        self.data = np.zeros((initial, dim), np.float32)
        self.written = np.zeros(initial, bool)
        self.size = 0
        self.used = 0

    def _ensure(self, n: int) -> None:
        if n <= len(self.data):
            if n > self.size:
                self.size = n
            return
        new = max(int(len(self.data) * _GROW), n)
        grown = np.zeros((new, self.dim), np.float32)
        grown[:len(self.data)] = self.data
        self.data = grown
        w = np.zeros(new, bool)
        w[:len(self.written)] = self.written
        self.written = w
        self.size = n

    def set(self, ids: np.ndarray, vals: np.ndarray) -> None:
        if len(ids) == 0:
            return
        self._ensure(int(ids.max()) + 1)
        fresh = ids[~self.written[ids]]
        if len(fresh):
            self.used += len(np.unique(fresh))
            self.written[fresh] = True
        self.data[ids] = vals

    def get(self, ids: np.ndarray) -> np.ndarray:
        out = np.zeros((len(ids), self.dim), np.float32)
        ok = (ids >= 0) & (ids < self.size)
        out[ok] = self.data[ids[ok]]
        return out


# ---------------------------------------------------------------------------
# The protocol
# ---------------------------------------------------------------------------


class StateService:
    """Access protocol for training state keyed by global ids.

    Implementations route each id to its hash owner (``owner_of``,
    id % P); unknown and negative ids read as zeros (padding lanes).
    ``register_edges`` is *metadata*: every SPMD process must call it
    with the same (eids, src) so the replicated eid->owner map stays
    derivable everywhere — only the feature payloads are sharded.
    """

    n_parts: int = 1
    d_node: int = 0
    d_edge: int = 0
    d_memory: int = 0
    local_rank: int = 0

    # -- symmetric get/put surface --------------------------------------
    def put_node_feats(self, ids, feats) -> None:
        raise NotImplementedError

    def get_node_feats(self, ids) -> np.ndarray:
        raise NotImplementedError

    def register_edges(self, eids, src) -> None:
        raise NotImplementedError

    def put_edge_feats(self, eids, feats) -> None:
        raise NotImplementedError

    def get_edge_feats(self, eids) -> np.ndarray:
        raise NotImplementedError

    def put_memory(self, ids, mem, ts) -> None:
        raise NotImplementedError

    def get_memory(self, ids) -> Tuple[np.ndarray, np.ndarray]:
        """-> (mem (N, d_memory), last-update ts (N,)) — symmetric with
        ``put_memory``."""
        raise NotImplementedError

    # -- placement -------------------------------------------------------
    def owners(self, table: str, ids) -> np.ndarray:
        """Per-id owner partition (-1 for padding / unregistered edges).
        ``table`` is ``"node"``, ``"edge"`` or ``"memory"``."""
        raise NotImplementedError

    def remote_mask(self, table: str, ids) -> np.ndarray:
        """True where the id's owner is a DIFFERENT partition than
        ``local_rank`` — the rows worth spending device-cache capacity
        on (owned rows are already a local host lookup). Padding and
        unregistered ids are False."""
        ids = np.asarray(ids, np.int64)
        own = self.owners(table, ids)
        return (own >= 0) & (own != self.local_rank)

    # -- accounting ------------------------------------------------------
    def resident_bytes(self) -> int:
        """Feature + memory bytes THIS process keeps resident (used rows
        only, not growable-array capacity)."""
        raise NotImplementedError

    def stats(self) -> Dict[str, Any]:
        """State-RPC accounting: ``calls``/``bytes``/``wait_s`` cover
        every partition-remote access (modeled in-process + real wire),
        ``wire_*`` the cross-process subset, ``served_calls`` requests
        answered for peers, plus ``resident_bytes``."""
        raise NotImplementedError


# ---------------------------------------------------------------------------
# Replicated implementation (tier-1 default; today's numerics)
# ---------------------------------------------------------------------------


class FeatureStorePartition:
    """One machine's feature shard (rows indexed by GLOBAL id)."""

    def __init__(self, part_id: int, n_parts: int, d_node: int,
                 d_edge: int, d_memory: int = 0):
        self.part_id = part_id
        self.n_parts = n_parts
        self.node = _Dense(d_node)
        self.edge = _Dense(d_edge)
        self.memory = _Dense(d_memory) if d_memory else None
        self.mem_ts = _Dense(1) if d_memory else None


class ReplicatedStateService(StateService):
    """All P hash partitions hosted in-process; partition-remote access
    is modeled (call/byte-accounted against ``local_rank``), never a
    real wire. Nodes (and memories) are owned by hash(node) % P; edge
    features by hash(src) % P (co-located with the edge's graph shard).
    """

    def __init__(self, n_parts: int, d_node: int, d_edge: int,
                 d_memory: int = 0, local_rank: int = 0):
        self.parts = [FeatureStorePartition(p, n_parts, d_node, d_edge,
                                            d_memory)
                      for p in range(n_parts)]
        self.n_parts = n_parts
        self.d_node, self.d_edge, self.d_memory = d_node, d_edge, d_memory
        self.local_rank = local_rank
        self.remote_calls = 0
        self.remote_bytes = 0
        self._edge_owner = _Dense(1)   # edge id -> owner partition

    # -- writes ---------------------------------------------------------
    def put_node_feats(self, ids, feats) -> None:
        ids = np.asarray(ids, np.int64)
        own = owner_of(ids, self.n_parts)
        for p in range(self.n_parts):
            sel = own == p
            if sel.any():
                self.parts[p].node.set(ids[sel], np.asarray(feats)[sel])
                self._account(p, int(sel.sum()) * self.d_node * 4)

    def register_edges(self, eids, src) -> None:
        eids = np.asarray(eids, np.int64)
        if not len(eids):
            return
        own = owner_of(np.asarray(src, np.int64), self.n_parts)
        # first registration wins (matches ShardedStateService: an
        # SPMD re-ingest of an id must be idempotent on the owner map)
        self._edge_owner._ensure(int(eids.max()) + 1)
        fresh = ~self._edge_owner.written[eids]
        self._edge_owner.set(eids[fresh],
                             own[fresh][:, None].astype(np.float32))

    def put_edge_feats(self, eids, feats) -> None:
        eids = np.asarray(eids, np.int64)
        own = self._edge_owner.get(eids)[:, 0].astype(np.int64)
        for p in range(self.n_parts):
            sel = own == p
            if sel.any():
                self.parts[p].edge.set(eids[sel], np.asarray(feats)[sel])
                self._account(p, int(sel.sum()) * self.d_edge * 4)

    def put_memory(self, ids, mem, ts) -> None:
        ids = np.asarray(ids, np.int64)
        own = owner_of(ids, self.n_parts)
        for p in range(self.n_parts):
            sel = own == p
            if not sel.any():
                continue
            self.parts[p].memory.set(ids[sel], np.asarray(mem)[sel])
            self.parts[p].mem_ts.set(
                ids[sel], np.asarray(ts)[sel][:, None])
            self._account(p, int(sel.sum()) * (self.d_memory + 1) * 4)

    # -- reads (remote-byte accounted) ----------------------------------
    def _account(self, p: int, nbytes: int) -> None:
        if p != self.local_rank:
            self.remote_calls += 1
            self.remote_bytes += nbytes

    def _fetch(self, table: str, ids: np.ndarray, dim: int) -> np.ndarray:
        ids = np.asarray(ids, np.int64)
        out = np.zeros((len(ids), dim), np.float32)
        if table == "edge":
            own = self._edge_owner.get(ids)[:, 0].astype(np.int64)
        else:
            own = owner_of(np.maximum(ids, 0), self.n_parts)
        for p in range(self.n_parts):
            sel = (own == p) & (ids >= 0)
            if not sel.any():
                continue
            t = getattr(self.parts[p], table)
            out[sel] = t.get(ids[sel])
            self._account(p, int(sel.sum()) * dim * 4)
        return out

    def get_node_feats(self, ids) -> np.ndarray:
        return self._fetch("node", ids, self.d_node)

    def get_edge_feats(self, eids) -> np.ndarray:
        return self._fetch("edge", eids, self.d_edge)

    def get_memory(self, ids) -> Tuple[np.ndarray, np.ndarray]:
        if self.d_memory == 0:
            raise ValueError("state service configured without a memory "
                             "table (d_memory=0)")
        mem = self._fetch("memory", ids, self.d_memory)
        ts = self._fetch("mem_ts", ids, 1)[:, 0]
        return mem, ts

    # -- placement -------------------------------------------------------
    def owners(self, table: str, ids) -> np.ndarray:
        ids = np.asarray(ids, np.int64)
        if table == "edge":
            own = self._edge_owner.get(ids)[:, 0].astype(np.int64)
            reg = np.zeros(len(ids), bool)
            ok = (ids >= 0) & (ids < len(self._edge_owner.written))
            reg[ok] = self._edge_owner.written[ids[ok]]
            return np.where(reg, own, -1)
        own = owner_of(np.maximum(ids, 0), self.n_parts)
        return np.where(ids >= 0, own, -1)

    # -- accounting ------------------------------------------------------
    def resident_bytes(self) -> int:
        total = 0
        for part in self.parts:
            total += part.node.used * self.d_node * 4
            total += part.edge.used * self.d_edge * 4
            if part.memory is not None:
                total += part.memory.used * self.d_memory * 4
                total += part.mem_ts.used * 4
        return total

    def stats(self) -> Dict[str, Any]:
        return {"mode": "replicated",
                "calls": self.remote_calls, "bytes": self.remote_bytes,
                "wait_s": 0.0, "wire_calls": 0, "wire_bytes": 0,
                "served_calls": 0,
                "round_trips": 0, "baseline_trips": 0,
                "dedup_saved_bytes": 0,
                "pf_wire_s": 0.0, "pf_overlap_s": 0.0,
                "pf_hits": 0, "pf_misses": 0, "stale_served": 0,
                "wire_bytes_per_part": [0] * self.n_parts,
                "resident_bytes": self.resident_bytes()}
