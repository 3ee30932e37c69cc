"""Time-indexed block-based dynamic graph storage (GNNFlow §4.1).

The paper's design, re-derived for array-based runtimes (DESIGN.md §2):

  * node table      — struct-of-arrays: head/tail block ids, block count,
                      degree, validity. Appending a node = appending a row.
  * edge blocks     — struct-of-arrays of block descriptors (the paper's
                      72-byte metadata): capacity, size, t_min, t_max,
                      prev/next indices, owning node, arena offset.
  * arena           — one flat append-only buffer holding (neighbor id,
                      edge id, timestamp, validity) lists; a block owns the
                      extent [start, start+capacity). Blocks and the edges
                      inside them are chronologically ordered, so temporal
                      queries scan a suffix of the block list and binary-
                      search inside blocks, and insertion is append-at-tail
                      (no re-sort) — the paper's two key properties.
  * adaptive sizing — a new block for node v gets capacity
                      b_v = clip(deg(v), min_block, tau)   (paper: min(deg, tau)).
  * deletions       — validity flips; layout/pointers untouched.
  * offload         — blocks entirely older than a cutoff spill to an npz
                      file and their arena extent is recyclable.

Everything is numpy (host memory — the paper also keeps edge data in host
shared memory); `snapshot()` exports the device-facing paged view used by
the GPU/TPU samplers (core/snapshot.py).
"""
from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Dict, Iterable, Optional, Tuple

import numpy as np

from repro_torch.obs import trace

_GROW = 1.5
NULL = -1


@dataclasses.dataclass
class DGraphStats:
    num_nodes: int
    num_edges: int
    num_blocks: int
    arena_capacity: int
    arena_used: int
    avg_list_len: float
    max_list_len: int
    edge_data_bytes: int
    metadata_bytes: int


class DynamicGraph:
    """Mutable CTDG store. Undirected graphs store each edge under both
    endpoints (paper footnote 1); directed graphs under the source."""

    def __init__(self, *, threshold: int = 256, min_block: int = 4,
                 undirected: bool = False, initial_nodes: int = 1024,
                 initial_arena: int = 1 << 16,
                 block_policy: str = "adaptive"):
        assert block_policy in ("adaptive", "fixed", "strawman", "adjlist")
        self.tau = int(threshold)
        self.min_block = int(min_block)
        self.undirected = undirected
        self.block_policy = block_policy

        # --- node table ---
        n = initial_nodes
        self.n_nodes = 0
        self.head = np.full(n, NULL, np.int64)
        self.tail = np.full(n, NULL, np.int64)
        self.nblocks = np.zeros(n, np.int64)
        self.degree = np.zeros(n, np.int64)
        self.node_valid = np.zeros(n, bool)

        # --- block descriptor table ---
        b = max(initial_nodes // 4, 16)
        self.n_blocks = 0
        self.blk_cap = np.zeros(b, np.int64)
        self.blk_size = np.zeros(b, np.int64)
        self.blk_tmin = np.full(b, np.inf, np.float64)
        self.blk_tmax = np.full(b, -np.inf, np.float64)
        self.blk_prev = np.full(b, NULL, np.int64)
        self.blk_next = np.full(b, NULL, np.int64)
        self.blk_node = np.full(b, NULL, np.int64)
        self.blk_start = np.zeros(b, np.int64)
        self.blk_offloaded = np.zeros(b, bool)

        # --- arena ---
        a = initial_arena
        self.arena_used = 0
        self.nbr = np.zeros(a, np.int64)
        self.eid = np.zeros(a, np.int64)
        self.ts = np.zeros(a, np.float64)
        self.valid = np.zeros(a, bool)

        self._last_ts = -np.inf
        self.num_edges = 0
        self._snapshot_dirty = True
        self._deleted_since_snapshot = False

    # ------------------------------------------------------------------
    # growth helpers
    # ------------------------------------------------------------------

    def _ensure_nodes(self, max_id: int) -> None:
        cap = len(self.head)
        if max_id < cap:
            if max_id >= self.n_nodes:
                self.n_nodes = max_id + 1
            return
        new = max(int(cap * _GROW), max_id + 1)
        for name in ("head", "tail", "nblocks", "degree", "node_valid"):
            arr = getattr(self, name)
            fill = NULL if name in ("head", "tail") else 0
            grown = np.full(new, fill, arr.dtype)
            grown[:cap] = arr
            setattr(self, name, grown)
        self.n_nodes = max_id + 1

    def _ensure_blocks(self, extra: int) -> None:
        cap = len(self.blk_cap)
        if self.n_blocks + extra <= cap:
            return
        new = max(int(cap * _GROW), self.n_blocks + extra)
        for name, fill in (("blk_cap", 0), ("blk_size", 0),
                           ("blk_tmin", np.inf), ("blk_tmax", -np.inf),
                           ("blk_prev", NULL), ("blk_next", NULL),
                           ("blk_node", NULL), ("blk_start", 0),
                           ("blk_offloaded", False)):
            arr = getattr(self, name)
            grown = np.full(new, fill, arr.dtype)
            grown[:cap] = arr
            setattr(self, name, grown)

    def _ensure_arena(self, extra: int) -> None:
        cap = len(self.nbr)
        if self.arena_used + extra <= cap:
            return
        new = max(int(cap * _GROW), self.arena_used + extra)
        for name in ("nbr", "eid", "ts", "valid"):
            arr = getattr(self, name)
            grown = np.zeros(new, arr.dtype)
            grown[:cap] = arr
            setattr(self, name, grown)

    # ------------------------------------------------------------------
    # block allocation (adaptive sizing lives here)
    # ------------------------------------------------------------------

    def _block_caps(self, nodes: np.ndarray,
                    incoming: np.ndarray) -> np.ndarray:
        """Vectorized new-block capacities for `nodes` about to receive
        `incoming` more edges — the adaptive sizing (paper §4.1):
        b_v = min(deg(v), tau), floored to avoid degenerate blocks."""
        if self.block_policy == "adaptive":
            caps = np.minimum(
                np.maximum(self.degree[nodes] + incoming,
                           self.min_block), self.tau)
        elif self.block_policy == "fixed":
            caps = np.full(len(nodes), self.tau, np.int64)
        elif self.block_policy == "strawman":
            caps = np.maximum(incoming, 1)   # block per incremental batch
        else:  # adjlist: one edge per "block"
            caps = np.ones(len(nodes), np.int64)
        return np.maximum(caps, 1)

    # ------------------------------------------------------------------
    # mutation API
    # ------------------------------------------------------------------

    def add_nodes(self, max_node_id: int) -> None:
        self._ensure_nodes(max_node_id)
        self.node_valid[:max_node_id + 1] = True

    def add_edges(self, src: np.ndarray, dst: np.ndarray, ts: np.ndarray,
                  eids: Optional[np.ndarray] = None) -> np.ndarray:
        """Insert a batch of timestamped edges (must be in time order
        batch-to-batch; within a batch we sort). Returns edge ids."""
        src = np.asarray(src, np.int64)
        dst = np.asarray(dst, np.int64)
        ts = np.asarray(ts, np.float64)
        if eids is None:
            eids = self.num_edges + np.arange(len(src), dtype=np.int64)
        order = np.argsort(ts, kind="stable")
        src, dst, ts, eids = src[order], dst[order], ts[order], eids[order]
        if len(ts) and ts[0] < self._last_ts:
            raise ValueError(
                f"batch starts at t={ts[0]} before the newest stored edge "
                f"t={self._last_ts}; CTDG ingestion must be chronological")

        if len(src):
            self._ensure_nodes(int(max(src.max(), dst.max())))
        if self.undirected:
            src, dst = np.concatenate([src, dst]), np.concatenate([dst,
                                                                   src])
            ts = np.concatenate([ts, ts])
            eids = np.concatenate([eids, eids])
            order = np.argsort(ts, kind="stable")
            src, dst, ts, eids = (src[order], dst[order], ts[order],
                                  eids[order])

        # group by source node, preserving chronological order per node
        with trace.span("dgraph.add_edges", edges=len(src)):
            sort_by_node = np.argsort(src, kind="stable")
            self._insert_bulk(src[sort_by_node], dst[sort_by_node],
                              ts[sort_by_node], eids[sort_by_node])

        self.node_valid[:self.n_nodes] = True
        if len(ts):
            self._last_ts = max(self._last_ts, float(ts[-1]))
        self.num_edges += len(np.unique(eids))
        self._snapshot_dirty = True
        return eids

    def _insert_for_node(self, node: int, nbrs: np.ndarray,
                         tss: np.ndarray, eids: np.ndarray) -> None:
        self._insert_bulk(np.full(len(nbrs), node, np.int64), nbrs, tss,
                          eids)

    def _insert_bulk(self, src: np.ndarray, dst: np.ndarray,
                     tss: np.ndarray, eids: np.ndarray) -> None:
        """Vectorized grouped insertion. `src` must be grouped by node
        (chronological within each group).

        Two loop-free phases: (1) fill the room left in each node's tail
        block; (2) bulk-allocate ALL remaining blocks in one shot and
        scatter the leftover rows into them. Phase 2 is exact w.r.t. the
        one-block-at-a-time allocation because within one batch every new
        block of a node gets the same capacity under every block policy
        (adaptive caps at min(max(final_degree, min_block), tau), which
        doesn't change between a node's consecutive allocations)."""
        total = len(src)
        if not total:
            return
        uniq, starts, counts = np.unique(src, return_index=True,
                                         return_counts=True)
        tails = self.tail[uniq]
        has_tail = tails != NULL
        safe_tails = np.maximum(tails, 0)
        room = np.where(
            has_tail & ~self.blk_offloaded[safe_tails],
            self.blk_cap[safe_tails] - self.blk_size[safe_tails], 0)
        take0 = np.minimum(room, counts)
        # per-row rank within its node group
        group_of = np.repeat(np.arange(len(uniq)), counts)
        within = np.arange(total) - np.repeat(starts, counts)
        use = within < take0[group_of]
        if use.any():
            pos = (self.blk_start[safe_tails]
                   + self.blk_size[safe_tails])[group_of] + within
            p = pos[use]
            self.nbr[p] = dst[use]
            self.eid[p] = eids[use]
            self.ts[p] = tss[use]
            self.valid[p] = True
            # block bookkeeping (vectorized): first/last inserted ts
            took = take0 > 0
            tk = tails[took]
            first_t = tss[starts[took]]
            last_t = tss[starts[took] + take0[took] - 1]
            self.blk_tmin[tk] = np.minimum(self.blk_tmin[tk], first_t)
            self.blk_tmax[tk] = np.maximum(self.blk_tmax[tk], last_t)
            self.blk_size[tk] += take0[took]
        self.degree[uniq] += take0

        left = counts - take0
        need = left > 0
        if not need.any():
            return
        nodes2 = uniq[need]
        left2 = left[need]
        # capacity of every new block this batch (identical per node)
        caps = self._block_caps(nodes2, left2)
        nblk = -(-left2 // caps)                      # ceil per node

        n_new = int(nblk.sum())
        self._ensure_blocks(n_new)
        caps_r = np.repeat(caps, nblk)
        self._ensure_arena(int(caps_r.sum()))
        b0 = self.n_blocks
        bids = b0 + np.arange(n_new, dtype=np.int64)
        nodes_r = np.repeat(nodes2, nblk)
        starts_r = self.arena_used + np.concatenate(
            [[0], np.cumsum(caps_r)[:-1]]).astype(np.int64)
        self.blk_cap[bids] = caps_r
        self.blk_size[bids] = 0
        self.blk_tmin[bids] = np.inf
        self.blk_tmax[bids] = -np.inf
        self.blk_node[bids] = nodes_r
        self.blk_start[bids] = starts_r
        # chain links: consecutive new blocks of a node link to each
        # other; the first links to the node's current tail
        grp_first = b0 + np.concatenate(
            [[0], np.cumsum(nblk)[:-1]]).astype(np.int64)
        grp_last = grp_first + nblk - 1
        prev = bids - 1
        nxt = bids + 1
        first_mask = np.zeros(n_new, bool)
        first_mask[grp_first - b0] = True
        last_mask = np.zeros(n_new, bool)
        last_mask[grp_last - b0] = True
        tails2 = self.tail[nodes2]
        prev[first_mask] = tails2
        nxt[last_mask] = NULL
        self.blk_prev[bids] = prev
        self.blk_next[bids] = nxt
        has_t2 = tails2 != NULL
        self.blk_next[tails2[has_t2]] = grp_first[has_t2]
        self.head[nodes2[~has_t2]] = grp_first[~has_t2]
        self.tail[nodes2] = grp_last
        self.nblocks[nodes2] += nblk
        self.arena_used += int(caps_r.sum())
        self.n_blocks += n_new

        # scatter leftover rows: row r of a node's leftovers goes to
        # block r // cap, lane r % cap (chronological order preserved)
        rows = ~use
        need_idx = np.cumsum(need) - 1                # group -> nodes2 pos
        j = need_idx[group_of[rows]]
        w2 = within[rows] - take0[group_of[rows]]
        c = caps[j]
        bid = grp_first[j] + w2 // c
        pos = self.blk_start[bid] + w2 % c
        self.nbr[pos] = dst[rows]
        self.eid[pos] = eids[rows]
        self.ts[pos] = tss[rows]
        self.valid[pos] = True
        self.blk_size[bids] = np.bincount(bid - b0, minlength=n_new)
        np.minimum.at(self.blk_tmin, bid, tss[rows])
        np.maximum.at(self.blk_tmax, bid, tss[rows])
        self.degree[nodes2] += left2

    def delete_edges(self, eids: Iterable[int]) -> int:
        """Mark edges invalid (validity flip; layout untouched)."""
        arr = (eids if isinstance(eids, np.ndarray)
               else np.fromiter(eids, np.int64))
        # arena eids are NOT unique (undirected stores both endpoints),
        # so only the query side may claim uniqueness
        hits = np.isin(self.eid[:self.arena_used], np.unique(arr))
        hits &= self.valid[:self.arena_used]
        self.valid[:self.arena_used][hits] = False
        self._snapshot_dirty = True
        self._deleted_since_snapshot = True
        return int(hits.sum())

    def delete_nodes(self, nodes: Iterable[int]) -> None:
        for v in nodes:
            if v < self.n_nodes:
                self.node_valid[v] = False
        self._snapshot_dirty = True
        self._deleted_since_snapshot = True

    def offload_older_than(self, cutoff: float, path: str | Path) -> int:
        """Spill blocks with t_max < cutoff to an npz file (paper's API for
        bounding memory); returns number of offloaded blocks."""
        sel = (np.arange(self.n_blocks)
               [(self.blk_tmax[:self.n_blocks] < cutoff)
                & ~self.blk_offloaded[:self.n_blocks]
                & (self.blk_size[:self.n_blocks] > 0)])
        if len(sel) == 0:
            return 0
        rows = []
        for b in sel:
            s, z = int(self.blk_start[b]), int(self.blk_size[b])
            rows.append((b, self.blk_node[b], self.nbr[s:s + z].copy(),
                         self.eid[s:s + z].copy(), self.ts[s:s + z].copy(),
                         self.valid[s:s + z].copy()))
        np.savez_compressed(
            Path(path),
            block_ids=np.array([r[0] for r in rows]),
            nodes=np.array([r[1] for r in rows]),
            nbr=np.concatenate([r[2] for r in rows]),
            eid=np.concatenate([r[3] for r in rows]),
            ts=np.concatenate([r[4] for r in rows]),
            valid=np.concatenate([r[5] for r in rows]),
            sizes=np.array([len(r[2]) for r in rows]))
        self.blk_offloaded[sel] = True
        # the arena extents stay allocated but invalid for sampling
        for b in sel:
            s, z = int(self.blk_start[b]), int(self.blk_size[b])
            self.valid[s:s + z] = False
        self._snapshot_dirty = True
        self._deleted_since_snapshot = True
        return len(sel)

    # ------------------------------------------------------------------
    # queries (host reference path; device paths in core/sampling.py)
    # ------------------------------------------------------------------

    def node_blocks_newest_first(self, node: int):
        b = self.tail[node] if node < self.n_nodes else NULL
        while b != NULL:
            yield int(b)
            b = self.blk_prev[b]

    def neighbors_in_window(self, node: int, t_start: float, t_end: float
                            ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """All valid edges of `node` with t_start <= ts < t_end, newest
        first (paper Algorithm 1's traversal order)."""
        outs_n, outs_e, outs_t = [], [], []
        if node >= self.n_nodes or not self.node_valid[node]:
            return (np.empty(0, np.int64), np.empty(0, np.int64),
                    np.empty(0, np.float64))
        for b in self.node_blocks_newest_first(node):
            if self.blk_offloaded[b] or self.blk_size[b] == 0:
                continue
            if t_end <= self.blk_tmin[b]:
                continue                      # entire block too new
            if t_start > self.blk_tmax[b]:
                break                         # older blocks are older still
            s, z = int(self.blk_start[b]), int(self.blk_size[b])
            tss = self.ts[s:s + z]
            lo = np.searchsorted(tss, t_start, side="left")
            hi = np.searchsorted(tss, t_end, side="left")
            if hi > lo:
                sel = slice(s + lo, s + hi)
                ok = self.valid[sel]
                outs_n.append(self.nbr[sel][ok][::-1])
                outs_e.append(self.eid[sel][ok][::-1])
                outs_t.append(self.ts[sel][ok][::-1])
        if not outs_n:
            return (np.empty(0, np.int64), np.empty(0, np.int64),
                    np.empty(0, np.float64))
        return (np.concatenate(outs_n), np.concatenate(outs_e),
                np.concatenate(outs_t))

    # ------------------------------------------------------------------
    # stats / serialization
    # ------------------------------------------------------------------

    def stats(self) -> DGraphStats:
        lens = self.nblocks[:self.n_nodes]
        lens = lens[lens > 0]
        edge_bytes = int(self.arena_used) * (8 + 8 + 8 + 1)
        meta_bytes = int(self.n_blocks) * 72 + int(self.n_nodes) * 33
        return DGraphStats(
            num_nodes=int(self.n_nodes),
            num_edges=int(self.num_edges),
            num_blocks=int(self.n_blocks),
            arena_capacity=int(len(self.nbr)),
            arena_used=int(self.arena_used),
            avg_list_len=float(lens.mean()) if len(lens) else 0.0,
            max_list_len=int(lens.max()) if len(lens) else 0,
            edge_data_bytes=edge_bytes,
            metadata_bytes=meta_bytes,
        )

    def save(self, path: str | Path) -> None:
        np.savez_compressed(
            Path(path),
            tau=self.tau, min_block=self.min_block,
            undirected=self.undirected, n_nodes=self.n_nodes,
            n_blocks=self.n_blocks, arena_used=self.arena_used,
            num_edges=self.num_edges, last_ts=self._last_ts,
            head=self.head[:self.n_nodes], tail=self.tail[:self.n_nodes],
            nblocks=self.nblocks[:self.n_nodes],
            degree=self.degree[:self.n_nodes],
            node_valid=self.node_valid[:self.n_nodes],
            blk_cap=self.blk_cap[:self.n_blocks],
            blk_size=self.blk_size[:self.n_blocks],
            blk_tmin=self.blk_tmin[:self.n_blocks],
            blk_tmax=self.blk_tmax[:self.n_blocks],
            blk_prev=self.blk_prev[:self.n_blocks],
            blk_next=self.blk_next[:self.n_blocks],
            blk_node=self.blk_node[:self.n_blocks],
            blk_start=self.blk_start[:self.n_blocks],
            blk_offloaded=self.blk_offloaded[:self.n_blocks],
            nbr=self.nbr[:self.arena_used], eid=self.eid[:self.arena_used],
            ts=self.ts[:self.arena_used],
            valid=self.valid[:self.arena_used])

    @classmethod
    def load(cls, path: str | Path) -> "DynamicGraph":
        z = np.load(Path(path), allow_pickle=False)
        g = cls(threshold=int(z["tau"]), min_block=int(z["min_block"]),
                undirected=bool(z["undirected"]))
        g.n_nodes = int(z["n_nodes"])
        g.n_blocks = int(z["n_blocks"])
        g.arena_used = int(z["arena_used"])
        g.num_edges = int(z["num_edges"])
        g._last_ts = float(z["last_ts"])
        for name in ("head", "tail", "nblocks", "degree", "node_valid"):
            setattr(g, name, np.array(z[name]))
        for name in ("blk_cap", "blk_size", "blk_tmin", "blk_tmax",
                     "blk_prev", "blk_next", "blk_node", "blk_start",
                     "blk_offloaded"):
            setattr(g, name, np.array(z[name]))
        for name in ("nbr", "eid", "ts", "valid"):
            setattr(g, name, np.array(z[name]))
        return g
