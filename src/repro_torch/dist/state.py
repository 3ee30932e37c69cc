"""Owner-sharded state service (counterpart of ``repro.dist.state``;
GNNFlow's hybrid placement, §4.4).

The paper keeps node/edge features and TGN memories WHERE their
partition lives; a process holds only its own shard and absorbs remote
reads with the dynamic cache.  :class:`ShardedStateService` is that
placement behind the :class:`repro_torch.core.feature_store.StateService`
protocol.  It is host-side numpy, as in the JAX package:

* a process hosts the partitions in ``hosted`` (all of them in the
  in-process mode) in COMPACT local rows — node/memory row ``id // P``
  (a bijection with owner ``id % P``), edge rows assigned per owner in
  ascending-eid order at ``register_edges`` time.  Resident bytes are
  therefore ~1/P of a full replica (``resident_bytes``);
* an access whose owner is hosted but != ``local_rank`` is a MODELED
  remote (call/byte-accounted post-dedup, the payload a wire would
  ship);
* an access whose owner is NOT hosted goes over the transport's state
  ops to the owner's server, wire bytes and wait accounted, errors
  re-raised on the caller.

Remote reads are COALESCED:

* repeated ids are deduped before the wire, and ``dedup_saved_bytes``
  counts what the repeats would have cost;
* :meth:`prefetch_async` packs every remote row an upcoming batch
  needs — node feats, edge feats, memories — into ONE ``state_batch``
  round trip per peer, issued on a background thread (host work only:
  it never touches a CUDA tensor).  The synchronous read path serves
  from the staging buffer and falls back to per-table ops for rows the
  prefetch missed;
* ``memory_staleness`` (paper §4.2) bounds how stale a buffered memory
  row may be, in COMMITS: ``put_memory`` bumps a version counter, and a
  buffered row tagged at version *v* may serve while
  ``version - v <= memory_staleness``.  The default 0 is exact.

``spmd_writes=True`` (the trainers' mode) DROPS non-hosted writes: every
process runs the same deterministic ingest/commit, so the owner derives
its own copy locally and the wire carries only reads.
``spmd_writes=False`` routes writes remotely too.  ``register_edges`` is
SPMD metadata either way.
"""
from __future__ import annotations

import threading
import time
from typing import Any, Dict, Iterable, List, Optional, Tuple

import numpy as np

from repro_torch.core.feature_store import StateService, _Dense
from repro_torch.core.partition import owner_of
from repro_torch.obs import trace


def pack_state_batch(node_ids=None, eids=None, mem_ids=None) -> Tuple:
    """Client-side payload of the coalesced ``state_batch`` op:
    ``(node_ids | None, eids | None, mem_ids | None)`` as int64 arrays.
    Empty requests collapse to None so absent tables cost no bytes."""
    def cvt(a):
        if a is None:
            return None
        a = np.asarray(a, np.int64)
        return a if len(a) else None
    return cvt(node_ids), cvt(eids), cvt(mem_ids)


def unpack_state_batch(reply) -> Tuple:
    """Server reply -> ``(node_feats, edge_feats, mem, mem_ts)``; None
    in the slots whose request was absent."""
    nf, ef, mem, ts = reply
    def f32(a):
        return None if a is None else np.asarray(a, np.float32)
    return f32(nf), f32(ef), f32(mem), f32(ts)


class _Shard:
    """One hosted partition's compact tables."""

    def __init__(self, d_node: int, d_edge: int, d_memory: int):
        self.node = _Dense(d_node)
        self.edge = _Dense(d_edge)
        self.memory = _Dense(d_memory) if d_memory else None
        self.mem_ts = _Dense(1) if d_memory else None
        self.edge_rows = 0          # next free owner-local edge row


class ShardedStateService(StateService):
    def __init__(self, n_parts: int, d_node: int, d_edge: int,
                 d_memory: int = 0, *,
                 hosted: Optional[Iterable[int]] = None,
                 transport=None, local_rank: int = 0,
                 spmd_writes: bool = True,
                 memory_staleness: int = 0,
                 pf_cap_rows: int = 1 << 18):
        self.n_parts = int(n_parts)
        self.d_node, self.d_edge, self.d_memory = d_node, d_edge, d_memory
        self.shards: Dict[int, _Shard] = {
            int(p): _Shard(d_node, d_edge, d_memory)
            for p in (hosted if hosted is not None else range(n_parts))}
        self.transport = transport
        self.local_rank = int(local_rank)
        self.spmd_writes = bool(spmd_writes)
        self.memory_staleness = int(memory_staleness)
        self.pf_cap_rows = int(pf_cap_rows)
        # replicated edge metadata (every SPMD process derives the same)
        self._edge_owner = np.full(1024, -1, np.int16)
        self._edge_row = np.full(1024, -1, np.int64)
        # modeled (hosted-but-foreign) + wire (non-hosted) accounting;
        # counters are touched from the prefetch thread too, so all
        # updates go through _acct_lock
        self._acct_lock = threading.Lock()
        self.model_calls = 0
        self.model_bytes = 0
        self.wire_calls = 0           # real round trips (the budget)
        self.wire_bytes = 0
        self.wire_time_s = 0.0        # total on-wire time, any thread
        self.block_wait_s = 0.0       # critical-path (caller-blocking)
        self.served_calls = 0
        self.baseline_trips = 0       # what the per-table path would cost
        self.dedup_saved_bytes = 0
        self.wire_bytes_per_part = np.zeros(self.n_parts, np.int64)
        # prefetch machinery: staged remote rows + in-flight jobs
        self._pf_lock = threading.Lock()
        self._pf_jobs: List[Tuple[threading.Thread, Dict]] = []
        self._pf_rows: Dict[str, Dict[int, np.ndarray]] = {
            "node": {}, "edge": {}}
        self._pf_mem: Dict[int, Tuple[np.ndarray, float, int]] = {}
        self._pf_error: Optional[BaseException] = None
        self.pf_wire_s = 0.0          # wire time on the background thread
        self.pf_block_s = 0.0         # portion the caller still waited on
        self.pf_hits = 0
        self.pf_misses = 0
        self.stale_served = 0
        # TGN memory: commit epoch counter + write/read lock (server
        # threads read while the local trainer commits)
        self.mem_version = 0
        self._mem_lock = threading.Lock()

    # -- edge metadata ---------------------------------------------------
    def _ensure_edge_meta(self, n: int) -> None:
        if n <= len(self._edge_owner):
            return
        grow = max(int(len(self._edge_owner) * 1.5), n)
        for name in ("_edge_owner", "_edge_row"):
            arr = getattr(self, name)
            g = np.full(grow, -1, arr.dtype)
            g[:len(arr)] = arr
            setattr(self, name, g)

    def register_edges(self, eids, src) -> None:
        """Record owner + owner-local row for new eids (assumed unique
        within a call, as the ingest path guarantees). Rows are assigned
        in ascending-eid order per owner, so every process that hosts a
        partition derives the identical row map."""
        eids = np.asarray(eids, np.int64)
        src = np.asarray(src, np.int64)
        if not len(eids):
            return
        order = np.argsort(eids, kind="stable")
        eids, src = eids[order], src[order]
        self._ensure_edge_meta(int(eids.max()) + 1)
        own = owner_of(src, self.n_parts).astype(np.int16)
        fresh = self._edge_owner[eids] < 0
        self._edge_owner[eids[fresh]] = own[fresh]
        for p, shard in self.shards.items():
            sel = fresh & (own == p)
            k = int(sel.sum())
            if k:
                self._edge_row[eids[sel]] = shard.edge_rows + np.arange(k)
                shard.edge_rows += k

    def owners(self, table: str, ids) -> np.ndarray:
        """Per-id owner partition; -1 for padding/unregistered ids."""
        ids = np.asarray(ids, np.int64)
        if table == "edge":
            self._ensure_edge_meta(int(ids.max(initial=0)) + 1)
            own = self._edge_owner[np.maximum(ids, 0)].astype(np.int64)
        else:
            own = owner_of(np.maximum(ids, 0), self.n_parts)
        return np.where(ids >= 0, own, -1)

    # -- hosted-shard primitives ----------------------------------------
    def _local_rows(self, p: int, table: str, ids: np.ndarray
                    ) -> np.ndarray:
        if table == "edge":
            return self._edge_row[ids]          # -1 -> zeros on get
        return ids // self.n_parts              # owner p == ids % P

    def _local_get(self, p: int, table: str, ids: np.ndarray
                   ) -> np.ndarray:
        shard = self.shards[p]
        return getattr(shard, table).get(self._local_rows(p, table, ids))

    def _local_put(self, p: int, table: str, ids: np.ndarray,
                   vals: np.ndarray) -> None:
        rows = self._local_rows(p, table, ids)
        if table == "edge" and (rows < 0).any():
            missing = ids[rows < 0][:8]
            raise ValueError(
                f"put_edge_feats for unregistered eids {missing.tolist()}"
                f" — call register_edges(eids, src) first")
        getattr(self.shards[p], table).set(rows, vals)

    def _account_model(self, p: int, *arrays) -> None:
        if p != self.local_rank:
            with self._acct_lock:
                self.model_calls += 1
                self.model_bytes += sum(int(a.nbytes) for a in arrays)

    def _wire(self, p: int, fn, *arrays, background: bool = False):
        if self.transport is None:
            raise RuntimeError(
                "partition not hosted here and no transport bound")
        # span kind mirrors the accounting split below: "state.prefetch"
        # runs on the background thread's lane (hidden behind the step),
        # "state.wait" is the caller-blocking critical path
        t0 = time.perf_counter()
        with trace.span("state.prefetch" if background else "state.wait",
                        peer=p, phase="wire"):
            out = fn()
        dt = time.perf_counter() - t0
        nbytes = sum(int(a.nbytes) for a in arrays if a is not None)
        if out is not None:
            res = out if isinstance(out, tuple) else (out,)
            nbytes += sum(int(np.asarray(a).nbytes) for a in res
                          if a is not None)
        with self._acct_lock:
            self.wire_calls += 1
            self.wire_bytes += nbytes
            self.wire_time_s += dt
            self.wire_bytes_per_part[p] += nbytes
            if background:
                self.pf_wire_s += dt
            else:
                self.block_wait_s += dt
        return out

    # -- async prefetch ---------------------------------------------------
    def prefetch_async(self, node_ids=None, eids=None, mem_ids=None
                       ) -> int:
        """Stage every listed remote row with ONE coalesced
        ``state_batch`` round trip per peer, on a background thread.

        Callers pass the union of ids an upcoming batch will read
        (already filtered to rows worth shipping — see the trainer's
        device-cache probe); hosted partitions are skipped here.
        Memory rows are tagged with the CURRENT commit version, so the
        staleness check at read time is conservative (the owner may
        commit between issue and landing, making the data fresher than
        its tag, never staler).  Returns the number of round trips
        issued."""
        if self.transport is None:
            return 0
        # join the previous batch's jobs first: keeps pf_filter_new
        # exact and bounds the job list (normally already complete)
        self._pf_drain()
        reqs: Dict[int, List] = {}
        for slot, (table, arr) in enumerate((("node", node_ids),
                                             ("edge", eids),
                                             ("memory", mem_ids))):
            if arr is None:
                continue
            arr = np.asarray(arr, np.int64)
            arr = np.unique(arr[arr >= 0])
            if not len(arr):
                continue
            own = self.owners(table, arr)
            for p in np.unique(own):
                p = int(p)
                if p < 0 or p in self.shards:
                    continue
                reqs.setdefault(p, [None, None, None])[slot] = \
                    arr[own == p]
        if not reqs:
            return 0
        ver = self.mem_version
        box: Dict[str, Any] = {"error": None}
        th = threading.Thread(target=self._pf_run, args=(reqs, ver, box),
                              daemon=True, name="state-prefetch")
        self._pf_jobs.append((th, box))
        th.start()
        return len(reqs)

    def _pf_run(self, reqs: Dict[int, List], ver: int, box: Dict) -> None:
        try:
            for p, (nids, peids, mids) in reqs.items():
                payload = pack_state_batch(nids, peids, mids)
                out = self._wire(
                    p, lambda: self.transport.state_batch(p, *payload),
                    *payload, background=True)
                nf, ef, mem, mts = unpack_state_batch(out)
                with self._pf_lock:
                    self._pf_trim()
                    if nf is not None:
                        buf = self._pf_rows["node"]
                        for i, g in enumerate(payload[0].tolist()):
                            buf[g] = nf[i]
                    if ef is not None:
                        buf = self._pf_rows["edge"]
                        for i, g in enumerate(payload[1].tolist()):
                            buf[g] = ef[i]
                    if mem is not None:
                        for i, g in enumerate(payload[2].tolist()):
                            self._pf_mem[g] = (mem[i], float(mts[i]), ver)
        except Exception as e:           # surfaces at the next drain
            box["error"] = e

    def _pf_trim(self) -> None:
        # bound the host-side staging buffer (called under _pf_lock)
        for buf in (*self._pf_rows.values(), self._pf_mem):
            if len(buf) > self.pf_cap_rows:
                buf.clear()

    def _pf_drain(self) -> None:
        """Join in-flight prefetch jobs; the join time is real
        critical-path waiting and is accounted as such.

        A failed job's error is held in ``_pf_error`` until it is
        raised HERE — the entry point of every stage that touches the
        prefetch machinery (``prefetch_async``, ``pf_reset``, the
        remote-read paths).  Before raising, every staging buffer is
        cleared: the failed thread may have landed rows from its
        earlier successful peers, and a round that aborted mid-stage
        (``PipelineEngine.run`` swallows secondary errors while
        draining) must not serve that partial state next round."""
        jobs, self._pf_jobs = self._pf_jobs, []
        if jobs:
            t0 = time.perf_counter()
            with trace.span("state.wait", phase="drain", jobs=len(jobs)):
                for th, _ in jobs:
                    th.join()
            dt = time.perf_counter() - t0
            with self._acct_lock:
                self.block_wait_s += dt
                self.pf_block_s += dt
            for _, box in jobs:
                if box["error"] is not None and self._pf_error is None:
                    self._pf_error = box["error"]   # first failure wins
        if self._pf_error is not None:
            err, self._pf_error = self._pf_error, None
            with self._pf_lock:
                for buf in (*self._pf_rows.values(), self._pf_mem):
                    buf.clear()
            raise err

    def pf_filter_new(self, table: str, ids: np.ndarray) -> np.ndarray:
        """Drop ids already staged in the prefetch buffer (features are
        immutable once written, so a staged row never needs re-shipping
        within a round)."""
        buf = self._pf_rows.get(table)
        if not buf or not len(ids):
            return ids
        with self._pf_lock:
            keep = np.fromiter((int(g) not in buf for g in ids),
                               bool, len(ids))
        return ids[keep]

    def pf_reset(self) -> None:
        """Quiesce prefetch threads and drop all staged rows.  The
        trainers call this before ingest (feature tables mutate) so no
        prefetch is in flight anywhere while peers write."""
        self._pf_drain()
        with self._pf_lock:
            for buf in (*self._pf_rows.values(), self._pf_mem):
                buf.clear()

    # -- feature reads ---------------------------------------------------
    def _read(self, table: str, ids, dim: int) -> np.ndarray:
        ids = np.asarray(ids, np.int64)
        out = np.zeros((len(ids), dim), np.float32)
        if not len(ids):
            return out
        own = self.owners(table, ids)
        for p in np.unique(own):
            p = int(p)
            if p < 0:
                continue
            sel = own == p
            sub = ids[sel]
            uniq, inv = np.unique(sub, return_inverse=True)
            if p != self.local_rank:
                # what the pre-coalescing per-table path would have
                # cost this foreign owner: one (modeled or real) round
                # trip per read invocation, full repeats on the wire
                with self._acct_lock:
                    self.baseline_trips += 1
                    self.dedup_saved_bytes += \
                        (len(sub) - len(uniq)) * (8 + dim * 4)
            if p in self.shards:
                vals = self._local_get(p, table, uniq)
                self._account_model(p, uniq, vals)
            else:
                vals = self._remote_rows(p, table, uniq, dim)
            out[sel] = vals[inv]
        return out

    def _remote_rows(self, p: int, table: str, uniq: np.ndarray,
                     dim: int) -> np.ndarray:
        """Serve deduped remote rows: prefetch buffer first, one wire
        fallback for whatever it missed (kept in the buffer for the
        batch's remaining shards)."""
        self._pf_drain()
        rows = np.zeros((len(uniq), dim), np.float32)
        miss_mask = np.ones(len(uniq), bool)
        buf = self._pf_rows[table]
        with self._pf_lock:
            for i, g in enumerate(uniq.tolist()):
                r = buf.get(g)
                if r is not None:
                    rows[i] = r
                    miss_mask[i] = False
        miss = uniq[miss_mask]
        with self._acct_lock:
            self.pf_hits += len(uniq) - len(miss)
            self.pf_misses += len(miss)
        if len(miss):
            vals = self._wire(
                p, lambda: self.transport.feat_get(p, table, miss), miss)
            rows[miss_mask] = vals
            with self._pf_lock:
                for i, g in zip(np.nonzero(miss_mask)[0].tolist(),
                                miss.tolist()):
                    buf[g] = rows[i]
        return rows

    def get_node_feats(self, ids) -> np.ndarray:
        return self._read("node", ids, self.d_node)

    def get_edge_feats(self, eids) -> np.ndarray:
        return self._read("edge", eids, self.d_edge)

    # -- feature writes --------------------------------------------------
    def _write(self, table: str, ids, vals) -> None:
        ids = np.asarray(ids, np.int64)
        vals = np.asarray(vals, np.float32)
        if not len(ids):
            return
        # a rewrite invalidates any staged copy of these rows: the SPMD
        # trainers only ever rewrite idempotently (and pf_reset before
        # ingest), but the service must stay correct for arbitrary
        # writers — reads after a write see the written value
        buf = self._pf_rows[table]
        if buf:
            with self._pf_lock:
                for g in ids.tolist():
                    buf.pop(g, None)
        own = self.owners(table, ids)
        for p in np.unique(own):
            p = int(p)
            if p < 0:
                continue
            sel = own == p
            sub, v = ids[sel], vals[sel]
            if p in self.shards:
                self._local_put(p, table, sub, v)
                self._account_model(p, sub, v)
            elif self.spmd_writes:
                # the owner process runs the same deterministic write
                # from its own replicated computation — drop, no wire
                continue
            else:
                self._wire(
                    p, lambda: self.transport.feat_put(p, table, sub, v),
                    sub, v)

    def put_node_feats(self, ids, feats) -> None:
        self._write("node", ids, feats)

    def put_edge_feats(self, eids, feats) -> None:
        self._write("edge", eids, feats)

    # -- TGN memory ------------------------------------------------------
    def _require_memory(self) -> None:
        if not self.d_memory:
            raise ValueError("state service configured without a memory "
                             "table (d_memory=0)")

    def get_memory(self, ids) -> Tuple[np.ndarray, np.ndarray]:
        self._require_memory()
        ids = np.asarray(ids, np.int64)
        mem = np.zeros((len(ids), self.d_memory), np.float32)
        ts = np.zeros(len(ids), np.float32)
        if not len(ids):
            return mem, ts
        own = self.owners("memory", ids)
        for p in np.unique(own):
            p = int(p)
            if p < 0:
                continue
            sel = own == p
            sub = ids[sel]
            uniq, inv = np.unique(sub, return_inverse=True)
            if p != self.local_rank:
                with self._acct_lock:
                    self.baseline_trips += 1
                    self.dedup_saved_bytes += \
                        (len(sub) - len(uniq)) * (12 + self.d_memory * 4)
            if p in self.shards:
                rows = uniq // self.n_parts
                with self._mem_lock:
                    m = self.shards[p].memory.get(rows)
                    t = self.shards[p].mem_ts.get(rows)[:, 0]
                self._account_model(p, uniq, m, t)
            else:
                m, t = self._remote_memory(p, uniq)
            mem[sel] = m[inv]
            ts[sel] = t[inv]
        return mem, ts

    def _remote_memory(self, p: int, uniq: np.ndarray
                       ) -> Tuple[np.ndarray, np.ndarray]:
        """Deduped remote memory rows: the prefetched copy may serve a
        row while it is at most ``memory_staleness`` commits old; the
        rest take one wire fallback (re-staged at the current
        version)."""
        self._pf_drain()
        m_rows = np.zeros((len(uniq), self.d_memory), np.float32)
        t_rows = np.zeros(len(uniq), np.float32)
        miss_mask = np.ones(len(uniq), bool)
        stale = 0
        with self._pf_lock:
            for i, g in enumerate(uniq.tolist()):
                ent = self._pf_mem.get(g)
                if ent is None:
                    continue
                m_r, t_r, ver = ent
                if self.mem_version - ver > self.memory_staleness:
                    continue    # too stale: refetch
                m_rows[i] = m_r
                t_rows[i] = t_r
                miss_mask[i] = False
                if self.mem_version > ver:
                    stale += 1
        miss = uniq[miss_mask]
        with self._acct_lock:
            self.pf_hits += len(uniq) - len(miss)
            self.pf_misses += len(miss)
            self.stale_served += stale
        if len(miss):
            ver = self.mem_version
            m, t = self._wire(
                p, lambda: self.transport.mem_get(p, miss), miss)
            m_rows[miss_mask] = m
            t_rows[miss_mask] = t
            with self._pf_lock:
                for i, g in zip(np.nonzero(miss_mask)[0].tolist(),
                                miss.tolist()):
                    self._pf_mem[g] = (m_rows[i], float(t_rows[i]), ver)
        return m_rows, t_rows

    def put_memory(self, ids, mem, ts) -> None:
        self._require_memory()
        ids = np.asarray(ids, np.int64)
        mem = np.asarray(mem, np.float32)
        ts = np.asarray(ts, np.float64)
        if not len(ids):
            return
        # one commit epoch per put: the staleness bound is measured in
        # these (every SPMD process commits in lockstep)
        self.mem_version += 1
        own = self.owners("memory", ids)
        for p in np.unique(own):
            p = int(p)
            if p < 0:
                continue
            sel = own == p
            sub, m, t = ids[sel], mem[sel], ts[sel]
            if p in self.shards:
                rows = sub // self.n_parts
                with self._mem_lock:
                    self.shards[p].memory.set(rows, m)
                    self.shards[p].mem_ts.set(rows, t[:, None])
                self._account_model(p, sub, m, t)
            elif self.spmd_writes:
                continue
            else:
                self._wire(
                    p, lambda: self.transport.mem_put(p, sub, m, t),
                    sub, m, t)

    # -- server-side entry points (transport op handlers) ----------------
    def _check_hosted(self, own: np.ndarray) -> None:
        bad = sorted(int(p) for p in np.unique(own)
                     if p >= 0 and int(p) not in self.shards)
        if bad:
            raise RuntimeError(
                f"state server hosts partitions "
                f"{sorted(self.shards)} but was asked for {bad} "
                f"(routing bug or stale owner map on the caller)")

    def _count_served(self) -> None:
        # server entry points run on every caller's thread at once
        with self._acct_lock:
            self.served_calls += 1

    def _serve_feat(self, table: str, ids) -> np.ndarray:
        ids = np.asarray(ids, np.int64)
        dim = self.d_node if table == "node" else self.d_edge
        out = np.zeros((len(ids), dim), np.float32)
        own = self.owners(table, ids)
        self._check_hosted(own)
        for p in np.unique(own):
            if p < 0:
                continue
            sel = own == p
            out[sel] = self._local_get(int(p), table, ids[sel])
        return out

    def serve_feat_get(self, table: str, ids) -> np.ndarray:
        self._count_served()
        return self._serve_feat(table, ids)

    def serve_feat_put(self, table: str, ids, vals) -> None:
        self._count_served()
        ids = np.asarray(ids, np.int64)
        vals = np.asarray(vals, np.float32)
        own = self.owners(table, ids)
        self._check_hosted(own)
        for p in np.unique(own):
            if p < 0:
                continue
            sel = own == p
            self._local_put(int(p), table, ids[sel], vals[sel])

    def _serve_mem(self, ids) -> Tuple[np.ndarray, np.ndarray]:
        self._require_memory()
        ids = np.asarray(ids, np.int64)
        own = self.owners("memory", ids)
        self._check_hosted(own)
        mem = np.zeros((len(ids), self.d_memory), np.float32)
        ts = np.zeros(len(ids), np.float32)
        for p in np.unique(own):
            if p < 0:
                continue
            sel = own == p
            rows = ids[sel] // self.n_parts
            with self._mem_lock:
                mem[sel] = self.shards[int(p)].memory.get(rows)
                ts[sel] = self.shards[int(p)].mem_ts.get(rows)[:, 0]
        return mem, ts

    def serve_mem_get(self, ids) -> Tuple[np.ndarray, np.ndarray]:
        self._count_served()
        return self._serve_mem(ids)

    def serve_mem_put(self, ids, mem, ts) -> None:
        self._count_served()
        self._require_memory()
        ids = np.asarray(ids, np.int64)
        mem = np.asarray(mem, np.float32)
        ts = np.asarray(ts, np.float64)
        own = self.owners("memory", ids)
        self._check_hosted(own)
        for p in np.unique(own):
            if p < 0:
                continue
            sel = own == p
            rows = ids[sel] // self.n_parts
            with self._mem_lock:
                self.shards[int(p)].memory.set(rows, mem[sel])
                self.shards[int(p)].mem_ts.set(rows, ts[sel][:, None])

    def serve_state_batch(self, node_ids, eids, mem_ids) -> Tuple:
        """The coalesced read: one frame answers a peer's node-feat +
        edge-feat + memory requests together."""
        self._count_served()
        with trace.span("state.serve", op="state_batch"):
            nf = ef = mem = ts = None
            if node_ids is not None and len(node_ids):
                nf = self._serve_feat("node", node_ids)
            if eids is not None and len(eids):
                ef = self._serve_feat("edge", eids)
            if mem_ids is not None and len(mem_ids):
                mem, ts = self._serve_mem(mem_ids)
            return nf, ef, mem, ts

    # -- accounting ------------------------------------------------------
    def resident_bytes(self) -> int:
        return sum(self.shard_bytes(p) for p in self.shards)

    def shard_bytes(self, p: int) -> int:
        """Resident bytes of hosted partition ``p``: what machine p alone
        holds."""
        shard = self.shards[p]
        total = shard.node.used * self.d_node * 4
        total += shard.edge.used * self.d_edge * 4
        if shard.memory is not None:
            total += shard.memory.used * self.d_memory * 4
            total += shard.mem_ts.used * 4
        return total

    def stats(self) -> Dict[str, Any]:
        with self._acct_lock:
            return {"mode": "sharded",
                    "calls": self.model_calls + self.wire_calls,
                    "bytes": self.model_bytes + self.wire_bytes,
                    "wait_s": round(self.block_wait_s, 6),
                    "wire_calls": self.wire_calls,
                    "wire_bytes": self.wire_bytes,
                    "served_calls": self.served_calls,
                    "round_trips": self.wire_calls,
                    "baseline_trips": self.baseline_trips,
                    "dedup_saved_bytes": self.dedup_saved_bytes,
                    "pf_wire_s": round(self.pf_wire_s, 6),
                    "pf_overlap_s": round(
                        max(0.0, self.pf_wire_s - self.pf_block_s), 6),
                    "pf_hits": self.pf_hits,
                    "pf_misses": self.pf_misses,
                    "stale_served": self.stale_served,
                    "wire_bytes_per_part": [
                        int(b) for b in self.wire_bytes_per_part],
                    "resident_bytes": self.resident_bytes()}
