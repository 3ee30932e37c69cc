"""QueryEngine: sample → state-fetch → forward on a pinned handle.

Counterpart of ``repro.serve.engine``.  One worker thread drains the
admission queue; each admitted batch pins the newest
:class:`SnapshotHandle` ONCE and answers every query in the batch
against exactly that snapshot version and parameter set — the version
travels on each response.  On the card a batch runs the hand-written
kernels: one ``temporal_sample`` launch per hop, one ``cache_gather``
launch per cache fetch, one ``temporal_attn`` launch per GNN layer.

Tiering: when the GNN queue is saturated (depth ≥ ``saturate_depth``)
or full, link queries fall back to the :class:`EdgeBank` table.

Wiring to a trainer: ``QueryEngine.attach(trainer)`` (a
``repro_torch.core.continuous.ContinuousTrainer``) builds the publisher
and registers the engine for the trainer's publish and params hooks.
Wiring without a trainer (the ingest sequence of
``ContinuousTrainer._ingest_body``)::

    pub = HandlePublisher(scan_pages=16)
    eng = QueryEngine(pub, cfg=cfg, state=state)   # state: StateService
    eng.start()
    # per ingested batch: add_edges, state puts, build/refresh_snapshot,
    # then eng.on_publish(owner, snap, batch, nodes, eids)
    # with owner.params holding the port's parameters
    res = eng.query_link([u], [v], [t])            # res.version, res.scores

Thread-safety notes:

* the engine's ``FeatureCache`` instances are touched ONLY by the
  worker thread; the ingest thread queues invalidations
  (:meth:`invalidate`) which the worker drains at batch start;
* node/edge feature reads against a live ``StateService`` are safe
  because ingested features are deterministic per id; TGN memory reads
  return the last committed memory (bounded-stale);
* the handle swap in ``HandlePublisher`` is the only synchronisation
  with ingest — no locks on the query hot path.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.feature_cache import FeatureCache
from repro_torch.core.mfg import assemble
from repro_torch.core.sampling import sample_khop
from repro_torch.device import resolve
from repro_torch.models import gnn as G
from repro_torch.obs import trace
from repro_torch.obs.log import get_logger
from repro_torch.obs.metrics import MetricRegistry
from repro_torch.serve.admission import AdmissionQueue, Query, QueryFuture
from repro_torch.serve.edgebank import EdgeBank
from repro_torch.serve.handle import HandlePublisher, SnapshotHandle

log = get_logger("serve")


def _pow2_lanes(n: int) -> int:
    """Pad a query batch's lane count to a power of two (min 8): the
    shape buckets of the JAX engine, kept so both engines see the same
    padded batches (and cache bookkeeping)."""
    if n <= 8:
        return 8
    return 1 << (n - 1).bit_length()


def _pad(arrs, n: int, m: int):
    """Pad 1-D arrays from n to m lanes repeating the last real entry
    (a valid id/ts — padded lanes are sliced off before reply)."""
    if m == n:
        return tuple(arrs)
    out = []
    for x in arrs:
        p = np.full(m, x[n - 1] if n else 0, x.dtype)
        p[:n] = x[:n]
        out.append(p)
    return tuple(out)


@dataclasses.dataclass
class QueryResult:
    """One answered query.  ``version`` is the snapshot version the
    answer was computed against (EdgeBank tier: the bank's update
    counter); ``nbrs`` carries the hop-0 sampled neighbourhood when the
    engine runs with ``record_neighbors=True``."""
    kind: str
    tier: str
    version: int
    latency_s: float
    scores: Optional[np.ndarray] = None
    emb: Optional[np.ndarray] = None
    nbrs: Optional[Dict[str, Any]] = None


class QueryEngine:
    """Versioned online query engine over the live graph.  Its caches and
    forward run on ``device`` (the card unless ``device="cpu"``), which
    must be the publisher's device."""

    def __init__(self, publisher: HandlePublisher, *, cfg,
                 state, edgebank: Optional[EdgeBank] = None,
                 max_batch: int = 64, admit_timeout_s: float = 0.002,
                 max_depth: int = 1024, saturate_depth: Optional[int] = None,
                 cache_nodes: int = 256, cache_edges: int = 256,
                 id_space_nodes: int = 1 << 20,
                 id_space_edges: int = 1 << 20,
                 metrics: Optional[MetricRegistry] = None,
                 record_neighbors: bool = False, seed: int = 0,
                 device=None):
        if cfg.model == "dysat":
            raise NotImplementedError(
                "serving covers the single-neighborhood models "
                "(tgn/tgat/graphsage/gat); dysat's snapshot stack is a "
                "training-eval construct")
        self.device = resolve(device)
        if publisher.device != self.device:
            raise ValueError(f"publisher on {publisher.device}, engine on "
                             f"{self.device}")
        self.publisher = publisher
        self.cfg = cfg
        self.state = state
        self.edgebank = edgebank
        self.record_neighbors = record_neighbors
        self.queue = AdmissionQueue(max_batch=max_batch,
                                    timeout_s=admit_timeout_s,
                                    max_depth=max_depth)
        self.saturate_depth = (int(saturate_depth) if saturate_depth
                               is not None else 4 * max_batch)
        self.metrics = metrics if metrics is not None else MetricRegistry()
        self._h_latency = self.metrics.histogram("serve.latency_us")
        self._h_batch = self.metrics.histogram("serve.batch_queries")
        self._c_queries = self.metrics.counter("serve.queries")
        self._c_fallback = self.metrics.counter("serve.fallback")
        self._c_batches = self.metrics.counter("serve.batches")
        self._g_version = self.metrics.gauge("serve.version")
        # worker-thread-only caches (invalidations arrive via the
        # pending queue below, drained at batch start)
        self.node_cache = FeatureCache(
            cache_nodes, cfg.d_node, id_space=id_space_nodes,
            device=self.device, metrics=self.metrics,
            name="serve.cache.node")
        self.edge_cache = FeatureCache(
            cache_edges, cfg.d_edge, id_space=id_space_edges,
            device=self.device, metrics=self.metrics,
            name="serve.cache.edge")
        self._inval_lock = threading.Lock()
        self._pend_nodes: List[np.ndarray] = []
        self._pend_eids: List[np.ndarray] = []
        self._n_events = 0
        self._t_max = 0.0
        self._seed = int(seed)
        self._seq = 0
        self._thread: Optional[threading.Thread] = None

    # -- wiring ----------------------------------------------------------
    @classmethod
    def attach(cls, trainer, *, edgebank: Optional[EdgeBank] = None,
               history: int = 8, start: bool = True, device=None,
               **kw) -> "QueryEngine":
        """Build a publisher + engine for ``trainer`` (a
        ``repro_torch.core.continuous.ContinuousTrainer``), register the
        serving hooks, and start the worker.  The engine serves the
        trainer's parameter trees as they are, so it runs on the
        trainer's device (``device`` may only name that one)."""
        device = trainer.device if device is None else resolve(device)
        if device != trainer.device:
            raise ValueError(f"trainer on {trainer.device}, engine asked "
                             f"for {device}: the engine must share the "
                             f"trainer's device")
        pub = HandlePublisher(scan_pages=trainer.sampler.scan_pages,
                              history=history, device=device)
        kw.setdefault("id_space_nodes", trainer.stream.n_nodes + 1)
        kw.setdefault("id_space_edges", len(trainer.stream) + 1)
        eng = cls(pub, cfg=trainer.cfg, state=trainer.state,
                  edgebank=edgebank, device=device, **kw)
        trainer.register_serving(eng)
        if start:
            eng.start()
        return eng

    # -- ingest-side protocol --------------------------------------------
    def on_publish(self, owner, snap, batch, nodes, eids) -> None:
        """Ingest-thread hook: fold the batch into the EdgeBank tier,
        queue cache invalidations for the rewritten rows, and publish
        the new snapshot version with ``owner.params``."""
        if batch is not None:
            if self.edgebank is not None:
                self.edgebank.update(batch.src, batch.dst, batch.ts)
            self._n_events += len(batch.src)
            if len(batch.ts):
                self._t_max = max(self._t_max, float(np.max(batch.ts)))
        self.invalidate(nodes, eids)
        h = self.publisher.publish(
            snap, params=owner.params, t_max=self._t_max,
            n_events=self._n_events)
        self._g_version.set(h.version)

    def on_params(self, params) -> None:
        """Swap refreshed model params into the current handle."""
        self.publisher.set_params(params)

    def invalidate(self, nodes, eids) -> None:
        """Queue cache invalidations (any thread); applied by the
        worker at the next batch start."""
        with self._inval_lock:
            if nodes is not None and len(nodes):
                self._pend_nodes.append(np.asarray(nodes, np.int64))
            if eids is not None and len(eids):
                self._pend_eids.append(np.asarray(eids, np.int64))

    def _drain_invalidations(self) -> None:
        with self._inval_lock:
            nodes, self._pend_nodes = self._pend_nodes, []
            eids, self._pend_eids = self._pend_eids, []
        if nodes:
            self.node_cache.invalidate(np.unique(np.concatenate(nodes)))
        if eids:
            self.edge_cache.invalidate(np.unique(np.concatenate(eids)))

    # -- public query API ------------------------------------------------
    def query_link(self, src, dst, ts, *, timeout: Optional[float] = 30.0
                   ) -> QueryResult:
        out = self.submit_link(src, dst, ts)
        if isinstance(out, QueryResult):
            return out
        return out.result(timeout)

    def submit_link(self, src, dst, ts):
        """Admit a link query; returns a :class:`QueryFuture`, or an
        immediate EdgeBank-tier :class:`QueryResult` when the GNN queue
        is saturated/full."""
        src = np.atleast_1d(np.asarray(src, np.int64))
        dst = np.atleast_1d(np.asarray(dst, np.int64))
        ts = np.atleast_1d(np.asarray(ts, np.float32))
        self._c_queries.add()
        t0 = time.perf_counter()
        if (self.edgebank is not None
                and self.queue.depth >= self.saturate_depth):
            return self._edgebank_answer(src, dst, ts, t0)
        q = Query("link", src, dst, ts, QueryFuture(), t0)
        if not self.queue.submit(q):
            if self.edgebank is not None:
                return self._edgebank_answer(src, dst, ts, t0)
            raise RuntimeError("serving queue full and no fallback tier")
        return q.future

    def query_embed(self, nodes, ts, *, timeout: Optional[float] = 30.0
                    ) -> QueryResult:
        return self.submit_embed(nodes, ts).result(timeout)

    def submit_embed(self, nodes, ts) -> QueryFuture:
        nodes = np.atleast_1d(np.asarray(nodes, np.int64))
        ts = np.atleast_1d(np.asarray(ts, np.float32))
        self._c_queries.add()
        q = Query("embed", nodes, None, ts, QueryFuture(),
                  time.perf_counter())
        if not self.queue.submit(q):
            raise RuntimeError("serving queue full (embed has no "
                               "non-parametric fallback tier)")
        return q.future

    def _edgebank_answer(self, src, dst, ts, t0) -> QueryResult:
        with trace.span("serve.fallback", pairs=len(src)):
            scores = self.edgebank.predict(src, dst, ts)
        lat = time.perf_counter() - t0
        self._c_fallback.add()
        self._h_latency.observe(lat * 1e6)
        return QueryResult(kind="link", tier="edgebank",
                           version=self.edgebank.version,
                           latency_s=lat, scores=scores)

    # -- worker ----------------------------------------------------------
    def start(self) -> "QueryEngine":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._worker, name="serve-worker", daemon=True)
            self._thread.start()
        return self

    def stop(self) -> None:
        self.queue.close()
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def __enter__(self) -> "QueryEngine":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def _worker(self) -> None:
        while True:
            batch = self.queue.next_batch()
            if batch is None:
                return
            try:
                self._process(batch)
            except Exception as e:     # noqa: BLE001 — fail the batch,
                log.error("serve batch failed", op="serve.batch",
                          error=repr(e), queries=len(batch))
                for q in batch:        # not the engine
                    if not q.future.done():
                        q.future.set_exception(e)

    def _process(self, batch: List[Query]) -> None:
        with trace.span("serve.batch", queries=len(batch)) as sp:
            self._drain_invalidations()
            handle = self.publisher.current()
            if handle is None:
                raise RuntimeError("no snapshot published yet")
            self._c_batches.add()
            self._h_batch.observe(len(batch))
            links = [q for q in batch if q.kind == "link"]
            embeds = [q for q in batch if q.kind == "embed"]
            if links:
                self._answer(handle, links, link=True)
            if embeds:
                self._answer(handle, embeds, link=False)
            sp.set(version=handle.version)

    def _next_generator(self) -> Optional[torch.Generator]:
        """Per-batch generator for the stochastic sampling policies (the
        deterministic ``recent`` policy needs none, so serving and
        offline replays agree bit for bit)."""
        if self.cfg.sampling not in ("uniform", "window"):
            return None
        self._seq += 1
        seed = (self._seed * 0x9E3779B1 + self._seq) % (1 << 63)
        return torch.Generator(device=self.device).manual_seed(seed)

    def _fetch_node(self, ids):
        return self.node_cache.fetch(
            ids, lambda miss: self.state.get_node_feats(miss))

    def _fetch_edge(self, eids):
        return self.edge_cache.fetch(
            eids, lambda miss: self.state.get_edge_feats(miss))

    def _fetch_memory(self):
        if not self.cfg.use_memory:
            return None
        return lambda ids: self.state.get_memory(ids)[0]

    @torch.inference_mode()
    def _forward(self, params, hops, *, link: bool) -> np.ndarray:
        h = G.gnn_embed(params["gnn"], self.cfg, hops)
        if link:
            n = h.shape[0] // 2            # seeds = [src | dst]
            h = G.link_score(params["head"], h[:n], h[n:])
        return h.cpu().numpy()

    def _sample_assemble(self, handle: SnapshotHandle, seeds, seed_ts,
                         *, use_cache: bool = True):
        """Shared sample+fetch path (worker hot path AND the offline
        parity replay — ``use_cache=False`` bypasses the worker-only
        caches so any thread may call it)."""
        with trace.span("serve.sample", lanes=len(seeds)):
            layers = sample_khop(
                handle.dev, seeds, seed_ts, fanouts=self.cfg.fanouts,
                policy=self.cfg.sampling, window=self.cfg.window,
                scan_pages=handle.scan_pages,
                generator=self._next_generator())
        fn = self._fetch_node if use_cache else self.state.get_node_feats
        fe = self._fetch_edge if use_cache else self.state.get_edge_feats
        with trace.span("serve.fetch"):
            hops = assemble(layers, fn, fe, self._fetch_memory())
        return layers, hops

    def _answer(self, handle: SnapshotHandle, queries: List[Query],
                *, link: bool) -> None:
        ns = [q.n for q in queries]
        n = sum(ns)
        m = _pow2_lanes(n)
        u = np.concatenate([q.src for q in queries])
        t = np.concatenate([q.ts for q in queries])
        if link:
            v = np.concatenate([q.dst for q in queries])
            u, v, t = _pad((u, v, t), n, m)
            seeds = np.concatenate([u, v])
            seed_ts = np.concatenate([t, t])
        else:
            u, t = _pad((u, t), n, m)
            seeds, seed_ts = u, t
        layers, hops = self._sample_assemble(handle, seeds, seed_ts)
        with trace.span("serve.forward", lanes=len(seeds)):
            out = self._forward(handle.params, hops, link=link)
        l0 = layers[0]
        nbr_ids = l0.nbr_ids.cpu().numpy()
        nbr_ts = l0.nbr_ts.cpu().numpy()
        nbr_mask = l0.mask.cpu().numpy()
        off = 0
        for q, k in zip(queries, ns):
            nbrs = None
            if self.record_neighbors:
                nbrs = {"ids": nbr_ids[off:off + k],
                        "ts": nbr_ts[off:off + k],
                        "mask": nbr_mask[off:off + k]}
                if link:
                    nbrs["dst_ids"] = nbr_ids[m + off:m + off + k]
                    nbrs["dst_mask"] = nbr_mask[m + off:m + off + k]
            lat = time.perf_counter() - q.t_submit
            self._h_latency.observe(lat * 1e6)
            res = QueryResult(
                kind=q.kind, tier="gnn", version=handle.version,
                latency_s=lat, nbrs=nbrs,
                scores=out[off:off + k].copy() if link else None,
                emb=None if link else out[off:off + k].copy())
            q.future.set_result(res)
            off += k

    # -- offline replay (parity harnesses) -------------------------------
    def offline_forward(self, version: int, src, dst=None, ts=None):
        """Recompute a query on the RETAINED handle for ``version`` —
        the parity oracle: a served response must match this ≤ 1e-4.
        Bypasses admission, batching and the caches; safe from any
        thread."""
        handle = self.publisher.get(version)
        if handle is None:
            raise KeyError(f"version {version} not in publisher history")
        src = np.atleast_1d(np.asarray(src, np.int64))
        ts = np.atleast_1d(np.asarray(ts, np.float32))
        if dst is not None:
            dst = np.atleast_1d(np.asarray(dst, np.int64))
            seeds = np.concatenate([src, dst])
            seed_ts = np.concatenate([ts, ts])
        else:
            seeds, seed_ts = src, ts
        _, hops = self._sample_assemble(handle, seeds, seed_ts,
                                        use_cache=False)
        return self._forward(handle.params, hops, link=dst is not None)
