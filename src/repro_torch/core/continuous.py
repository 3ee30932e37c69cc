"""Continuous temporal GNN learning loop (counterpart of
``repro.core.continuous``; GNNFlow §3, §4.3).

Workflow per incremental batch G(t, t+1):
  1. evaluate the CURRENT model on the new events (test-then-train AP);
  2. ingest: update the dynamic graph + feature store, refresh the
     sampler's device mirror incrementally;
  3. finetune ``epochs`` epochs over new events (+ experience replay),
     each epoch in strict chronological order;
  4. cache lifecycle: reuse across rounds, snapshot at round start,
     restore at each epoch start (§4.3).

Execution is staged through ``repro_torch.core.pipeline.PipelineEngine``.
The JAX package's jitted ``value_and_grad`` step becomes an eager step:
the forward, ``torch.autograd.grad`` over a detached alias of every
parameter, then the functional AdamW, which returns a new parameter
tree.  Nothing writes a parameter in place, so a tree handed to a
serving listener never changes under it.  On the card the step runs
the hand-written kernels: ``temporal_sample`` per hop,
``cache_gather`` per cache fetch, and the ``temporal_attn`` forward and
backward per attention layer.

TGN's node memory follows the paper/TGN scheme: raw messages are staged
per node and applied lazily inside the training graph (so the GRU
memory updater gets gradients), then committed to the store after each
optimizer step; memory blobs are assembled at launch time, after the
previous step's commit.

``ContinuousTrainer`` keeps the hooks the JAX package's distributed
trainer overrides (``_init_sampling``, ``_make_state``,
``_build_steps``, ``_stage_*``, ``_launch_*``, ``_complete_train``,
``_memory_params``, ``_memory_fence``, ``_init_dist_state``).  The kernel
route follows the device, so the JAX constructor's ``use_pallas`` has no
counterpart; ``device`` (the card unless ``"cpu"`` is asked for) takes
its place.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.tgn_gdelt import GNNConfig
from repro_torch.core.dgraph import DynamicGraph
from repro_torch.core.feature_cache import FeatureCache
from repro_torch.core.feature_store import ReplicatedStateService, StateService
from repro_torch.core.pipeline import (FeatureAssembler, PipelineEngine,
                                       pad_tail, pow2_pad_len)
from repro_torch.core.sampling import TemporalSampler
from repro_torch.core.snapshot import build_snapshot, refresh_snapshot
from repro_torch.data.events import EventStream
from repro_torch.data.loader import (chronological_batches, replay_mix,
                                     sample_negatives)
from repro_torch.device import resolve
from repro_torch.models import gnn as G
from repro_torch.obs import trace
from repro_torch.obs.metrics import MetricRegistry
from repro_torch.train.optimizer import (Optimizer, adamw, tree_leaves,
                                         tree_map, tree_unflatten)

NULL = -1


class EventLog:
    """Chronological (ts -> eid) record of ingested events: recovers the
    edge ids of a training batch whose stream carries none (TGN's raw
    messages need the batch's edge features).  Arrays grow
    geometrically so appends stay amortized O(batch)."""

    def __init__(self):
        self.size = 0
        self.ts = np.zeros(1024, np.float64)
        self.eid = np.zeros(1024, np.int64)

    def append(self, ts: np.ndarray, eids: np.ndarray) -> None:
        # sort within the batch (batches are chronological batch to
        # batch), keeping searchsorted valid
        ts = np.asarray(ts, np.float64)
        order = np.argsort(ts, kind="stable")
        n = self.size + len(ts)
        if n > len(self.ts):
            grow = max(int(len(self.ts) * 1.5), n)
            for name in ("ts", "eid"):
                arr = getattr(self, name)
                g = np.zeros(grow, arr.dtype)
                g[:self.size] = arr[:self.size]
                setattr(self, name, g)
        self.ts[self.size:n] = ts[order]
        self.eid[self.size:n] = np.asarray(eids, np.int64)[order]
        self.size = n

    def eids_for(self, ts: np.ndarray) -> np.ndarray:
        if not self.size:
            return np.zeros(len(ts), np.int64)
        ts = np.asarray(ts, np.float64)
        log = self.ts[:self.size]
        pos = np.searchsorted(log, ts, side="left")
        if len(ts) > 1:
            # tie disambiguation: consecutive queries with the SAME
            # timestamp take consecutive log entries
            idx = np.arange(len(ts))
            new_run = np.concatenate([[True], ts[1:] != ts[:-1]])
            run_start = np.maximum.accumulate(np.where(new_run, idx, 0))
            rank = idx - run_start
            hi = np.searchsorted(log, ts, side="right")
            pos = np.minimum(pos + rank, np.maximum(hi - 1, pos))
        pos = np.clip(pos, 0, self.size - 1)
        return self.eid[pos]


# ---------------------------------------------------------------------------
# TGN raw-message store (lazy memory updates, trained GRU)
# ---------------------------------------------------------------------------


class TGNMemory:
    """Pending raw messages per node (host arrays) over the memory table
    of the ``StateService``.  ``gather`` hands the trainer tensors on
    ``device``; ``commit_and_stage`` runs the GRU there without autograd
    and copies the new memories to the host only for ``put_memory``."""

    def __init__(self, cfg: GNNConfig, state: StateService, *, device):
        self.cfg = cfg
        self.state = state
        self.device = torch.device(device)
        n0 = 1024
        self.raw_other = np.full(n0, NULL, np.int64)
        self.raw_eid = np.full(n0, NULL, np.int64)
        self.raw_t = np.zeros(n0, np.float64)
        self.raw_has = np.zeros(n0, bool)

    def _ensure(self, n: int) -> None:
        if n <= len(self.raw_other):
            return
        grow = max(int(len(self.raw_other) * 1.5), n)
        for name, fill in (("raw_other", NULL), ("raw_eid", NULL),
                           ("raw_t", 0.0), ("raw_has", False)):
            arr = getattr(self, name)
            g = np.full(grow, fill, arr.dtype)
            g[:len(arr)] = arr
            setattr(self, name, g)

    def _t(self, a, dtype=np.float32) -> torch.Tensor:
        return torch.from_numpy(np.asarray(a, dtype)).to(self.device)

    def gather(self, ids: np.ndarray, edge_feat_fn) -> Dict[str, Any]:
        """Pending-message ingredients for ``ids`` (feeds the GRU)."""
        ids = np.asarray(ids, np.int64)
        self._ensure(int(ids.max(initial=0)) + 1)
        safe = np.maximum(ids, 0)
        has = self.raw_has[safe] & (ids >= 0)
        other = np.where(has, self.raw_other[safe], 0)
        eid = np.where(has, self.raw_eid[safe], 0)
        t = np.where(has, self.raw_t[safe], 0.0)
        mem, last_upd = self.state.get_memory(ids)
        other_mem, _ = self.state.get_memory(other)
        return {
            "mem": self._t(mem),
            "last_upd": self._t(last_upd),
            "other_mem": self._t(other_mem),
            "e_feat": self._t(edge_feat_fn(eid)),
            "msg_t": self._t(t),
            "has": self._t(has, bool),
        }

    @torch.no_grad()
    def commit_and_stage(self, mem_params, src, dst, ts, eids,
                         edge_feat_fn, fence=None) -> None:
        """After a step: commit pending messages of this batch's
        endpoints, then stage the new raw messages.  ``fence`` (a
        callable or None) runs between the read of the pre-commit memory
        and the ``put_memory`` that overwrites it (the distributed
        trainer's cross-process barrier)."""
        nodes = np.concatenate([src, dst])
        others = np.concatenate([dst, src])
        tts = np.concatenate([ts, ts])
        ee = np.concatenate([eids, eids])
        self._ensure(int(nodes.max(initial=0)) + 1)

        uniq = np.unique(nodes)
        pend = uniq[self.raw_has[uniq]]
        if len(pend):
            g = self.gather(pend, edge_feat_fn)
            new_mem = G.memory_batch_update(
                mem_params, pend, g["mem"], g["last_upd"], g["other_mem"],
                g["e_feat"], g["msg_t"]).cpu().numpy()
            if fence is not None:
                fence()     # all peers done reading the old memory
            self.state.put_memory(pend, new_mem, self.raw_t[pend])
            self.raw_has[pend] = False
        # stage new messages, last event per node wins ('last'
        # aggregator; events are time-sorted so later writes win)
        self.raw_other[nodes] = others
        self.raw_eid[nodes] = ee
        self.raw_t[nodes] = tts
        self.raw_has[nodes] = True


# ---------------------------------------------------------------------------
# Shared step/batch builders
# ---------------------------------------------------------------------------


def make_forward(cfg: GNNConfig):
    """Loss/score forward over one assembled batch.  The loss is a
    mask-weighted mean over the batch's valid lanes
    (``batch["seed_mask"]``): padded ragged-tail lanes carry weight 0."""

    def apply_memory(params, hops, mem_blobs):
        """Apply pending raw messages in-graph (trains the GRU)."""
        out = []
        for hop, (dstb, nbrb) in zip(hops, mem_blobs):
            def eff(blob):
                new = G.memory_batch_update(
                    params["memory"], None, blob["mem"],
                    blob["last_upd"], blob["other_mem"],
                    blob["e_feat"], blob["msg_t"])
                return torch.where(blob["has"][..., None], new,
                                   blob["mem"])
            dmem = eff(dstb)
            nK = tuple(hop["nbr_feat"].shape[:2])
            nmem = eff(nbrb).reshape(nK + (-1,))
            hop = dict(hop)
            hop["dst_feat"] = torch.cat([hop["dst_feat"], dmem], dim=-1)
            hop["nbr_feat"] = torch.cat([hop["nbr_feat"], nmem], dim=-1)
            out.append(hop)
        return out

    def forward(params, batch):
        if cfg.model == "dysat":
            h = G.dysat_embed(params["gnn"], cfg, batch["snapshots"])
        else:
            hops = batch["hops"]
            if cfg.use_memory:
                hops = apply_memory(params, hops, batch["mem_blobs"])
            h = G.gnn_embed(params["gnn"], cfg, hops)
        n = h.shape[0] // 3       # seeds = [src | dst | neg]
        h_src, h_dst, h_neg = h[:n], h[n:2 * n], h[2 * n:3 * n]
        pos = G.link_score(params["head"], h_src, h_dst)
        neg = G.link_score(params["head"], h_src, h_neg)
        scores = torch.cat([pos, neg])
        labels = torch.cat([torch.ones_like(pos), torch.zeros_like(neg)])
        w = torch.cat([batch["seed_mask"], batch["seed_mask"]])
        loss = G.bce_logits(scores, labels, weights=w)
        return loss, (scores, labels, w)

    return forward


def value_and_grad(forward):
    """``forward(params, batch) -> (loss, aux)`` to
    ``(params, batch) -> ((loss, aux), grads)``, with ``grads`` shaped
    like ``params``: the eager counterpart of ``jax.value_and_grad(...,
    has_aux=True)``.  The forward sees detached aliases of the
    parameters (no copy), so ``params`` never joins a graph; a leaf the
    loss does not reach gets a zero gradient, as in JAX."""

    def fn(params, batch):
        leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
        loss, aux = forward(tree_unflatten(params, leaves), batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, grads)]
        aux = tree_map(lambda x: x.detach(), aux)
        return (loss.detach(), aux), tree_unflatten(params, grads)

    return fn


class BatchBuilder:
    """Negative-sampling stream: one draw per global batch from the
    trainer's numpy RNG, in the JAX trainer's order."""

    def __init__(self, stream: EventStream, *,
                 rng: Optional[np.random.Generator] = None):
        self.stream = stream
        self.rng = rng if rng is not None else np.random.default_rng(0)

    def negatives(self, n: int) -> np.ndarray:
        return sample_negatives(self.stream, n, self.rng)


# ---------------------------------------------------------------------------
# Continuous trainer
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class RoundMetrics:
    ap: float
    auc_like: float
    loss: float               # last finetune-step train loss
    ingest_s: float
    sample_s: float
    fetch_s: float
    train_s: float            # finetune-loop wall clock (overlapped)
    node_hit_rate: float
    edge_hit_rate: float
    refresh_bytes: int = 0    # H2D payload of this round's mirror sync
    step_s: float = 0.0       # step time: enqueue + boundary sync
    eval_loss: float = 0.0    # test-then-train loss on the new events
    step_losses: List[float] = dataclasses.field(default_factory=list)
    """every finetune step's loss, in order (the JAX package keeps only
    the last; the card-vs-CPU check compares them all)"""


class ContinuousTrainer:
    """Single-host trainer and the shared engine-driven skeleton (the
    distributed wing subclasses it, overriding topology, the steps,
    batch staging and metrics)."""

    def __init__(self, cfg: GNNConfig, stream: EventStream, *,
                 threshold: int = 64, cache_ratio: float = 0.03,
                 cache_policy: str = "lru", lam: float = 0.2,
                 lr: float = 1e-3, seed: int = 0, overlap: bool = True,
                 device=None):
        self.cfg = cfg
        self.stream = stream
        self.device = resolve(device)
        self.rng = np.random.default_rng(seed)
        # single source of truth for per-round accounting
        self.metrics = MetricRegistry()

        self._init_sampling(threshold, seed)    # sets self.n_partitions
        self.state = self._make_state()
        cache_n = max(64, int(cache_ratio * stream.n_nodes))
        cache_e = max(64, int(cache_ratio * len(stream)))
        self.node_cache = FeatureCache(
            cache_n, cfg.d_node, id_space=stream.n_nodes + 1,
            policy=cache_policy, lam=lam, device=self.device,
            metrics=self.metrics, name="cache.node")
        self.edge_cache = FeatureCache(
            cache_e, cfg.d_edge, id_space=len(stream) + 1,
            policy=cache_policy, lam=lam, device=self.device,
            metrics=self.metrics, name="cache.edge")

        self.params: Dict[str, Any] = G.init_params(
            cfg, torch.Generator().manual_seed(seed), device=self.device)
        self.memory = TGNMemory(cfg, self.state, device=self.device) \
            if cfg.use_memory else None
        self.events = EventLog()
        self._last_eids = np.zeros(0, np.int64)
        self.assembler = FeatureAssembler(
            cfg, fetch_node=self._fetch_node, fetch_edge=self._fetch_edge,
            edge_feat_fn=self.state.get_edge_feats, memory=self.memory,
            timers=self.metrics.timers("sample", "fetch", "ingest",
                                       "step"),
            device=self.device)
        self.builder = BatchBuilder(stream, rng=self.rng)
        self.timers = self.assembler.timers

        self.optimizer: Optimizer = adamw(lr, weight_decay=0.0)
        self.opt_state = self.optimizer.init(self.params)
        self.history: Optional[EventStream] = None
        # online-serving listeners (repro_torch.serve): notified after
        # every ingest (new snapshot version) and round (new params)
        self._serving: List[Any] = []
        self._c_refresh_bytes = self.metrics.counter("refresh_bytes")
        self._init_dist_state()
        self._build_steps()
        self.engine = PipelineEngine(overlap=overlap)

    # -- topology hooks (overridden by a distributed trainer) -------------
    def _make_state(self) -> StateService:
        cfg = self.cfg
        return ReplicatedStateService(
            self.n_partitions, d_node=cfg.d_node, d_edge=cfg.d_edge,
            d_memory=cfg.d_memory if cfg.use_memory else 0)

    def _init_sampling(self, threshold: int, seed: int) -> None:
        self.n_partitions = 1
        self.graph = DynamicGraph(threshold=threshold, undirected=True)
        self.sampler = TemporalSampler(
            DynamicGraph(threshold=threshold), self.cfg.fanouts,
            policy=self.cfg.sampling, window=self.cfg.window, seed=seed,
            device=self.device)
        self._snap = None

    def _init_dist_state(self) -> None:
        pass

    # -- steps -------------------------------------------------------------
    def _build_steps(self) -> None:
        forward = make_forward(self.cfg)
        grad_fn = value_and_grad(forward)

        def train_step(params, opt_state, batch):
            (loss, aux), grads = grad_fn(params, batch)
            new_params, new_opt = self.optimizer.update(grads, opt_state,
                                                        params)
            return new_params, new_opt, loss, aux

        @torch.no_grad()
        def eval_step(params, batch):
            return forward(params, batch)

        self._train_step = train_step
        self._eval_step = eval_step

    # -- plumbing ---------------------------------------------------------
    @property
    def _refresh_bytes(self) -> int:
        return int(self._c_refresh_bytes.value)

    @_refresh_bytes.setter
    def _refresh_bytes(self, value: int) -> None:
        self._c_refresh_bytes.reset(value)

    def ingest(self, batch: EventStream) -> float:
        with trace.span("ingest", events=len(batch.src)):
            return self._ingest_body(batch)

    def _ingest_body(self, batch: EventStream) -> float:
        t0 = time.perf_counter()
        base = self.graph.num_edges
        eids = self.graph.add_edges(batch.src, batch.dst, batch.ts)
        # event-level ids (add_edges duplicates eids for undirected)
        self._last_eids = base + np.arange(len(batch.src), dtype=np.int64)
        self.events.append(batch.ts, self._last_eids)
        nodes = np.unique(np.concatenate([batch.src, batch.dst]))
        self.state.put_node_feats(nodes, batch.node_features(nodes))
        uniq_e = np.unique(eids)
        # single-partition service here: every src hashes to owner 0
        self.state.register_edges(uniq_e, np.zeros_like(uniq_e))
        self.state.put_edge_feats(uniq_e, batch.edge_features(uniq_e))
        # write coherence: a row cached before this batch's feature
        # landed (featureless negative) must not keep its stale zeros
        self.node_cache.invalidate(nodes)
        self.edge_cache.invalidate(uniq_e)
        if self._snap is None:
            self._snap = build_snapshot(self.graph)
        else:
            self._snap = refresh_snapshot(self.graph, self._snap)
        # delta-upload: only the changed snapshot rows go to the device
        self.sampler.refresh(self._snap)
        self._refresh_bytes += self.sampler.last_refresh_bytes
        # serving listeners see the new version only after the snapshot
        # refresh and the feature writes above
        for listener in self._serving:
            listener.on_publish(self, self._snap, batch, nodes, uniq_e)
        dt = time.perf_counter() - t0
        self.timers["ingest"] += dt
        return dt

    def _fetch_node(self, ids):
        return self.node_cache.fetch(
            ids, lambda miss: self.state.get_node_feats(miss))

    def _fetch_edge(self, eids):
        return self.edge_cache.fetch(
            eids, lambda miss: self.state.get_edge_feats(miss))

    # -- pipeline stages ---------------------------------------------------
    def _stage_batch(self, src, dst, ts) -> Dict[str, Any]:
        """Prefetch one [src|dst|neg] batch; ragged tails are padded
        (pow2, loss-masked lanes) as in the JAX package."""
        n = len(src)
        neg = self.builder.negatives(n)
        m = pow2_pad_len(n, self.cfg.batch_size)
        src, dst, neg, ts = pad_tail((src, dst, neg, ts), n, m)
        mask = np.zeros(m, np.float32)
        mask[:n] = 1.0
        seeds = np.concatenate([src, dst, neg]).astype(np.int64)
        seed_ts = np.concatenate([ts, ts, ts]).astype(np.float32)
        return self.assembler.prefetch(seeds, seed_ts,
                                       self.sampler.sample, mask)

    def _stage_train(self, item) -> Dict[str, Any]:
        src, dst, ts, _ = item
        return self._stage_batch(src, dst, ts)

    _stage_eval = _stage_train

    def _launch_train(self, item, staged):
        batch = self.assembler.finalize(staged)
        with trace.stage(self.timers, "step", phase="enqueue"):
            self.params, self.opt_state, loss, _ = self._train_step(
                self.params, self.opt_state, batch)
        return loss

    def _launch_eval(self, item, staged):
        batch = self.assembler.finalize(staged)
        loss, (scores, labels, w) = self._eval_step(self.params, batch)
        return loss, scores, labels, w

    def _memory_params(self):
        """TGN memory module params for the host-side commit."""
        return self.params["memory"]

    def _memory_fence(self):
        """Read/write fence handed to the TGN commit — None in-process."""
        return None

    def _complete_train(self, loss, item) -> float:
        """Stage boundary: wait for the step's loss, then apply its host
        side effects (TGN raw-message commit)."""
        src, dst, ts, eids = item
        with trace.stage(self.timers, "step", phase="sync"):
            loss = loss.item()
        if self.cfg.use_memory:
            if eids is None:    # stream without explicit ids: fall
                eids = self.events.eids_for(ts)  # back to the ts search
            self.memory.commit_and_stage(
                self._memory_params(), src, dst, ts, eids,
                self.state.get_edge_feats, fence=self._memory_fence())
        return loss

    # -- public API --------------------------------------------------------
    def register_serving(self, listener: Any) -> None:
        """Attach an online-serving listener (``repro_torch.serve``).  Its
        ``on_publish(trainer, snap, batch, nodes, eids)`` fires at the
        end of every ingest and ``on_params(params)`` at the end of every
        finetune round; with a snapshot already built it is primed
        at once."""
        self._serving.append(listener)
        if self._snap is not None:
            listener.on_publish(self, self._snap, None,
                                np.zeros(0, np.int64),
                                np.zeros(0, np.int64))
            listener.on_params(self.params)

    def evaluate(self, events: EventStream) -> Dict[str, float]:
        with trace.span("eval", events=len(events)):
            return self._evaluate_body(events)

    def _evaluate_body(self, events: EventStream) -> Dict[str, float]:
        scores_all, labels_all, losses = [], [], []

        def complete(handle, item):
            loss, scores, labels, w = handle
            keep = w.cpu().numpy() > 0    # drop padded ragged-tail lanes
            losses.append(loss.item())
            scores_all.append(scores.cpu().numpy()[keep])
            labels_all.append(labels.cpu().numpy()[keep])

        self.engine.run(
            chronological_batches(events, self.cfg.batch_size),
            prefetch=self._stage_eval, launch=self._launch_eval,
            complete=complete)
        s = np.concatenate(scores_all)
        l = np.concatenate(labels_all)
        return {"ap": G.average_precision(s, l),
                "loss": float(np.mean(losses)),
                "acc": float(((s > 0) == l).mean())}

    def train_round(self, new_events: EventStream, *, epochs: int = 3,
                    replay_ratio: float = 0.0) -> RoundMetrics:
        """Paper §3: evaluate-then-finetune on one incremental batch."""
        with trace.span("round", events=len(new_events)):
            return self._train_round_body(new_events, epochs=epochs,
                                          replay_ratio=replay_ratio)

    def _train_round_body(self, new_events: EventStream, *, epochs: int,
                          replay_ratio: float) -> RoundMetrics:
        self._reset_round_stats()

        ev = self.evaluate(new_events)          # test-then-train
        self.ingest(new_events)
        # the ingest-assigned per-event edge ids ride to the TGN commit
        new_events = new_events.with_eids(self._last_eids)

        train_set = replay_mix(new_events, self.history, replay_ratio,
                               self.rng)
        # cache restoration point (§4.3)
        self.node_cache.snapshot_round()
        self.edge_cache.snapshot_round()
        step_losses: List[float] = []
        t0 = time.perf_counter()
        for ep in range(epochs):
            self.node_cache.restore_epoch()
            self.edge_cache.restore_epoch()
            step_losses += self.engine.run(
                chronological_batches(train_set, self.cfg.batch_size),
                prefetch=self._stage_train, launch=self._launch_train,
                complete=self._complete_train)
        train_s = time.perf_counter() - t0

        self.history = (train_set if self.history is None
                        else _concat_streams(self.history, new_events))
        for listener in self._serving:       # round done: fresh params
            listener.on_params(self.params)
        return self._round_metrics(ev, step_losses, train_s)

    # -- round bookkeeping hooks -------------------------------------------
    def _reset_round_stats(self) -> None:
        for k in self.timers:
            self.timers[k] = 0.0
        self._refresh_bytes = 0
        self.node_cache.reset_stats()
        self.edge_cache.reset_stats()

    def _round_metrics(self, ev, step_losses, train_s) -> RoundMetrics:
        return RoundMetrics(
            ap=ev["ap"], auc_like=ev["acc"],
            loss=step_losses[-1] if step_losses else 0.0,
            eval_loss=ev["loss"],
            ingest_s=self.timers["ingest"], sample_s=self.timers["sample"],
            fetch_s=self.timers["fetch"], train_s=train_s,
            node_hit_rate=self.node_cache.hit_rate,
            edge_hit_rate=self.edge_cache.hit_rate,
            refresh_bytes=self._refresh_bytes,
            step_s=self.timers["step"], step_losses=step_losses)


def _concat_streams(a: EventStream, b: EventStream) -> EventStream:
    eid = None
    if a.eid is not None and b.eid is not None:
        eid = np.concatenate([a.eid, b.eid])
    return EventStream(np.concatenate([a.src, b.src]),
                       np.concatenate([a.dst, b.dst]),
                       np.concatenate([a.ts, b.ts]), b.n_nodes, b.d_node,
                       b.d_edge, b.bipartite, b.seed, b.n_communities,
                       eid)
