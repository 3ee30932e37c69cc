"""Distributed continuous temporal-GNN training (counterpart of
``repro.dist.continuous``; GNNFlow §4.4–§5).

The full paper loop across P machines × G trainer ranks, run through
the staged pipeline engine (``repro_torch.core.pipeline``), either all
hosted in this process (in-process mode) or one machine per OS process
(multihost mode, ``repro_torch.launch.multihost``):

  ingest   — ``Dispatcher`` splits each incremental event batch by owner
             into per-machine ``GraphPartition``s and hash-co-located
             feature shards; each partition then chains ONE
             ``SnapshotDelta`` into all of its rank samplers' device
             mirrors (``DistributedSamplerSystem.refresh``).
  sample   — the static load-balancing schedule routes every worker's
             k-hop requests to the owner machine's same-rank sampler
             (byte/CV-accounted; the paper measures CV < 0.06).
  fetch    — per-worker shards assemble through the FeatureCache in
             front of the partitioned state service.
  train    — data parallelism over W = P·G workers: the global batch is
             split into W shards, each worker computes its gradient on
             its shard (over ``grad_accum`` micro shards), the W
             gradients are summed with ``repro_torch.dist.collectives``
             (exact ``bucketed_psum`` by default; int8/fp16-quantized or
             top-k-sparsified with error feedback via
             ``DistConfig.collective``), and one optimizer step applies
             the worker average.

The JAX package runs the W workers under one ``shard_map`` over W
devices.  Here a process's workers run one after another on its
device: ``torch.func.vmap`` cannot pass through the kernels'
``autograd.Function``s, and the workers' kernels launch as they would
on separate ranks, shard by shard.  In-process a train step therefore
launches the attention forward and backward kernels W·A·L times each,
an eval step the forward W·L times; a multihost worker launches them
G·A·L and G·L times.

Per-lane loss masking makes sharding exact for ANY batch size: shards
carry a ``seed_mask``, worker w's loss is scaled by ``W / total``
(``total = max(2·Σ seed_mask over every worker, 1)``), and the summed
gradient divided by W is the global-batch mean gradient over real
events.  Ragged stream tails are padded (pow2, masked lanes) and take
the SAME collective path as full batches.

``state="replicated"`` (the default) keeps every partition's features
and memories in one replicated service; ``state="sharded"`` puts them in
a ``ShardedStateService`` (compact per-owner rows, modeled remote
traffic) with a placement-aware device cache and one coalesced
``state_batch`` prefetch per remote peer per global batch.

In-process the transport is a ``LocalTransport``: every machine is an
in-process object.  In multihost mode (a transport spanning processes,
``RpcTransport``) each process hosts one machine: its graph partition,
its G rank samplers and, with sharded state, its state shard; remote
hops and state rows go over the transport's RPCs.  The process stages
only its G workers' shards of each global batch (still drawing the
whole batch's negatives, so every process's RNG stays in lockstep),
the shard count is summed over the ``torch.distributed`` process group
(the step loss and the ``W / total`` scale are the fleet's), the
gradients are summed by the collectives over the group, and eval scores
are all-gathered in worker order, so every process computes the same
AP.  Ingest is bracketed by barriers; with sharded TGN memory the
commit adds a read fence and a commit barrier, unless
``memory_staleness > 0`` lets remote memory reads serve a prefetched
copy up to k commits stale and drops both.  Every collective and every
barrier is issued from the trainer's main thread, in the same order on
every process; the state prefetch thread only makes RPC calls.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.tgn_gdelt import DistConfig, GNNConfig
from repro_torch.core.continuous import (ContinuousTrainer, RoundMetrics,
                                         make_forward, value_and_grad)
from repro_torch.core.partition import Dispatcher, GraphPartition
from repro_torch.core.scheduler import DistributedSamplerSystem
from repro_torch.data.events import EventStream
from repro_torch.dist import collectives as C
from repro_torch.dist.transport import LocalTransport, SamplingTransport
from repro_torch.obs import trace
from repro_torch.train.optimizer import tree_map


@dataclasses.dataclass
class DistRoundMetrics(RoundMetrics):
    dispatch_bytes: int = 0     # ingest payload (owner dispatch)
    request_bytes: int = 0      # sampling request payload (modeled)
    response_bytes: int = 0     # sampling response payload (modeled)
    reduce_bytes: int = 0       # per-worker gradient wire payload
    load_cv: float = 0.0        # worker-load CV of the static schedule
    collective_steps: int = 0   # optimizer steps (all through the collective)
    node_hit_per_part: Tuple[float, ...] = ()
    edge_hit_per_part: Tuple[float, ...] = ()
    # real cross-process RPC traffic (zero in-process, whose request and
    # response bytes above are the modeled payloads)
    rpc_calls: int = 0
    rpc_wire_bytes: int = 0     # pickled request + response bytes
    rpc_wait_s: float = 0.0     # client-side blocking on remote calls
    # state-service traffic: modeled calls for the replicated service,
    # modeled + wire for the sharded one
    state_calls: int = 0
    state_bytes: int = 0
    state_wait_s: float = 0.0
    state_resident_bytes: int = 0
    # coalesced-read surface: round trips vs the per-table path, dedup
    # savings, prefetch overlap and the staleness counter
    state_round_trips: int = 0
    state_trips_per_batch: float = 0.0
    state_staged_batches: int = 0
    state_baseline_trips: int = 0
    state_dedup_saved_bytes: int = 0
    state_pf_overlap_s: float = 0.0
    state_pf_hits: int = 0
    state_pf_misses: int = 0
    state_stale_served: int = 0
    state_wire_bytes_per_part: Tuple[int, ...] = ()
    # the routing's host waits on the owners' hop results (part of
    # sample_s): seconds and count
    route_sync_s: float = 0.0
    route_syncs: int = 0


class DistributedContinuousTrainer(ContinuousTrainer):
    """P×G data-parallel continuous trainer over partitioned graph,
    feature and sampler state.  Subclasses the single-host trainer:
    only topology, the steps and the sharded batch staging differ; the
    round driver, cache lifecycle and pipeline overlap are inherited."""

    def __init__(self, cfg: GNNConfig, stream: EventStream,
                 dist: Optional[DistConfig] = None, *,
                 threshold: int = 64, cache_ratio: float = 0.03,
                 cache_policy: str = "lru", lam: float = 0.2,
                 lr: float = 1e-3, seed: int = 0, overlap: bool = True,
                 transport: Optional[SamplingTransport] = None,
                 state: str = "replicated", memory_staleness: int = 0,
                 device=None):
        if state not in ("replicated", "sharded"):
            raise ValueError(f"unknown state mode {state!r}")
        if memory_staleness < 0:
            raise ValueError("memory_staleness must be >= 0")
        self.memory_staleness = int(memory_staleness)
        self.dist = dist if dist is not None else DistConfig()
        self.transport = transport if transport is not None \
            else LocalTransport()
        self.multihost = self.transport.n_processes > 1
        self.group = None     # the process group the collectives span
        if self.multihost:
            import torch.distributed as tdist
            if not (tdist.is_available() and tdist.is_initialized()):
                raise RuntimeError(
                    f"a transport spanning {self.transport.n_processes} "
                    f"processes needs an initialized torch.distributed "
                    f"process group for its barriers and collectives "
                    f"(repro_torch.launch.multihost.init_worker_from_env)")
            if tdist.get_world_size() != self.transport.n_processes:
                raise RuntimeError(
                    f"process group of {tdist.get_world_size()} processes "
                    f"for a transport spanning "
                    f"{self.transport.n_processes}")
            self.group = tdist.group.WORLD
        self.state_mode = state
        super().__init__(cfg, stream, threshold=threshold,
                         cache_ratio=cache_ratio,
                         cache_policy=cache_policy, lam=lam, lr=lr,
                         seed=seed, overlap=overlap, device=device)

    # -- topology hooks ----------------------------------------------------
    def _init_sampling(self, threshold: int, seed: int) -> None:
        dist = self.dist
        self.n_partitions = dist.n_machines
        local = self.transport.local_machines(dist.n_machines)
        parts = [GraphPartition(p, dist.n_machines, threshold=threshold)
                 for p in local]
        self.dispatcher = Dispatcher(parts, undirected=True,
                                     n_parts=dist.n_machines)
        self.samplers = DistributedSamplerSystem(
            parts, dist.n_gpus, self.cfg.fanouts, policy=self.cfg.sampling,
            window=self.cfg.window, scan_pages=dist.scan_pages, seed=seed,
            n_machines=dist.n_machines, transport=self.transport,
            device=self.device)
        self.transport.bind(self.samplers)
        self.transport.connect()
        self.transport.barrier("rpc-up")

    def _make_state(self):
        if self.state_mode == "replicated":
            return super()._make_state()
        from repro_torch.dist.state import ShardedStateService
        cfg = self.cfg
        svc = ShardedStateService(
            self.dist.n_machines, d_node=cfg.d_node, d_edge=cfg.d_edge,
            d_memory=cfg.d_memory if cfg.use_memory else 0,
            hosted=self.transport.local_machines(self.dist.n_machines),
            transport=self.transport,
            local_rank=self.transport.process_id,
            memory_staleness=self.memory_staleness)
        # expose the hosted shards to peers; the first remote state
        # access comes after the pre-ingest barrier, long after every
        # process has bound its state here
        self.transport.bind_state(svc)
        return svc

    def _init_dist_state(self) -> None:
        dist = self.dist
        # per-worker error-feedback residual of this process's workers,
        # only for the lossy collectives (the exact path would carry
        # dead copies)
        if dist.collective == "bucketed":
            self.err: Any = {}
        else:
            self.err = [tree_map(torch.zeros_like, self.params)
                        for _ in self._worker_ids()]
        self.reduce_bytes_per_step = C.grad_payload_bytes(
            self.params, dist.collective, bits=dist.quant_bits,
            frac=dist.topk_frac)
        self._c_reduce_bytes = self.metrics.counter("reduce_bytes")
        self._c_collective_steps = self.metrics.counter("collective_steps")
        self._c_staged_batches = self.metrics.counter("staged_batches")
        # per-partition cache accounting: (node=0 | edge=1, partition)
        Pm = dist.n_machines
        self._part_hits = np.zeros((2, Pm), np.int64)
        self._part_accesses = np.zeros((2, Pm), np.int64)

    def _worker_ids(self) -> range:
        """Global worker ids this process stages batches for."""
        if not self.multihost:
            return range(self.dist.n_workers)
        G = self.dist.n_gpus
        p = self.transport.process_id
        return range(p * G, (p + 1) * G)

    @property
    def _reduce_bytes(self) -> int:
        return int(self._c_reduce_bytes.value)

    @_reduce_bytes.setter
    def _reduce_bytes(self, value: int) -> None:
        self._c_reduce_bytes.reset(value)

    @property
    def _collective_steps(self) -> int:
        return int(self._c_collective_steps.value)

    @_collective_steps.setter
    def _collective_steps(self, value: int) -> None:
        self._c_collective_steps.reset(value)

    @property
    def _staged_batches(self) -> int:
        return int(self._c_staged_batches.value)

    @_staged_batches.setter
    def _staged_batches(self, value: int) -> None:
        self._c_staged_batches.reset(value)

    # -- steps -------------------------------------------------------------
    def _build_steps(self) -> None:
        dist = self.dist
        W = dist.n_workers
        mode = dist.collective
        if mode not in ("bucketed", "quantized", "topk"):
            raise ValueError(f"unknown collective mode {mode!r}")
        forward = make_forward(self.cfg)
        optimizer = self.optimizer

        def scaled(params, item):
            """``W * masked_sum / total`` of one micro shard (``scale`` =
            W/total): summed over workers and micro shards, then divided
            by W, its gradient is the global-batch mean gradient."""
            mb, scale = item
            loss, aux = forward(params, mb)
            wsum = loss * (2.0 * mb["seed_mask"].sum())  # pos + neg lanes
            return wsum * scale, (wsum, aux)

        micro_grads = value_and_grad(scaled)

        def count(mb):
            return 2.0 * mb["seed_mask"].sum()

        group = self.group     # None in-process: no cross-process sum
        G = dist.n_gpus        # sums run machine by machine (G workers)

        def dist_step(params, opt_state, shards, err):
            """One global step over this process's workers' ``shards``
            (all W in-process); ``total`` is the fleet-wide count, as
            JAX's ``lax.psum(cnt, "dp")`` (whole numbers: exact in any
            order)."""
            total = C.machine_sum(
                [torch.stack([count(mb) for mb in micros]).sum()
                 for micros in shards], G, group).clamp_min(1.0)
            scale = W / total
            grads, wsums = [], []
            for micros in shards:            # worker by worker
                gsum, wsum = None, 0.0
                for mb in micros:
                    (_, (ws, _)), g = micro_grads(params, (mb, scale))
                    gsum = g if gsum is None else tree_map(torch.add,
                                                           gsum, g)
                    wsum = wsum + ws
                grads.append(gsum)
                wsums.append(wsum)
            if mode == "bucketed":
                red = C.bucketed_psum(grads, bucket_bytes=dist.bucket_bytes,
                                      per_machine=G, group=group)
                new_err = err
            elif mode == "quantized":
                red, new_err = C.quantized_psum_grads(
                    grads, err, bits=dist.quant_bits, per_machine=G,
                    group=group)
            else:
                red, new_err = C.topk_psum_grads(
                    grads, err, frac=dist.topk_frac, per_machine=G,
                    group=group)
            red = tree_map(lambda x: x / W, red)
            loss = C.machine_sum(wsums, G, group) / total
            new_params, new_opt = optimizer.update(red, opt_state, params)
            return new_params, new_opt, loss, new_err

        @torch.no_grad()
        def dist_eval(params, shards):
            """Every local shard's forward in worker order; scores,
            labels and weights concatenate in that order and, across
            processes, are all-gathered in process order (the JAX
            package's tiled all_gather: the shards are pow2-padded to
            one size fleet-wide), so every process holds all of them."""
            outs, cnts, wl = [], [], []
            for micros in shards:
                mb = micros[0]
                loss, aux = forward(params, mb)
                cnt = count(mb)
                outs.append(aux)
                cnts.append(cnt)
                wl.append(loss * cnt)
            total = C.machine_sum(cnts, G, group).clamp_min(1.0)
            scores, labels, w = (C.all_gather_cat(torch.cat(x), group)
                                 for x in zip(*outs))
            return C.machine_sum(wl, G, group) / total, scores, labels, w

        self._dist_step = dist_step
        self._dist_eval = dist_eval

    # -- feature fetch (device cache in front of the sharded store) -------
    # With sharded state the device cache is placement-aware: only rows
    # whose owner is another machine than local_rank are cacheable (and
    # hit/miss-counted), so the hit rate measures avoided (modeled)
    # remote traffic.  Replicated state keeps the unmasked cache.
    def _cacheable(self, table: str, ids) -> Optional[np.ndarray]:
        if self.state_mode != "sharded":
            return None
        return self.state.remote_mask(table, ids)

    def _fetch_node(self, ids):
        out = self.node_cache.fetch(
            ids, lambda miss: self.state.get_node_feats(miss),
            cacheable=self._cacheable("node", ids))
        self._account_cache(0, ids, self.node_cache.last_hit)
        return out

    def _fetch_edge(self, eids):
        out = self.edge_cache.fetch(
            eids, lambda miss: self.state.get_edge_feats(miss),
            cacheable=self._cacheable("edge", eids))
        self._account_cache(1, eids, self.edge_cache.last_hit)
        return out

    def _account_cache(self, kind: int, ids, hit: np.ndarray) -> None:
        """Per-partition hit accounting: cache traffic bucketed by the
        owner machine that a miss would have had to ask."""
        ids = np.asarray(ids, np.int64)
        own = self.state.owners("node" if kind == 0 else "edge", ids)
        valid = own >= 0
        if not valid.any():
            return
        np.add.at(self._part_accesses[kind], own[valid], 1)
        np.add.at(self._part_hits[kind], own[valid],
                  np.asarray(hit)[valid].astype(np.int64))

    def hit_rate_per_partition(self, kind: str) -> Tuple[float, ...]:
        k = 0 if kind == "node" else 1
        acc = np.maximum(self._part_accesses[k], 1)
        return tuple((self._part_hits[k] / acc).round(4).tolist())

    # -- sampling routes ---------------------------------------------------
    def _sample_fn(self, worker: int):
        m, r = divmod(worker, self.dist.n_gpus)
        return lambda seeds, ts: self.samplers.sample(
            m, r, np.asarray(seeds, np.int64), np.asarray(ts, np.float32))

    # -- sharded batch staging ---------------------------------------------
    def _stage_shards(self, src, dst, ts, *, micros: int,
                      for_train: bool = True) -> Dict[str, Any]:
        """Stage one global batch as this process's workers' (all W
        in-process) lists of ``micros`` shards, each sampled through the
        static schedule from that worker's (machine, rank) perspective.
        The negatives are drawn ONCE for the whole global batch (the
        single-host trainer's RNG consumption, and every process's in a
        fleet, which keeps their RNGs in lockstep).  Batches that do not
        split evenly are padded per shard (pow2 lanes, loss-masked), so
        EVERY step takes the collective path.  Two phases: every shard
        is sampled, one coalesced state prefetch covers the union of
        their remote rows, then cache-fronted assembly runs."""
        W = self.dist.n_workers
        n = len(src)
        neg = self.builder.negatives(n)
        chunks = W * micros
        s = -(-n // chunks)                     # ceil
        if n % chunks:
            # ragged: pow2 shard so the tail's shapes repeat
            s = max(1, 1 << (s - 1).bit_length()) if s > 1 else 1
        sampled: List[List[Dict[str, Any]]] = []
        for w in self._worker_ids():
            fn = self._sample_fn(w)
            parts = []
            for a in range(micros):
                i = w * micros + a
                lo, hi = min(i * s, n), min(i * s + s, n)
                v = hi - lo
                sc, dc, nc, tc = (
                    np.asarray(src[lo:hi]), np.asarray(dst[lo:hi]),
                    np.asarray(neg[lo:hi]), np.asarray(ts[lo:hi]))
                if v < s:
                    # pad with the batch's last real event (valid ids)
                    sc, dc, nc, tc = (
                        np.concatenate([x, np.full(s - v, fill, x.dtype)])
                        for x, fill in ((sc, src[n - 1]), (dc, dst[n - 1]),
                                        (nc, neg[n - 1]), (tc, ts[n - 1])))
                mask = np.zeros(s, np.float32)
                mask[:v] = 1.0
                seeds = np.concatenate([sc, dc, nc]).astype(np.int64)
                seed_ts = np.concatenate([tc, tc, tc]).astype(np.float32)
                parts.append(self.assembler.sample(seeds, seed_ts, fn,
                                                   mask))
            sampled.append(parts)
        self._state_prefetch([p for parts in sampled for p in parts],
                             for_train)
        self._staged_batches += 1
        stageds = [[self.assembler.assemble_batch(p) for p in parts]
                   for parts in sampled]
        if not self.assembler.needs_finalize:
            # memory-less models: the batches are complete already
            return {"batch": self._finalized(stageds), "parts": None}
        return {"batch": None, "parts": stageds}

    def _state_prefetch(self, sampled_parts: List[Dict[str, Any]],
                        for_train: bool) -> None:
        """Union the ids every shard of this global batch will read and
        ship the REMOTE subset in one background ``state_batch`` round
        trip per peer (rows already staged are filtered out first)."""
        svc = self.state
        if not callable(getattr(svc, "prefetch_async", None)):
            return
        nodes, eids, mems = [], [], []
        for p in sampled_parts:
            n_, e_, m_ = self.assembler.collect_ids(p)
            nodes.append(n_)
            eids.append(e_)
            if m_ is not None:
                mems.append(m_)
        nodes = (np.unique(np.concatenate(nodes)) if nodes
                 else np.zeros(0, np.int64))
        eids = (np.unique(np.concatenate(eids)) if eids
                else np.zeros(0, np.int64))
        # staged-buffer filter only, deliberately NOT a device-cache
        # probe: this batch's own assemblies evict probed rows under LRU
        # churn, and every such race would be a wire fallback
        nodes = svc.pf_filter_new("node",
                                  nodes[svc.remote_mask("node", nodes)])
        eids = svc.pf_filter_new("edge",
                                 eids[svc.remote_mask("edge", eids)])
        mem_ids = None
        if mems and (self.memory_staleness > 0 or not for_train):
            # staleness 0 + the commit between prefetch and finalize
            # would version-reject every buffered row of a train batch;
            # eval rounds never commit, so the buffered copy serves
            # exactly, and staleness > 0 serves within its bound
            m = np.unique(np.concatenate(mems))
            mem_ids = m[svc.remote_mask("memory", m)]
        svc.prefetch_async(node_ids=nodes, eids=eids, mem_ids=mem_ids)

    def _sharded_batch(self, staged) -> List[List[Dict[str, Any]]]:
        """This process's workers' lists of finalized micro batches (TGN
        memory blobs gathered now, after the previous step's commit)."""
        if staged["batch"] is not None:
            return staged["batch"]
        return self._finalized(staged["parts"])

    def _finalized(self, stageds):
        return [[self.assembler.finalize(p) for p in parts]
                for parts in stageds]

    # -- pipeline stage overrides ------------------------------------------
    def _stage_train(self, item) -> Dict[str, Any]:
        src, dst, ts, _ = item
        return self._stage_shards(src, dst, ts,
                                  micros=self.dist.grad_accum)

    def _stage_eval(self, item) -> Dict[str, Any]:
        src, dst, ts, _ = item
        return self._stage_shards(src, dst, ts, micros=1, for_train=False)

    def _launch_train(self, item, staged):
        shards = self._sharded_batch(staged)
        with trace.stage(self.timers, "step", phase="enqueue"):
            self.params, self.opt_state, loss, self.err = self._dist_step(
                self.params, self.opt_state, shards, self.err)
        self._reduce_bytes += self.reduce_bytes_per_step
        self._collective_steps += 1
        return loss

    def _launch_eval(self, item, staged):
        return self._dist_eval(self.params, self._sharded_batch(staged))

    # -- TGN memory fences (sharded multihost only) ------------------------
    def _cross_process_memory(self) -> bool:
        return (self.multihost and self.state_mode == "sharded"
                and self.cfg.use_memory)

    def _memory_fence(self):
        # commit_and_stage READS step t-1's memory of the pending set,
        # then WRITES step t's; with cross-process shards every process
        # must finish the read before any owner overwrites its rows.
        # The pending set derives from replicated host state, so every
        # process reaches the fence the same number of times.  With
        # memory_staleness > 0 peers may serve memory up to k commits
        # old, so both fences come off the critical path.
        if not self._cross_process_memory() or self.memory_staleness > 0:
            return None
        return lambda: self.transport.barrier("mem-read")

    def _complete_train(self, loss, item) -> float:
        loss = super()._complete_train(loss, item)
        if self._cross_process_memory() and self.memory_staleness == 0:
            # nobody gathers batch t+1's memory until every owner has
            # committed batch t's writes into its shard
            self.transport.barrier("mem-commit")
        return loss

    # -- public API --------------------------------------------------------
    def ingest(self, batch: EventStream) -> float:
        """Dispatch the incremental batch to owner partitions + feature
        shards, then publish per-partition deltas to all rank
        samplers."""
        with trace.span("ingest", events=len(batch.src)):
            return self._ingest_body(batch)

    def _ingest_body(self, batch: EventStream) -> float:
        t0 = time.perf_counter()
        if callable(getattr(self.state, "pf_reset", None)):
            # quiesce the prefetch thread and drop buffered rows: no
            # in-flight state_batch may race the feature rewrites
            self.state.pf_reset()
        self.transport.barrier("pre-ingest")
        eids = self.dispatcher.ingest(batch, self.state)
        self.events.append(batch.ts, eids)
        self._last_eids = eids
        # write coherence: rows cached before this batch's features
        # landed must not serve stale zeros
        self.node_cache.invalidate(
            np.unique(np.concatenate([batch.src, batch.dst])))
        self.edge_cache.invalidate(np.unique(eids))
        self._refresh_bytes += self.samplers.refresh()
        self.transport.barrier("post-ingest")
        dt = time.perf_counter() - t0
        self.timers["ingest"] += dt
        return dt

    # -- round bookkeeping -------------------------------------------------
    def _reset_round_stats(self) -> None:
        super()._reset_round_stats()
        self._reduce_bytes = 0
        self._collective_steps = 0
        self.samplers.reset_stats()
        self._dispatch_base = self.dispatcher.bytes_dispatched
        self._part_hits[:] = 0
        self._part_accesses[:] = 0
        self._staged_batches = 0
        self._rpc_base = self.transport.stats()
        self._state_base = self.state.stats()

    def _round_metrics(self, ev, step_losses, train_s) -> DistRoundMetrics:
        st = self.samplers.load_stats()
        rt = self.transport.stats()
        base = getattr(self, "_rpc_base", None) or {}
        ss = self.state.stats()
        sbase = getattr(self, "_state_base", None) or {}
        d = lambda key, default=0: ss.get(key, default) - sbase.get(
            key, default)
        trips = d("round_trips")
        per_part = [int(a - b) for a, b in zip(
            ss.get("wire_bytes_per_part", []),
            sbase.get("wire_bytes_per_part", []))]
        return DistRoundMetrics(
            rpc_calls=rt["calls"] - base.get("calls", 0),
            rpc_wire_bytes=(rt["bytes_out"] + rt["bytes_in"]
                            - base.get("bytes_out", 0)
                            - base.get("bytes_in", 0)),
            rpc_wait_s=rt["wait_s"] - base.get("wait_s", 0.0),
            state_calls=d("calls"), state_bytes=d("bytes"),
            state_wait_s=d("wait_s", 0.0),
            state_resident_bytes=ss["resident_bytes"],
            state_round_trips=trips,
            state_trips_per_batch=round(
                trips / max(self._staged_batches, 1), 4),
            state_staged_batches=self._staged_batches,
            state_baseline_trips=d("baseline_trips"),
            state_dedup_saved_bytes=d("dedup_saved_bytes"),
            state_pf_overlap_s=round(d("pf_overlap_s", 0.0), 6),
            state_pf_hits=d("pf_hits"), state_pf_misses=d("pf_misses"),
            state_stale_served=d("stale_served"),
            state_wire_bytes_per_part=tuple(per_part),
            route_sync_s=self.samplers.sync_s,
            route_syncs=self.samplers.syncs,
            ap=ev["ap"], auc_like=ev["acc"],
            loss=step_losses[-1] if step_losses else 0.0,
            eval_loss=ev["loss"],
            ingest_s=self.timers["ingest"],
            sample_s=self.timers["sample"],
            fetch_s=self.timers["fetch"], train_s=train_s,
            node_hit_rate=self.node_cache.hit_rate,
            edge_hit_rate=self.edge_cache.hit_rate,
            refresh_bytes=self._refresh_bytes,
            step_s=self.timers["step"], step_losses=step_losses,
            dispatch_bytes=(self.dispatcher.bytes_dispatched
                            - self._dispatch_base),
            request_bytes=st.request_bytes,
            response_bytes=st.response_bytes,
            reduce_bytes=self._reduce_bytes,
            load_cv=st.cv,
            collective_steps=self._collective_steps,
            node_hit_per_part=self.hit_rate_per_partition("node"),
            edge_hit_per_part=self.hit_rate_per_partition("edge"))

    # -- introspection -----------------------------------------------------
    def full_upload_bytes(self) -> int:
        """What ONE full snapshot re-upload across every hosted rank
        sampler would cost right now — the delta protocol's baseline."""
        total = 0
        for snap in self.samplers.snaps.values():
            per_rank = snap.edge_data_bytes() + snap.metadata_bytes()
            total += per_rank * self.dist.n_gpus
        return total
