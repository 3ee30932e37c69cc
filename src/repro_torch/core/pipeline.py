"""Staged continuous-learning pipeline engine (counterpart of
``repro.core.pipeline``; GNNFlow §4.3, §5).

``PipelineEngine``
    Drives the per-round loop as explicit stages with double buffering:
    ``prefetch(t+1) → complete(t) → launch(t+1)``.  In PyTorch the
    "dispatch" is the CUDA stream's own asynchrony: ``launch`` enqueues
    the forward, backward and optimizer kernels and returns, and the
    sync is the loss's ``.item()`` in ``complete``.  On the card little
    of ``prefetch(t+1)`` overlaps step *t*: the step is bound by its
    kernel launches, so the device finishes it about as soon as the
    host has queued it, and prefetch's first upload or hit-mask read
    waits, on the one CUDA stream, for whatever is still queued.

``FeatureAssembler``
    Batch staging behind a prefetchable interface.  ``prefetch`` is the
    pipelinable part (k-hop sampling + cache-fronted feature fetch);
    ``finalize`` is the late-bound part (TGN raw-message blobs, which
    must observe the *previous* step's memory commit) and runs after the
    stage-boundary sync.

Numerics are order-preserving: the engine only moves batch *t+1*'s
prefetch ahead of batch *t*'s completion, and prefetch depends on
nothing the train step writes, so pipelined and serial execution are
step-for-step identical.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Iterable, List, Optional

import numpy as np
import torch

from repro_torch.core.mfg import assemble, host_ids
from repro_torch.device import resolve
from repro_torch.obs import trace


class FeatureAssembler:
    """Prefetchable sampling + feature staging for one batch.

    * ``prefetch(seeds, seed_ts, sample_fn, seed_mask)`` — sampling and
      cache-fronted feature fetch, against graph / snapshot / cache
      state that the train step never writes.
    * ``finalize(staged)`` — attaches TGN raw-message memory blobs; for
      memory-less models a passthrough (``needs_finalize`` is False).

    Every tensor of the staged batch lives on ``device`` (the card
    unless ``"cpu"`` is asked for).
    """

    def __init__(self, cfg, *, fetch_node, fetch_edge, edge_feat_fn=None,
                 memory=None, timers: Optional[Dict[str, float]] = None,
                 device=None):
        self.cfg = cfg
        self.fetch_node = fetch_node
        self.fetch_edge = fetch_edge
        self.edge_feat_fn = edge_feat_fn
        self.memory = memory
        self.device = resolve(device)
        self.timers = timers if timers is not None else {
            "sample": 0.0, "fetch": 0.0}

    @property
    def needs_finalize(self) -> bool:
        return self.memory is not None

    def sample(self, seeds: np.ndarray, seed_ts: np.ndarray, sample_fn,
               seed_mask: Optional[np.ndarray] = None) -> Dict[str, Any]:
        """Phase 1 of ``prefetch``: k-hop sampling only, no feature I/O.
        ``seed_mask`` flags the valid third of the seed triple (padded
        lanes carry 0 and are loss-masked in the forward)."""
        cfg = self.cfg
        seeds = np.asarray(seeds, np.int64)
        seed_ts = np.asarray(seed_ts, np.float32)
        if seed_mask is None:
            seed_mask = np.ones(len(seeds) // 3, np.float32)
        mask_t = torch.from_numpy(
            np.asarray(seed_mask, np.float32)).to(self.device)

        with trace.stage(self.timers, "sample", seeds=len(seeds)):
            if cfg.model == "dysat":
                # one hop-set per time-window snapshot (newest last)
                snap_layers = [sample_fn(seeds, seed_ts - i * cfg.window)
                               for i in reversed(range(cfg.n_snapshots))]
                return {"snap_layers": snap_layers, "mask": mask_t}
            return {"layers": sample_fn(seeds, seed_ts), "mask": mask_t}

    def collect_ids(self, sampled: Dict[str, Any]):
        """Union of (node ids, edge ids, memory ids) the assembly and
        finalize of ``sampled`` will read — what an async remote-row
        prefetch must cover.  Memory ids include each node's pending
        raw-message counterpart (and the pending edge's feature id goes
        into the edge set); they are computed against the CURRENT raw
        state, so a commit between collect and finalize can shift a few
        ids — those just fall back to the synchronous path."""
        layer_list = (sampled["layers"] if "layers" in sampled
                      else [l for snap in sampled["snap_layers"]
                            for l in snap])
        nodes, eids = [], []
        for layer in layer_list:
            nodes.append(host_ids(layer.dst_nodes).ravel())
            nodes.append(host_ids(layer.nbr_ids).ravel())
            eids.append(host_ids(layer.nbr_eids).ravel())
        nodes = np.unique(np.concatenate(nodes)) if nodes else \
            np.zeros(0, np.int64)
        nodes = nodes[nodes >= 0]
        eids = np.unique(np.concatenate(eids)) if eids else \
            np.zeros(0, np.int64)
        eids = eids[eids >= 0]
        mem_ids = None
        if self.memory is not None:
            m = self.memory
            safe = nodes[nodes < len(m.raw_has)]
            pend = safe[m.raw_has[safe]]
            others = m.raw_other[pend]
            # id 0 rides along: gather() reads memory row 0 for every
            # node WITHOUT a pending message (its placeholder "other")
            mem_ids = np.unique(np.concatenate(
                [nodes, others, np.zeros(1, np.int64)]))
            pend_eids = m.raw_eid[pend]
            eids = np.unique(np.concatenate([eids,
                                             pend_eids[pend_eids >= 0]]))
        return nodes, eids, mem_ids

    def assemble_batch(self, sampled: Dict[str, Any]) -> Dict[str, Any]:
        """Phase 2 of ``prefetch``: cache/StateService feature fetch +
        batch assembly for an already-sampled batch."""
        mask_t = sampled["mask"]
        with trace.stage(self.timers, "fetch", phase="assemble"):
            if "snap_layers" in sampled:
                snapshots = [assemble(layers, self.fetch_node,
                                      self.fetch_edge, device=self.device)
                             for layers in sampled["snap_layers"]]
                return {"batch": {"snapshots": snapshots,
                                  "seed_mask": mask_t},
                        "layers": None}
            layers = sampled["layers"]
            hops = assemble(layers, self.fetch_node, self.fetch_edge,
                            device=self.device)
        return {"batch": {"hops": hops, "seed_mask": mask_t},
                "layers": layers if self.needs_finalize else None}

    def prefetch(self, seeds: np.ndarray, seed_ts: np.ndarray, sample_fn,
                 seed_mask: Optional[np.ndarray] = None) -> Dict[str, Any]:
        """Sample + fetch one batch of [src|dst|neg] seeds."""
        return self.assemble_batch(
            self.sample(seeds, seed_ts, sample_fn, seed_mask))

    def finalize(self, staged: Dict[str, Any]) -> Dict[str, Any]:
        """Late-bound staging: gather the TGN memory blobs NOW, after
        the previous step's ``commit_and_stage`` has landed."""
        layers = staged["layers"]
        if layers is None:
            return staged["batch"]
        with trace.stage(self.timers, "fetch", phase="finalize"):
            blobs = []
            for layer in layers:
                dst = host_ids(layer.dst_nodes)
                nbr = host_ids(layer.nbr_ids)
                blobs.append((
                    self.memory.gather(dst, self.edge_feat_fn),
                    self.memory.gather(nbr.reshape(-1), self.edge_feat_fn)))
            batch = dict(staged["batch"])
            batch["mem_blobs"] = blobs
        return batch


class PipelineEngine:
    """Double-buffered stage executor for the continuous trainer.

    ``run`` threads every work item through three caller-supplied
    stages:

    * ``prefetch(item) -> staged`` — sample + feature fetch;
    * ``launch(item, staged) -> handle`` — finalize the batch and
      enqueue the train step (returns once the host has queued it);
    * ``complete(handle, item) -> result`` — the stage-boundary sync:
      read the loss and apply host side effects (TGN memory commit).

    With ``overlap=True`` (default) the schedule per item *t* is
    ``prefetch(t+1) → complete(t) → launch(t+1)``; with
    ``overlap=False`` the stages run strictly serially, the measured
    baseline and the numerics A/B.
    """

    def __init__(self, overlap: bool = True):
        self.overlap = overlap

    def run(self, items: Iterable, *, prefetch: Callable,
            launch: Callable, complete: Callable) -> List[Any]:
        results: List[Any] = []
        inflight = None

        def _finish(pending):
            # the virtual device lane closes only after the sync, so the
            # span covers enqueue -> retire
            handle, item, dspan = pending
            with trace.span("pipeline.complete"):
                out = complete(handle, item)
            trace.end_async(dspan)
            return out

        try:
            for item in items:
                if not self.overlap and inflight is not None:
                    pending, inflight = inflight, None
                    results.append(_finish(pending))
                with trace.span("pipeline.prefetch"):
                    staged = prefetch(item)  # overlaps the in-flight step
                if inflight is not None:   # stage boundary: sync t
                    pending, inflight = inflight, None
                    results.append(_finish(pending))
                dspan = trace.begin_async("device.step", lane="device")
                with trace.span("pipeline.launch"):
                    handle = launch(item, staged)
                inflight = (handle, item, dspan)
        except BaseException:
            # a stage raised mid-round: complete the in-flight step (its
            # optimizer update is already queued — completing it applies
            # the TGN commit, leaving the trainer resumable), then
            # surface the ORIGINAL exception
            if inflight is not None:
                try:
                    _finish(inflight)
                except Exception:
                    pass               # the first failure wins
            raise
        if inflight is not None:           # drain (epoch boundary)
            results.append(_finish(inflight))
        return results


def pad_tail(arrays, n: int, m: int):
    """Pad 1-D arrays of length ``n`` to ``m`` lanes with their last
    real element (a valid id/timestamp — results are loss-masked)."""
    if m == n:
        return tuple(arrays)
    out = []
    for x in arrays:
        p = np.full(m, x[n - 1] if n else 0, x.dtype)
        p[:n] = x[:n]
        out.append(p)
    return tuple(out)


def pow2_pad_len(n: int, full: int) -> int:
    """Batch lane count: ``full`` batches keep their shape; ragged tails
    pad up to a power of two (at least 8), capped at ``full``, so the
    padded shapes — and the cache bookkeeping they drive — are the JAX
    package's."""
    if n >= full:
        return n
    pow2 = max(8, 1 << (n - 1).bit_length()) if n > 1 else 8
    return min(pow2, full)
