"""Static scheduling for distributed sampling (counterpart of
``repro.core.scheduler``; GNNFlow §4.4, Fig. 6).

Policy: when trainer (machine m, local GPU rank r) must sample a target
node owned by machine m', the request is serviced by the GPU with the
SAME local rank r on m'.  Every (machine, rank) pair therefore serves
exactly one requester per remote machine per step — deterministic,
coordination-free load balance (the paper measures CV < 0.06 across
workers).

WHERE machine m' lives is a transport concern
(``repro_torch.dist.transport``): in the in-process mode every machine
is hosted here and a remote hop is a direct call with byte accounting.
On one card every (machine, rank) sampler mirrors its partition's
snapshot on the trainer's device, and each owner's hop result is read
back to the host to be scattered into the requester's layer — one
device-to-host copy per (worker, hop, owner), timed in ``sync_s``.

Served hops run on a CUDA stream of their own (the counterpart of the
JAX package's spare sampling device), for latency: a peer's request
does not queue behind the step kernels the trainer's main thread has
already enqueued on the default stream.  (It is not needed against a
deadlock: the collectives are staged through host memory, and that
copy drains the default stream before a process blocks in gloo, so no
device work waits on a peer.)  The serving stream waits on an
event recorded after each ``refresh`` (which writes the mirrors on the
main thread's stream), so a served hop never reads a half-refreshed
mirror.  On the CPU there is no stream.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.partition import GraphPartition, owner_of
from repro_torch.core.sampling import NULL, SampledLayer, TemporalSampler
from repro_torch.core.snapshot import (GraphSnapshot, build_snapshot,
                                       refresh_snapshot)
from repro_torch.device import resolve
from repro_torch.obs import trace


@dataclasses.dataclass
class SamplingLoadStats:
    per_worker_targets: np.ndarray     # (machines, gpus)
    request_bytes: int
    response_bytes: int

    @property
    def cv(self) -> float:
        x = self.per_worker_targets.reshape(-1).astype(np.float64)
        return float(x.std() / x.mean()) if x.mean() else 0.0


class DistributedSamplerSystem:
    """P machines x G gpus; per-machine graph shard + per-rank samplers.

    ``partitions`` are the machines hosted IN THIS PROCESS (all P of
    them in the in-process mode).  Sampler seeds derive from the GLOBAL
    machine id, ``seed * 1000 + m * 10 + r``.  Every sampler's mirror
    lives on ``device`` (the card unless ``"cpu"`` is asked for).
    """

    def __init__(self, partitions: Sequence[GraphPartition], n_gpus: int,
                 fanouts: Sequence[int], policy: str = "recent",
                 window: float = 0.0, scan_pages: int = 16, seed: int = 0,
                 n_machines: Optional[int] = None, transport=None,
                 device=None):
        self.partitions = list(partitions)
        self.n_machines = (n_machines if n_machines is not None
                           else len(partitions))
        self.n_gpus = n_gpus
        self.fanouts = tuple(fanouts)
        self.transport = transport
        self.device = resolve(device)
        # the serving stream and the event it waits on (set by refresh)
        self._serve_stream = (torch.cuda.Stream(device=self.device)
                              if self.device.type == "cuda" else None)
        self._refreshed: Optional[torch.cuda.Event] = None
        # one snapshot per hosted machine, one sampler per (machine,
        # rank): ranks share the machine snapshot object so refresh()
        # can chain SnapshotDeltas into every rank's device mirror
        self.snaps: Dict[int, GraphSnapshot] = {}
        self.samplers: Dict[int, List[TemporalSampler]] = {}
        self._locks: Dict[int, List[threading.Lock]] = {}
        for part in self.partitions:
            m = part.part_id
            snap = build_snapshot(part.graph)
            self.snaps[m] = snap
            self.samplers[m] = [
                TemporalSampler(snap, fanouts, policy=policy,
                                window=window, scan_pages=scan_pages,
                                seed=seed * 1000 + m * 10 + r,
                                device=self.device)
                for r in range(n_gpus)]
            self._locks[m] = [threading.Lock() for _ in range(n_gpus)]
        self._load = np.zeros((self.n_machines, n_gpus), np.int64)
        # per-(requesting machine, rank) request sequence: the request-
        # keyed RNG (TemporalSampler.request_key) rides on it.  NOT
        # reset by reset_stats: it tracks program order, not traffic
        self._req_seq: Dict[Tuple[int, int], int] = {}
        self.request_bytes = 0
        self.response_bytes = 0
        self.last_refresh_bytes = 0
        self.total_refresh_bytes = 0
        self.sync_s = 0.0       # host waits on owners' hop results
        self.syncs = 0

    def refresh(self) -> int:
        """Publish per-partition SnapshotDeltas to every rank sampler:
        O(changed cells) of upload per refresh instead of a re-upload
        per rank.  Returns the bytes this refresh moved across all
        hosted ranks."""
        total = 0
        for part in self.partitions:
            m = part.part_id
            self.snaps[m] = refresh_snapshot(part.graph, self.snaps[m])
            for r, s in enumerate(self.samplers[m]):
                with self._locks[m][r]:
                    s.refresh(self.snaps[m])
                total += s.last_refresh_bytes
        if self._serve_stream is not None:
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(self.device))
            self._refreshed = ev
        self.last_refresh_bytes = total
        self.total_refresh_bytes += total
        return total

    def _serving(self):
        """Context for one served hop: the serving stream, ordered after
        the last refresh (a no-op on the CPU)."""
        stream = self._serve_stream
        if stream is None:
            return contextlib.nullcontext()
        if self._refreshed is not None:
            stream.wait_event(self._refreshed)
        return torch.cuda.stream(stream)

    def mirror_bytes(self) -> int:
        """Device bytes of every hosted sampler's snapshot mirror."""
        return sum(t.numel() * t.element_size()
                   for ranks in self.samplers.values() for s in ranks
                   for t in (s._mirror.dev or {}).values())

    # -- hop service (local call or server entry) --------------------------
    def serve_hop(self, machine: int, rank: int, targets: np.ndarray,
                  times: np.ndarray, pmask: np.ndarray, k: int,
                  req_machine: int = 0, seq: int = 0, hop: int = 0
                  ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                             np.ndarray]:
        """One (already pow2-padded) hop on a hosted sampler, under the
        per-sampler lock; (req_machine, seq, hop) is the request
        coordinate stochastic policies key their noise on.  Returns
        host arrays (the wire's format): reading them back waits for the
        hop's launch on the serving stream only."""
        return self._serve(machine, rank, targets, times, pmask, k,
                           req_machine, seq, hop)[0]

    def _serve(self, machine, rank, targets, times, pmask, k,
               req_machine, seq, hop):
        """:meth:`serve_hop` plus the seconds its host read waited."""
        worker = self.samplers[machine][rank]
        key = worker.request_key(req_machine, seq, hop)
        with trace.span("sample.serve_hop", machine=machine, rank=rank,
                        n=len(targets)):
            with self._locks[machine][rank], self._serving():
                out = worker.sample_hop(targets, times, pmask, k, key=key)
                t0 = time.perf_counter()
                out = tuple(x.cpu().numpy() for x in out)
                return out, time.perf_counter() - t0

    def _route_hop(self, trainer_machine: int, rank: int,
                   targets: np.ndarray, times: np.ndarray,
                   tmask: np.ndarray, k: int, seq: int = 0,
                   hop: int = 0):
        """Route one hop's targets to their owners (static schedule)."""
        N = len(targets)
        nbr = np.full((N, k), NULL, np.int32)
        eid = np.full((N, k), NULL, np.int32)
        ts = np.zeros((N, k), np.float32)
        msk = np.zeros((N, k), bool)
        owners = owner_of(np.maximum(targets, 0), self.n_machines)
        for m in range(self.n_machines):
            sel = (owners == m) & tmask & (targets >= 0)
            n_sel = int(sel.sum())
            if not n_sel:
                continue
            # static schedule: remote requests go to the same local rank
            self._load[m, rank] += n_sel
            if m != trainer_machine:
                self.request_bytes += n_sel * 12   # (id, ts)
            # pad each request to a power-of-two length (masked rows) so
            # the launch shapes stay O(log N) however ownership splits
            idx = np.nonzero(sel)[0]
            bucket = 1 << (n_sel - 1).bit_length()
            idx_p = np.concatenate(
                [idx, np.full(bucket - n_sel, idx[0], idx.dtype)])
            pmask = np.zeros(bucket, bool)
            pmask[:n_sel] = True
            if m in self.samplers:
                (a, b, c, d), dt = self._serve(
                    m, rank, targets[idx_p], times[idx_p], pmask, k,
                    trainer_machine, seq, hop)
                self.sync_s += dt
                self.syncs += 1
            else:
                a, b, c, d = self.transport.sample_hop(
                    m, rank, targets[idx_p], times[idx_p], pmask, k,
                    req_machine=trainer_machine, seq=seq, hop=hop)
            nbr[idx] = np.asarray(a)[:n_sel]
            eid[idx] = np.asarray(b)[:n_sel]
            ts[idx] = np.asarray(c)[:n_sel]
            msk[idx] = np.asarray(d)[:n_sel]
            if m != trainer_machine:
                self.response_bytes += n_sel * k * 12
        return nbr, eid, ts, msk

    def sample(self, trainer_machine: int, rank: int, seeds, seed_ts
               ) -> List[SampledLayer]:
        """k-hop distributed sampling from one trainer's perspective;
        the layers hold host (numpy) arrays."""
        targets = np.asarray(seeds, np.int64)
        times = np.asarray(seed_ts, np.float32)
        tmask = np.ones(len(targets), bool)
        seq = self._req_seq.get((trainer_machine, rank), 0)
        self._req_seq[(trainer_machine, rank)] = seq + 1
        layers: List[SampledLayer] = []
        for hop, k in enumerate(self.fanouts):
            nbr, eid, ts, msk = self._route_hop(
                trainer_machine, rank, targets, times, tmask, k,
                seq=seq, hop=hop)
            layers.append(SampledLayer(
                dst_nodes=targets.astype(np.int32),
                dst_times=times, dst_mask=tmask.copy(),
                nbr_ids=nbr, nbr_eids=eid, nbr_ts=ts, mask=msk))
            targets = nbr.reshape(-1).astype(np.int64)
            times = ts.reshape(-1)
            tmask = msk.reshape(-1)
        return layers

    def load_stats(self) -> SamplingLoadStats:
        return SamplingLoadStats(per_worker_targets=self._load.copy(),
                                 request_bytes=self.request_bytes,
                                 response_bytes=self.response_bytes)

    def reset_stats(self) -> None:
        self._load[:] = 0
        self.request_bytes = 0
        self.response_bytes = 0
        self.sync_s = 0.0
        self.syncs = 0
