"""Chronological mini-batching + negative sampling for link prediction
(a copy of ``repro.data.loader``; numpy only)."""
from __future__ import annotations

from typing import Iterator, Optional, Tuple

import numpy as np

from repro_torch.data.events import EventStream


def chronological_batches(stream: EventStream, batch_size: int,
                          drop_last: bool = False
                          ) -> Iterator[Tuple[np.ndarray, np.ndarray,
                                              np.ndarray,
                                              Optional[np.ndarray]]]:
    """Yields (src, dst, ts, eids) in strict time order (paper §2.1).

    ``eids`` are the batch's explicit per-event edge ids when the
    stream carries them (attached after ingest — see
    ``EventStream.with_eids``), else None; consumers that need edge
    features (TGN raw messages) use them directly instead of a ts->eid
    search that is ambiguous under duplicate timestamps."""
    n = len(stream)
    for lo in range(0, n, batch_size):
        hi = min(lo + batch_size, n)
        if drop_last and hi - lo < batch_size:
            return
        yield (stream.src[lo:hi], stream.dst[lo:hi], stream.ts[lo:hi],
               None if stream.eid is None else stream.eid[lo:hi])


def sample_negatives(stream: EventStream, n: int,
                     rng: np.random.Generator) -> np.ndarray:
    """Uniform negative destinations (item side for bipartite graphs)."""
    if stream.bipartite:
        lo = stream.n_nodes // 2
        return rng.integers(lo, stream.n_nodes, n)
    return rng.integers(0, stream.n_nodes, n)


def replay_mix(new: EventStream, history: Optional[EventStream],
               replay_ratio: float, rng: np.random.Generator
               ) -> EventStream:
    """Experience replay (paper §2.1/[49]): mix a sample of historical
    events into the finetuning set to fight catastrophic forgetting.
    Returned stream is time-sorted."""
    if history is None or replay_ratio <= 0 or len(history) == 0:
        return new
    n_replay = int(len(new) * replay_ratio)
    idx = np.sort(rng.choice(len(history), min(n_replay, len(history)),
                             replace=False))
    src = np.concatenate([history.src[idx], new.src])
    dst = np.concatenate([history.dst[idx], new.dst])
    ts = np.concatenate([history.ts[idx], new.ts])
    order = np.argsort(ts, kind="stable")
    # thread explicit eids through the thinning + re-sort: every
    # surviving event keeps ITS id (a ts->eid search cannot recover
    # them once replay sampling drops some of a tie run)
    eid = None
    if history.eid is not None and new.eid is not None:
        eid = np.concatenate([history.eid[idx], new.eid])[order]
    return EventStream(src[order], dst[order], ts[order], new.n_nodes,
                       new.d_node, new.d_edge, new.bipartite, new.seed,
                       new.n_communities, eid)
