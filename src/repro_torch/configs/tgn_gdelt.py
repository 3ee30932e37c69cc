"""The paper's own workload configs: temporal GNNs for continuous learning.

These describe the GNN wing (graph models trained on CTDG streams), not the
assigned LM archs. Defaults follow GNNFlow §6: two-layer sampling with
fanout 10 (TGN one layer), per-GPU batch sizes 4000/600/600 for
TGN/TGAT/DySAT, LRU cache at 3%/3% node/edge ratios, lambda=0.2.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Tuple


@dataclass(frozen=True)
class GNNConfig:
    name: str
    model: str                     # tgn | tgat | dysat | graphsage | gat
    d_node: int = 128              # node feature dim
    d_edge: int = 172              # edge feature dim
    d_time: int = 100              # Bochner time-encoding dim
    d_hidden: int = 100            # embedding dim
    d_memory: int = 100            # TGN node memory dim
    n_heads: int = 2
    fanouts: Tuple[int, ...] = (10, 10)
    sampling: str = "recent"       # recent | uniform | window (DySAT)
    window: float = 0.0            # DySAT time window (0 = unbounded)
    batch_size: int = 600          # per-trainer positive edges per step
    n_snapshots: int = 3           # DySAT structural snapshots
    use_memory: bool = False
    dropout: float = 0.1

    @property
    def n_layers(self) -> int:
        return len(self.fanouts)


@dataclass(frozen=True)
class DistConfig:
    """Distributed continuous-training shape (repro.dist.continuous).

    P simulated machines each hold a graph/feature shard and run G
    trainer ranks; the P*G workers form the data-parallel group whose
    gradients are reduced with the selected collective schedule."""
    n_machines: int = 4            # P: graph/feature shards ("machines")
    n_gpus: int = 2                # G: trainer ranks per machine
    collective: str = "bucketed"   # bucketed | quantized | topk
    quant_bits: int = 8            # quantized mode: 8 (int8) or 16 (fp16)
    topk_frac: float = 0.01        # topk mode: fraction transmitted
    grad_accum: int = 1            # micro-batches per optimizer step
    bucket_bytes: int = 4 << 20    # bucketed mode: fusion bucket size
    scan_pages: int = 16           # per-partition sampler page window

    @property
    def n_workers(self) -> int:
        return self.n_machines * self.n_gpus


def tgn(**kw) -> GNNConfig:
    base = dict(name="tgn", model="tgn", fanouts=(10,), sampling="recent",
                use_memory=True, batch_size=4000)
    base.update(kw)
    return GNNConfig(**base)


def tgat(**kw) -> GNNConfig:
    base = dict(name="tgat", model="tgat", fanouts=(10, 10),
                sampling="uniform", batch_size=600)
    base.update(kw)
    return GNNConfig(**base)


def dysat(**kw) -> GNNConfig:
    base = dict(name="dysat", model="dysat", fanouts=(10, 10),
                sampling="window", window=10_000.0, batch_size=600)
    base.update(kw)
    return GNNConfig(**base)


def graphsage(**kw) -> GNNConfig:
    base = dict(name="graphsage", model="graphsage", fanouts=(15, 10),
                sampling="uniform", batch_size=1200)
    base.update(kw)
    return GNNConfig(**base)


def gat(**kw) -> GNNConfig:
    base = dict(name="gat", model="gat", fanouts=(10, 10),
                sampling="uniform", batch_size=1200)
    base.update(kw)
    return GNNConfig(**base)


GNN_MODELS = {
    "tgn": tgn, "tgat": tgat, "dysat": dysat,
    "graphsage": graphsage, "gat": gat,
}
