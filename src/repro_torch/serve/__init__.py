"""Online serving wing: low-latency temporal-embedding and
link-prediction queries against the live graph (counterpart of
``repro.serve``).

* :class:`~repro_torch.serve.handle.HandlePublisher` — copy-on-write
  device mirror; each ingest publishes an immutable
  :class:`~repro_torch.serve.handle.SnapshotHandle` (snapshot version +
  device tensors + model params), and the atomic handle swap is the
  only synchronisation between ingest and query threads.
* :class:`~repro_torch.serve.admission.AdmissionQueue` — batched
  admission: requests collect up to a size/timeout budget.
* :class:`~repro_torch.serve.engine.QueryEngine` — sample → state-fetch
  → forward on a worker thread, pinned to one handle per batch.
* :class:`~repro_torch.serve.edgebank.EdgeBank` — non-parametric
  recency tier answering link queries when the GNN queue is saturated.
"""
from repro_torch.serve.admission import AdmissionQueue, Query, QueryFuture
from repro_torch.serve.edgebank import EdgeBank
from repro_torch.serve.engine import QueryEngine, QueryResult
from repro_torch.serve.handle import HandlePublisher, SnapshotHandle

__all__ = [
    "AdmissionQueue", "EdgeBank", "HandlePublisher", "Query",
    "QueryEngine", "QueryFuture", "QueryResult", "SnapshotHandle",
]
