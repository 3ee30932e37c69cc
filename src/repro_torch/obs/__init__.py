"""repro_torch.obs — observability: span tracing, metric registry,
structured logging and the trace report (a copy of the JAX package's
framework-free ``repro.obs``).

- :mod:`repro_torch.obs.trace`   — thread-aware span tracer, Chrome trace export,
  fleet merge (``REPRO_TRACE=1`` to enable).
- :mod:`repro_torch.obs.metrics` — typed counter/gauge/histogram registry;
  round metrics are snapshots/deltas of it.
- :mod:`repro_torch.obs.log`     — structured stderr logger (``REPRO_LOG`` level).
- :mod:`repro_torch.obs.report`  — ``python -m repro_torch.obs.report
  TRACE.json``: per-span p50/p99/total, wire bytes per op, cache hit rates.
"""
from repro_torch.obs import trace
from repro_torch.obs.log import get_logger
from repro_torch.obs.metrics import Counter, Gauge, Histogram, MetricRegistry, RegistryTimers
from repro_torch.obs.trace import span, stage

__all__ = [
    "trace",
    "span",
    "stage",
    "get_logger",
    "Counter",
    "Gauge",
    "Histogram",
    "MetricRegistry",
    "RegistryTimers",
]
