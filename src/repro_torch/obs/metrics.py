"""Typed metric registry: counters, gauges, histograms.

One registry per trainer/transport becomes the single source of truth for
what used to be scattered ad-hoc ints and dicts (`RoundMetrics` timers,
`FeatureCache` hit accounting, `RpcTransport` wire counters). Round
metrics are computed as snapshot deltas of the registry rather than
hand-threaded constructor args.

Counters/gauges are float-valued and individually locked — cheap enough
for the batch-granular hot path (a few dozen updates per round), and safe
for the background prefetch / RPC server threads that share a registry.
"""
from __future__ import annotations

import threading
from typing import Any, Dict, Iterator, List, Optional, Tuple

__all__ = ["Counter", "Gauge", "Histogram", "MetricRegistry", "RegistryTimers"]


class Counter:
    """Monotonic-by-convention accumulator (``reset`` is explicit)."""

    __slots__ = ("name", "_value", "_lock")

    def __init__(self, name: str) -> None:
        self.name = name
        self._value = 0.0
        self._lock = threading.Lock()

    def add(self, n: float = 1.0) -> None:
        with self._lock:
            self._value += n

    def reset(self, value: float = 0.0) -> None:
        with self._lock:
            self._value = float(value)

    @property
    def value(self) -> float:
        return self._value


class Gauge:
    """Last-write-wins scalar."""

    __slots__ = ("name", "_value", "_lock")

    def __init__(self, name: str) -> None:
        self.name = name
        self._value = 0.0
        self._lock = threading.Lock()

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    def reset(self, value: float = 0.0) -> None:
        self.set(value)

    @property
    def value(self) -> float:
        return self._value


class Histogram:
    """Count/sum/min/max plus reservoir percentiles over a ring of the
    most recent observations."""

    __slots__ = ("name", "_lock", "_count", "_sum", "_min", "_max",
                 "_ring", "_cap", "_idx")

    def __init__(self, name: str, capacity: int = 4096) -> None:
        self.name = name
        self._lock = threading.Lock()
        self._cap = int(capacity)
        self._reset_locked()

    def _reset_locked(self) -> None:
        self._count = 0
        self._sum = 0.0
        self._min = float("inf")
        self._max = float("-inf")
        self._ring: List[float] = []
        self._idx = 0

    def observe(self, v: float) -> None:
        v = float(v)
        with self._lock:
            self._count += 1
            self._sum += v
            if v < self._min:
                self._min = v
            if v > self._max:
                self._max = v
            if len(self._ring) < self._cap:
                self._ring.append(v)
            else:
                self._ring[self._idx] = v
                self._idx = (self._idx + 1) % self._cap

    def reset(self) -> None:
        with self._lock:
            self._reset_locked()

    def percentile(self, q: float) -> float:
        with self._lock:
            ring = sorted(self._ring)
        if not ring:
            return 0.0
        i = min(int(q / 100.0 * len(ring)), len(ring) - 1)
        return ring[i]

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    def summary(self) -> Dict[str, float]:
        with self._lock:
            ring = sorted(self._ring)
            count, total = self._count, self._sum
            lo = self._min if count else 0.0
            hi = self._max if count else 0.0

        def pct(q: float) -> float:
            if not ring:
                return 0.0
            return ring[min(int(q / 100.0 * len(ring)), len(ring) - 1)]

        return {"count": count, "sum": total, "min": lo, "max": hi,
                "p50": pct(50.0), "p99": pct(99.0)}


class RegistryTimers:
    """MutableMapping adapter exposing a set of counters as the familiar
    ``timers["sample"] += dt`` dict, so existing call sites (including the
    per-round zeroing loop) keep working while the registry stays the
    authority."""

    __slots__ = ("_counters",)

    def __init__(self, counters: Dict[str, Counter]) -> None:
        self._counters = counters

    def __getitem__(self, key: str) -> float:
        return self._counters[key].value

    def __setitem__(self, key: str, value: float) -> None:
        self._counters[key].reset(value)

    def __iadd__(self, other: Any) -> "RegistryTimers":  # pragma: no cover
        raise TypeError("use timers[key] += dt")

    def __contains__(self, key: str) -> bool:
        return key in self._counters

    def __iter__(self) -> Iterator[str]:
        return iter(self._counters)

    def __len__(self) -> int:
        return len(self._counters)

    def keys(self):
        return self._counters.keys()

    def items(self) -> List[Tuple[str, float]]:
        return [(k, c.value) for k, c in self._counters.items()]

    def get(self, key: str, default: float = 0.0) -> float:
        c = self._counters.get(key)
        return c.value if c is not None else default


class MetricRegistry:
    """Get-or-create home for named metrics, with snapshot/delta export."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._metrics: Dict[str, Any] = {}

    def _get_or_create(self, name: str, cls: type, *args: Any) -> Any:
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name, *args)
                self._metrics[name] = m
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r} already registered as "
                    f"{type(m).__name__}, not {cls.__name__}")
            return m

    def counter(self, name: str) -> Counter:
        return self._get_or_create(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get_or_create(name, Gauge)

    def histogram(self, name: str, capacity: int = 4096) -> Histogram:
        return self._get_or_create(name, Histogram, capacity)

    def timers(self, *keys: str, prefix: str = "time.") -> RegistryTimers:
        return RegistryTimers({k: self.counter(prefix + k) for k in keys})

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._metrics)

    def snapshot(self) -> Dict[str, Any]:
        """Flat, JSON-serializable view: scalars for counters/gauges,
        summary dicts for histograms."""
        with self._lock:
            items = list(self._metrics.items())
        out: Dict[str, Any] = {}
        for name, m in sorted(items):
            if isinstance(m, Histogram):
                out[name] = m.summary()
            else:
                out[name] = m.value
        return out

    def delta(self, base: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
        """Snapshot minus an earlier snapshot (missing keys count as 0).

        Histogram summaries subtract count/sum; percentiles stay current
        (they describe the recent window, not an interval).
        """
        base = base or {}
        cur = self.snapshot()
        out: Dict[str, Any] = {}
        for name, v in cur.items():
            b = base.get(name)
            if isinstance(v, dict):
                b = b if isinstance(b, dict) else {}
                d = dict(v)
                d["count"] = v["count"] - b.get("count", 0)
                d["sum"] = v["sum"] - b.get("sum", 0.0)
                out[name] = d
            else:
                out[name] = v - (b if isinstance(b, (int, float)) else 0.0)
        return out

    def reset(self, prefix: Optional[str] = None) -> None:
        with self._lock:
            items = list(self._metrics.items())
        for name, m in items:
            if prefix is None or name.startswith(prefix):
                m.reset()
