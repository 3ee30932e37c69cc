"""Batched query admission: collect-until-budget, bounded depth.

Per-query dispatch would pay one jit call (and one host->device trip)
per request; the admission queue instead collects requests up to a
size/timeout budget and the engine runs them as ONE padded batch —
the same shape-bucketing trick the trainer uses (``pow2_pad_len``), so
serving shares the trainer's jit cache instead of compiling per queue
length.

Backpressure is explicit: ``submit`` fails fast when the queue is at
``max_depth`` instead of queueing unboundedly — the engine then routes
link queries to the EdgeBank tier (always fresh, microseconds) rather
than letting tail latency grow without bound.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, List, Optional

import numpy as np


class QueryFuture:
    """Minimal single-assignment result slot (no asyncio dependency:
    the serving wing is plain threads, like the RPC substrate)."""

    __slots__ = ("_ev", "_val", "_exc")

    def __init__(self):
        self._ev = threading.Event()
        self._val = None
        self._exc: Optional[BaseException] = None

    def set_result(self, val: Any) -> None:
        self._val = val
        self._ev.set()

    def set_exception(self, exc: BaseException) -> None:
        self._exc = exc
        self._ev.set()

    def done(self) -> bool:
        return self._ev.is_set()

    def result(self, timeout: Optional[float] = None) -> Any:
        if not self._ev.wait(timeout):
            raise TimeoutError("query not answered within timeout")
        if self._exc is not None:
            raise self._exc
        return self._val


@dataclasses.dataclass
class Query:
    """One admitted request: a (vector of) link pairs or embed nodes.

    ``kind`` is ``"link"`` (score (src[i], dst[i]) at ts[i]) or
    ``"embed"`` (temporal embedding of src[i] at ts[i]; dst unused)."""
    kind: str
    src: np.ndarray
    dst: Optional[np.ndarray]
    ts: np.ndarray
    future: QueryFuture
    t_submit: float

    @property
    def n(self) -> int:
        return len(self.src)


class AdmissionQueue:
    """Thread-safe FIFO with batch-granular handoff.

    ``next_batch`` blocks until at least one query is present, then
    keeps collecting until the batch holds ``max_batch`` queries or
    ``timeout_s`` has elapsed since the first arrival — the classic
    size-or-deadline admission budget.
    """

    def __init__(self, *, max_batch: int = 64, timeout_s: float = 0.002,
                 max_depth: int = 1024):
        self.max_batch = int(max_batch)
        self.timeout_s = float(timeout_s)
        self.max_depth = int(max_depth)
        self._q: List[Query] = []
        self._cv = threading.Condition()
        self._closed = False

    @property
    def depth(self) -> int:
        return len(self._q)

    def submit(self, q: Query) -> bool:
        """Enqueue; False when the queue is full or closed (the caller
        falls back or fails fast — never silent unbounded queueing)."""
        with self._cv:
            if self._closed or len(self._q) >= self.max_depth:
                return False
            self._q.append(q)
            self._cv.notify()
            return True

    def next_batch(self) -> Optional[List[Query]]:
        """One admission batch, or None once closed and drained."""
        with self._cv:
            while not self._q and not self._closed:
                self._cv.wait()
            if not self._q:
                return None                      # closed and drained
            deadline = time.monotonic() + self.timeout_s
            while len(self._q) < self.max_batch and not self._closed:
                left = deadline - time.monotonic()
                if left <= 0:
                    break
                self._cv.wait(left)
            batch = self._q[:self.max_batch]
            del self._q[:len(batch)]
            return batch

    def close(self) -> None:
        with self._cv:
            self._closed = True
            self._cv.notify_all()
