"""Thread-aware span tracer with Chrome trace-event export.

Design goals, in order:

1. **True no-op when disabled.** ``span(...)`` returns a shared singleton
   whose ``__enter__``/``__exit__`` do nothing; the only per-call cost is
   two global-bool checks plus the (unavoidable) kwargs dict. Spans are
   placed at batch/stage/layer granularity (~tens per round or step),
   never per element.
2. **Thread safety without locks on the hot path.** Each thread records
   into its own ring buffer (created lazily via ``threading.local``); the
   global registry lock is taken only on first use per thread and at
   export time.
3. **Perfetto-loadable output.** ``export_chrome`` emits Chrome
   trace-event JSON (``"ph": "X"`` complete events, microsecond
   timestamps). Real threads become lanes automatically; logically-async
   work (the in-flight jitted device step) is placed on a virtual lane
   via ``begin_async``/``end_async`` so PipelineEngine overlap is visible.
4. **Fleet merge.** Every process exports with a ``clock_sync_us`` taken
   right after a fleet-wide barrier, so each per-worker file is already
   offset-corrected (barrier exit == t=0). ``merge_chrome`` concatenates
   worker files onto distinct pids and rebases the fleet minimum to 0.
5. **One timeline with the device.** While ``torch.profiler`` records
   (``torch.autograd.profiler._is_profiler_enabled``), a span also opens
   a profiler range named ``repro.<kind>``: a Kineto ``user_annotation``
   event on the profiler's clock, beside the kernels the span launches.
   :func:`bracket` carries the same range into a layer's backward.

Enable the ring buffer via ``REPRO_TRACE=1`` in the environment or
``trace.enable()``; the profiler ranges follow the profiler alone.
"""
from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

import torch
from torch.autograd import profiler as _profiler

__all__ = [
    "enabled",
    "enable",
    "disable",
    "reset",
    "now_us",
    "span",
    "bracket",
    "stage",
    "begin_async",
    "end_async",
    "events",
    "export_chrome",
    "merge_chrome",
    "load_trace",
]

TRACE_ENV = "REPRO_TRACE"
DEFAULT_CAPACITY = 65536
RANGE_PREFIX = "repro."      # the profiler ranges' names: repro.<kind>

_enabled: bool = False
_capacity: int = DEFAULT_CAPACITY

_reg_lock = threading.Lock()
_buffers: List["_RingBuffer"] = []
_tls = threading.local()


class _RingBuffer:
    """Fixed-capacity per-thread event buffer; oldest events are dropped."""

    __slots__ = ("tid", "name", "cap", "items", "idx", "dropped")

    def __init__(self, tid: int, name: str, cap: int) -> None:
        self.tid = tid
        self.name = name
        self.cap = cap
        self.items: List[Tuple[str, int, int, Optional[str], Optional[Dict[str, Any]]]] = []
        self.idx = 0
        self.dropped = 0

    def add(self, kind: str, t0_us: int, dur_us: int,
            lane: Optional[str], args: Optional[Dict[str, Any]]) -> None:
        ev = (kind, t0_us, dur_us, lane, args)
        if len(self.items) < self.cap:
            self.items.append(ev)
        else:
            self.items[self.idx] = ev
            self.idx = (self.idx + 1) % self.cap
            self.dropped += 1

    def snapshot(self) -> List[Tuple[str, int, int, Optional[str], Optional[Dict[str, Any]]]]:
        return self.items[self.idx:] + self.items[: self.idx]


def _buffer() -> _RingBuffer:
    buf = getattr(_tls, "buf", None)
    if buf is None:
        t = threading.current_thread()
        buf = _RingBuffer(t.ident or 0, t.name, _capacity)
        _tls.buf = buf
        with _reg_lock:
            _buffers.append(buf)
    return buf


def now_us() -> int:
    """Monotonic microseconds; the time base for every recorded event."""
    return time.perf_counter_ns() // 1000


def enabled() -> bool:
    return _enabled


def enable(capacity: int = DEFAULT_CAPACITY) -> None:
    global _enabled, _capacity
    _capacity = int(capacity)
    # re-size buffers already registered for live threads (keep the
    # newest events when shrinking) so the capacity takes effect now,
    # not only for threads that start after this call
    with _reg_lock:
        for buf in _buffers:
            if buf.cap != _capacity:
                items = buf.snapshot()[-_capacity:]
                buf.items, buf.idx, buf.cap = items, 0, _capacity
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


def reset() -> None:
    """Drop all recorded events (buffers of dead threads included)."""
    with _reg_lock:
        for buf in _buffers:
            buf.items = []
            buf.idx = 0
            buf.dropped = 0


class _Noop:
    """Shared do-nothing context manager returned when tracing is off."""

    __slots__ = ()

    def __enter__(self) -> "_Noop":
        return self

    def __exit__(self, *exc: Any) -> None:
        return None

    def set(self, **kw: Any) -> None:
        return None


_NOOP = _Noop()


class _Span:
    __slots__ = ("kind", "args", "t0", "rec", "rf")

    def __init__(self, kind: str, args: Optional[Dict[str, Any]]) -> None:
        self.kind = kind
        self.args = args

    def __enter__(self) -> "_Span":
        self.rec = _enabled
        self.rf = None
        if _profiler._is_profiler_enabled:
            self.rf = _profiler.record_function(RANGE_PREFIX + self.kind)
            self.rf.__enter__()
        self.t0 = now_us()
        return self

    def __exit__(self, *exc: Any) -> None:
        if self.rec:
            t1 = now_us()
            _buffer().add(self.kind, self.t0, max(t1 - self.t0, 0), None,
                          self.args)
        if self.rf is not None:
            self.rf.__exit__(*exc)
        return None

    def set(self, **kw: Any) -> None:
        """Attach/override args after the span opened (e.g. byte counts)."""
        if self.args is None:
            self.args = dict(kw)
        else:
            self.args.update(kw)


def span(kind: str, **args: Any):
    """``with span("sample", hop=2): ...`` — records a complete event in
    the ring buffer when tracing is enabled, and opens the profiler range
    ``repro.<kind>`` while ``torch.profiler`` records.

    Exception-safe: the span closes (and is recorded) even if the traced
    block raises. When both are off this returns the shared no-op after
    two bool checks: nothing is opened, recorded or kept.
    """
    if not _enabled and not _profiler._is_profiler_enabled:
        return _NOOP
    return _Span(kind, args or None)


# ---------------------------------------------------------------------------
# Brackets: a span over a layer's backward
# ---------------------------------------------------------------------------


class _NoBracket:
    """The shared bracket while the profiler is off or autograd does not
    record: both ends return the tensor itself."""

    __slots__ = ()

    def input(self, x: torch.Tensor) -> torch.Tensor:
        return x

    def output(self, y: torch.Tensor) -> torch.Tensor:
        return y


_NO_BRACKET = _NoBracket()


class _Bracket:
    """Two identity autograd nodes around a layer: the one on its output
    opens ``repro.<kind>`` when the gradient reaches the layer, the one
    on its input closes it when the gradient first leaves through an
    input, on the thread that runs the backward (autograd's device
    thread on the card).  Under block remat the recompute runs inside
    the bracket of the block being differentiated."""

    __slots__ = ("name", "closes", "rf")

    def __init__(self, name: str) -> None:
        self.name = name
        self.closes = False          # an input node will close the range
        self.rf = None

    def input(self, x: torch.Tensor) -> torch.Tensor:
        if not x.requires_grad:
            return x
        self.closes = True
        return _Close.apply(x, self)

    def output(self, y: torch.Tensor) -> torch.Tensor:
        if not (self.closes and y.requires_grad):
            return y
        return _Open.apply(y, self)

    def open(self) -> None:
        if self.rf is None:
            self.rf = _profiler.record_function(self.name)
            self.rf.__enter__()

    def close(self) -> None:
        if self.rf is not None:
            self.rf.__exit__(None, None, None)
            self.rf = None


class _Open(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, br):
        ctx.br = br
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        ctx.br.open()
        return g, None


class _Close(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, br):
        ctx.br = br
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        ctx.br.close()
        return g, None


def bracket(kind: str):
    """A layer's backward under the profiler range ``repro.<kind>``:

        br = bracket("moe")
        x = br.input(x)
        ...
        y = br.output(y)

    Acts only while ``torch.profiler`` records and autograd records the
    layer: otherwise ``input`` and ``output`` return the tensor itself
    and the graph gets no node."""
    if not _profiler._is_profiler_enabled or not torch.is_grad_enabled():
        return _NO_BRACKET
    return _Bracket(RANGE_PREFIX + kind)


class _Stage:
    """Times a block into ``timers[key]`` AND emits a span over the same
    interval, so the metric registry and the trace agree by construction.
    Timing happens regardless of whether tracing is enabled."""

    __slots__ = ("timers", "key", "args", "t0")

    def __init__(self, timers: Any, key: str, args: Optional[Dict[str, Any]]) -> None:
        self.timers = timers
        self.key = key
        self.args = args

    def __enter__(self) -> "_Stage":
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc: Any) -> None:
        t1 = time.perf_counter_ns()
        self.timers[self.key] += (t1 - self.t0) * 1e-9
        if _enabled:
            _buffer().add(self.key, self.t0 // 1000, max((t1 - self.t0) // 1000, 0),
                          None, self.args)
        return None

    def set(self, **kw: Any) -> None:
        if self.args is None:
            self.args = dict(kw)
        else:
            self.args.update(kw)


def stage(timers: Any, key: str, **args: Any) -> _Stage:
    """``with stage(self.timers, "fetch", phase="assemble"): ...``"""
    return _Stage(timers, key, args or None)


class _AsyncHandle:
    __slots__ = ("kind", "lane", "args", "t0", "buf")

    def __init__(self, kind: str, lane: str, args: Optional[Dict[str, Any]]) -> None:
        self.kind = kind
        self.lane = lane
        self.args = args
        self.t0 = now_us()
        self.buf = _buffer()


def begin_async(kind: str, lane: str = "async", **args: Any) -> Optional[_AsyncHandle]:
    """Open a span on a *virtual* lane (e.g. the in-flight device step).

    Returns a handle to pass to :func:`end_async`, or ``None`` when
    disabled. The event is recorded only when ended — an abandoned handle
    (exception before completion) simply drops the event.
    """
    if not _enabled:
        return None
    return _AsyncHandle(kind, lane, args or None)


def end_async(handle: Optional[_AsyncHandle], **args: Any) -> None:
    if handle is None:
        return
    t1 = now_us()
    if args:
        if handle.args is None:
            handle.args = dict(args)
        else:
            handle.args.update(args)
    handle.buf.add(handle.kind, handle.t0, max(t1 - handle.t0, 0),
                   handle.lane, handle.args)


def events() -> List[Dict[str, Any]]:
    """Snapshot of every recorded event across all threads (unsorted)."""
    with _reg_lock:
        bufs = list(_buffers)
    out: List[Dict[str, Any]] = []
    for buf in bufs:
        for kind, t0, dur, lane, args in buf.snapshot():
            out.append({
                "kind": kind, "ts_us": t0, "dur_us": dur,
                "lane": lane if lane is not None else buf.name,
                "tid": buf.tid, "args": args or {},
            })
    return out


def dropped() -> int:
    with _reg_lock:
        return sum(buf.dropped for buf in _buffers)


def _jsonable(obj: Any) -> Any:
    """Coerce numpy scalars etc. so json.dump never chokes on span args."""
    if isinstance(obj, (str, int, float, bool)) or obj is None:
        return obj
    if hasattr(obj, "item"):
        try:
            return obj.item()
        except Exception:
            pass
    return str(obj)


def export_chrome(path: Optional[str] = None, *, pid: int = 0,
                  process_name: str = "repro",
                  clock_sync_us: Optional[int] = None,
                  metadata: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """Export all recorded events as a Chrome trace-event JSON dict.

    ``clock_sync_us`` (a :func:`now_us` value taken right after a
    fleet-wide barrier) becomes t=0 in the exported file, so per-worker
    files are directly mergeable. Returns the trace dict; also writes it
    to ``path`` when given.
    """
    shift = clock_sync_us if clock_sync_us is not None else 0
    with _reg_lock:
        bufs = list(_buffers)

    # Stable lane ids: real threads first (in registration order), then
    # virtual lanes in name order.
    lane_names: List[str] = []
    for buf in bufs:
        if buf.items and buf.name not in lane_names:
            lane_names.append(buf.name)
    virtual: List[str] = []
    for buf in bufs:
        for _, _, _, lane, _ in buf.items:
            if lane is not None and lane not in lane_names and lane not in virtual:
                virtual.append(lane)
    lane_names.extend(sorted(virtual))
    lane_tid = {name: i + 1 for i, name in enumerate(lane_names)}

    trace_events: List[Dict[str, Any]] = [
        {"ph": "M", "name": "process_name", "pid": pid, "tid": 0,
         "args": {"name": process_name}},
    ]
    for name, tid in lane_tid.items():
        trace_events.append({"ph": "M", "name": "thread_name", "pid": pid,
                             "tid": tid, "args": {"name": name}})
    n_dropped = 0
    for buf in bufs:
        n_dropped += buf.dropped
        for kind, t0, dur, lane, args in buf.snapshot():
            trace_events.append({
                "ph": "X", "name": kind,
                "ts": t0 - shift, "dur": dur,
                "pid": pid, "tid": lane_tid[lane if lane is not None else buf.name],
                "args": {k: _jsonable(v) for k, v in (args or {}).items()},
            })

    meta: Dict[str, Any] = {"process_name": process_name, "pid": pid,
                            "dropped_events": n_dropped}
    if clock_sync_us is not None:
        meta["clock_sync_us"] = clock_sync_us
    if metadata:
        meta.update(metadata)
    trace = {"traceEvents": trace_events, "displayTimeUnit": "ms",
             "metadata": meta}
    if path is not None:
        with open(path, "w") as f:
            json.dump(trace, f)
    return trace


def merge_chrome(parts: Sequence[Tuple[Dict[str, Any], int]],
                 path: Optional[str] = None) -> Dict[str, Any]:
    """Merge per-worker trace dicts into one fleet timeline.

    ``parts`` is ``[(trace_dict, pid), ...]`` where each trace was
    exported with its own ``clock_sync_us`` (so its timestamps are already
    offset-corrected to the shared barrier). Events are re-tagged with the
    given pid and the fleet minimum timestamp is rebased to 0.
    """
    merged_events: List[Dict[str, Any]] = []
    workers_meta: Dict[str, Any] = {}
    min_ts: Optional[int] = None
    for trace, pid in parts:
        workers_meta[str(pid)] = trace.get("metadata", {})
        for ev in trace.get("traceEvents", []):
            ev = dict(ev)
            ev["pid"] = pid
            merged_events.append(ev)
            if ev.get("ph") == "X":
                ts = ev.get("ts", 0)
                min_ts = ts if min_ts is None else min(min_ts, ts)
    if min_ts:
        for ev in merged_events:
            if ev.get("ph") == "X":
                ev["ts"] = ev["ts"] - min_ts
    merged = {"traceEvents": merged_events, "displayTimeUnit": "ms",
              "metadata": {"merged": True, "workers": workers_meta}}
    if path is not None:
        with open(path, "w") as f:
            json.dump(merged, f)
    return merged


def merge_chrome_files(parts: Sequence[Tuple[str, int]],
                       path: Optional[str] = None) -> Dict[str, Any]:
    """Like :func:`merge_chrome` but loads each part from a JSON file."""
    loaded = [(load_trace(p), pid) for p, pid in parts]
    return merge_chrome(loaded, path)


def load_trace(path: str) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


# Honor REPRO_TRACE at import so subprocess workers start tracing without
# code changes; the value is the ring-buffer capacity when > 1.
_env = os.environ.get(TRACE_ENV, "")
if _env and _env != "0":
    try:
        _cap = int(_env)
    except ValueError:
        _cap = 0
    enable(_cap if _cap > 1 else DEFAULT_CAPACITY)
del _env
