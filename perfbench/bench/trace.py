"""The traced run: spans the benchmark puts around calls into the
program's layers, a ``torch.profiler`` window, and the reduction of its
trace to device busy time, kernel time by name and by span, and the
device's idle gaps by what the host was doing.

Spans are ``record_function`` ranges named ``perfbench.<layer>``.  A
kernel belongs to the innermost such range open on the thread that
launched it, at its launch (the runtime call the trace links to it).
The mixture's backward is bracketed by two identity autograd nodes, on
its output and on its input: the first opens ``perfbench.moe`` when the
gradient reaches the output, the second closes it when the gradient
leaves the input.  Block remat's recompute runs the block again inside
that bracket, under ``perfbench.block``, so its kernels outside the
mixture fall to the block and not to the mixture.
"""
from __future__ import annotations

import bisect
import contextlib
import json
import os
import tempfile
import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import torch

PREFIX = "perfbench."
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class _Bracket:
    """Opens a range in the backward of the node on a layer's output and
    closes it in the backward of the node on its input."""

    def __init__(self, name: str):
        self.name, self.open = name, []

    def output(self, y: torch.Tensor) -> torch.Tensor:
        return _Open.apply(y, self) if y.requires_grad else y

    def input(self, x: torch.Tensor) -> torch.Tensor:
        return _Close.apply(x, self) if x.requires_grad else x


class _Open(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, br):
        ctx.br = br
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        rf = torch.autograd.profiler.record_function(ctx.br.name)
        rf.__enter__()
        ctx.br.open.append(rf)
        return g, None


class _Close(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, br):
        ctx.br = br
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if ctx.br.open:
            ctx.br.open.pop().__exit__(None, None, None)
        return g, None


def ranged(name: str, fn):
    def wrapper(*a, **kw):
        with torch.autograd.profiler.record_function(PREFIX + name):
            return fn(*a, **kw)
    return wrapper


@contextlib.contextmanager
def layer_spans():
    """Within: ``perfbench.block`` around each transformer block,
    ``perfbench.moe`` around the mixture (forward, recompute and
    backward).  The program's modules are patched for the length of the
    block and restored after it."""
    from repro_torch.models import transformer_lm as T

    saved = {"_block_apply": T._block_apply, "moe_apply": T.moe_apply}
    moe_fn = T.moe_apply

    def moe(params, x, *a, **kw):
        br = _Bracket(PREFIX + "moe")
        with torch.autograd.profiler.record_function(PREFIX + "moe"):
            y, aux = moe_fn(params, br.input(x), *a, **kw)
            return br.output(y), aux

    T._block_apply = ranged("block", saved["_block_apply"])
    T.moe_apply = moe
    try:
        yield
    finally:
        for k, v in saved.items():
            setattr(T, k, v)


class Trace:
    """A profiled window's device work, reduced."""

    def __init__(self, events: List[dict], window_s: float):
        self.window_s = window_s
        corr_launch = {}
        self.ranges: Dict[int, List[Tuple[float, float, str]]] = \
            defaultdict(list)
        self.cpu_ops: Dict[int, List[Tuple[float, float, str]]] = \
            defaultdict(list)
        kernels = []
        for e in events:
            if e.get("ph") != "X":
                continue
            cat = e.get("cat", "")
            ts, dur = float(e["ts"]), float(e.get("dur", 0.0))
            if cat in DEVICE_CATS:
                kernels.append((ts, ts + dur, e["name"],
                                e.get("args", {}).get("correlation")))
            elif cat in ("cuda_runtime", "cuda_driver"):
                c = e.get("args", {}).get("correlation")
                if c is not None:
                    corr_launch[c] = (e["tid"], ts)
            elif cat == "user_annotation" and e["name"].startswith(PREFIX):
                self.ranges[e["tid"]].append((ts, ts + dur, e["name"]))
            elif cat in ("cpu_op", "user_annotation"):
                self.cpu_ops[e["tid"]].append((ts, ts + dur, e["name"]))
        kernels.sort()
        self.kernels = kernels
        self.launch = corr_launch
        for table in (self.ranges, self.cpu_ops):
            for v in table.values():
                v.sort()
        self.t0 = min((k[0] for k in kernels), default=0.0)
        self._under = None          # span name -> device s, once asked
        self._starts = None         # tid -> the ranges' starts, once asked

    # ---- device time ----------------------------------------------------
    @staticmethod
    def union_us(intervals) -> float:
        tot, end = 0.0, None
        start = None
        for a, b in sorted(intervals):
            if end is None or a > end:
                if end is not None:
                    tot += end - start
                start, end = a, b
            else:
                end = max(end, b)
        if end is not None:
            tot += end - start
        return tot

    def busy_s(self, lo: float, hi: float) -> float:
        """Seconds of [lo, hi] (trace microseconds) in which some device
        operation ran."""
        iv = [(max(a, lo), min(b, hi)) for a, b, _, _ in self.kernels]
        return self.union_us([(a, b) for a, b in iv if b > a]) / 1e6

    def named_ranges(self, name: str) -> List[Tuple[float, float]]:
        return sorted((a, b) for v in self.ranges.values()
                      for a, b, n in v if n == PREFIX + name)

    def busy_in_ranges_s(self, name: str) -> Tuple[float, float]:
        """(device busy s, range s) summed over the ranges called
        ``perfbench.<name>``."""
        busy = span = 0.0
        for a, b in self.named_ranges(name):
            busy += self.busy_s(a, b)
            span += (b - a) / 1e6
        return busy, span

    def _innermost(self, tid, ts) -> Optional[str]:
        """The latest-starting range on ``tid`` open at ``ts`` (later
        starts are deeper; of two with one start, the longer)."""
        if self._starts is None:
            self._starts = {t: [r[0] for r in v]
                            for t, v in self.ranges.items()}
        rs = self.ranges.get(tid, ())
        for i in range(bisect.bisect_right(self._starts.get(tid, ()), ts)
                       - 1, -1, -1):
            if rs[i][1] >= ts:
                return rs[i][2]
        return None

    def kernel_s_under(self, name: str) -> float:
        """Device seconds of the kernels whose launch lies innermost in a
        ``perfbench.<name>`` range."""
        if self._under is None:
            self._under = defaultdict(float)
            for a, b, _, corr in self.kernels:
                at = self.launch.get(corr)
                if at is not None:
                    self._under[self._innermost(*at)] += (b - a) / 1e6
        return self._under.get(PREFIX + name, 0.0)

    def spans(self) -> Dict[str, list]:
        """For each ``perfbench.<name>`` span: [ranges opened, device
        seconds of the kernels innermost in them]."""
        out = {}
        for v in self.ranges.values():
            for _, _, n in v:
                out.setdefault(n[len(PREFIX):], [0, 0.0])[0] += 1
        for n in out:
            out[n][1] = self.kernel_s_under(n)
        return out

    def kernel_s_named(self, *needles: str, lo=None, hi=None) -> float:
        tot = 0.0
        for a, b, n, _ in self.kernels:
            if any(x in n for x in needles) and (
                    lo is None or (a >= lo and a < hi)):
                tot += b - a
        return tot / 1e6

    # ---- the breakdown ----------------------------------------------------
    def device_ops(self, n: int = 10) -> List[list]:
        by = defaultdict(float)
        for a, b, name, _ in self.kernels:
            by[name[:96]] += (b - a) / 1e6
        return [[k, v] for k, v in sorted(by.items(), key=lambda x: -x[1])[:n]]

    def idle_gaps(self, lo: float, hi: float, n: int = 10) -> List[list]:
        """The device's idle time in [lo, hi] (trace microseconds), by the
        innermost host operation open, on the thread that launched the
        next kernel, when the device went idle; the longest first."""
        by = defaultdict(float)
        end = lo
        for a, b, _, corr in self.kernels:
            if b <= lo or a >= hi:
                continue
            if a > end:
                at = self.launch.get(corr)
                by[self._host_op(at[0], end) if at else "unknown"] += \
                    (a - end) / 1e6
            end = max(end, b)
        if hi > end:
            by["after the last kernel"] += (hi - end) / 1e6
        return [[k, v] for k, v in sorted(by.items(), key=lambda x: -x[1])[:n]]

    def _host_op(self, tid, ts) -> str:
        ops = self.cpu_ops.get(tid, ())
        i = bisect.bisect_right(ops, (ts, float("inf"), ""))
        best = None
        for a, b, name in ops[max(0, i - 256):i]:   # the latest 256 starts
            if a <= ts <= b and (best is None or a >= best[0]):
                best = (a, name)
        return best[1] if best else "host (no operation open)"


@contextlib.contextmanager
def profiled(out: dict):
    """Profile the block (CPU and CUDA activity).  On exit, ``out`` gets
    ``trace``: the reduced :class:`Trace`, and ``window``: the block's
    own range in trace microseconds.  The raw trace goes to a temporary
    file under ``TMPDIR`` and is removed once read."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        with torch.autograd.profiler.record_function(PREFIX + "window"):
            yield
            torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    tr = Trace(events, window_s)
    win = tr.named_ranges("window")
    out["trace"] = tr
    out["window"] = win[0] if win else (tr.t0, tr.t0 + window_s * 1e6)
