"""The program's own spans in a profiled window.

While ``torch.profiler`` records, ``repro_torch.obs.trace`` opens a
profiler range ``repro.<name>`` for each span of the program, and for
the backward of a bracketed layer.  They reach :class:`bench.trace.Trace`
among its host operations (``cpu_ops``), on the thread that opened them.
A kernel belongs to the innermost ``repro.*`` range open on the thread
that launched it, at its launch (the runtime call the trace links to
it): the latest-starting one, and of two with one start the shorter.
The innermost range is found by bisection over each thread's
breakpoints, made once a trace.
"""
from __future__ import annotations

import bisect
import heapq
import math
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

PREFIX = "repro."
Range = Tuple[float, float, str]


def program_ranges(trace) -> Dict[int, List[Range]]:
    """Each thread's ``repro.*`` ranges, (start, end, name), ordered so
    that of two ranges open at one time the later is the deeper: by
    start, and of one start the longer first."""
    cache = getattr(trace, "_program_ranges", None)
    if cache is None:
        cache = {}
        for tid, ops in trace.cpu_ops.items():
            rs = [r for r in ops if r[2].startswith(PREFIX)]
            if rs:
                cache[tid] = sorted(rs, key=lambda r: (r[0], -r[1]))
        trace._program_ranges = cache
    return cache


def ranges(trace, name: str) -> List[Tuple[float, float]]:
    """The ``repro.<name>`` ranges of every thread, (start, end) in trace
    microseconds, in order of start."""
    full = PREFIX + name
    return sorted((a, b) for rs in program_ranges(trace).values()
                  for a, b, n in rs if n == full)


def breakpoints(rs: List[Range]) -> Tuple[List[float], List[Optional[str]]]:
    """For ranges ordered as :func:`program_ranges` orders them: the
    times at which the innermost open range changes, and from each on,
    its name (None: none open).  A range is open from its start to its
    end, both included."""
    events = []
    for i, (a, b, _) in enumerate(rs):
        events.append((a, 0, i))
        events.append((math.nextafter(b, math.inf), 1, i))
    events.sort()
    times: List[float] = []
    names: List[Optional[str]] = []
    heap: List[int] = []         # open ranges, the deepest (largest) first
    closed = set()
    k = 0
    while k < len(events):
        t = events[k][0]
        while k < len(events) and events[k][0] == t:
            _, kind, i = events[k]
            if kind == 0:
                heapq.heappush(heap, -i)
            else:
                closed.add(i)
            k += 1
        while heap and -heap[0] in closed:
            closed.discard(-heapq.heappop(heap))
        times.append(t)
        names.append(rs[-heap[0]][2] if heap else None)
    return times, names


def _index(trace) -> Dict[int, Tuple[List[float], List[Optional[str]]]]:
    idx = getattr(trace, "_program_index", None)
    if idx is None:
        idx = {tid: breakpoints(rs)
               for tid, rs in program_ranges(trace).items()}
        trace._program_index = idx
    return idx


def innermost(trace, tid: int, ts: float) -> Optional[str]:
    """The innermost ``repro.*`` range open on ``tid`` at ``ts``."""
    times, names = _index(trace).get(tid, ((), ()))
    j = bisect.bisect_right(times, ts) - 1
    return names[j] if j >= 0 else None


def _launched(trace) -> List[Tuple[Optional[str], int, float, float]]:
    """Each kernel's (innermost range at its launch, launching thread,
    launch time, device seconds); kernels the trace links to no launch
    are left out."""
    out = getattr(trace, "_program_launched", None)
    if out is None:
        out = []
        for a, b, _, corr in trace.kernels:
            at = trace.launch.get(corr)
            if at is not None:
                out.append((innermost(trace, at[0], at[1]), at[0], at[1],
                            (b - a) / 1e6))
        trace._program_launched = out
    return out


def _inside(spans: Dict[int, List[Tuple[float, float]]], tid: int,
            ts: float) -> bool:
    rs = spans.get(tid, ())
    j = bisect.bisect_right(rs, (ts, math.inf)) - 1
    return j >= 0 and rs[j][1] >= ts


def _merged(trace, name: str) -> Dict[int, List[Tuple[float, float]]]:
    """Each thread's ``repro.<name>`` ranges, overlaps merged."""
    out = defaultdict(list)
    for tid, rs in program_ranges(trace).items():
        for a, b, n in rs:
            if n != PREFIX + name:
                continue
            if out[tid] and a <= out[tid][-1][1]:
                out[tid][-1] = (out[tid][-1][0], max(out[tid][-1][1], b))
            else:
                out[tid].append((a, b))
    return out


def kernel_s_under(trace, name: str, within: Optional[str] = None) -> float:
    """Device seconds of the kernels whose launch lies innermost in a
    ``repro.<name>`` range on the launching thread; with ``within``, only
    those launched inside a ``repro.<within>`` range on that thread too.
    0.0 where the program opened no such range."""
    full = PREFIX + name
    spans = _merged(trace, within) if within is not None else None
    tot = 0.0
    for inner, tid, ts, s in _launched(trace):
        if inner == full and (spans is None or _inside(spans, tid, ts)):
            tot += s
    return tot
