"""Trace report CLI: ``python -m repro_torch.obs.report MH_TRACE.json``
(a copy of the JAX package's framework-free ``repro.obs.report``).

Prints a per-span-kind p50/p99/total table, wire bytes per RPC op, and
cache-hit summaries from the embedded registry snapshots. Works on both
single-process exports (:func:`repro_torch.obs.trace.export_chrome`)
and merged fleet timelines.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Any, Dict, List, Optional

__all__ = ["summarize", "format_report", "main"]


def _percentile(sorted_vals: List[float], q: float) -> float:
    if not sorted_vals:
        return 0.0
    i = min(int(q / 100.0 * len(sorted_vals)), len(sorted_vals) - 1)
    return sorted_vals[i]


def summarize(trace: Dict[str, Any], pid: Optional[int] = None) -> Dict[str, Any]:
    """Aggregate a Chrome trace dict into per-kind / per-op / cache stats.

    ``pid`` restricts to one worker of a merged fleet trace; ``None``
    aggregates everything.
    """
    durs: Dict[str, List[float]] = {}
    wire: Dict[str, Dict[str, float]] = {}
    for ev in trace.get("traceEvents", []):
        if ev.get("ph") != "X":
            continue
        if pid is not None and ev.get("pid") != pid:
            continue
        kind = ev.get("name", "?")
        durs.setdefault(kind, []).append(ev.get("dur", 0) / 1e6)
        if kind in ("rpc.call", "rpc.serve"):
            args = ev.get("args") or {}
            op = str(args.get("op", "?"))
            w = wire.setdefault(f"{kind}:{op}", {"calls": 0, "bytes": 0, "wait_s": 0.0})
            w["calls"] += 1
            w["bytes"] += int(args.get("bytes", 0) or 0)
            w["wait_s"] += ev.get("dur", 0) / 1e6

    spans: Dict[str, Dict[str, float]] = {}
    for kind, vals in durs.items():
        vals.sort()
        spans[kind] = {
            "count": len(vals),
            "total_s": sum(vals),
            "p50_ms": _percentile(vals, 50.0) * 1e3,
            "p99_ms": _percentile(vals, 99.0) * 1e3,
        }

    # Cache-hit summaries from embedded registry snapshots (single-process
    # metadata["metrics"], or metadata["workers"][pid]["metrics"] when merged).
    meta = trace.get("metadata", {}) or {}
    snapshots: Dict[str, Dict[str, Any]] = {}
    if "workers" in meta:
        for wid, wmeta in meta["workers"].items():
            if pid is not None and str(pid) != str(wid):
                continue
            snap = (wmeta or {}).get("metrics")
            if isinstance(snap, dict):
                snapshots[str(wid)] = snap
    elif isinstance(meta.get("metrics"), dict):
        snapshots[str(meta.get("pid", 0))] = meta["metrics"]

    caches: Dict[str, Dict[str, float]] = {}
    for wid, snap in snapshots.items():
        for key, val in snap.items():
            if not isinstance(val, (int, float)):
                continue
            if ".hits" in key or ".accesses" in key or ".bypassed" in key \
                    or ".inserted" in key or ".invalidated" in key:
                base, _, field = key.rpartition(".")
                c = caches.setdefault(f"w{wid}:{base}", {})
                c[field] = c.get(field, 0.0) + val
    for c in caches.values():
        acc = c.get("accesses", 0.0)
        c["hit_rate"] = (c.get("hits", 0.0) / acc) if acc else 0.0

    return {"spans": spans, "wire": wire, "caches": caches,
            "n_workers": len(meta.get("workers", {})) or 1}


def _table(rows: List[List[str]], header: List[str]) -> str:
    widths = [max(len(h), *(len(r[i]) for r in rows)) if rows else len(h)
              for i, h in enumerate(header)]
    def fmt(row: List[str]) -> str:
        return "  ".join(c.ljust(w) if i == 0 else c.rjust(w)
                         for i, (c, w) in enumerate(zip(row, widths)))
    lines = [fmt(header), fmt(["-" * w for w in widths])]
    lines.extend(fmt(r) for r in rows)
    return "\n".join(lines)


def format_report(summary: Dict[str, Any]) -> str:
    out: List[str] = []
    spans = summary["spans"]
    rows = [[k, f"{v['count']:d}", f"{v['total_s']:.3f}",
             f"{v['p50_ms']:.2f}", f"{v['p99_ms']:.2f}"]
            for k, v in sorted(spans.items(),
                               key=lambda kv: -kv[1]["total_s"])]
    out.append("== spans ==")
    out.append(_table(rows, ["kind", "count", "total_s", "p50_ms", "p99_ms"]))

    if summary["wire"]:
        rows = [[op, f"{int(v['calls']):d}", f"{int(v['bytes']):d}",
                 f"{v['wait_s']:.3f}"]
                for op, v in sorted(summary["wire"].items(),
                                    key=lambda kv: -kv[1]["bytes"])]
        out.append("")
        out.append("== wire bytes per op ==")
        out.append(_table(rows, ["op", "calls", "bytes", "wait_s"]))

    if summary["caches"]:
        rows = [[name, f"{int(v.get('accesses', 0)):d}",
                 f"{int(v.get('hits', 0)):d}", f"{v['hit_rate']:.3f}",
                 f"{int(v.get('inserted', 0)):d}",
                 f"{int(v.get('invalidated', 0)):d}"]
                for name, v in sorted(summary["caches"].items())]
        out.append("")
        out.append("== caches ==")
        out.append(_table(rows, ["cache", "accesses", "hits", "hit_rate",
                                 "inserted", "invalidated"]))
    return "\n".join(out)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.report",
        description="Summarize a repro trace (Chrome trace-event JSON).")
    ap.add_argument("trace", help="path to trace JSON (per-worker or merged)")
    ap.add_argument("--pid", type=int, default=None,
                    help="restrict to one worker pid of a merged trace")
    ap.add_argument("--json", action="store_true",
                    help="emit the summary as JSON instead of tables")
    args = ap.parse_args(argv)
    with open(args.trace) as f:
        trace = json.load(f)
    summary = summarize(trace, pid=args.pid)
    if args.json:
        print(json.dumps(summary, indent=2, sort_keys=True))
    else:
        print(format_report(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
