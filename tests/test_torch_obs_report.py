"""The port's trace report (``repro_torch.obs.report``) against the JAX
package's (``repro.obs.report``) on traces the port exports on the CPU
(``repro_torch.obs.trace``): a single-process export with spans, RPC
wire bytes and cache counters, and a merged two-worker timeline.  The
summaries are equal dicts, the formatted reports equal text, and
``python -m repro_torch.obs.report`` prints what
``python -m repro.obs.report`` prints on the same file, tables and
``--json`` alike.
"""
import json
import subprocess
import sys

import pytest

from repro.obs import report as JR
from repro_torch.obs import report as TR
from repro_torch.obs import trace


@pytest.fixture(autouse=True)
def _clean_trace():
    trace.disable()
    trace.reset()
    yield
    trace.disable()
    trace.reset()


def _record(worker: int):
    for i in range(6):
        with trace.span("sample", seeds=8 + i):
            pass
        with trace.span("rpc.call", op="sample_hop", machine=worker,
                        bytes=100 * (worker + 1) + i):
            pass
    with trace.span("rpc.serve", op="state_batch", bytes=4096):
        pass
    handle = trace.begin_async("step", lane="device")
    trace.end_async(handle)


def _single(path):
    trace.enable()
    _record(0)
    trace.export_chrome(str(path), pid=0, metadata={"metrics": {
        "cache.node.hits": 30, "cache.node.accesses": 40,
        "cache.edge.hits": 2, "cache.edge.accesses": 8,
        "cache.edge.inserted": 5, "cache.edge.invalidated": 1}})
    return str(path)


def _merged(tmp_path):
    parts = []
    for pid in (0, 1):
        trace.reset()
        trace.enable()
        _record(pid)
        p = tmp_path / f"w{pid}.json"
        trace.export_chrome(str(p), pid=pid, clock_sync_us=trace.now_us(),
                            metadata={"metrics": {
                                "cache.node.hits": 10 * pid,
                                "cache.node.accesses": 40}})
        parts.append((str(p), pid))
    trace.merge_chrome_files(parts, path=str(tmp_path / "merged.json"))
    return str(tmp_path / "merged.json")


@pytest.mark.parametrize("kind", ["single", "merged"])
def test_summary_and_report_equal_the_jax_package(tmp_path, kind):
    path = _single(tmp_path / "t.json") if kind == "single" else \
        _merged(tmp_path)
    tr = trace.load_trace(path)
    pids = (None,) if kind == "single" else (None, 0, 1)
    for pid in pids:
        got, want = TR.summarize(tr, pid=pid), JR.summarize(tr, pid=pid)
        assert got == want
        assert TR.format_report(got) == JR.format_report(want)
    summary = TR.summarize(tr)
    assert summary["spans"]["sample"]["count"] == 6 * len(pids[1:] or [0])
    assert summary["wire"]["rpc.call:sample_hop"]["calls"] > 0
    if kind == "single":
        assert summary["caches"]["w0:cache.node"]["hit_rate"] == 0.75
    else:
        assert summary["n_workers"] == 2


def test_cli_prints_what_the_jax_cli_prints(tmp_path, subprocess_env):
    path = _single(tmp_path / "t.json")
    outs = {}
    for pkg in ("repro_torch", "repro"):
        for extra in ([], ["--json"]):
            out = subprocess.run(
                [sys.executable, "-m", f"{pkg}.obs.report", path, *extra],
                env=subprocess_env, capture_output=True, text=True,
                timeout=120)
            assert out.returncode == 0, out.stderr
            outs[pkg, bool(extra)] = out.stdout
    assert outs["repro_torch", False] == outs["repro", False]
    assert outs["repro_torch", True] == outs["repro", True]
    assert "== spans ==" in outs["repro_torch", False]
    assert json.loads(outs["repro_torch", True])["wire"][
        "rpc.call:sample_hop"]["bytes"] == sum(100 + i for i in range(6))
