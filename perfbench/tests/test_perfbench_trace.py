"""The reduction of a profiler trace: busy time, spans, idle gaps."""
from __future__ import annotations

import pytest
import torch

from perfbench.bench.trace import Trace


def ev(cat, name, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
         "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def synthetic():
    return Trace([
        ev("user_annotation", "perfbench.window", 0, 100),
        ev("user_annotation", "perfbench.moe", 10, 30),
        ev("cpu_op", "aten::mm", 12, 2),
        ev("cuda_runtime", "cudaLaunchKernel", 12, 1, corr=1),
        ev("cuda_runtime", "cudaLaunchKernel", 50, 1, corr=2),
        ev("cpu_op", "aten::item", 60, 30),
        ev("cuda_runtime", "cudaLaunchKernel", 91, 1, corr=3),
        ev("kernel", "gemm", 20, 20, tid=7, corr=1),
        ev("kernel", "flash_bwd_dq", 30, 30, tid=7, corr=2),
        ev("kernel", "gemm", 92, 4, tid=7, corr=3),
    ], window_s=100e-6)


def test_busy_union_spans_and_gaps():
    t = synthetic()
    assert t.busy_s(0, 100) == pytest.approx(44e-6)     # [20, 60] + [92, 96]
    assert t.kernel_s_under("moe") == pytest.approx(20e-6)
    assert t.kernel_s_named("flash_bwd_", lo=0, hi=100) == pytest.approx(
        30e-6)
    gaps = dict(t.idle_gaps(0, 100))
    assert gaps["aten::item"] == pytest.approx(32e-6)   # 60 -> 92
    assert sum(gaps.values()) == pytest.approx(56e-6)
    ops = dict(t.device_ops())
    assert ops["gemm"] == pytest.approx(24e-6)


def test_kernel_falls_to_the_innermost_open_span():
    """A kernel belongs to the latest-starting span open at its launch:
    nested spans, a span that ended before it, and one open past it."""
    t = Trace([
        ev("user_annotation", "perfbench.window", 0, 1000),
        ev("user_annotation", "perfbench.decode", 10, 100),
        ev("user_annotation", "perfbench.moe", 20, 30),
        ev("user_annotation", "perfbench.decode", 200, 100),
        ev("cuda_runtime", "cudaLaunchKernel", 25, 1, corr=1),
        ev("cuda_runtime", "cudaLaunchKernel", 60, 1, corr=2),
        ev("cuda_runtime", "cudaLaunchKernel", 150, 1, corr=3),
        ev("cuda_runtime", "cudaLaunchKernel", 250, 1, corr=4),
        ev("kernel", "k", 30, 10, tid=7, corr=1),
        ev("kernel", "k", 70, 20, tid=7, corr=2),
        ev("kernel", "k", 160, 40, tid=7, corr=3),
        ev("kernel", "k", 260, 80, tid=7, corr=4),
    ], window_s=1e-3)
    assert t.kernel_s_under("moe") == pytest.approx(10e-6)
    assert t.kernel_s_under("decode") == pytest.approx(100e-6)
    assert t.kernel_s_under("window") == pytest.approx(40e-6)


def test_decode_and_prefill_shares_divide_by_device_busy_time():
    """hbm_roofline.decode and mfu.prefill divide by the device's busy
    time inside their spans, not by the spans' host time."""
    from perfbench.bench import costs, spec

    t = Trace([
        ev("user_annotation", "perfbench.decode", 0, 100),
        ev("user_annotation", "perfbench.prefill", 200, 100),
        ev("kernel", "gemv", 10, 20, tid=7),
        ev("kernel", "gemv", 60, 20, tid=7),
        ev("kernel", "gemm", 210, 50, tid=7),
    ], window_s=300e-6)
    cfg = spec.cell("nemotron-4-340b.chat-b8").config
    ctx = {"cfg": cfg, "trace": t, "batches": [(8, 512)], "decode_steps": 1}
    need = costs.decode_step_bytes(cfg, 8, 513)
    hbm = spec.metric_reader("hbm_roofline.decode")(ctx)
    assert hbm == pytest.approx(100 * need / costs.HBM_BYTES_PER_S / 40e-6)
    flops = costs.prefill_flops(cfg, 8, 512)
    mfu = spec.metric_reader("mfu.prefill")(ctx)
    assert mfu == pytest.approx(100 * flops / 50e-6 / costs.BF16_OPS_PER_S)


@pytest.mark.cuda
def test_profiled_window_reads_device_time(card):
    from perfbench.bench import trace

    a = torch.randn(4096, 4096, device=card, dtype=torch.bfloat16)
    out = {}
    with trace.profiled(out):
        for _ in range(20):
            a = (a @ a).clamp_(-1, 1)
    lo, hi = out["window"]
    busy = out["trace"].busy_s(lo, hi)
    assert 0 < busy <= out["trace"].window_s
