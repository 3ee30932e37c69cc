"""The reader of the program's own spans (``bench/program_spans.py``)
over synthetic profiler events: innermost attribution across nested
ranges, the backward's thread, ``within``, the bisection against a
linear scan, and the seven metrics that read it."""
from __future__ import annotations

import bisect
import random

import pytest

from perfbench.bench import costs, program_spans, spec
from perfbench.bench.trace import Trace


def ev(cat, name, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
         "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def launched(kernels):
    """(launch tid, launch ts, kernel ts, kernel dur) -> events."""
    out = []
    for i, (tid, at, ts, dur) in enumerate(kernels):
        out.append(ev("cuda_runtime", "cudaLaunchKernel", at, 1, tid=tid,
                      corr=i))
        out.append(ev("kernel", f"k{i}", ts, dur, tid=7, corr=i))
    return out


def nested():
    return Trace([
        ev("user_annotation", "perfbench.window", 0, 1000),
        ev("user_annotation", "repro.train_step", 5, 900),
        ev("user_annotation", "repro.block", 10, 100),
        ev("user_annotation", "repro.moe", 20, 60),
        ev("user_annotation", "repro.moe.route", 25, 10),
        ev("cpu_op", "aten::mm", 26, 3),
        ev("user_annotation", "repro.moe.experts", 40, 20),
        # the backward on autograd's thread, while the main thread waits
        # inside train_step
        ev("user_annotation", "repro.moe", 300, 100, tid=2),
        ev("user_annotation", "repro.moe.combine", 310, 20, tid=2),
        ev("user_annotation", "repro.optimizer", 600, 200),
    ] + launched([
        (1, 27, 30, 5),       # route (under an aten op inside it)
        (1, 45, 50, 10),      # experts
        (1, 70, 80, 4),       # moe's own (after the phases)
        (1, 100, 105, 2),     # block's own
        (1, 200, 210, 3),     # train_step's own
        (2, 315, 320, 6),     # combine, backward thread
        (2, 350, 360, 7),     # moe's bracket, backward thread
        (1, 350, 370, 1),     # main thread at that time: train_step
        (2, 450, 460, 9),     # backward thread, no range open
        (1, 700, 710, 40),    # optimizer
    ]), window_s=1e-3)


def test_kernel_falls_to_the_innermost_program_range():
    t = nested()
    us = lambda name: program_spans.kernel_s_under(t, name) * 1e6
    assert us("moe.route") == pytest.approx(5)
    assert us("moe.experts") == pytest.approx(10)
    assert us("moe.combine") == pytest.approx(6)
    assert us("moe") == pytest.approx(4 + 7)
    assert us("block") == pytest.approx(2)
    assert us("train_step") == pytest.approx(3 + 1)
    assert us("optimizer") == pytest.approx(40)
    assert us("head") == 0.0
    # the benchmark's own spans are not the program's
    assert program_spans.kernel_s_under(t, "window") == 0.0


def test_ranges_by_name_on_every_thread():
    t = nested()
    assert program_spans.ranges(t, "moe") == [(20, 80), (300, 400)]
    assert program_spans.innermost(t, 2, 320) == "repro.moe.combine"
    assert program_spans.innermost(t, 1, 320) == "repro.train_step"
    assert program_spans.innermost(t, 2, 450) is None
    assert program_spans.innermost(t, 9, 10) is None


def test_within_restricts_to_an_enclosing_range():
    t = Trace([
        ev("user_annotation", "repro.prefill", 0, 100),
        ev("user_annotation", "repro.attention.core", 10, 20),
        ev("user_annotation", "repro.decode", 200, 100),
        ev("user_annotation", "repro.attention.core", 210, 20),
        ev("user_annotation", "repro.decode", 400, 100),
        ev("user_annotation", "repro.attention.core", 410, 20),
        ev("user_annotation", "repro.attention.core", 600, 20, tid=3),
    ] + launched([(1, 15, 20, 8), (1, 215, 220, 3), (1, 415, 420, 4),
                  (3, 605, 610, 50)]), window_s=1e-3)
    s = program_spans.kernel_s_under
    assert s(t, "attention.core") * 1e6 == pytest.approx(8 + 3 + 4 + 50)
    assert s(t, "attention.core", within="decode") * 1e6 == \
        pytest.approx(3 + 4)
    assert s(t, "attention.core", within="prefill") * 1e6 == \
        pytest.approx(8)


def test_a_range_includes_its_ends():
    t = Trace([
        ev("user_annotation", "repro.head", 10, 10),
        ev("user_annotation", "repro.block", 20, 10),
    ] + launched([(1, 10, 11, 1), (1, 20, 21, 2), (1, 30, 31, 4),
                  (1, 30.5, 32, 8)]), window_s=1e-4)
    us = lambda name: program_spans.kernel_s_under(t, name) * 1e6
    # at 20 both are open: the later start is the deeper
    assert us("head") == pytest.approx(1)
    assert us("block") == pytest.approx(2 + 4)


def innermost_linear(rs, ts):
    """The innermost range open at ``ts`` by a scan of every range, in
    :func:`program_spans.program_ranges`' order: the definition the
    bisection is held to."""
    best = None
    for a, b, n in rs:
        if a <= ts <= b:
            best = n
    return best


def random_ranges(rng, n, nested_only):
    rs = []
    if nested_only:
        def fill(lo, hi, depth):
            t = lo
            while t < hi and len(rs) < n:
                a = t + rng.uniform(0, (hi - t) / 3)
                b = a + rng.uniform(0, (hi - a))
                rs.append((round(a, 3), round(b, 3), f"repro.r{len(rs)}"))
                if depth < 4 and rng.random() < 0.6:
                    fill(a, b, depth + 1)
                t = b + rng.uniform(0, 5)
        fill(0.0, 1000.0, 0)
    else:
        for i in range(n):
            a = rng.choice([rng.uniform(0, 1000), float(rng.randrange(50))])
            b = a + rng.choice([0.0, rng.uniform(0, 200), 3.0])
            rs.append((a, b, f"repro.r{i}"))
    return sorted(rs, key=lambda r: (r[0], -r[1]))


@pytest.mark.parametrize("nested_only", [True, False])
def test_bisection_agrees_with_a_linear_scan(nested_only):
    rng = random.Random(7 if nested_only else 11)
    for _ in range(20):
        rs = random_ranges(rng, 60, nested_only)
        times, names = program_spans.breakpoints(rs)
        probes = [rng.uniform(-10, 1300) for _ in range(200)]
        probes += [x for a, b, _ in rs for x in (a, b)]
        for ts in probes:
            j = bisect.bisect_right(times, ts) - 1
            got = names[j] if j >= 0 else None
            assert got == innermost_linear(rs, ts), ts


def test_the_metrics_read_the_program_spans():
    """The seven metrics over one synthetic trace: each the device time
    under its span, a step, or the least bytes over it."""
    train = spec.cell("qwen3-moe-235b-a22b.train-4k")
    t = nested()
    ctx = {"cfg": train.config, "traffic": train.traffic, "trace": t,
           "window": (0, 1000), "steps": 2, "step_s": 1.0}
    read = lambda name: spec.metric_reader(name)(ctx)
    assert read("moe_route_ms.train") == pytest.approx(5e-3 / 2)
    assert read("moe_experts_ms.train") == pytest.approx(10e-3 / 2)
    assert read("moe_combine_ms.train") == pytest.approx(6e-3 / 2)
    assert read("moe_dispatch_ms.train") is None
    assert read("head_ms.train") is None
    opt = read("optimizer_roofline.train")
    # 12 bytes a parameter for master, gradient and new master, and the
    # factored state's row and column means read and written
    nbytes = spec.metric_reader("optimizer_roofline.train").__globals__[
        "update_bytes"](train.config)
    assert 12 * 3.73e9 < nbytes < 12.01 * 3.74e9
    assert opt == pytest.approx(100 * 2 * nbytes / costs.HBM_BYTES_PER_S
                                / 40e-6)

    chat = spec.cell("nemotron-4-340b.chat-b8")
    c = chat.config
    d = Trace([
        ev("user_annotation", "repro.decode", 0, 100),
        ev("user_annotation", "repro.attention.core", 10, 20),
        ev("user_annotation", "repro.decode", 200, 100),
        ev("user_annotation", "repro.attention.core", 210, 20),
    ] + launched([(1, 15, 20, 30), (1, 215, 220, 50), (1, 50, 60, 9)]),
        window_s=1e-3)
    ctx = {"cfg": c, "trace": d, "batches": [(8, 4096)], "decode_steps": 2}
    need = sum(c["num_hidden_layers"] * 8 * (4096 + j + 1) * 2 * 2
               * c["num_key_value_heads"] * c["head_dim"] for j in range(2))
    assert spec.metric_reader("decode_attn_roofline.decode")(ctx) == \
        pytest.approx(100 * need / costs.HBM_BYTES_PER_S / 80e-6)


def test_without_program_spans_the_metrics_read_nothing():
    """A program that opens no ``repro.*`` range (an older one): every new
    metric returns None and raises nothing."""
    t = Trace([ev("user_annotation", "perfbench.window", 0, 100),
               ev("user_annotation", "perfbench.moe", 10, 50)]
              + launched([(1, 20, 30, 5)]), window_s=1e-4)
    for cell, names in (
            ("qwen3-moe-235b-a22b.train-4k",
             ("moe_route_ms.train", "moe_dispatch_ms.train",
              "moe_experts_ms.train", "moe_combine_ms.train",
              "head_ms.train", "optimizer_roofline.train")),
            ("nemotron-4-340b.chat-b8", ("decode_attn_roofline.decode",))):
        c = spec.cell(cell)
        ctx = {"cfg": c.config, "traffic": c.traffic, "trace": t,
               "window": (0, 100), "steps": 1, "batches": [(8, 4096)],
               "decode_steps": 1}
        for n in names:
            assert spec.metric_reader(n)(ctx) is None, n
