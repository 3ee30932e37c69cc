"""The LM path's own spans (``repro_torch.obs.trace``): with the profiler
and ``REPRO_TRACE`` off they cost no object and no autograd node; under
``torch.profiler`` (CPU) a reduced Qwen3-MoE train step and a reduced
dense decode step open every ``repro.*`` range the benchmark reads,
nested as the layers are, forward and backward; the step's outputs are
the same bits with the profiler on and off; the ring buffer records as
before, and the dry run still traces a cell with ``REPRO_TRACE=1``."""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import tempfile
from collections import Counter
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import get_arch
from repro_torch.models import lm_zoo as Z
from repro_torch.obs import trace
from repro_torch.train.optimizer import tree_leaves, tree_unflatten

ROOT = Path(__file__).resolve().parents[1]
B, S = 2, 16
PHASES = ("moe.route", "moe.dispatch", "moe.experts", "moe.combine")
TRAIN_NAMES = ("train_step", "block", "attention.core", "moe", "head",
               "optimizer") + PHASES


@pytest.fixture(autouse=True)
def _clean_trace():
    trace.disable()
    trace.reset()
    yield
    trace.disable()
    trace.reset()


def moe_cfg():
    return dataclasses.replace(get_arch("qwen3-moe-235b-a22b").reduced(),
                               remat="block")


def dense_cfg():
    return get_arch("nemotron-4-340b").reduced()


def tokens(cfg, seed=1):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, cfg.vocab, (B, S), generator=g).to(torch.int32)


def train_once(cfg, profiled: bool):
    """One train step from seed 0: (new state, metrics, the profiler's
    ranges or None)."""
    state = Z.init_train_state(cfg, torch.Generator().manual_seed(0),
                               device="cpu")
    step = Z.make_train_step(cfg)
    batch = {"tokens": tokens(cfg)}
    if not profiled:
        return (*step(state, batch), None)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        new, metrics = step(state, batch)
    return new, metrics, program_ranges(prof)


def program_ranges(prof):
    """The ``repro.*`` ranges of a profile: [(name without the prefix,
    start, end, tid)], in order of start."""
    path = Path(tempfile.gettempdir()) / f"spans-{os.getpid()}.json"
    try:
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text())["traceEvents"]
    finally:
        path.unlink(missing_ok=True)
    out = [(e["name"][len(trace.RANGE_PREFIX):], float(e["ts"]),
            float(e["ts"]) + float(e["dur"]), e["tid"])
           for e in events if e.get("ph") == "X"
           and e.get("cat") == "user_annotation"
           and e["name"].startswith(trace.RANGE_PREFIX)]
    return sorted(out, key=lambda r: (r[1], -r[2]))


def holder(rs, r):
    """The innermost other range on ``r``'s thread that holds ``r``."""
    best = None
    for q in rs:
        if (q is not r and q[3] == r[3] and q[1] <= r[1] and r[2] <= q[2]
                and (best is None or q[1] >= best[1])):
            best = q
    return best


def parent(rs, r):
    best = holder(rs, r)
    return best[0] if best else None


def ancestors(rs, r):
    return {q[0] for q in rs if q is not r and q[3] == r[3]
            and q[1] <= r[1] and r[2] <= q[2]}


def count_nodes(t: torch.Tensor) -> int:
    seen, todo = set(), [t.grad_fn]
    while todo:
        fn = todo.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        todo.extend(f for f, _ in fn.next_functions)
    return len(seen)


def loss_graph_nodes(cfg) -> int:
    state = Z.init_train_state(cfg, torch.Generator().manual_seed(0),
                               device="cpu")
    leaves = [p.detach().requires_grad_(True)
              for p in tree_leaves(state["params"])]
    with torch.enable_grad():
        loss, _ = Z.make_loss_fn(cfg)(tree_unflatten(state["params"],
                                                     leaves),
                                      {"tokens": tokens(cfg)})
    return count_nodes(loss)


# ---------------------------------------------------------------------------
# off: nothing made
# ---------------------------------------------------------------------------


def test_span_and_bracket_are_shared_noops_when_off():
    assert not torch.autograd.profiler._is_profiler_enabled
    assert trace.span("block") is trace._NOOP
    assert trace.span("moe", a=1) is trace._NOOP
    br = trace.bracket("block")
    assert br is trace._NO_BRACKET
    x = torch.ones(3, requires_grad=True) * 2
    assert br.input(x) is x and br.output(x) is x


@pytest.mark.parametrize("make_cfg", [moe_cfg, dense_cfg],
                         ids=["moe", "dense"])
def test_off_graph_has_no_bracket_node(make_cfg, monkeypatch):
    """With the profiler off, the loss's autograd graph has as many nodes
    as with every bracket taken out; with it on, the brackets' nodes."""
    cfg = make_cfg()
    off = loss_graph_nodes(cfg)
    monkeypatch.setattr(trace, "bracket", lambda kind: trace._NO_BRACKET)
    assert loss_graph_nodes(cfg) == off
    monkeypatch.undo()
    with profile(activities=[ProfilerActivity.CPU]):
        on = loss_graph_nodes(cfg)
    # a bracket's output node and one a bracketed input: each block (1 +
    # 1), attention core (1 + q, k, v), the head, the mixture and its four
    # phases (1 + 1 each)
    per_layer = 2 + 4 + (10 if cfg.moe is not None else 0)
    assert on == off + cfg.n_layers * per_layer + 2


def test_bracket_needs_grad_and_an_input():
    with profile(activities=[ProfilerActivity.CPU]):
        br = trace.bracket("x")
        y = torch.ones(2, requires_grad=True) * 3
        assert br.output(y) is y                 # no input bracketed
        c = torch.ones(2)
        assert br.input(c) is c                  # needs no grad
        with torch.no_grad():
            assert trace.bracket("x") is trace._NO_BRACKET


# ---------------------------------------------------------------------------
# on: the ranges, forward and backward
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def moe_step():
    cfg = moe_cfg()
    plain = train_once(cfg, False)
    traced = train_once(cfg, True)
    return cfg, plain, traced


def test_train_step_opens_every_range(moe_step):
    cfg, _, (_, _, rs) = moe_step
    n = Counter(r[0] for r in rs)
    L = cfg.n_layers
    assert set(n) == set(TRAIN_NAMES)
    assert n["train_step"] == 1 and n["optimizer"] == 1
    assert n["head"] == 2                        # forward, backward
    # forward, recompute (block remat) and backward of each layer
    for name in ("block", "attention.core", "moe") + PHASES:
        assert n[name] == 3 * L, name


def test_train_ranges_nest_as_the_layers(moe_step):
    _, _, (_, _, rs) = moe_step
    for r in rs:
        up = ancestors(rs, r)
        if r[0] == "train_step":
            assert not up
            continue
        assert "train_step" in up, r
        if r[0] in PHASES:
            assert parent(rs, r) == "moe", r
        elif r[0] in ("attention.core", "moe"):
            assert "block" in up, r
        elif r[0] in ("head", "optimizer"):
            assert parent(rs, r) == "train_step", r


def test_backward_phases_follow_the_gradient(moe_step):
    """In each layer's backward the mixture's bracket holds the phases in
    the gradient's order: combine, experts, dispatch, route."""
    _, _, (_, _, rs) = moe_step
    opt = next(r for r in rs if r[0] == "optimizer")
    head_bwd = [r for r in rs if r[0] == "head"][1]
    bwd = [r for r in rs if head_bwd[2] < r[1] < opt[1]]
    # the mixture's bracket lies in the block's bracket, right in the step
    # (the recompute's forward runs inside the mixture's bracket)
    moes = [r for r in bwd if r[0] == "moe" and parent(rs, r) == "block"
            and parent(rs, holder(rs, r)) == "train_step"]
    assert len(moes) == moe_step[0].n_layers
    for m in moes:
        inner = [r[0] for r in bwd if holder(rs, r) is m
                 and r[0] in PHASES]
        assert inner == ["moe.combine", "moe.experts", "moe.dispatch",
                         "moe.route"], inner


def test_profiler_leaves_the_step_bit_for_bit(moe_step):
    _, (p_state, p_m, _), (t_state, t_m, _) = moe_step
    a, b = tree_leaves(p_state), tree_leaves(t_state)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert (torch.equal(x, y) if isinstance(x, torch.Tensor)
                else x == y)
    for k in p_m:
        assert torch.equal(p_m[k], t_m[k]), k


def test_dense_train_step_same_bits_and_ranges():
    cfg = dense_cfg()
    (p_state, p_m, _), (t_state, t_m, rs) = (train_once(cfg, False),
                                             train_once(cfg, True))
    for x, y in zip(tree_leaves(p_state), tree_leaves(t_state)):
        assert (torch.equal(x, y) if isinstance(x, torch.Tensor)
                else x == y)
    assert torch.equal(p_m["loss"], t_m["loss"])
    n = Counter(r[0] for r in rs)
    # no remat in the reduced dense config: forward and backward
    assert n == Counter({"train_step": 1, "optimizer": 1, "head": 2,
                         "block": 2 * cfg.n_layers,
                         "attention.core": 2 * cfg.n_layers})


def test_serving_steps_open_their_ranges():
    cfg = dense_cfg()
    params = Z.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    prefill, serve = Z.make_prefill_step(cfg), Z.make_serve_step(cfg)
    logits_plain, st = prefill(params, {"tokens": tokens(cfg)})
    k = torch.zeros(st["k"].shape[:2] + (S + 2,) + st["k"].shape[3:],
                    dtype=st["k"].dtype)
    k[:, :, :S] = st["k"]
    v = torch.zeros_like(k)
    v[:, :, :S] = st["v"]
    tok = logits_plain.argmax(-1, keepdim=True).to(torch.int32)
    ref, _ = serve(params, {"pos": st["pos"], "k": k.clone(),
                            "v": v.clone()}, tok)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        logits, _ = prefill(params, {"tokens": tokens(cfg)})
        got, _ = serve(params, {"pos": st["pos"], "k": k, "v": v}, tok)
    assert torch.equal(logits, logits_plain) and torch.equal(got, ref)
    rs = program_ranges(prof)
    n = Counter(r[0] for r in rs)
    L = cfg.n_layers
    assert n == Counter({"prefill": 1, "decode": 1, "head": 2,
                         "block": 2 * L, "attention.core": 2 * L})
    for r in rs:
        if r[0] == "attention.core":
            assert parent(rs, r) == "block"
        elif r[0] in ("block", "head"):
            assert parent(rs, r) in ("prefill", "decode")
    dec = next(r for r in rs if r[0] == "decode")
    inside = {r[0] for r in rs if dec[1] <= r[1] and r[2] <= dec[2]}
    assert inside == {"decode", "block", "attention.core", "head"}


# ---------------------------------------------------------------------------
# the ring buffer, as before
# ---------------------------------------------------------------------------


def test_ring_buffer_records_the_lm_spans():
    trace.enable()
    cfg = dense_cfg()
    params = Z.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    Z.make_prefill_step(cfg)(params, {"tokens": tokens(cfg)})
    kinds = Counter(e["kind"] for e in trace.events())
    assert kinds == Counter({"prefill": 1, "head": 1,
                             "block": cfg.n_layers,
                             "attention.core": cfg.n_layers})


def test_span_records_in_both_with_args():
    trace.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.span("rpc.call", op="x", bytes=3) as sp:
            sp.set(bytes=4)
    ev = trace.events()
    assert [(e["kind"], e["args"]) for e in ev] == [
        ("rpc.call", {"op": "x", "bytes": 4})]
    assert [r[0] for r in program_ranges(prof)] == ["rpc.call"]


def test_profiler_alone_leaves_the_ring_buffer_empty():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.span("sample", seeds=4):
            pass
    assert trace.events() == []
    assert [r[0] for r in program_ranges(prof)] == ["sample"]


def test_dryrun_traces_a_cell_with_repro_trace_on():
    code = (
        "import dataclasses\n"
        "from repro_torch.configs import get_arch\n"
        "from repro_torch.configs.base import ShapeSpec\n"
        "from repro_torch.launch import dryrun\n"
        "from repro_torch.obs import trace\n"
        "cfg = dataclasses.replace(get_arch('qwen3-moe-235b-a22b')"
        ".reduced(), remat='block')\n"
        "r = dryrun.run_cell(cfg.name, 't', False, {}, False, cfg=cfg,"
        " shape=ShapeSpec('t', 32, 2, 'train'), mesh_shape=(1, 1))\n"
        "print(trace.enabled(), r['ok'], r['trace']['flops'] > 0)\n"
        "print(sorted({e['kind'] for e in trace.events()}))\n")
    env = dict(os.environ, REPRO_TRACE="1",
               PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300, env=env)
    assert r.returncode == 0, r.stderr[-3000:]
    flags, kinds = r.stdout.strip().splitlines()[-2:]
    assert flags == "True True True"
    assert set(eval(kinds)) == set(TRAIN_NAMES)
