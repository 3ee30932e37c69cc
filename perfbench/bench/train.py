"""The training traffic: a closed loop of the program's train step.

Set-up makes the float32 masters from the seed, builds the program's
train step (``lm_zoo.make_train_step``) with its optimizer state, and
drives that one state through the first ``check_steps`` steps on the
window's own feed (fresh tokens drawn on the device, batch i from
stream i).  Those steps warm every shape the window runs.  The window
then runs step after step with no host synchronisation, for at least
``--seconds``, and ends in one.  The losses are read after it.

What is compared with the plain reference (``perfbench.reference``),
once the window has closed and the program's state is freed:

* ``loss_gap``: over the first steps, the largest |loss - reference's|
  over the reference's;
* ``grad_gap``: the norm of each leaf's first gradient, as the
  optimizer got it (read from Adafactor's factors after step 1), against
  the reference's, by the worst leaf (``common.worst_leaf_gap``);
* ``change_gap``: the norm of each leaf's change over the first steps,
  read before the window's first step replaces the parameters, against
  the reference's, by the worst leaf; leaves whose reference gradient
  is under a thousandth of the median leaf's are left out;
* ``block_gap``: the first block's output in the first step's forward,
  taken from the program's own call (its input is the embedding of the
  step's tokens, which both sides make alike), against the reference's
  block on that input, token by token (``common.token_gap``): the median
  token's gap.  A routing near-tie that goes one way on one side and the
  other way on the other moves a few tokens' outputs wholly and every
  leaf norm above in first order, but not the median token, which a
  product computed below bf16 moves.
"""
from __future__ import annotations

import contextlib
import math
import statistics
import time
from typing import Dict

import torch

from perfbench.bench import common, trace, weights
from perfbench.bench.spec import arch_config
from perfbench.reference import adafactor as ref_opt
from perfbench.reference import model as ref_model

ZERO_GRAD = 1e-3        # a leaf's gradient this share of the median's: out


def leaf_name(path) -> str:
    return "/".join(path)


def first_grad_norms(cfg: dict, opt_state) -> Dict[str, float]:
    """Each leaf's first-gradient norm from Adafactor's state after step
    1, where the factors are the means of g^2 + 1e-30 (beta_1 = 0)."""
    out = {}
    for spec in weights.leaf_specs(cfg):
        s = weights.get(opt_state.mu, spec[0])
        shape = spec[1]
        n = math.prod(shape)
        if isinstance(s, (tuple, list)):
            tot = float(s[0].double().sum()) * shape[-1]
        else:
            tot = float(s.double().sum())
        out[leaf_name(spec[0])] = math.sqrt(max(tot - 1e-30 * n, 0.0))
    return out


def change_norms(cfg: dict, params, seed: int, device) -> Dict[str, float]:
    """||p - p0|| of each leaf, p0 made again from the seed, one leaf at
    a time."""
    out = {}
    for i, spec in enumerate(weights.leaf_specs(cfg)):
        p0 = weights.make_leaf(spec, seed, i, torch.float32, device)
        p = weights.get(params, spec[0])
        out[leaf_name(spec[0])] = float((p.float() - p0).double().norm())
        del p0
    return out


@contextlib.contextmanager
def first_block_output(box: dict):
    """Within: the first call of the program's transformer block (the
    first layer's forward; block remat calls it again in the backward)
    leaves its output in ``box["block"]``, on the host."""
    from repro_torch.models import transformer_lm as T

    real = T._block_apply

    def block(*a, **kw):
        out = real(*a, **kw)
        if "block" not in box:
            box["block"] = out[0].detach().to("cpu", copy=True)
        return out

    T._block_apply = block
    try:
        yield
    finally:
        T._block_apply = real


def numbers(got: dict, ref: dict) -> dict:
    """The numbers a train cell may compare: ``loss_gap``, the largest
    |loss - reference's| / |reference's| over the first steps; for the
    first gradient's leaf norms (``grad_``) and the leaves' change norms
    (``change_``, leaves whose reference gradient is under ZERO_GRAD of
    the median leaf's left out), the worst leaf's gap (``*_gap``) and the
    median leaf's (``*_gap_median``), each leaf's by
    ``common.leaf_gaps``; ``block_gap``, the first block's output against
    the reference's by the median token (``common.token_gap``), and the
    mean token's (``block_gap_mean``).  ``leaves`` names the three worst
    of each."""
    med = statistics.median(ref["grad"].values())
    moved = [k for k, g in ref["grad"].items() if g >= ZERO_GRAD * med]
    out = {"loss_gap": max(abs(a - b) / abs(b)
                           for a, b in zip(got["loss"], ref["loss"]))}
    tok = common.token_gap(got["block"], ref["block"], ref["block_in"])
    out["block_gap"] = float(tok.median())
    out["block_gap_mean"] = float(tok.mean())
    leaves = {}
    for key, keep in (("grad", None), ("change", moved)):
        gaps = common.leaf_gaps(got[key], ref[key], keep)
        out[f"{key}_gap"] = max(gaps.values())
        out[f"{key}_gap_median"] = statistics.median(gaps.values())
        leaves[key] = sorted(gaps.items(), key=lambda x: -x[1])[:3]
    out["leaves"] = leaves
    return out


def optimizer_of(cfg: dict, arch, traced: bool):
    from repro_torch.models import lm_zoo as Z
    from repro_torch.train.optimizer import Optimizer

    o = cfg["port"]["optimizer"]
    opt = Z.make_optimizer(arch, peak_lr=o["peak_lr"], warmup=o["warmup"],
                           total=o["total"])
    if traced:
        opt = Optimizer(init=opt.init,
                        update=trace.ranged("optimizer", opt.update))
    return opt


def run(cell, seed: int, seconds: float, traced: bool, device,
        t_start: float) -> dict:
    from repro_torch.models import lm_zoo as Z

    cfg, tr = cell.config, cell.traffic
    B, S, n_check = tr["batch"], tr["seq_len"], tr["check_steps"]
    V = cfg["vocab_size"]
    arch = arch_config(cfg)
    opt = optimizer_of(cfg, arch, traced)
    feed = lambda i: {"tokens": weights.tokens(seed, i, (B, S), V, device)}

    params = weights.make_params(cfg, seed, torch.float32, device)
    masters = getattr(torch, cfg["port"]["master_dtype"])
    if masters is not torch.float32:   # the same draws, held lower
        for spec in weights.leaf_specs(cfg):
            if not spec[3]:
                weights.put(params, spec[0],
                            weights.get(params, spec[0]).to(masters))
    box = {"state": {"params": params, "opt": opt.init(params)}}
    del params
    step = Z.make_train_step(arch, opt)
    common.sync(device)
    marks = {"weights": time.time() - t_start}
    losses, grad_prog, first = [], None, {}
    spans = trace.layer_spans() if traced else contextlib.nullcontext()
    with spans:
        for i in range(n_check):
            seen = (first_block_output(first) if i == 0
                    else contextlib.nullcontext())
            with seen:
                box["state"], m = step(box.pop("state"), feed(i))
            losses.append(m["loss"])
            if i == 0:
                grad_prog = first_grad_norms(cfg, box["state"]["opt"])
            del m
        common.sync(device)
        setup_s = time.time() - t_start
        marks["check_steps"] = setup_s
        loss_prog = [float(x) for x in losses]
        change_prog = change_norms(cfg, box["state"]["params"], seed, device)

        out: dict = {}
        window_losses, n = [], 0
        common.sync(device)
        t0 = time.perf_counter()
        while True:
            if traced and n == 2:
                with trace.profiled(out):
                    for _ in range(3):
                        box["state"], m = step(box.pop("state"),
                                               feed(n_check + n))
                        window_losses.append(m["loss"])
                        n += 1
                out["steps"] = 3
            box["state"], m = step(box.pop("state"), feed(n_check + n))
            window_losses.append(m["loss"])
            del m
            n += 1
            if time.perf_counter() - t0 >= seconds:
                break
        common.sync(device)
        window_s = time.perf_counter() - t0
    finite = [math.isfinite(float(x)) for x in window_losses]
    peak = (torch.cuda.max_memory_allocated()
            if torch.device(device).type == "cuda" else 0)
    del box, window_losses, losses
    common.free(device)

    ref = reference(cfg, seed, B, S, n_check, device)
    got = numbers({"loss": loss_prog, "grad": grad_prog,
                   "change": change_prog, "block": first["block"]}, ref)
    leaves = got.pop("leaves")
    checks, read = common.compared(got, common.limits(cell.name))
    result = {
        "attempted": n, "failed": finite.count(False),
        "setup_s": setup_s, "memory_peak_bytes": peak,
        "e2e": {"train_tokens_per_s": n * B * S / window_s},
        "checks": checks,
        "notes": {"losses": loss_prog, "reference_losses": ref["loss"],
                  "not_compared": read, "worst_leaves": leaves,
                  "window_steps": n, "window_s": window_s,
                  "setup_marks": marks}}
    if traced:
        t = out["trace"]
        lo, hi = out["window"]
        result["trace"] = t
        result["ctx"] = {"cfg": cfg, "traffic": tr, "trace": t,
                         "window": out["window"], "steps": out["steps"],
                         "step_s": t.window_s / out["steps"]}
        result["busy_s"] = t.busy_s(lo, hi)
        result["window_s"] = t.window_s
        result["notes"]["spans"] = t.spans()
        result["breakdown"] = {"device_ops": t.device_ops(),
                               "idle_gaps": t.idle_gaps(lo, hi)}
    return result


def reference(cfg: dict, seed: int, B: int, S: int, steps: int, device,
              numerics: ref_model.Numerics = ref_model.Numerics(),
              rows: int | None = None) -> dict:
    """The plain reference's first ``steps`` steps from the same seed and
    feed: losses, the first gradient's leaf norms, the leaves' change
    norms, and the first block's input and output in the first step
    (``block_in``, ``block``, on the host).  ``numerics`` and ``rows``
    (the loss over the first ``rows`` batch rows) are for the control and
    the planted faults."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    o = cfg["port"]["optimizer"]
    specs = weights.leaf_specs(cfg)
    params = weights.make_params(cfg, seed, torch.float32, device)
    leaves = [weights.get(params, s[0]).requires_grad_() for s in specs]
    states = [ref_opt.init(p) for p in leaves]
    losses, grad = [], {}
    for t in range(1, steps + 1):
        toks = weights.tokens(seed, t - 1, (B, S), cfg["vocab_size"], device)
        if t == 1:
            first = first_block(params, toks, cfg, numerics)
        loss = ref_model.loss(params, toks, cfg, numerics, rows)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
        losses.append(float(loss.detach()))
        del loss
        if t == 1:
            grad = {leaf_name(s[0]): float(g.double().norm())
                    for s, g in zip(specs, grads)}
        lr = ref_opt.lr_at(t, o["peak_lr"], o["warmup"], o["total"])
        for p, g, st in zip(leaves, grads, states):
            ref_opt.update_(p, g, st, t, lr)
        del grads
    change = {}
    with torch.no_grad():
        for i, (spec, p) in enumerate(zip(specs, leaves)):
            p0 = weights.make_leaf(spec, seed, i, torch.float32, device)
            change[leaf_name(spec[0])] = float((p - p0).double().norm())
            del p0
    del params, leaves, states
    common.free(device)
    return dict(first, loss=losses, grad=grad, change=change)


@torch.no_grad()
def first_block(params, toks, cfg: dict, numerics: ref_model.Numerics
                ) -> dict:
    """The reference's first block over the embedded tokens: its input
    and output (bf16, on the host)."""
    x = params["embed"][toks.long()].to(torch.bfloat16)
    pos = torch.arange(toks.shape[1], device=toks.device)
    y, _ = ref_model.block(x, ref_model.layer(params["layers"], 0), cfg,
                           numerics, pos, grad=False)
    return {"block_in": x.cpu(), "block": y.cpu()}
