"""The chat traffic: a closed loop of batches of requests, each batch one
prompt length, prefilled by the program (``lm_zoo.make_prefill_step``)
and then decoded greedily (``make_serve_step``) through its cache.

A cycle is one batch of each entry of ``prompt_lengths``, in an order
the seed shuffles; every seed so serves the same set of lengths.  The
window runs whole cycles until ``--seconds`` have passed.  A request's
time to first token runs from its batch's start to its first token on
the host; a decode step's time, from its input token on the host to its
output token on the host.  The prefill's K/V are copied into a cache
with room for the decode steps (the program's prefill returns a cache as
long as the prompt); that copy is in neither time.

Set-up makes the bf16 weights from the seed and serves one batch of
each length with two decode steps, so that the window runs no shape for
the first time.  A traced run profiles one batch of the first cycle,
the longest prompts' (the class the p95 lies in): its prefill and every
decode step.

What is compared with the plain reference, once the window has closed
and the program's weights are freed: a sample of the finished batches
drawn from the seed, ``check_batches`` of the longest prompts and of the
others, every request in them.  The reference runs once over each prompt and its
served tokens; ``logit_gap`` is the widest gap by which a served token's
reference logit lies below the reference's best at that position.
"""
from __future__ import annotations

import contextlib
import time
from typing import List

import numpy as np
import torch

from perfbench.bench import common, trace, weights
from perfbench.bench.spec import arch_config
from perfbench.reference import model as ref_model


class Server:
    def __init__(self, cfg: dict, params, traced: bool):
        from repro_torch.models import lm_zoo as Z

        arch = arch_config(cfg)
        self.params = params
        self.prefill = Z.make_prefill_step(arch)
        self.serve = Z.make_serve_step(arch)
        self.traced = traced
        self.finite: List[torch.Tensor] = []

    def _range(self, name):
        if self.traced:
            return torch.autograd.profiler.record_function(
                trace.PREFIX + name)
        return contextlib.nullcontext()

    def batch(self, toks: torch.Tensor, n_decode: int, room: int):
        """Serve one batch through a cache with ``room`` positions past
        the prompt: (served tokens (B, 1 + n_decode) on the host, time to
        first token s, decode step times s)."""
        B, L = toks.shape
        t0 = time.perf_counter()
        with self._range("prefill"):
            logits, st = self.prefill(self.params, {"tokens": toks})
            tok = logits.argmax(-1, keepdim=True).to(torch.int32)
            self.finite.append(torch.isfinite(logits).all())
            first = tok[:, 0].cpu()
        ttft = time.perf_counter() - t0
        del logits
        k = st["k"].new_zeros(st["k"].shape[:2] + (L + room,)
                              + st["k"].shape[3:])
        v = torch.zeros_like(k)
        k[:, :, :L].copy_(st["k"])
        v[:, :, :L].copy_(st["v"])
        dstate = {"pos": st["pos"], "k": k, "v": v}
        del st, k, v
        served, steps = [first], []
        for _ in range(n_decode):
            t1 = time.perf_counter()
            with self._range("decode"):
                logits, dstate = self.serve(self.params, dstate, tok)
                tok = logits.argmax(-1, keepdim=True).to(torch.int32)
                self.finite.append(torch.isfinite(logits).all())
                served.append(tok[:, 0].cpu())
            steps.append(time.perf_counter() - t1)
            del logits
        del dstate
        return torch.stack(served, 1), ttft, steps


def run(cell, seed: int, seconds: float, traced: bool, device,
        t_start: float, control: bool = False) -> dict:
    """One run; ``control`` also reads the float8 control's gap on the
    same sample (``perfbench/calibrate.py``; the benchmark never does)."""
    cfg, tr = cell.config, cell.traffic
    B, lengths, n_dec = tr["batch"], tr["prompt_lengths"], tr["decode_steps"]
    V = cfg["vocab_size"]
    params = weights.make_params(cfg, seed, torch.bfloat16, device)
    srv = Server(cfg, params, traced)
    del params
    common.sync(device)
    marks = {"weights": time.time() - t_start}
    warm = len(lengths) * 1000          # token streams the window never uses
    for j, L in enumerate(sorted(set(lengths))):
        srv.batch(weights.tokens(seed, warm + j, (B, L), V, device), 2,
                  n_dec)
    srv.finite.clear()
    common.sync(device)
    setup_s = time.time() - t_start
    marks["warm_up"] = setup_s

    rng = np.random.default_rng(weights.mix(seed, 7))
    done, ttfts, steps = [], [], []     # done: (batch index, L, served)
    out: dict = {}
    longest = max(lengths)
    t0 = time.perf_counter()
    cycle = 0
    while True:
        order = rng.permutation(len(lengths))
        for j in order:
            b = len(done)
            L = lengths[j]
            prof = (trace.profiled(out)
                    if traced and L == longest and "trace" not in out
                    else contextlib.nullcontext())
            with prof:
                toks = weights.tokens(seed, b, (B, L), V, device)
                served, ttft, dsteps = srv.batch(toks, n_dec, n_dec)
            done.append((b, L, served))
            ttfts += [ttft] * B
            steps += dsteps
        cycle += 1
        if time.perf_counter() - t0 >= seconds:
            break
    window_s = time.perf_counter() - t0
    finite = torch.stack(srv.finite).cpu()
    per_batch = 1 + n_dec
    failed = sum(B for i in range(len(done))
                 if not bool(finite[i * per_batch:(i + 1) * per_batch].all()))
    peak = (torch.cuda.max_memory_allocated()
            if torch.device(device).type == "cuda" else 0)
    srv.params = None
    del srv
    common.free(device)

    sample = check_sample(done, seed, tr)
    gap = logit_gap(cfg, seed, sample, device, control)
    result = {
        "attempted": len(done) * B, "failed": failed,
        "setup_s": setup_s, "memory_peak_bytes": peak,
        "e2e": {"ttft_ms_p95": float(np.percentile(ttfts, 95)) * 1e3,
                "tpot_ms": sum(steps) / len(steps) * 1e3},
        "checks": common.compared({"logit_gap": gap["program"]},
                                  common.limits(cell.name))[0],
        "notes": {"batches": len(done), "cycles": cycle,
                  "window_s": window_s, "checked_tokens": gap["tokens"],
                  "setup_marks": marks}}
    if control:
        result["notes"]["control_gap"] = gap["control"]
    if traced:
        t = out["trace"]
        lo, hi = out["window"]
        result["trace"] = t
        result["ctx"] = {"cfg": cfg, "traffic": tr, "trace": t,
                         "window": out["window"],
                         "batches": [(B, longest)], "decode_steps": n_dec}
        result["busy_s"] = t.busy_s(lo, hi)
        result["window_s"] = t.window_s
        result["notes"]["spans"] = t.spans()
        result["breakdown"] = {"device_ops": t.device_ops(),
                               "idle_gaps": t.idle_gaps(lo, hi)}
    return result


def check_sample(done, seed: int, tr: dict):
    """Finished batches drawn from the seed: ``check_batches["longest"]``
    of the longest prompts and ``["other"]`` of the rest."""
    rng = np.random.default_rng(weights.mix(seed, 11))
    longest = max(tr["prompt_lengths"])
    pick = []
    for key, want in (("longest", lambda L: L == longest),
                      ("other", lambda L: L != longest)):
        cands = [d for d in done if want(d[1])]
        for _ in range(min(tr["check_batches"][key], len(cands))):
            pick.append(cands.pop(int(rng.integers(len(cands)))))
    return pick


def logit_gap(cfg: dict, seed: int, sample, device,
              control: bool = False) -> dict:
    """The widest gap, over every served token of the sampled batches, of
    the reference's best logit over the served token's.  With
    ``control``, also the same gap of the token that the reference in
    float8 puts first at each position."""
    torch.backends.cuda.matmul.allow_tf32 = False
    params = weights.make_params(cfg, seed, torch.bfloat16, device)
    worst, worst_ctl, n = 0.0, 0.0, 0
    for b, L, served in sample:
        B, n_served = served.shape
        prompt = weights.tokens(seed, b, (B, L), cfg["vocab_size"], device)
        seq = torch.cat([prompt, served[:, :-1].to(device)], 1)
        ref = ref_model.logits_at(params, seq, cfg, n_served)
        got = served.to(device).long()
        gaps = ref.amax(-1) - ref.gather(-1, got[..., None])[..., 0]
        worst = max(worst, float(gaps.max()))
        n += got.numel()
        if control:
            low = ref_model.logits_at(params, seq, cfg, n_served,
                                      ref_model.Numerics(fp8=True))
            pick = low.argmax(-1, keepdim=True)
            g = ref.amax(-1) - ref.gather(-1, pick)[..., 0]
            worst_ctl = max(worst_ctl, float(g.max()))
            del low
        del ref, seq, prompt
    del params
    common.free(device)
    return {"program": worst, "control": worst_ctl, "tokens": n}
