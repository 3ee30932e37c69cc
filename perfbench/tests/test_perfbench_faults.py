"""The comparison that decides ``correct`` fails what it must: the
float8 control in the reference's place, and each fault a cell can have
planted under its timed path, at a size the CPU runs."""
from __future__ import annotations

import time

import pytest

from conftest import tiny_limits
from perfbench.bench import chat, train
from perfbench.reference.model import Numerics

TRAIN = ("nemotron-4-340b.train-4k", "qwen3-moe-235b-a22b.train-4k")
SEEDS = (3, 2 ** 31 + 11, 2 ** 33 + 1)


def drive(name, tiny, seed=SEEDS[0]):
    from perfbench import run

    c = tiny(name)
    drv = train if c.traffic["kind"] == "train" else chat
    r = drv.run(c, seed, 0.2, False, "cpu", time.time())
    return run.is_correct(r), r


@pytest.mark.parametrize("name", TRAIN + ("nemotron-4-340b.chat-b8",))
def test_sound_run_is_correct(name, tiny):
    ok, r = drive(name, tiny)
    assert ok, r["checks"]


@pytest.mark.parametrize("name", TRAIN)
def test_state_left_unchanged_fails(name, monkeypatch, tiny):
    from repro_torch.models import lm_zoo as Z

    real = Z.make_train_step

    def make(cfg, opt=None):
        step = real(cfg, opt)

        def unchanged(state, batch):
            new, m = step(state, batch)
            return state, m
        return unchanged
    monkeypatch.setattr(Z, "make_train_step", make)
    ok, r = drive(name, tiny)
    assert not ok and r["checks"]["change_gap"][0] >= 0.99


@pytest.mark.parametrize("name", TRAIN)
def test_half_the_batch_left_out_fails(name, monkeypatch, tiny):
    from repro_torch.models import lm_zoo as Z

    real = Z.make_loss_fn

    def make(cfg):
        loss = real(cfg)

        def half(params, batch):
            rows = batch["tokens"].shape[0] // 2
            return loss(params, {"tokens": batch["tokens"][:rows]})
        return half
    monkeypatch.setattr(Z, "make_loss_fn", make)
    ok, r = drive(name, tiny)
    assert not ok, r["checks"]


def test_altered_token_fails(monkeypatch, tiny):
    from repro_torch.models import lm_zoo as Z

    real = Z.make_serve_step

    def make(cfg):
        serve = real(cfg)

        def altered(params, dstate, tokens):
            logits, st = serve(params, dstate, tokens)
            return -logits, st           # the worst token put first
        return altered
    monkeypatch.setattr(Z, "make_serve_step", make)
    ok, r = drive("nemotron-4-340b.chat-b8", tiny)
    assert not ok, r["checks"]


@pytest.mark.parametrize("name", TRAIN)
def test_float8_control_fails_a_limit(name, tiny):
    """The reference in float8 put in the program's place, on three
    seeds: ``block_gap`` (the number that catches it in the mixture's
    cell at full size) over its limit on each."""
    c = tiny(name)
    lim = tiny_limits(name)
    B, S = c.traffic["batch"], c.traffic["seq_len"]
    for seed in SEEDS:
        ref = train.reference(c.config, seed, B, S, 3, "cpu")
        ctl = train.reference(c.config, seed, B, S, 3, "cpu",
                              Numerics(fp8=True))
        got = train.numbers(ctl, ref)
        assert got["block_gap"] > lim["block_gap"], (seed, got, lim)


@pytest.mark.parametrize("name", TRAIN)
def test_block_gap_holds_a_few_tokens_wholly_changed(name):
    """A routing near-tie changes a few tokens' outputs wholly: the
    median token's gap does not move; rounding every output moves it."""
    import torch

    from perfbench.bench import common

    g = torch.Generator().manual_seed(SEEDS[0])
    x = torch.randn(2, 64, 32, generator=g)
    ref = x + torch.randn(2, 64, 32, generator=g)
    prog = ref.clone()
    prog[0, :6] = x[0, :6] + torch.randn(6, 32, generator=g)
    assert float(common.token_gap(prog, ref, x).median()) == 0.0
    noisy = ref + 0.05 * (ref - x) * torch.randn(2, 64, 32, generator=g)
    assert float(common.token_gap(noisy, ref, x).median()) > 0.03
    half = ref[:1]
    assert float(common.token_gap(half, ref, x).max()) > 0.5


def test_float8_control_fails_the_chat_limit(tiny):
    c = tiny("nemotron-4-340b.chat-b8")
    lim = tiny_limits("nemotron-4-340b.chat-b8")["logit_gap"]
    for seed in SEEDS:
        r = chat.run(c, seed, 0.05, False, "cpu", time.time(),
                     control=True)
        assert r["notes"]["control_gap"] > lim, (seed, r["notes"])


@pytest.mark.parametrize("name", TRAIN)
def test_bf16_masters_control_fails(name, tiny):
    """The program's own path in the precision below its float32
    masters (the same draws held in bf16) comes out not correct."""
    from perfbench import run

    c = tiny(name)
    c.config["port"]["master_dtype"] = "bfloat16"
    r = train.run(c, SEEDS[1], 0.2, False, "cpu", time.time())
    assert not run.is_correct(r) and r["checks"]["change_gap"][0] > 1
