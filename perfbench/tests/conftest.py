"""Fixtures of the benchmark's own tests (run them with
``python -m pytest perfbench/tests``; the repository's suite does not
collect them).  A test that needs the card is marked ``cuda`` and skips
inside its fixture when there is none."""
from __future__ import annotations

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "cuda: needs an NVIDIA card; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs on the card")
    return "cuda"


TINY = {"hidden_size": 64, "num_attention_heads": 4,
        "num_key_value_heads": 2, "head_dim": 16, "vocab_size": 97}


def tiny_cell(name: str):
    """The cell ``name`` of BENCHMARK.json at a size the CPU runs in a
    second: every width cut, the traffic shortened, the shape kept."""
    from perfbench.bench import spec

    c = spec.cell(name)
    c.config.update(TINY)
    if c.config.get("num_experts"):
        c.config.update(num_experts=8, num_experts_per_tok=2,
                        moe_intermediate_size=32)
    else:
        c.config.update(intermediate_size=128)
    if c.traffic["kind"] == "train":
        c.traffic.update(batch=2, seq_len=16)
    else:
        c.traffic.update(batch=4, prompt_lengths=[8, 8, 16, 32],
                         decode_steps=8)
    return c


# the limits at the tiny size, set as the cells' are, from readings at
# that size on the CPU (the program's sound runs: loss_gap <= 5.7e-4,
# grad_gap <= 1.9e-3, change_gap <= 2.1e-3, block_gap <= 6.7e-3,
# logit_gap <= 0.031 over 8 seeds; the float8 control: loss_gap >= 5.5e-3,
# grad_gap >= 2.0e-2, change_gap >= 9.2e-3, block_gap >= 7.3e-2,
# logit_gap >= 0.26)
TINY_LIMITS = {"train": {"loss_gap": 2.5e-3, "grad_gap": 8e-3,
                         "change_gap": 6e-3, "block_gap": 2.5e-2},
               "chat": {"logit_gap": 0.1}}


def tiny_limits(name: str) -> dict:
    return TINY_LIMITS["chat" if "chat" in name else "train"]


@pytest.fixture
def tiny(monkeypatch):
    """Compare at the tiny size against the tiny size's limits."""
    from perfbench.bench import common

    monkeypatch.setattr(common, "limits", tiny_limits)
    return tiny_cell
