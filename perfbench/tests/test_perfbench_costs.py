"""The frozen FLOP and byte counts against hand-checked numbers."""
from __future__ import annotations

import pytest

from perfbench.bench import costs, spec


def test_nemotron_train_step_flops():
    cfg = spec.run_config("nemotron-4-340b", "train")
    # layer 3.455e9 + head 18,432 x 32,000 = 4.045e9 matmul parameters,
    # 6 x 8,192 tokens; causal attention 12 x 192 x 2 x 96 x 4,096 x 4,097/2
    mm = (2 * 18432 * 18432 + 2 * 18432 * 1536 + 2 * 18432 * 73728
          + 18432 * 32000)
    want = 6 * mm * 8192 + 12 * 192 * 96 * 4096 * 4097
    got = costs.train_step_flops(cfg, 2, 4096)
    assert got == pytest.approx(want)
    assert got == pytest.approx(2.02e14, rel=0.01)


def test_qwen3_moe_train_step_flops():
    cfg = spec.run_config("qwen3-moe-235b-a22b", "train")
    active = costs.layer_matmul_params(cfg) + 4096 * 151936
    assert active == pytest.approx(844e6, rel=0.01)
    assert costs.train_step_flops(cfg, 2, 4096) == pytest.approx(4.3e13,
                                                                 rel=0.01)


def test_nemotron_decode_step_bytes():
    cfg = spec.run_config("nemotron-4-340b", "serve")
    weights = costs.decode_step_bytes(cfg, 8, 0)
    assert weights == pytest.approx(37.1e9, rel=0.01)
    kv = costs.decode_step_bytes(cfg, 8, 4096) - weights
    assert kv == pytest.approx(2 * 4 * 8 * 4096 * 2 * 8 * 192)


def test_flash_bounds():
    # Nemotron-4's train shape: 10 D FLOP a pair at 989 TFLOP/s, 3.13 ms
    b = costs.flash_bwd_bound_s(2, 4096, 96, 8, 192)
    assert b == pytest.approx(3.1275e-3, rel=1e-3)
    f = costs.flash_fwd_bound_s(2, 4096, 96, 8, 192)
    assert f == pytest.approx(1.2510e-3, rel=1e-3)
