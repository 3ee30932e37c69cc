"""ArchConfig -> runnable serving steps (counterpart of the serving part
of ``repro.models.lm_zoo``):

    cfg     = get_arch("yi-6b")
    params  = init_params(cfg, torch.Generator("cuda").manual_seed(0))
    prefill = make_prefill_step(cfg)   # (params, batch) -> (logits, dstate)
    serve   = make_serve_step(cfg)     # (params, dstate, tokens) -> ...

Both steps compute in bfloat16 (``_cast_compute``), with the float32
leaves of ``_FP32_KEEP`` left as they are.  The loss, the train step and
the shape stand-ins of the JAX module are not ported yet.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve
from repro_torch.models.layers import rms_norm
from repro_torch.models.transformer_lm import (decode_forward, embed_input,
                                               forward_hidden, init_lm,
                                               unembed_weight)

PyTree = Any
COMPUTE_DTYPE = torch.bfloat16

# fp32-sensitive parameter names kept out of the bf16 compute cast
_FP32_KEEP = ("A_log", "dt_bias", "D", "router")


def _cast_compute(params: PyTree, dtype=COMPUTE_DTYPE) -> PyTree:
    """The compute tree: every float32 leaf not named in ``_FP32_KEEP``
    cast to ``dtype``, every other leaf as it is (the same tensor).

    On a tree that is already cast this is the identity, as in JAX, so a
    caller may cast once, drop the float32 masters and hand the cast
    tree to the steps, which then copy no weight."""
    def walk(x, name):
        if isinstance(x, dict):
            return {k: walk(v, str(k)) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(walk(v, "") for v in x)
        if x.dtype == torch.float32 and name not in _FP32_KEEP:
            return x.to(dtype)
        return x
    return walk(params, "")


# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------


def init_params(cfg: ArchConfig, generator: torch.Generator,
                dtype=torch.float32, *, device=None) -> PyTree:
    """The parameter tree on ``device`` (default: the card), drawn on the
    generator's device; give a generator on the target device for a
    full-size model."""
    device = resolve(device)

    def to(tree):      # a no-op for leaves already on the device
        if isinstance(tree, dict):
            return {k: to(v) for k, v in tree.items()}
        return tree.to(device)
    return to(init_lm(cfg, generator, dtype))


# ---------------------------------------------------------------------------
# Serving: prefill + decode
# ---------------------------------------------------------------------------


def make_prefill_step(cfg: ArchConfig):
    """(params, batch) -> (last-token logits (B, V) f32, decode state);
    an encoder returns full-sequence logits (B, S, V) and no state."""

    def prefill(params: PyTree, batch: Dict[str, torch.Tensor]):
        cp = _cast_compute(params)
        x = embed_input(cfg, cp, batch)
        B, S = x.shape[:2]
        positions = torch.arange(S, device=x.device)[None, :].expand(B, S)
        h, _, state = forward_hidden(cfg, cp, x, positions,
                                     collect_state=True)
        h = rms_norm(h, cp["final_norm"], cfg.norm_eps)
        w_out = unembed_weight(cfg, cp)
        if cfg.is_encoder:
            # encoder "serving" = full-sequence logits (e.g. frame labels)
            return (h @ w_out).float(), None
        logits = (h[:, -1] @ w_out).float()
        state = dict(state or {})
        state["pos"] = torch.full((B,), S, dtype=torch.int32,
                                  device=x.device)
        return logits, state

    return prefill


def make_serve_step(cfg: ArchConfig):
    """(params, dstate, tokens (B, 1)) -> (logits (B, V) f32, new dstate);
    an encoder's step is its prefill on ``batch`` in place of tokens."""
    if cfg.is_encoder:
        prefill = make_prefill_step(cfg)

        def encode(params, dstate, batch):
            logits, _ = prefill(params, batch)
            return logits, dstate
        return encode

    def serve(params: PyTree, dstate: Dict, tokens: torch.Tensor):
        cp = _cast_compute(params)
        x = cp["embed"][tokens.long()]                  # (B, 1, d)
        h, new_state = decode_forward(cfg, cp, x, dstate)
        h = rms_norm(h, cp["final_norm"], cfg.norm_eps)
        w_out = unembed_weight(cfg, cp)
        return (h[:, 0] @ w_out).float(), new_state

    return serve
