"""ArchConfig -> runnable train and serving steps (counterpart of
``repro.models.lm_zoo``):

    cfg     = get_arch("yi-6b")
    gen     = torch.Generator("cuda").manual_seed(0)
    state   = init_train_state(cfg, gen)   # {"params", "opt"}
    step    = make_train_step(cfg)         # (state, batch) -> (state, metrics)
    params  = init_params(cfg, gen)
    prefill = make_prefill_step(cfg)   # (params, batch) -> (logits, dstate)
    serve   = make_serve_step(cfg)     # (params, dstate, tokens) -> ...
    specs   = train_state_specs(cfg)   # meta tensors: shapes, no memory

Every step computes in bfloat16 (``_cast_compute``), with the float32
leaves of ``_FP32_KEEP`` left as they are; the train step takes its
gradient with respect to the float32 master leaves.

Under a mesh, as in the JAX package, the same steps shard themselves:

    with sharding_ctx(make_local_mesh(1, 4), default_rules()):
        logits, dstate = prefill(params, batch)   # CP attention, EP moe
        logits, dstate = serve(params, dstate, tokens)

(``dist.sharding``, ``launch.mesh``): a prefill whose length the
``seq_act`` axis divides takes context-parallel attention and the
expert-parallel moe path; a decode step's one token does not split, so
it takes the whole-sequence paths.  The tree needs nothing new.

The JAX module's ``input_specs``/``decode_state_specs`` (stand-ins for
XLA lowering) have no counterpart.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve
from repro_torch.models.layers import chunked_softmax_xent, rms_norm
from repro_torch.models.transformer_lm import (check_family, decode_forward,
                                               embed_input, forward_hidden,
                                               init_lm, unembed_weight)
from repro_torch.train.optimizer import (OPTIMIZERS, Optimizer, tree_leaves,
                                         tree_unflatten,
                                         warmup_cosine_schedule)

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


def param_specs(cfg: ArchConfig, dtype=torch.float32) -> PyTree:
    """The parameter tree's shapes and dtypes as ``meta`` tensors, with
    no memory allocated: ``init_lm`` traced under a fake-tensor mode
    (the counterpart of ``jax.eval_shape``)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    check_family(cfg)
    with FakeTensorMode():
        fake = init_lm(cfg, torch.Generator(), dtype)

    def meta(tree):
        if isinstance(tree, dict):
            return {k: meta(v) for k, v in tree.items()}
        return torch.empty(tree.shape, dtype=tree.dtype, device="meta")
    return meta(fake)


def make_optimizer(cfg: ArchConfig, *, peak_lr: float = 3e-4,
                   warmup: int = 200, total: int = 10_000) -> Optimizer:
    sched = warmup_cosine_schedule(peak_lr, warmup, total)
    return OPTIMIZERS[cfg.optimizer](sched)


# ---------------------------------------------------------------------------
# Loss / train step
# ---------------------------------------------------------------------------


def make_loss_fn(cfg: ArchConfig):
    """(params, batch) -> (loss, metrics): next-token cross-entropy for a
    ``tokens`` input (``valid`` optional), masked-frame prediction
    (``frames``, ``labels``, ``mask``) for a ``frames`` input; a moe
    config adds ``router_aux_weight`` times the layers' mean load-balance
    loss and reports ``moe_lb_loss`` and ``moe_drop_frac``."""
    check_family(cfg)

    def loss_fn(params: PyTree, batch: Dict[str, torch.Tensor]):
        cp = _cast_compute(params)
        x = embed_input(cfg, cp, batch)
        B, S = x.shape[:2]
        positions = torch.arange(S, device=x.device)[None, :].expand(B, S)
        h, aux, _ = forward_hidden(cfg, cp, x, positions)
        h = rms_norm(h, cp["final_norm"], cfg.norm_eps)
        w_out = unembed_weight(cfg, cp)
        if cfg.input_kind == "tokens":
            labels = batch["tokens"][:, 1:]
            valid = batch.get("valid")
            valid = valid[:, 1:] if valid is not None else None
            loss, cnt = chunked_softmax_xent(h[:, :-1], w_out, labels,
                                             valid)
        else:  # masked-frame prediction (HuBERT-style)
            loss, cnt = chunked_softmax_xent(h, w_out, batch["labels"],
                                             batch["mask"])
        metrics = {"ce_loss": loss, "tokens": cnt}
        total = loss
        if cfg.moe is not None:
            total = total + cfg.moe.router_aux_weight * aux["moe_lb_loss"]
            metrics.update(aux)
        metrics["loss"] = total
        return total, metrics
    return loss_fn


def init_train_state(cfg: ArchConfig, generator: torch.Generator,
                     optimizer: Optional[Optimizer] = None, *,
                     device=None) -> Dict:
    optimizer = optimizer or make_optimizer(cfg)
    params = init_params(cfg, generator, device=device)
    return {"params": params, "opt": optimizer.init(params)}


def train_state_specs(cfg: ArchConfig,
                      optimizer: Optional[Optimizer] = None) -> Dict:
    """The train state's shapes and dtypes (``meta`` tensors; the
    optimizer's step count is a host int)."""
    optimizer = optimizer or make_optimizer(cfg)
    p = param_specs(cfg)
    return {"params": p, "opt": optimizer.init(p)}


def make_train_step(cfg: ArchConfig,
                    optimizer: Optional[Optimizer] = None):
    """(state, batch) -> (new state, metrics): the loss's gradient with
    respect to the float32 master leaves (``torch.autograd.grad``; a leaf
    the loss does not reach gets zeros, as under ``jax.grad``), then the
    optimizer's functional update.  Metrics are detached 0-d tensors, so
    the step does not wait for the device."""
    optimizer = optimizer or make_optimizer(cfg)
    loss_fn = make_loss_fn(cfg)

    def train_step(state: Dict, batch: Dict[str, torch.Tensor]):
        params = state["params"]
        with torch.enable_grad():
            leaves = [p.detach().requires_grad_(True)
                      for p in tree_leaves(params)]
            loss, metrics = loss_fn(tree_unflatten(params, leaves), batch)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                        materialize_grads=True)
        new_params, new_opt = optimizer.update(
            tree_unflatten(params, list(grads)), state["opt"], params)
        return ({"params": new_params, "opt": new_opt},
                {k: v.detach() for k, v in metrics.items()})

    return train_step


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
