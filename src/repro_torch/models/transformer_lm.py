"""LM backbones of every family (counterpart of
``repro.models.transformer_lm``).

One parameter tree + entry points per config:
  * ``forward_hidden``  — full-sequence forward (prefill), optionally
    collecting the decode-state ingredients (K/V stacks, mamba states);
  * ``decode_forward``  — single-token step against a decode state;
  * ``init_lm`` / ``init_decode_state``.

Families:
  dense/moe/vlm/audio — (attn + mlp|moe) blocks; attention is the
    hand-written ``flash_attention`` kernel on the card
    (``layers.blocked_attention``); the moe layer is ``moe.moe_apply``.
  ssm (falcon-mamba) — pure mamba1 blocks; the scan is the hand-written
    ``selective_scan`` kernel on the card.
  hybrid (zamba2) — "superlayers" of ``attn_every - 1`` Mamba-2 blocks
    followed by ONE weight-tied shared attention+MLP block; the shared
    block's KV cache is per application (``n_super`` entries), its
    weights a single set.  Mamba-2's SSD is plain PyTorch (the JAX
    package has no kernel for it); the shared attention is
    ``flash_attention``, one launch a superlayer.

Training: unless ``cfg.remat`` is ``"none"``, each block of
``forward_hidden`` (each superlayer of the hybrid family) runs under
``torch.utils.checkpoint`` (non-reentrant) when autograd records it,
the counterpart of the JAX package's ``jax.checkpoint`` of the scanned
block: only the blocks' inputs stay alive, and each block's forward
(its kernel launch included) runs again in the backward.  Serving (no
grad) calls the blocks directly.

Per-layer leaves are stacked on a leading ``L`` axis, the layout
``jax.vmap`` of the JAX init gives, so a JAX tree maps across one to one
(``repro_torch.models.convert.params_from_jax``); ``lax.scan`` over the
layers is a Python loop over ``leaf[i]`` slices.  The JAX package's
sharding constraints are the identity on the port's logical mesh and
are left out.  Under an active mesh (``dist.sharding.sharding_ctx``)
whose ``seq_act`` axis divides the sequence, ``attn_full`` takes the
context-parallel branch as the JAX package does
(:func:`_cp_attention_shard_map`: each shard's queries against the
all-gathered K/V, directly or, past the per-shard score budget,
through ``flash_attention`` with the shard's ``q_offset``), and the moe
layer its expert-parallel path (``moe.moe_apply``).

Two departures from JAX's functional style, both to save device memory:
``decode_forward`` writes the new token's K/V into the caches of the
state it is given, in place (the returned state holds the same cache
tensors), and the embedding lookup indexes ``params["embed"]`` directly,
which raises on an out-of-range id where ``jnp.take`` clips it.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve
from repro_torch.dist.sharding import (P, active_mesh, all_gather,
                                       axis_for, axis_index, axis_size_of,
                                       carry_ctx, shard_map)
from repro_torch.models import mamba as M
from repro_torch.models.layers import (apply_rope, blocked_attention,
                                       decode_attention, dense_init,
                                       direct_attention, embed_init,
                                       mlp_apply, mlp_param_shapes,
                                       rms_norm)
from repro_torch.models.moe import moe_apply, moe_init
from repro_torch.obs import trace

PyTree = Any
FAMILIES = ("dense", "moe", "vlm", "audio", "ssm", "hybrid")


def check_family(cfg: ArchConfig) -> None:
    """Raise ``ValueError`` for a family no backbone here builds."""
    if cfg.family not in FAMILIES:
        raise ValueError(cfg.family)


def attention_layers(cfg: ArchConfig) -> int:
    """Full-sequence attention calls of one forward: a block's each
    layer, the hybrid's shared block once a superlayer, none in ssm."""
    if cfg.family == "ssm":
        return 0
    if cfg.family == "hybrid":
        return cfg.n_layers // cfg.attn_every
    return cfg.n_layers


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def _dense(gen, lead: tuple, shape, dtype, scale: Optional[float] = None):
    """Dense weights (fan_in = shape[0]) stacked on ``lead`` axes."""
    s = scale if scale is not None else shape[0] ** -0.5
    return dense_init(gen, lead + tuple(shape), dtype=dtype, scale=s)


def _ones(gen, shape, dtype):
    return torch.ones(shape, dtype=dtype, device=gen.device)


def _init_attn(gen, cfg: ArchConfig, dtype, lead: tuple) -> dict:
    d, Hq, Hkv, Dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    p = {
        "wq": _dense(gen, lead, (d, Hq * Dh), dtype),
        "wk": _dense(gen, lead, (d, Hkv * Dh), dtype),
        "wv": _dense(gen, lead, (d, Hkv * Dh), dtype),
        "wo": _dense(gen, lead, (Hq * Dh, d), dtype,
                     scale=(Hq * Dh) ** -0.5 / math.sqrt(2 * cfg.n_layers)),
    }
    if cfg.qk_norm:
        p["q_norm"] = _ones(gen, lead + (Dh,), dtype)
        p["k_norm"] = _ones(gen, lead + (Dh,), dtype)
    return p


def _init_mlp(gen, cfg: ArchConfig, dtype, lead: tuple) -> dict:
    shapes = mlp_param_shapes(cfg.d_model, cfg.d_ff, cfg.act)
    return {n: _dense(gen, lead, s, dtype) for n, s in sorted(shapes.items())}


def _init_block(gen, cfg: ArchConfig, dtype, lead: tuple,
                keep=None) -> dict:
    p = {
        "ln1": _ones(gen, lead + (cfg.d_model,), dtype),
        "ln2": _ones(gen, lead + (cfg.d_model,), dtype),
        "attn": _init_attn(gen, cfg, dtype, lead),
    }
    if cfg.moe is not None:
        p["moe"] = moe_init(gen, cfg.moe, cfg.d_model, cfg.act, dtype,
                            lead=lead, keep=keep)
    else:
        p["mlp"] = _init_mlp(gen, cfg, dtype, lead)
    return p


def _init_mamba_layer(gen, cfg: ArchConfig, dtype, lead: tuple) -> dict:
    version = cfg.ssm.version
    if version == 1:
        block = M.mamba1_init(gen, cfg.ssm, cfg.d_model, dtype,
                              layers=lead[0])
    else:
        block = M.mamba2_init(gen, cfg.ssm, cfg.d_model, dtype, lead=lead)
    return {"ln": _ones(gen, lead + (cfg.d_model,), dtype),
            f"mamba{version}": block}


def init_lm(cfg: ArchConfig, generator: torch.Generator,
            dtype=torch.float32, *, keep=None) -> dict:
    """The parameter tree, drawn on the generator's device (``keep``:
    ``lm_zoo.init_params``'s)."""
    check_family(cfg)
    gen, L, d = generator, cfg.n_layers, cfg.d_model
    params: Dict[str, Any] = {}
    if cfg.input_kind == "tokens":
        params["embed"] = embed_init(gen, (cfg.vocab, d), dtype=dtype)
    else:  # frames: frontend stub; learned input proj + mask embedding
        params["in_proj"] = dense_init(gen, (d, d), dtype=dtype)
        params["mask_emb"] = embed_init(gen, (d,), dtype=dtype)
    if cfg.family == "ssm":
        params["layers"] = _init_mamba_layer(gen, cfg, dtype, (L,))
    elif cfg.family == "hybrid":
        n_super = cfg.n_layers // cfg.attn_every
        params["superlayers"] = _init_mamba_layer(
            gen, cfg, dtype, (n_super, cfg.attn_every - 1))
        params["shared"] = _init_block(gen, cfg, dtype, ())
    else:
        params["layers"] = _init_block(gen, cfg, dtype, (L,), keep)
    params["final_norm"] = _ones(gen, (d,), dtype)
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(gen, (d, cfg.vocab), dtype=dtype,
                                       scale=d ** -0.5)
    return params


def layer(tree: dict, i: int) -> dict:
    """Layer ``i``'s slice of a tree of stacked leaves (views)."""
    return {k: layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


# ---------------------------------------------------------------------------
# Attention (full-sequence and decode-step)
# ---------------------------------------------------------------------------


def _qkv(p: dict, x: torch.Tensor, cfg: ArchConfig,
         positions: torch.Tensor):
    B, S, _ = x.shape
    Hq, Hkv, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    q = (x @ p["wq"]).reshape(B, S, Hq, Dh)
    k = (x @ p["wk"]).reshape(B, S, Hkv, Dh)
    v = (x @ p["wv"]).reshape(B, S, Hkv, Dh)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


_CP_SCORE_BYTES_LIMIT = 5e9  # per-shard f32 score block budget


def _cp_attention_shard_map(q, k, v, *, causal: bool,
                            blocked: bool = False) -> torch.Tensor:
    """Context-parallel attention as an explicit shard_map.

    q/k/v arrive seq-sharded over the 'seq_act' axis.  Each shard
    all-gathers K/V and computes its query shard's attention against
    them, its rows at positions ``axis_index * S_loc`` on: with
    ``direct_attention``, or with ``blocked_attention`` (the
    ``flash_attention`` kernel on the card, at the shard's ``q_offset``)
    when ``blocked``.  Under autograd the all-gather's transpose sums
    each shard's dK/dV back onto its own rows.
    """
    mesh = active_mesh()
    dp_ax = axis_for("batch")
    sp_ax = axis_for("seq_act")
    sp_name = sp_ax if isinstance(sp_ax, str) else sp_ax[0]

    def body(q_l, k_l, v_l):
        # (B_loc, S_loc, H, D); gather the full K/V sequence
        k_f = yield all_gather(k_l, sp_name, axis=1, tiled=True)
        v_f = yield all_gather(v_l, sp_name, axis=1, tiled=True)
        offset = axis_index(sp_name) * q_l.shape[1]
        attend = blocked_attention if blocked else direct_attention
        return attend(q_l, k_f, v_f, causal=causal, q_offset=offset)

    spec = P(dp_ax, sp_ax, None, None)
    return shard_map(body, mesh=mesh, in_specs=(spec, spec, spec),
                     out_specs=spec)(q, k, v)


def attn_full(p: dict, x: torch.Tensor, cfg: ArchConfig,
              positions: torch.Tensor):
    """x: (B, S, d) (already normed). Returns (out, (k, v)).

    Path selection, as in the JAX package: when the sequence axis is
    sharded ('seq_act' rule, context parallelism) and divides S, the
    shard_map branch, single-shot ``direct_attention`` if the per-shard
    float32 score block fits :data:`_CP_SCORE_BYTES_LIMIT`, else the
    blocked kernel inside the shard; otherwise ``blocked_attention``
    over the whole sequence.
    """
    B, S, _ = x.shape
    q, k, v = _qkv(p, x, cfg, positions)
    with trace.span("attention.core"):
        br = trace.bracket("attention.core")
        q, k, v = br.input(q), br.input(k), br.input(v)
        if (axis_for("seq_act") is not None
                and S % axis_size_of("seq_act") == 0):
            dp, sp = axis_size_of("batch"), axis_size_of("seq_act")
            score_bytes = (B / dp) * cfg.n_heads * (S / sp) * S * 4.0
            o = _cp_attention_shard_map(
                q, k, v, causal=cfg.causal,
                blocked=score_bytes > _CP_SCORE_BYTES_LIMIT)
        else:
            o = blocked_attention(q, k, v, causal=cfg.causal)
        o = br.output(o)
    out = o.reshape(B, S, -1) @ p["wo"]
    return out, (k, v)


def attn_decode(p: dict, x_t: torch.Tensor, k_cache: torch.Tensor,
                v_cache: torch.Tensor, pos: torch.Tensor, cfg: ArchConfig):
    """x_t: (B, 1, d) normed; caches (B, S, Hkv, Dh); pos: (B,).

    The new K/V go to the shared write index pos[0], clamped to S - 1 as
    ``lax.dynamic_update_slice_in_dim`` clamps it, written into the caches
    in place; per-row positions still mask attention.
    """
    B = x_t.shape[0]
    q, k_new, v_new = _qkv(p, x_t, cfg, pos[:, None])
    idx = pos[:1].clamp(0, k_cache.shape[1] - 1).long()
    k_cache.index_copy_(1, idx, k_new.to(k_cache.dtype))
    v_cache.index_copy_(1, idx, v_new.to(v_cache.dtype))
    with trace.span("attention.core"):
        o = decode_attention(q, k_cache, v_cache, valid_len=pos + 1)
    out = o.reshape(B, 1, -1) @ p["wo"]
    return out, k_cache, v_cache


# ---------------------------------------------------------------------------
# Full-sequence forward (prefill)
# ---------------------------------------------------------------------------


def _block_apply(cfg: ArchConfig, p: dict, x: torch.Tensor,
                 positions: torch.Tensor):
    h, kv = attn_full(p["attn"], rms_norm(x, p["ln1"], cfg.norm_eps), cfg,
                      positions)
    x = x + h
    hn = rms_norm(x, p["ln2"], cfg.norm_eps)
    if cfg.moe is not None:
        ff, aux = moe_apply(p["moe"], hn, cfg.moe, cfg.act)
    else:
        ff, aux = mlp_apply(hn, p["mlp"], cfg.act), {}
    return x + ff, aux, kv


def _ssm_block(cfg: ArchConfig, lp: dict, x: torch.Tensor,
               collect_state: bool):
    out = M.mamba1_forward(lp["mamba1"], rms_norm(x, lp["ln"], cfg.norm_eps),
                           cfg.ssm, return_state=collect_state)
    y, st = out if collect_state else (out, None)
    return x + y, st


def _super_block(cfg: ArchConfig, slp: dict, shared: dict, x: torch.Tensor,
                 positions: torch.Tensor, collect_state: bool):
    """One hybrid superlayer: its Mamba-2 blocks, then the shared
    attention and MLP.  Returns (x, stacked mamba states|None, (k, v))."""
    sts = []
    for j in range(cfg.attn_every - 1):
        lp = layer(slp, j)
        out = M.mamba2_forward(lp["mamba2"],
                               rms_norm(x, lp["ln"], cfg.norm_eps), cfg.ssm,
                               return_state=collect_state)
        y, st = out if collect_state else (out, None)
        x = x + y
        sts.append(st)
    h, kv = attn_full(shared["attn"], rms_norm(x, shared["ln1"], cfg.norm_eps),
                      cfg, positions)
    x = x + h
    x = x + mlp_apply(rms_norm(x, shared["ln2"], cfg.norm_eps), shared["mlp"],
                      cfg.act)
    st = ({key: torch.stack([s[key] for s in sts]) for key in ("conv", "h")}
          if collect_state else None)
    return x, st, kv


def _spanned(block):
    """``block`` under the span ``block``.  Given to :func:`_remat`, the
    span lies inside the checkpoint, so the recompute runs under it too;
    the caller brackets the block's backward (``obs.trace.bracket``)."""
    def run(*args):
        with trace.span("block"):
            return block(*args)
    return run


def _remat(cfg: ArchConfig, block):
    """``block`` under non-reentrant ``torch.utils.checkpoint`` when the
    config asks for block remat and autograd records the call; else
    ``block`` itself.  The blocks draw no random numbers, so no RNG state
    is kept for the recompute.  The recompute re-enters the sharding
    context of the forward (``carry_ctx``): on the card it runs on
    autograd's device thread, and a mesh block must take the same
    context-parallel and expert-parallel paths again."""
    if cfg.remat == "none" or not torch.is_grad_enabled():
        return block
    block = carry_ctx(block)
    return lambda *args: checkpoint(block, *args, use_reentrant=False,
                                    preserve_rng_state=False)


def forward_hidden(cfg: ArchConfig, params: dict, x: torch.Tensor,
                   positions: torch.Tensor, collect_state: bool = False
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], PyTree]:
    """x: (B, S, d) embedded input. Returns (hidden, aux, state|None).

    state (when collect_state): family-dependent prefill decode-state
    ingredients — attention KV stacks (L, B, S, Hkv, Dh) or mamba states.
    """
    check_family(cfg)
    L = cfg.n_layers
    stack = lambda sts: {key: torch.stack([st[key] for st in sts])
                         for key in ("conv", "h")}
    if cfg.family == "ssm":
        block = _remat(cfg, _spanned(_ssm_block))
        states = []
        for i in range(L):
            br = trace.bracket("block")
            x, st = block(cfg, layer(params["layers"], i), br.input(x),
                          collect_state)
            x = br.output(x)
            states.append(st)
        return x, {}, ({"mamba": stack(states)} if collect_state else None)

    ks, vs = [], []
    if cfg.family == "hybrid":
        block = _remat(cfg, _spanned(_super_block))
        states = []
        for i in range(L // cfg.attn_every):
            br = trace.bracket("block")
            x, st, (k, v) = block(cfg, layer(params["superlayers"], i),
                                  params["shared"], br.input(x), positions,
                                  collect_state)
            x = br.output(x)
            if collect_state:
                states.append(st)
                ks.append(k)
                vs.append(v)
        state = ({"mamba": stack(states), "k": torch.stack(ks),
                  "v": torch.stack(vs)} if collect_state else None)
        return x, {}, state

    block = _remat(cfg, _spanned(_block_apply))
    lb = dr = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(L):
        br = trace.bracket("block")
        x, aux, (k, v) = block(cfg, layer(params["layers"], i), br.input(x),
                               positions)
        x = br.output(x)
        if aux:
            lb = lb + aux["moe_lb_loss"]
            dr = dr + aux["moe_drop_frac"]
        if collect_state:
            ks.append(k)
            vs.append(v)
    aux = {"moe_lb_loss": lb / L, "moe_drop_frac": dr / L}
    state = ({"k": torch.stack(ks), "v": torch.stack(vs)}
             if collect_state else None)
    return x, aux, state


def embed_input(cfg: ArchConfig, params: dict,
                batch: Dict[str, torch.Tensor],
                dtype=torch.bfloat16) -> torch.Tensor:
    if cfg.input_kind == "tokens":
        x = params["embed"][batch["tokens"].long()]
    else:
        frames = batch["frames"].to(dtype)
        w = params["in_proj"]
        ct = torch.promote_types(frames.dtype, w.dtype)
        x = frames.to(ct) @ w.to(ct)
        if "mask" in batch:  # masked-prediction training (HuBERT)
            x = torch.where(batch["mask"][..., None], params["mask_emb"], x)
    return x.to(dtype)


def unembed_weight(cfg: ArchConfig, params: dict) -> torch.Tensor:
    if cfg.tie_embeddings or "lm_head" not in params:
        return params["embed"].T
    return params["lm_head"]


# ---------------------------------------------------------------------------
# Decode state + single-token forward
# ---------------------------------------------------------------------------


def init_decode_state(cfg: ArchConfig, batch: int, max_seq: int,
                      dtype=torch.bfloat16, *, device=None) -> dict:
    """Zero decode state on ``device`` (default: the card)."""
    check_family(cfg)
    device = resolve(device)
    L, Hkv, Dh = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim_
    state: Dict[str, Any] = {
        "pos": torch.zeros((batch,), dtype=torch.int32, device=device)}
    if cfg.family in ("ssm", "hybrid"):
        lead = ((L,) if cfg.family == "ssm"
                else (L // cfg.attn_every, cfg.attn_every - 1))
        init = (M.mamba1_init_state if cfg.ssm.version == 1
                else M.mamba2_init_state)
        one = init(cfg.ssm, cfg.d_model, batch, dtype, device=device)
        state["mamba"] = {k: v.expand(lead + v.shape).clone()
                          for k, v in one.items()}
    if cfg.family != "ssm":
        shape = (attention_layers(cfg), batch, max_seq, Hkv, Dh)
        state["k"] = torch.zeros(shape, dtype=dtype, device=device)
        state["v"] = torch.zeros(shape, dtype=dtype, device=device)
    return state


def decode_forward(cfg: ArchConfig, params: dict, x: torch.Tensor,
                   state: dict) -> Tuple[torch.Tensor, dict]:
    """x: (B, 1, d) embedded token. Returns (hidden (B, 1, d), new state);
    the K/V caches are updated in place (see the module docstring)."""
    check_family(cfg)
    pos = state["pos"]
    new_state = dict(state)
    if cfg.family == "ssm":
        convs, hs = [], []
        for i in range(cfg.n_layers):
            with trace.span("block"):
                lp = layer(params["layers"], i)
                st = {k: v[i] for k, v in state["mamba"].items()}
                y, st = M.mamba1_decode_step(
                    lp["mamba1"], rms_norm(x[:, 0], lp["ln"], cfg.norm_eps),
                    st, cfg.ssm)
                x = x + y[:, None]
            convs.append(st["conv"])
            hs.append(st["h"])
        new_state["mamba"] = {"conv": torch.stack(convs),
                              "h": torch.stack(hs)}
    elif cfg.family == "hybrid":
        shared = params["shared"]
        convs, hs = [], []
        for i in range(cfg.n_layers // cfg.attn_every):
            with trace.span("block"):
                slp = layer(params["superlayers"], i)
                for j in range(cfg.attn_every - 1):
                    lp = layer(slp, j)
                    st = {k: v[i, j] for k, v in state["mamba"].items()}
                    y, st = M.mamba2_decode_step(
                        lp["mamba2"],
                        rms_norm(x[:, 0], lp["ln"], cfg.norm_eps), st,
                        cfg.ssm)
                    x = x + y[:, None]
                    convs.append(st["conv"])
                    hs.append(st["h"])
                x = _decode_block(cfg, shared, x, state["k"][i],
                                  state["v"][i], pos)
        lead = state["mamba"]["h"].shape[:2]
        new_state["mamba"] = {
            "conv": torch.stack(convs).reshape(
                lead + state["mamba"]["conv"].shape[2:]),
            "h": torch.stack(hs).reshape(lead + state["mamba"]["h"].shape[2:])}
    else:
        for i in range(cfg.n_layers):
            with trace.span("block"):
                x = _decode_block(cfg, layer(params["layers"], i), x,
                                  state["k"][i], state["v"][i], pos)
    new_state["pos"] = pos + 1
    return x, new_state


def _decode_block(cfg: ArchConfig, p: dict, x: torch.Tensor,
                  k_cache: torch.Tensor, v_cache: torch.Tensor,
                  pos: torch.Tensor) -> torch.Tensor:
    """One attention + mlp|moe block of a decode step; the caches are
    written in place."""
    h, _, _ = attn_decode(p["attn"], rms_norm(x, p["ln1"], cfg.norm_eps),
                          k_cache, v_cache, pos, cfg)
    x = x + h
    hn = rms_norm(x, p["ln2"], cfg.norm_eps)
    if cfg.moe is not None:
        return x + moe_apply(p["moe"], hn, cfg.moe, cfg.act)[0]
    return x + mlp_apply(hn, p["mlp"], cfg.act)
