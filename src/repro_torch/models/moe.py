"""Mixture-of-Experts layer with sort/scatter token dispatch (counterpart
of ``repro.models.moe``).

Dispatch is computed per batch row, as in the JAX package: top-k over
the router's softmax, a stable sort of the (token, choice) slots by
expert, each slot's position in its expert's segment, and capacity
``C = max(4, ceil(k * S * cf / E))`` slots an expert a row; slots past
it are dropped (their residual passes through) and land on a dummy row
of the ``(B, E * C + 1, d)`` buffer, which the expert product never
reads.  The expert FFN is one batched product over experts
(``torch.einsum``, cuBLAS on the card), as the JAX package computes it
outside any Pallas kernel; the weighted combine back to token order is
an ``index_add_``, which on the card adds in no fixed order.

Two paths, chosen as the JAX package chooses them (:func:`moe_apply`):
under an active mesh (``dist.sharding.sharding_ctx``) whose ``expert``
axis is mapped, with the sequence split over ``seq_act`` into more than
one shard that divides it and E divisible by the expert shards, the
expert-parallel path (:func:`_moe_apply_ep`): each shard of
``(batch, seq_act)`` tokens routes locally with its own capacity
``C = max(4, ceil(k * T_loc * cf / E))`` over its ``T_loc`` tokens,
one all-to-all sends each expert's slots to the shard that holds its
``(E / ep, ., .)`` slice of the expert weights, and one brings the
results back.  Its balance loss and drop fraction are each shard's,
averaged over the shards (``pmean``), not the dense path's global
statistic.  Otherwise (off a mesh, and for decode, whose one token
does not split) the dense path.  The port's shards run one after
another on one device (``dist.sharding.shard_map``).

Ties in top-k go to the lower expert index, as ``lax.top_k`` breaks
them: :func:`_top_k` takes the first k of a stable descending sort
(``torch.topk`` does not specify its order among ties).

Init departs from the JAX package in one scale: JAX's ``dense_init``
takes its fan-in from the first axis of the shape, which for the
stacked expert weights ``(E, d, f)`` is E; the port scales each
expert's matrix by its own fan-in (d, or f for ``w_down``), the scale of
the dense MLP (at llama4-scout's width E^-1/2 is 0.25, where d^-1/2
is 0.014 and f^-1/2 0.011: three factors of 18-23 in a SwiGLU expert's
output).  Parity tests load the JAX tree, so only the names, shapes and
dtypes of the port's own init must match it.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import MoEConfig
from repro_torch.dist.sharding import (P, active_mesh, all_to_all,
                                       axis_for, axis_size_of, constrain,
                                       pmean, shard_map)
from repro_torch.models.layers import dense_init, mlp_apply


def moe_capacity(moe: MoEConfig, seq_len: int) -> int:
    c = math.ceil(moe.top_k * seq_len * moe.capacity_factor
                  / moe.num_experts)
    return max(4, int(c))


def moe_init(generator: torch.Generator, moe: MoEConfig, d_model: int,
             act: str, dtype=torch.float32, *, lead: Tuple[int, ...] = ()
             ) -> dict:
    """Parameters of one MoE layer, or of ``lead`` stacked layers, drawn
    on the generator's device; the router is float32 whatever ``dtype``."""
    E, f = moe.num_experts, moe.expert_d_ff
    lead = tuple(lead)

    def dense(shape, dt=dtype, scale=None):
        s = scale if scale is not None else shape[-2] ** -0.5
        return dense_init(generator, lead + shape, dtype=dt, scale=s)

    p = {
        "router": dense((d_model, E), torch.float32, d_model ** -0.5),
        "w_up": dense((E, d_model, f)),
        "w_down": dense((E, f, d_model)),
    }
    if act == "swiglu":
        p["w_gate"] = dense((E, d_model, f))
    if moe.shared_expert_d_ff:
        sf = moe.shared_expert_d_ff
        shared = {"w_up": dense((d_model, sf)), "w_down": dense((sf, d_model))}
        if act == "swiglu":
            shared["w_gate"] = dense((d_model, sf))
        p["shared"] = shared
    return p


def _expert_ffn(p: dict, x: torch.Tensor, act: str) -> torch.Tensor:
    """x: (B, E, C, d) with per-expert weights (E, d, f)."""
    if act == "swiglu":
        g = torch.einsum("becd,edf->becf", x, p["w_gate"])
        u = torch.einsum("becd,edf->becf", x, p["w_up"])
        h = F.silu(g.float()).to(x.dtype) * u
    else:
        u = torch.einsum("becd,edf->becf", x, p["w_up"])
        if act == "sq_relu":
            h = torch.relu(u).square()
        else:
            h = F.gelu(u.float(), approximate="tanh").to(x.dtype)
    return torch.einsum("becf,efd->becd", h, p["w_down"])


def _top_k(probs: torch.Tensor, k: int
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the k largest along the last axis, ties to
    the lower index (``lax.top_k``'s order)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_apply(params: dict, x: torch.Tensor, moe: MoEConfig, act: str
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: (B, S, d) -> (out (B, S, d), aux metrics incl. the load-balance
    loss).  The expert-parallel path under a mesh that splits the
    sequence and the experts, else the dense path (the module
    docstring)."""
    mesh = active_mesh()
    ep_ax = axis_for("expert")
    sp = axis_size_of("seq_act")
    if (mesh is not None and ep_ax is not None and sp > 1
            and x.shape[1] % sp == 0
            and moe.num_experts % axis_size_of("expert") == 0):
        return _moe_apply_ep(params, x, moe, act)
    return _moe_apply_dense(params, x, moe, act)


def _moe_apply_dense(params: dict, x: torch.Tensor, moe: MoEConfig,
                     act: str
                     ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    B, S, d = x.shape
    E, k = moe.num_experts, moe.top_k
    C = moe_capacity(moe, S)
    dev = x.device

    # per-row dispatch needs the full row (the JAX package's hint; the
    # identity on the port's logical mesh)
    x = constrain(x, "batch", None, None)

    logits = (x @ params["router"].to(x.dtype)).float()
    probs = torch.softmax(logits, dim=-1)                    # (B, S, E)
    gate, expert_idx = _top_k(probs, k)                      # (B, S, k)
    gate = gate / gate.sum(-1, keepdim=True).clamp_min(1e-9)

    # ---- per-row dispatch bookkeeping ----
    Tk = S * k
    e_flat = expert_idx.reshape(B, Tk)
    g_flat = gate.reshape(B, Tk)
    tok_of_slot = torch.arange(S, device=dev).repeat_interleave(k)

    order = torch.sort(e_flat, dim=-1, stable=True).indices  # (B, Tk)
    e_sorted = e_flat.gather(-1, order)
    g_sorted = g_flat.gather(-1, order)
    tok_sorted = tok_of_slot[order]                          # (B, Tk)

    # position of each sorted slot within its expert segment
    experts = torch.arange(E, device=dev).expand(B, E).contiguous()
    seg_start = torch.searchsorted(e_sorted, experts, side="left")
    pos = (torch.arange(Tk, device=dev)[None, :]
           - seg_start.gather(-1, e_sorted))
    keep = pos < C
    slot = torch.where(keep, e_sorted * C + pos,
                       torch.full_like(pos, E * C))          # drop -> dummy

    # ---- scatter tokens into expert buffers (B, E*C+1, d) ----
    rows = torch.arange(B, device=dev)[:, None]
    buf = x.new_zeros((B, E * C + 1, d))
    buf[rows, slot] = x[rows, tok_sorted]
    out_buf = _expert_ffn(params, buf[:, :E * C].reshape(B, E, C, d), act)
    out_buf = torch.cat([out_buf.reshape(B, E * C, d),
                         x.new_zeros((B, 1, d))], dim=1)     # dummy row

    # ---- gather back to token order, weighted combine ----
    w = (g_sorted * keep).to(x.dtype)[..., None]
    y = x.new_zeros((B * S, d))
    y.index_add_(0, (rows * S + tok_sorted).reshape(-1),
                 (out_buf[rows, slot] * w).reshape(B * Tk, d))
    y = y.reshape(B, S, d)

    # ---- shared expert (always-on) ----
    if "shared" in params:
        y = y + mlp_apply(x, params["shared"], act)

    # ---- aux: load-balance loss (Switch) + stats; the counts over the
    # slot count as the JAX package's means of one-hots divide them ----
    n = B * Tk
    frac_tokens = torch.bincount(e_flat.reshape(-1), minlength=E).float() / n
    mean_prob = probs.mean(dim=(0, 1))
    lb_loss = E * (frac_tokens * mean_prob).sum()
    dropped = (~keep).sum().float() / n
    return y, {"moe_lb_loss": lb_loss, "moe_drop_frac": dropped}


# ---------------------------------------------------------------------------
# Expert-parallel path (shard_map + all-to-all)
# ---------------------------------------------------------------------------


def _moe_local_shard(params, x, moe: MoEConfig, act: str, ep_names,
                     all_names):
    """Body run per shard under ``shard_map`` (a generator: it yields its
    collectives).

    x: (B_loc, S_loc, d) local tokens; expert weights local (E_loc, ...).
    Dispatch is local (top-k, sort, scatter), then ONE tiled all-to-all
    moves each expert's slots to its owner and one moves the results
    back.  Returns (y, balance loss, drop fraction), the last two
    averaged over every shard.
    """
    Bl, Sl, d = x.shape
    E, k = moe.num_experts, moe.top_k
    T = Bl * Sl
    C = max(4, math.ceil(k * T * moe.capacity_factor / E))
    dev = x.device

    xt = x.reshape(T, d)
    logits = (xt @ params["router"].to(x.dtype)).float()
    probs = torch.softmax(logits, dim=-1)
    gate, expert_idx = _top_k(probs, k)                      # (T, k)
    gate = gate / gate.sum(-1, keepdim=True).clamp_min(1e-9)

    e_flat = expert_idx.reshape(T * k)
    g_flat = gate.reshape(T * k)
    tok_of_slot = torch.arange(T, device=dev).repeat_interleave(k)
    order = torch.sort(e_flat, stable=True).indices
    e_sorted, g_sorted = e_flat[order], g_flat[order]
    tok_sorted = tok_of_slot[order]
    seg_start = torch.searchsorted(e_sorted, torch.arange(E, device=dev),
                                   side="left")
    pos = torch.arange(T * k, device=dev) - seg_start[e_sorted]
    keep = pos < C
    slot = torch.where(keep, e_sorted * C + pos,
                       torch.full_like(pos, E * C))          # drop -> dummy

    buf = x.new_zeros((E * C + 1, d))
    buf[slot] = xt[tok_sorted]
    recv = buf[:E * C].reshape(E, C, d)

    # ---- all-to-all: each expert's slots to its owner ----
    # (E, C, d) -> (E_loc, ep * C, d): the owner receives every shard's
    for nm in ep_names:  # a single name in practice
        recv = yield all_to_all(recv, nm, split_axis=0, concat_axis=1,
                                tiled=True)

    # ---- local expert FFN on (E_loc, ep * C, d) ----
    if act == "swiglu":
        g_ = torch.einsum("ecd,edf->ecf", recv, params["w_gate"])
        u_ = torch.einsum("ecd,edf->ecf", recv, params["w_up"])
        h = F.silu(g_.float()).to(x.dtype) * u_
    else:
        u_ = torch.einsum("ecd,edf->ecf", recv, params["w_up"])
        h = (torch.relu(u_).square() if act == "sq_relu"
             else F.gelu(u_.float(), approximate="tanh").to(x.dtype))
    out = torch.einsum("ecf,efd->ecd", h, params["w_down"])

    # ---- return path ----
    for nm in ep_names:
        out = yield all_to_all(out, nm, split_axis=1, concat_axis=0,
                               tiled=True)
    out = torch.cat([out.reshape(E * C, d), x.new_zeros((1, d))])

    w = (g_sorted * keep).to(x.dtype)[:, None]
    y = x.new_zeros((T, d))
    y.index_add_(0, tok_sorted, out[slot] * w)
    y = y.reshape(Bl, Sl, d)

    if "shared" in params:
        y = y + mlp_apply(x, params["shared"], act)

    n = T * k
    frac_tokens = torch.bincount(e_flat, minlength=E).float() / n
    lb = E * (frac_tokens * probs.mean(0)).sum()
    dropped = (~keep).sum().float() / n
    lb = yield pmean(lb, all_names)
    dropped = yield pmean(dropped, all_names)
    return y, lb, dropped


def _moe_apply_ep(params: dict, x: torch.Tensor, moe: MoEConfig, act: str
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The expert-parallel path: :func:`_moe_local_shard` on each
    (batch, seq_act) shard of x, the expert weights split over the
    ``expert`` axis, everything else whole on every shard."""
    mesh = active_mesh()
    dp_ax = axis_for("batch")
    sp_ax = axis_for("seq_act")
    ep_ax = axis_for("expert")
    ep_names = (ep_ax,) if isinstance(ep_ax, str) else tuple(ep_ax)
    all_names = tuple(mesh.axis_names)

    x_spec = P(dp_ax, sp_ax, None)
    pspecs = {}
    for name, leaf in params.items():
        if name == "shared":
            pspecs[name] = {n: P(*([None] * l.dim())) for n, l in leaf.items()}
        elif name in ("w_gate", "w_up", "w_down") and leaf.dim() == 3:
            pspecs[name] = P(ep_ax, None, None)
        else:
            pspecs[name] = P(*([None] * leaf.dim()))

    fn = shard_map(
        lambda p, xx: _moe_local_shard(p, xx, moe, act, ep_names,
                                       all_names),
        mesh=mesh, in_specs=(pspecs, x_spec),
        out_specs=(x_spec, P(), P()))
    y, lb, dropped = fn(params, x)
    return y, {"moe_lb_loss": lb, "moe_drop_frac": dropped}
