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

Only the dense path is ported.  The JAX package takes its
expert-parallel path (``_moe_local_shard``/``_moe_apply_ep``,
``shard_map`` with all-to-alls) only under an active device mesh with an
``expert`` axis; off a mesh it takes the dense path, and so does the
port, which has no mesh yet (the distributed wing).

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
    loss).  The dense path (see the module docstring)."""
    return _moe_apply_dense(params, x, moe, act)


def _moe_apply_dense(params: dict, x: torch.Tensor, moe: MoEConfig,
                     act: str
                     ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    B, S, d = x.shape
    E, k = moe.num_experts, moe.top_k
    C = moe_capacity(moe, S)
    dev = x.device

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
