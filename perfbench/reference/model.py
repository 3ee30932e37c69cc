"""Plain reference of the cells' decoder: one pass of plain PyTorch
operations, written from the configuration's equations and nothing of
the program.

A block is pre-norm attention then a pre-norm MLP or mixture of experts,
each added to the residual:

  x <- x + Wo . attn(rope(norm_q(x' Wq)), rope(norm_k(x' Wk)), x' Wv),
      x' = rms(x) * ln1
  x <- x + ffn(rms(x) * ln2)

with RMS norms in float32, rotate-half RoPE in float32, causal
grouped-query attention with float32 scores scaled by D^-1/2 after the
product, and a float32 softmax whose weights are rounded to bf16 before
they weight V.  The MLP is squared ReLU (``relu2``) or SwiGLU (``silu``).
The mixture routes each token by a softmax over bf16 router logits to
its top ``k`` experts (ties to the lower expert), renormalises the k
gates, and keeps at most ``C = max(4, ceil(k S cf / E))`` slots an
expert in each batch row, the first in token-major (token, choice)
order; a dropped slot adds nothing.  Matrix products take bf16 operands
(the configuration's compute precision), the parameters being float32
masters or bf16 weights.

``Numerics(fp8=True)`` is the control: every matrix product's operands
rounded to float8 e4m3 under a per-tensor scale, the precision below
bf16.

The reference runs in blocks so that it fits beside what is left on the
card: attention one (batch row, KV head) at a time under checkpoint, the
loss one batch row at a time under checkpoint.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional

import torch
from torch.utils.checkpoint import checkpoint

BF16 = torch.bfloat16
E4M3_MAX = 448.0
LOGIT_ROWS = 4          # sequences a serving reference pass holds at once


@dataclass(frozen=True)
class Numerics:
    fp8: bool = False          # the control: operands rounded to e4m3

    def round(self, t: torch.Tensor) -> torch.Tensor:
        """An operand in the products' precision: bf16, or the e4m3
        values of t under one per-tensor scale (held in bf16).  Without
        autograd the rounding runs a block of rows at a time, so that a
        full-width head needs no float32 copy."""
        t = t.to(BF16)
        if not self.fp8:
            return t
        scale = (t.detach().abs().amax().float() / E4M3_MAX).clamp_min(1e-30)
        e4m3 = lambda x: ((x.float() / scale).to(torch.float8_e4m3fn)
                          .float() * scale)
        if not t.requires_grad:
            out = torch.empty_like(t)
            flat, dst = t.reshape(-1, t.shape[-1]), out.view(-1, t.shape[-1])
            for i in range(0, flat.shape[0], 4096):
                dst[i:i + 4096] = e4m3(flat[i:i + 4096])
            return out
        # straight-through: the rounding's gradient is the identity
        return (t.float() + (e4m3(t) - t.float()).detach()).to(BF16)

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self.round(a) @ self.round(b)


def rms(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    x32 = x.float()
    y = x32 * torch.rsqrt(x32.square().mean(-1, keepdim=True) + eps)
    return (y * w.float()).to(x.dtype)


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x (B, S, H, D), pos (S,): rotate-half, angles pos * theta^(-i/(D/2))."""
    half = x.shape[-1] // 2
    inv = torch.pow(theta, -torch.arange(half, dtype=torch.float32,
                                         device=x.device) / half)
    ang = pos.float()[:, None] * inv                  # (S, D/2)
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    a, b = x.float()[..., :half], x.float()[..., half:]
    return torch.cat([a * cos - b * sin, a * sin + b * cos], -1).to(x.dtype)


def _attend(q, k, v, mask):
    """q (S, G, D), k, v (Skv, D) bf16, mask (S, Skv) True where hidden:
    the G heads' outputs (S, G, D) in bf16."""
    s = torch.einsum("qgd,kd->gqk", q.float(), k.float()) * q.shape[-1] ** -0.5
    s = s.masked_fill(mask, float("-inf"))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("gqk,kd->qgd", p.to(BF16).float(), v.float()).to(BF16)


def attention(q, k, v, grad: bool) -> torch.Tensor:
    """Causal GQA, one (batch row, KV head) block at a time.  q (B, S,
    Hq, D), k, v (B, S, Hkv, D), the last S positions of a sequence
    starting at 0."""
    B, S, Hq, D = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    pos = torch.arange(S, device=q.device)
    mask = pos[None, :] > pos[:, None]
    rows = []
    for b in range(B):
        heads = []
        for h in range(Hkv):
            args = (q[b, :, h * G:(h + 1) * G], k[b, :, h], v[b, :, h], mask)
            heads.append(checkpoint(_attend, *args, use_reentrant=False)
                         if grad else _attend(*args))
        rows.append(torch.cat(heads, dim=1))
    return torch.stack(rows)


def mlp(x, p: Dict, act: str, nm: Numerics) -> torch.Tensor:
    if act == "silu":
        g = nm.mm(x, p["w_gate"])
        h = (torch.nn.functional.silu(g.float()).to(BF16)
             * nm.mm(x, p["w_up"]))
    else:
        u = nm.mm(x, p["w_up"])
        h = torch.relu(u).square()
    return nm.mm(h, p["w_down"])


def moe(x, p: Dict, cfg: dict, nm: Numerics):
    """The mixture over x (B, S, d): (output (B, S, d) bf16, the Switch
    balance loss E sum_e f_e P_e)."""
    B, S, d = x.shape
    E, k = cfg["num_experts"], cfg["num_experts_per_tok"]
    cf = cfg["port"]["capacity_factor"]
    C = max(4, math.ceil(k * S * cf / E))
    logits = nm.mm(x, p["router"]).float()
    probs = torch.softmax(logits, dim=-1)                      # (B, S, E)
    order = torch.sort(probs.detach(), dim=-1, descending=True,
                       stable=True).indices[..., :k]           # (B, S, k)
    gate = probs.gather(-1, order)
    gate = gate / gate.sum(-1, keepdim=True)
    choice = order.reshape(B, S * k)                           # token-major
    onehot = torch.nn.functional.one_hot(choice, E).to(torch.int32)
    rank = (onehot.cumsum(1) * onehot).sum(-1) - 1             # (B, S k)
    kept = rank < C
    y = torch.zeros((B, S, d), dtype=torch.float32, device=x.device)
    g_flat = gate.reshape(B, S * k)
    for e in range(E):
        b_i, s_i = torch.nonzero((choice == e) & kept, as_tuple=True)
        if b_i.numel() == 0:
            continue
        tok = s_i // k
        pe = {n: p[n][e] for n in ("w_up", "w_down", "w_gate") if n in p}
        out = mlp(x[b_i, tok], pe, cfg["hidden_act"], nm)
        w = g_flat[b_i, s_i].to(BF16)
        y = y.index_put((b_i, tok), (out * w[:, None]).float(),
                        accumulate=True)
    frac = torch.bincount(choice.reshape(-1), minlength=E).float() / (B * S * k)
    balance = E * (frac * probs.mean(dim=(0, 1))).sum()
    return y.to(BF16), balance


def block(x, lp: Dict, cfg: dict, nm: Numerics, pos, grad: bool):
    eps, port = cfg["port"]["norm_eps"], cfg["port"]
    hq, hkv, dh = (cfg["num_attention_heads"], cfg["num_key_value_heads"],
                   cfg["head_dim"])
    B, S, _ = x.shape
    a = lp["attn"]
    h = rms(x, lp["ln1"], eps)
    q = nm.mm(h, a["wq"]).reshape(B, S, hq, dh)
    k = nm.mm(h, a["wk"]).reshape(B, S, hkv, dh)
    v = nm.mm(h, a["wv"]).reshape(B, S, hkv, dh)
    if port["qk_norm"]:
        q, k = rms(q, a["q_norm"], eps), rms(k, a["k_norm"], eps)
    theta = float(cfg["rope_theta"])
    q, k = rope(q, pos, theta), rope(k, pos, theta)
    if nm.fp8:
        q, k, v = nm.round(q), nm.round(k), nm.round(v)
    o = attention(q, k, v, grad).reshape(B, S, hq * dh)
    x = x + nm.mm(o, a["wo"])
    h = rms(x, lp["ln2"], eps)
    if cfg.get("num_experts"):
        f, balance = moe(h, lp["moe"], cfg, nm)
    else:
        f, balance = mlp(h, lp["mlp"], cfg["hidden_act"], nm), None
    return x + f, balance


def layer(tree: Dict, i: int) -> Dict:
    return {k: layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def hidden(params: Dict, toks: torch.Tensor, cfg: dict, nm: Numerics,
           grad: bool):
    """Final-normed hidden states (B, S, d) bf16 and the mean balance
    loss over the layers (None without experts)."""
    x = params["embed"][toks.long()].to(BF16)
    pos = torch.arange(toks.shape[1], device=toks.device)
    L = cfg["num_hidden_layers"]
    bal = []
    for i in range(L):
        x, b = block(x, layer(params["layers"], i), cfg, nm, pos, grad)
        if b is not None:
            bal.append(b)
    h = rms(x, params["final_norm"], cfg["port"]["norm_eps"])
    return h, (torch.stack(bal).mean() if bal else None)


def _row_xent(h, w, labels, nm: Numerics):
    logits = nm.mm(h, w).float()
    return (torch.logsumexp(logits, -1)
            - logits.gather(-1, labels.long()[:, None])[:, 0]).sum()


def loss(params: Dict, toks: torch.Tensor, cfg: dict,
         nm: Numerics = Numerics(), rows: Optional[int] = None):
    """Mean next-token cross-entropy over the batch's first ``rows`` rows
    (all by default), plus the router's balance term weighted by
    ``router_aux_loss_coef``."""
    toks = toks if rows is None else toks[:rows]
    h, balance = hidden(params, toks, cfg, nm, grad=True)
    w = params["lm_head"]
    tot = sum(checkpoint(_row_xent, h[b, :-1], w, toks[b, 1:], nm,
                         use_reentrant=False) for b in range(toks.shape[0]))
    out = tot / (toks.shape[0] * (toks.shape[1] - 1))
    if balance is not None:
        out = out + cfg["router_aux_loss_coef"] * balance
    return out


@torch.no_grad()
def logits_at(params: Dict, toks: torch.Tensor, cfg: dict, last: int,
              nm: Numerics = Numerics()) -> torch.Tensor:
    """float32 logits (B, last, V) at each sequence's last ``last``
    positions, ``LOGIT_ROWS`` sequences at a time."""
    out = []
    for rows in toks.split(LOGIT_ROWS):
        h, _ = hidden(params, rows, cfg, nm, grad=False)
        out.append(nm.mm(h[:, -last:], params["lm_head"]).float())
        del h
    return torch.cat(out)
