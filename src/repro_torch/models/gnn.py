"""Temporal & static GNN models over sampled neighbourhoods (counterpart
of ``repro.models.gnn``; GNNFlow §2.1), with the TGN memory updater,
the link head, the loss and the AP metric.

All models consume mask-padded fixed-fanout neighbourhoods assembled by
``repro_torch.core.mfg.assemble``.  The attention core of TGN/TGAT is
the hand-written ``temporal_attn`` kernel pair on the card (forward,
and backward under autograd); the projections are plain
``torch.matmul``.  Parameters are nested dicts/lists of
tensors with the JAX package's tree layout, so
``repro_torch.models.convert.params_from_jax`` loads a JAX tree as is.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.tgn_gdelt import GNNConfig
from repro_torch.kernels.temporal_attn.ops import temporal_attn
from repro_torch.models.layers import (dense_init, time_encode,
                                       time_encode_params)

Params = Any


def _zeros(n: int, device) -> torch.Tensor:
    return torch.zeros((n,), dtype=torch.float32, device=device)


# ---------------------------------------------------------------------------
# Temporal graph attention layer (TGAT eq. 5-7; TGN uses the same block)
# ---------------------------------------------------------------------------


def _attn_layer_init(gen, d_in_dst, d_in_nbr, d_edge, d_time, d_out, *,
                     device):
    d_q = d_in_dst + d_time
    d_kv = d_in_nbr + d_edge + d_time
    init = lambda shape: dense_init(gen, shape, device=device)
    return {
        "wq": init((d_q, d_out)),
        "wk": init((d_kv, d_out)),
        "wv": init((d_kv, d_out)),
        "w_out1": init((d_out + d_in_dst, d_out)),
        "w_out2": init((d_out, d_out)),
        "b_out1": _zeros(d_out, device),
        "b_out2": _zeros(d_out, device),
    }


def temporal_attn_layer(p: dict, h_dst: torch.Tensor, h_nbr: torch.Tensor,
                        e_feat: torch.Tensor, dt: torch.Tensor,
                        mask: torch.Tensor, te: dict, n_heads: int
                        ) -> torch.Tensor:
    """h_dst: (N, d_dst); h_nbr: (N, K, d_nbr); e_feat: (N, K, de);
    dt: (N, K) (>=0); mask: (N, K). Returns (N, d_out)."""
    N, K, _ = h_nbr.shape
    phi0 = time_encode(torch.zeros((N,), dtype=torch.float32,
                                   device=h_dst.device), te["w"], te["b"])
    phid = time_encode(dt, te["w"], te["b"])                # (N, K, dt)
    q_in = torch.cat([h_dst, phi0], dim=-1)
    kv_in = torch.cat([h_nbr, e_feat, phid], dim=-1)

    d_out = p["wq"].shape[1]
    dh = d_out // n_heads
    q = (q_in @ p["wq"]).reshape(N, n_heads, dh)
    k = (kv_in @ p["wk"]).reshape(N, K, n_heads, dh)
    v = (kv_in @ p["wv"]).reshape(N, K, n_heads, dh)
    attn = temporal_attn(q, k, v, mask).reshape(N, d_out)

    hcat = torch.cat([attn, h_dst], dim=-1)
    out = torch.relu(hcat @ p["w_out1"] + p["b_out1"])
    return out @ p["w_out2"] + p["b_out2"]


# ---------------------------------------------------------------------------
# GraphSAGE / GAT layers (static GNNs; same padded-neighbourhood layout)
# ---------------------------------------------------------------------------


def _sage_layer_init(gen, d_in_dst, d_in_nbr, d_out, *, device):
    return {"w_self": dense_init(gen, (d_in_dst, d_out), device=device),
            "w_nbr": dense_init(gen, (d_in_nbr, d_out), device=device),
            "b": _zeros(d_out, device)}


def sage_layer(p, h_dst, h_nbr, mask):
    denom = mask.sum(-1, keepdim=True).clamp_min(1)
    mean = (h_nbr * mask[..., None]).sum(1) / denom
    return torch.relu(h_dst @ p["w_self"] + mean @ p["w_nbr"] + p["b"])


def _gat_layer_init(gen, d_in_dst, d_in_nbr, d_out, n_heads, *, device):
    dh = d_out // n_heads
    init = lambda shape: dense_init(gen, shape, device=device)
    return {"w_dst": init((d_in_dst, d_out)),
            "w_nbr": init((d_in_nbr, d_out)),
            "a_dst": init((n_heads, dh)),
            "a_nbr": init((n_heads, dh))}


def gat_layer(p, h_dst, h_nbr, mask, n_heads):
    N, K, _ = h_nbr.shape
    d_out = p["w_dst"].shape[1]
    dh = d_out // n_heads
    zd = (h_dst @ p["w_dst"]).reshape(N, n_heads, dh)
    zn = (h_nbr @ p["w_nbr"]).reshape(N, K, n_heads, dh)
    s = (torch.einsum("nhd,hd->nh", zd, p["a_dst"])[:, None, :]
         + torch.einsum("nkhd,hd->nkh", zn, p["a_nbr"]))
    s = F.leaky_relu(s, 0.2)
    s = torch.where(mask[..., None], s, -1e30)
    a = torch.softmax(s, dim=1)
    a = torch.where(mask[..., None], a, 0.0)
    out = torch.einsum("nkh,nkhd->nhd", a, zn).reshape(N, d_out)
    return F.elu(out)


# ---------------------------------------------------------------------------
# Model bundles: init(cfg) + embed(params, hops) -> seed embeddings
# ---------------------------------------------------------------------------


def _feat_dims(cfg: GNNConfig) -> Tuple[int, int]:
    d_node_in = cfg.d_node + (cfg.d_memory if cfg.use_memory else 0)
    return d_node_in, cfg.d_edge


def init_gnn(cfg: GNNConfig, gen: torch.Generator, *, device) -> Params:
    L = cfg.n_layers
    d_node_in, d_edge = _feat_dims(cfg)
    params: Dict[str, Any] = {
        "te": time_encode_params(cfg.d_time, device=device)}
    layers = []
    for l in range(L):
        # hop l's dst input is always the node's RAW features; its nbr
        # input is the deeper hop's output except at the deepest hop
        d_in_dst = d_node_in
        d_in_nbr = d_node_in if l == L - 1 else cfg.d_hidden
        if cfg.model in ("tgn", "tgat", "dysat"):
            layers.append(_attn_layer_init(
                gen, d_in_dst, d_in_nbr, d_edge, cfg.d_time, cfg.d_hidden,
                device=device))
        elif cfg.model == "graphsage":
            layers.append(_sage_layer_init(gen, d_in_dst, d_in_nbr,
                                           cfg.d_hidden, device=device))
        else:  # gat
            layers.append(_gat_layer_init(gen, d_in_dst, d_in_nbr,
                                          cfg.d_hidden, cfg.n_heads,
                                          device=device))
    params["layers"] = layers
    if cfg.model == "dysat":
        d = cfg.d_hidden
        params["temp_attn"] = {
            name: dense_init(gen, (d, d), device=device)
            for name in ("wq", "wk", "wv")}
    return params


def init_link_head(cfg: GNNConfig, gen: torch.Generator, *,
                   device) -> Params:
    return {"w1": dense_init(gen, (2 * cfg.d_hidden, cfg.d_hidden),
                             device=device),
            "b1": _zeros(cfg.d_hidden, device),
            "w2": dense_init(gen, (cfg.d_hidden, 1), device=device),
            "b2": _zeros(1, device)}


def init_memory_module(cfg: GNNConfig, gen: torch.Generator, *,
                       device) -> Params:
    d_msg = 2 * cfg.d_memory + cfg.d_time + cfg.d_edge
    dm = cfg.d_memory
    p = {"te": time_encode_params(cfg.d_time, device=device)}
    # GRU: z, r, n gates over [msg, mem]
    for g in ("z", "r", "n"):
        p[f"w_{g}"] = dense_init(gen, (d_msg + dm, dm), device=device)
    for g in ("z", "r", "n"):
        p[f"b_{g}"] = _zeros(dm, device)
    return p


def init_params(cfg: GNNConfig, gen: torch.Generator, *, device) -> Params:
    """Full parameter tree: gnn + link head (+ TGN memory module when
    cfg.use_memory), with the JAX package's layout and shapes.  ``gen``
    is a CPU generator; the tensors are moved to ``device``."""
    params: Dict[str, Any] = {
        "gnn": init_gnn(cfg, gen, device=device),
        "head": init_link_head(cfg, gen, device=device)}
    if cfg.use_memory:
        params["memory"] = init_memory_module(cfg, gen, device=device)
    return params


def gnn_embed(params: Params, cfg: GNNConfig, hops: List[dict]
              ) -> torch.Tensor:
    """Bottom-up recursion over L hops -> seed embeddings (N0, d_hidden).

    hops[l]["dst_feat"]: (Nl, d_in), ["nbr_feat"]: (Nl, Kl, d_in), etc.
    """
    L = cfg.n_layers
    h_nbr: Optional[torch.Tensor] = None
    for l in reversed(range(L)):
        hop = hops[l]
        dst = hop["dst_feat"]
        nbr = hop["nbr_feat"] if h_nbr is None else h_nbr
        if cfg.model in ("tgn", "tgat", "dysat"):
            h = temporal_attn_layer(
                params["layers"][l], dst, nbr, hop["edge_feat"],
                hop["dt"], hop["mask"], params["te"], cfg.n_heads)
        elif cfg.model == "graphsage":
            h = sage_layer(params["layers"][l], dst, nbr, hop["mask"])
        else:
            h = gat_layer(params["layers"][l], dst, nbr, hop["mask"],
                          cfg.n_heads)
        if l > 0:
            Np, Kp = hops[l - 1]["mask"].shape
            h_nbr = h.reshape(Np, Kp, -1)
    return h


def dysat_embed(params: Params, cfg: GNNConfig,
                snapshots: List[List[dict]]) -> torch.Tensor:
    """DySAT: structural embedding per time-window snapshot + temporal
    self-attention across the snapshot axis (newest last)."""
    embs = [gnn_embed(params, cfg, hops) for hops in snapshots]
    H = torch.stack(embs, dim=1)                 # (N, T, d)
    ta = params["temp_attn"]
    q = H @ ta["wq"]
    k = H @ ta["wk"]
    v = H @ ta["wv"]
    s = torch.einsum("ntd,nsd->nts", q, k) / (H.shape[-1] ** 0.5)
    # causal across snapshots: window t attends to windows <= t
    T = H.shape[1]
    causal = torch.tril(torch.ones((T, T), dtype=torch.bool,
                                   device=H.device))
    s = torch.where(causal[None], s, -1e30)
    a = torch.softmax(s, dim=-1)
    out = torch.einsum("nts,nsd->ntd", a, v)
    return out[:, -1]                            # newest snapshot's view


# ---------------------------------------------------------------------------
# TGN node memory (message -> last-aggregation -> GRU)
# ---------------------------------------------------------------------------


def _gru(p, msg, mem):
    x = torch.cat([msg, mem], dim=-1)
    z = torch.sigmoid(x @ p["w_z"] + p["b_z"])
    r = torch.sigmoid(x @ p["w_r"] + p["b_r"])
    xn = torch.cat([msg, r * mem], dim=-1)
    n = torch.tanh(xn @ p["w_n"] + p["b_n"])
    return (1 - z) * mem + z * n


def memory_batch_update(mp: Params, nodes, mem: torch.Tensor,
                        last_upd: torch.Tensor, other_mem: torch.Tensor,
                        e_feat: torch.Tensor, t: torch.Tensor
                        ) -> torch.Tensor:
    """Updated memories given one event each (``nodes`` is unused, as in
    the JAX package).  mem/other_mem: (E, dm) current memories of the
    endpoints; e_feat: (E, de); t: (E,).  Returns (E, dm) new memories;
    when a node has several events the caller's later write wins
    (the paper's 'last' message aggregator)."""
    dt = torch.clamp(t - last_upd, min=0.0)
    phi = time_encode(dt, mp["te"]["w"], mp["te"]["b"])
    msg = torch.cat([mem, other_mem, phi, e_feat], dim=-1)
    return _gru(mp, msg, mem)


# ---------------------------------------------------------------------------
# Link prediction head + loss/metric
# ---------------------------------------------------------------------------


def link_score(p: Params, h_u: torch.Tensor, h_v: torch.Tensor
               ) -> torch.Tensor:
    x = torch.cat([h_u, h_v], dim=-1)
    h = torch.relu(x @ p["w1"] + p["b1"])
    return (h @ p["w2"] + p["b2"])[..., 0]


def bce_logits(scores: torch.Tensor, labels: torch.Tensor,
               weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean BCE over logits; with ``weights``, the weighted mean over
    positive-weight lanes (padded ragged-tail lanes carry weight 0, so
    a padded batch scores exactly its real events)."""
    per = (torch.clamp(scores, min=0) - scores * labels
           + torch.log1p(torch.exp(-torch.abs(scores))))
    if weights is None:
        return torch.mean(per)
    w = weights.to(per.dtype)
    return torch.sum(per * w) / torch.clamp(torch.sum(w), min=1.0)


def average_precision(scores, labels) -> float:
    """Sklearn-style AP over numpy arrays (a copy of the JAX package's)."""
    scores = np.asarray(scores, np.float64)
    labels = np.asarray(labels, np.float64)
    order = np.argsort(-scores, kind="stable")
    labels = labels[order]
    tp = np.cumsum(labels)
    precision = tp / (np.arange(len(labels)) + 1)
    n_pos = labels.sum()
    if n_pos == 0:
        return 0.0
    return float((precision * labels).sum() / n_pos)
