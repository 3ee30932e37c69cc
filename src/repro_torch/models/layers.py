"""Shared model primitives (counterpart of ``repro.models.layers``).

Two wings share this module:

* the temporal GNNs: ``time_encode`` and its parameters;
* the LM backbones: ``rms_norm``, rotary embeddings (rotate-half, in
  float32), ``blocked_attention`` (the full-sequence GQA attention; on
  the card it is the hand-written ``flash_attention`` kernel, and its
  backward kernel under autograd), ``decode_attention`` (one token
  against a padded KV cache, plain PyTorch as in the JAX package), the
  MLP activations and the LM loss ``chunked_softmax_xent``.

Initialisers take an explicit ``torch.Generator`` and draw on the
generator's own device: a CPU generator gives the same weights on every
device (the GNN wing), a CUDA generator draws billions of normals on the
card in a fraction of a second (the full-size LM init).

Matrix products of two bfloat16 operands give bfloat16, as ``x @ w`` does
in JAX; where the JAX package asks for float32 accumulation
(``preferred_element_type``), the port converts both operands to float32,
which is exact for bfloat16 values.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels.flash_attention.ops import flash_attention

NEG_INF = -1e30

# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6
             ) -> torch.Tensor:
    x32 = x.float()
    var = x32.square().mean(-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps)
    return (out * weight.float()).to(x.dtype)


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------


def rope_frequencies(head_dim: int, theta: float, device=None
                     ) -> torch.Tensor:
    half = head_dim // 2
    e = -torch.arange(0, half, dtype=torch.float32, device=device) / half
    return torch.pow(theta, e)      # a Python base: no host-to-device copy


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """x: (B, S, H, D); positions: (B, S) or (S,). Rotate-half convention."""
    d = x.shape[-1]
    freqs = rope_frequencies(d, theta, x.device)              # (D/2,)
    if positions.dim() == 1:
        positions = positions[None, :]
    angles = positions[..., None].float() * freqs             # (B, S, D/2)
    cos = torch.cos(angles)[:, :, None, :]                    # (B, S, 1, D/2)
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention (GQA)
# ---------------------------------------------------------------------------


def blocked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool) -> torch.Tensor:
    """Full-sequence GQA attention with an online softmax.

    q: (B, Sq, Hq, D); k, v: (B, Skv, Hkv, D) with Hq % Hkv == 0; query
    row i sits at position i + Skv - Sq.  Returns (B, Sq, Hq, D) in
    q.dtype.  On the card this is one launch of the ``flash_attention``
    kernel, which tiles the sequence itself (the JAX package's
    ``q_chunk``/``kv_chunk`` have no counterpart), and under autograd
    one launch of its backward kernel; on the CPU it is the kernel's
    plain version.
    """
    return flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                           causal=causal)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, valid_len: torch.Tensor
                     ) -> torch.Tensor:
    """Single-token attention against a padded KV cache.

    q: (B, 1, Hq, D); caches: (B, S, Hkv, D); valid_len: (B,) — number of
    populated cache slots (including the just-written token).
    """
    B, _, Hq, D = q.shape
    S, Hkv = k_cache.shape[1], k_cache.shape[2]
    G = Hq // Hkv
    scale = D ** -0.5
    qg = q.reshape(B, Hkv, G, D).float()
    s = torch.einsum("bhgd,bkhd->bhgk", qg, k_cache.float()) * scale
    pos = torch.arange(S, device=q.device)
    mask = pos[None, None, None, :] >= valid_len[:, None, None, None]
    s = s.masked_fill(mask, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgk,bkhd->bhgd", p.to(v_cache.dtype).float(),
                       v_cache.float())
    return out.reshape(B, 1, Hq, D).to(q.dtype)


# ---------------------------------------------------------------------------
# MLP activations
# ---------------------------------------------------------------------------


def mlp_apply(x: torch.Tensor, params: dict, act: str) -> torch.Tensor:
    """params: swiglu -> {w_gate, w_up, w_down}; else {w_up, w_down}.
    ``gelu`` is the tanh approximation, ``jax.nn.gelu``'s default."""
    if act == "swiglu":
        g = x @ params["w_gate"]
        u = x @ params["w_up"]
        h = F.silu(g.float()).to(x.dtype) * u
    elif act == "sq_relu":
        u = x @ params["w_up"]
        h = torch.relu(u).square()
    elif act == "gelu":
        u = x @ params["w_up"]
        h = F.gelu(u.float(), approximate="tanh").to(x.dtype)
    else:
        raise ValueError(f"unknown act {act!r}")
    return h @ params["w_down"]


def mlp_param_shapes(d_model: int, d_ff: int, act: str) -> dict:
    shapes = {"w_up": (d_model, d_ff), "w_down": (d_ff, d_model)}
    if act == "swiglu":
        shapes["w_gate"] = (d_model, d_ff)
    return shapes


# ---------------------------------------------------------------------------
# Chunked cross-entropy (never materializes (B, S, V))
# ---------------------------------------------------------------------------


def chunked_softmax_xent(h: torch.Tensor, w_out: torch.Tensor,
                         labels: torch.Tensor,
                         valid: Optional[torch.Tensor] = None,
                         n_chunks: int = 4
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """h: (B, S, d); w_out: (d, V); labels: (B, S) int.

    Returns (mean loss over the valid tokens (float32), valid-token count
    (int32)).  Computed per batch chunk (``n_chunks`` lowered until it
    divides B), each under ``torch.utils.checkpoint`` when autograd
    records it, so the full (B, S, V) logits never exist: only one
    chunk's, in the forward and again in the backward.  Logits go to
    float32 before the logsumexp.  (The JAX version's sharding hints
    have no single-device meaning and are left out.)
    """
    B, S, _ = h.shape
    if valid is None:
        valid = torch.ones((B, S), dtype=torch.bool, device=h.device)
    while n_chunks > 1 and B % n_chunks:
        n_chunks -= 1
    c = B // n_chunks
    remat = torch.is_grad_enabled() and (h.requires_grad
                                         or w_out.requires_grad)
    tot = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(n_chunks):
        chunk = (h[i * c:(i + 1) * c], w_out, labels[i * c:(i + 1) * c],
                 valid[i * c:(i + 1) * c])
        tot = tot + (checkpoint(_xent_sum, *chunk, use_reentrant=False)
                     if remat else _xent_sum(*chunk))
    cnt = valid.sum(dtype=torch.int32)
    return tot / cnt.clamp_min(1).float(), cnt


def _xent_sum(h, w_out, labels, valid) -> torch.Tensor:
    """The summed token losses of one batch chunk."""
    logits = (h @ w_out).float()                          # (c, S, V)
    lse = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels.long()[..., None])[..., 0]
    return torch.where(valid, lse - gold, 0.0).sum()


# ---------------------------------------------------------------------------
# Temporal (Bochner) time encoding — used by the temporal GNNs
# ---------------------------------------------------------------------------


def time_encode(dt: torch.Tensor, w: torch.Tensor, b: torch.Tensor
                ) -> torch.Tensor:
    """cos(dt * w + b); dt: (...,), w/b: (d_time,) -> (..., d_time)."""
    return torch.cos(dt[..., None].to(torch.float32) * w + b)


def time_encode_params(d_time: int, *, device) -> dict:
    # TGAT init: w = 1 / 10^linspace — covers multiple time scales.
    w = 1.0 / (10.0 ** torch.linspace(0.0, 9.0, d_time,
                                      dtype=torch.float32))
    return {"w": w.to(device),
            "b": torch.zeros((d_time,), dtype=torch.float32, device=device)}


# ---------------------------------------------------------------------------
# Initializers
# ---------------------------------------------------------------------------


def dense_init(generator: torch.Generator, shape: Tuple[int, ...], *,
               device=None, dtype=torch.float32,
               scale: Optional[float] = None) -> torch.Tensor:
    """Normal(0, fan_in^-1/2) weights (``fan_in`` = ``shape[0]``, or
    ``scale`` as given), drawn on the generator's device and then moved
    to ``device`` (default: the generator's).  A dtype other than
    float32 is drawn in that dtype, so a full-size bf16 tree never
    holds a float32 copy of its largest leaf."""
    fan_in = shape[0] if len(shape) >= 2 else 1
    s = scale if scale is not None else fan_in ** -0.5
    if dtype == torch.float32:
        w = torch.randn(tuple(shape), generator=generator,
                        dtype=torch.float32, device=generator.device).mul_(s)
    else:
        w = torch.empty(tuple(shape), dtype=dtype,
                        device=generator.device).normal_(0.0, s,
                                                         generator=generator)
    return w.to(device=device or generator.device, dtype=dtype)


def embed_init(generator: torch.Generator, shape: Tuple[int, ...], *,
               device=None, dtype=torch.float32) -> torch.Tensor:
    return dense_init(generator, shape, device=device, dtype=dtype,
                      scale=0.02)
