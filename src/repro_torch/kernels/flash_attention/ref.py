"""Plain PyTorch version of the flash_attention kernel: dense masked GQA
attention.

Scores are float32 (operands converted to float32, which is exact for
bfloat16), scaled by D^-0.5 after the dot product; causal masking is
``k_pos > q_pos + (Skv - Sq)``.  As in the kernel and in the JAX
package's ``blocked_attention``, the unnormalised weights
``p = exp(s - max s)`` are rounded to v's dtype before P.V, and the
float32 row sum of the unrounded ``p`` divides the result, floored at
1e-30.  A row with no key in its causal window gives zeros.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def flash_attention_ref(q, k, v, *, causal: bool) -> torch.Tensor:
    """q: (B, Sq, Hq, D); k, v: (B, Skv, Hkv, D) -> (B, Sq, Hq, D)."""
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    qg = q.reshape(B, Sq, Hkv, G, D).float()
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) * (D ** -0.5)
    if causal:
        kpos = torch.arange(Skv, device=q.device)
        qpos = torch.arange(Sq, device=q.device) + (Skv - Sq)
        masked = kpos[None, :] > qpos[:, None]                  # (Sq, Skv)
        s = s.masked_fill(masked, float("-inf"))
    m = s.amax(dim=-1, keepdim=True).clamp_min(NEG_INF)
    p = torch.exp(s - m)
    l = p.sum(dim=-1)                                           # (B,h,g,q)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p.to(v.dtype).float(), v.float())
    o = o / l.clamp_min(1e-30).permute(0, 3, 1, 2)[..., None]
    return o.reshape(B, Sq, Hq, D).to(q.dtype)
