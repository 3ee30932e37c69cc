"""Plain PyTorch version of the temporal_attn kernels: the forward, and,
through PyTorch's autograd of the same expression, the backward (the
`where` blocks every gradient of a masked neighbour)."""
from __future__ import annotations

import torch


def temporal_attn_ref(q, k, v, mask):
    """q: (N, H, Dh); k, v: (N, K, H, Dh); mask: (N, K) -> (N, H, Dh)."""
    dh = q.shape[-1]
    s = torch.einsum("nhd,nkhd->nhk", q, k) * (dh ** -0.5)
    s = torch.where(mask[:, None, :], s, -1e30)
    a = torch.softmax(s, dim=-1)
    a = torch.where(mask[:, None, :], a, 0.0)   # rows w/o neighbours -> 0
    return torch.einsum("nhk,nkhd->nhd", a, v)
