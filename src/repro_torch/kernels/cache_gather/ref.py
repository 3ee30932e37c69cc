"""Plain PyTorch version of the cache_gather kernel (== cache_lookup)."""
from __future__ import annotations

import torch

NULL = -1


def cache_gather_ref(slot_of, slot_ids, feats, ids):
    """slot_of: (M,); slot_ids: (C,); feats: (C, D); ids: (N,).
    Returns (out (N, D), hit (N,))."""
    safe = ids.clamp(0, slot_of.shape[0] - 1).long()
    slot = slot_of[safe]
    slot_c = slot.clamp(0, slot_ids.shape[0] - 1).long()
    hit = (ids >= 0) & (slot >= 0) & (slot_ids[slot_c] == ids)
    out = torch.where(hit[:, None], feats[slot_c],
                      torch.zeros((), dtype=feats.dtype,
                                  device=feats.device))
    return out, hit
