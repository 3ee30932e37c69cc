"""Wrapper of the cache_gather CUDA kernel (``csrc/cache_gather.cu``),
with the slot precompute ``slot_of[clip(id)]`` folded into the kernel.
A CPU tensor takes the plain version; a CUDA tensor launches the kernel
or raises."""
from __future__ import annotations

import torch

from repro_torch.kernels import runtime as rt
from repro_torch.kernels.cache_gather.ref import cache_gather_ref

P, I = rt.PTR, rt.INT
_SIG = {"cache_gather_launch": (P, I, P, I, P, I, P, I, P, P, P)}


def cache_gather(slot_of, slot_ids, feats, ids):
    """slot_of: (M,) int32; slot_ids: (C,) int32; feats: (C, D) float32;
    ids: (N,) int32. Returns (out (N, D), hit (N,) bool)."""
    if ids.device.type == "cpu":
        return cache_gather_ref(slot_of, slot_ids, feats, ids)
    dev = ids.device
    rt.require(slot_of, "slot_of", torch.int32, dev, 1)
    rt.require(slot_ids, "slot_ids", torch.int32, dev, 1)
    rt.require(feats, "feats", torch.float32, dev, 2)
    rt.require(ids, "ids", torch.int32, dev, 1)
    m, c, (c2, d), n = slot_of.shape[0], slot_ids.shape[0], feats.shape, \
        ids.shape[0]
    if c != c2 or m < 1 or c < 1:
        raise ValueError(f"bad cache extents M={m} C={c} feats C={c2}")
    out = torch.empty((n, d), dtype=torch.float32, device=dev)
    hit = torch.empty((n,), dtype=torch.bool, device=dev)
    if n == 0:
        return out, hit
    lib = rt.load("cache_gather", _SIG)
    rc = lib.cache_gather_launch(
        rt.ptr(slot_of), m, rt.ptr(slot_ids), c, rt.ptr(feats), d,
        rt.ptr(ids), n, rt.ptr(out), rt.ptr(hit), rt.stream_handle(dev))
    rt.count_launch("cache_gather")
    rt.check(lib, rc, "cache_gather")
    return out, hit
