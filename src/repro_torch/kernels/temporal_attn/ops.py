"""Wrapper of the temporal_attn CUDA kernel (``csrc/temporal_attn.cu``),
forward only. A CPU tensor takes the plain version; a CUDA tensor
launches the kernel or raises — including when an input requires a
gradient, since the kernel has no backward yet."""
from __future__ import annotations

import torch

from repro_torch.kernels import runtime as rt
from repro_torch.kernels.temporal_attn.ref import temporal_attn_ref

P, I, F = rt.PTR, rt.INT, rt.FLOAT
_SIG = {"temporal_attn_launch": (P, P, P, P, I, I, I, I, F, P, P)}


def temporal_attn(q, k, v, mask):
    """q: (N, H, Dh); k, v: (N, K, H, Dh); mask: (N, K) -> (N, H, Dh)."""
    if q.device.type == "cpu":
        return temporal_attn_ref(q, k, v, mask)
    dev = q.device
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (q, k, v)):
        raise RuntimeError("temporal_attn: the CUDA kernel is forward-"
                           "only; call it under torch.no_grad()")
    rt.require(q, "q", torch.float32, dev, 3)
    rt.require(k, "k", torch.float32, dev, 4)
    rt.require(v, "v", torch.float32, dev, 4)
    rt.require(mask, "mask", torch.bool, dev, 2)
    n, h, dh = q.shape
    kn = k.shape[1]
    if k.shape != (n, kn, h, dh) or v.shape != k.shape \
            or mask.shape != (n, kn):
        raise ValueError("temporal_attn: shapes disagree")
    if not (1 <= kn <= 32 and 1 <= dh <= 128):
        raise ValueError(f"temporal_attn: needs K <= 32 and Dh <= 128, "
                         f"got K={kn} Dh={dh}")
    out = torch.empty((n, h, dh), dtype=torch.float32, device=dev)
    if n == 0:
        return out
    lib = rt.load("temporal_attn", _SIG)
    rc = lib.temporal_attn_launch(
        rt.ptr(q), rt.ptr(k), rt.ptr(v), rt.ptr(mask), n, h, kn, dh,
        dh ** -0.5, rt.ptr(out), rt.stream_handle(dev))
    rt.count_launch("temporal_attn")
    rt.check(lib, rc, "temporal_attn")
    return out
