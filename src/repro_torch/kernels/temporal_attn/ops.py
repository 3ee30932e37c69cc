"""Wrapper of the temporal_attn CUDA kernels (``csrc/temporal_attn.cu``),
forward and backward, as one ``torch.autograd.Function``.

A CPU tensor takes the plain version (``ref.py``), whose gradient is
PyTorch's autograd of the same expression.  A CUDA tensor launches the
forward kernel, and, when autograd reaches the op, the backward kernel;
each launch is counted (``temporal_attn``, ``temporal_attn_bwd``).  Any
K and Dh are taken, as by the Pallas body, up to what a warp's shared
memory holds (the forward's ring of two stages of at least one
neighbour's k and v rows, H*Dh in the thousands of floats); past that,
or for a CUDA input of another dtype or layout, the call raises."""
from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from repro_torch.kernels import runtime as rt
from repro_torch.kernels.temporal_attn.ref import temporal_attn_ref

P, I, F = rt.PTR, rt.INT, rt.FLOAT
_SIG = {"temporal_attn_launch": (P, P, P, P, I, I, I, I, F, P, P),
        "temporal_attn_bwd_launch": (P, P, P, P, P, I, I, I, I, F, P, P,
                                     P, P)}


def temporal_attn(q, k, v, mask):
    """q: (N, H, Dh); k, v: (N, K, H, Dh); mask: (N, K) -> (N, H, Dh)."""
    if q.device.type == "cpu":
        return temporal_attn_ref(q, k, v, mask)
    _check(q, k, v, mask)
    return _TemporalAttn.apply(q, k, v, mask)


def _check(q, k, v, mask):
    dev = q.device
    rt.require(q, "q", torch.float32, dev, 3)
    rt.require(k, "k", torch.float32, dev, 4)
    rt.require(v, "v", torch.float32, dev, 4)
    rt.require(mask, "mask", torch.bool, dev, 2)
    n, h, dh = q.shape
    kn = k.shape[1]
    if k.shape != (n, kn, h, dh) or v.shape != k.shape \
            or mask.shape != (n, kn):
        raise ValueError("temporal_attn: shapes disagree")
    if kn < 1 or dh < 1:
        raise ValueError(f"temporal_attn: needs K >= 1 and Dh >= 1, got "
                         f"K={kn} Dh={dh}")


class _TemporalAttn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, mask):
        n, h, dh = q.shape
        out = torch.empty((n, h, dh), dtype=torch.float32, device=q.device)
        ctx.save_for_backward(q, k, v, mask)
        if n == 0:
            return out
        lib = rt.load("temporal_attn", _SIG)
        rc = lib.temporal_attn_launch(
            rt.ptr(q), rt.ptr(k), rt.ptr(v), rt.ptr(mask), n, h,
            k.shape[1], dh, dh ** -0.5, rt.ptr(out),
            rt.stream_handle(q.device))
        rt.count_launch("temporal_attn")
        rt.check(lib, rc, "temporal_attn")
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, dout):
        q, k, v, mask = ctx.saved_tensors
        dout = dout.contiguous()
        dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
        n, h, dh = q.shape
        if n == 0:
            return dq, dk, dv, None
        rt.require(dout, "dout", torch.float32, q.device, 3)
        lib = rt.load("temporal_attn", _SIG)
        rc = lib.temporal_attn_bwd_launch(
            rt.ptr(q), rt.ptr(k), rt.ptr(v), rt.ptr(mask), rt.ptr(dout),
            n, h, k.shape[1], dh, dh ** -0.5, rt.ptr(dq), rt.ptr(dk),
            rt.ptr(dv), rt.stream_handle(q.device))
        rt.count_launch("temporal_attn_bwd")
        rt.check(lib, rc, "temporal_attn_bwd")
        return dq, dk, dv, None
