"""Wrapper of the flash_attention CUDA kernel
(``csrc/flash_attention.cu``).

A CPU tensor takes the plain version (``ref.py``).  A CUDA tensor
launches the kernel, counted as ``flash_attention``, or raises on what
the kernel does not take: q, k and v must be contiguous float32 or
bfloat16 tensors of one dtype, (B, S, H, D) with Hq % Hkv == 0 and
D <= 256, and a causal call needs Sq <= Skv (every query row then has
at least one key).  Unlike the Pallas wrapper, any Sq and Skv are taken:
the kernel masks the ragged edge of its tiles itself.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import runtime as rt
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

P, I, F = rt.PTR, rt.INT, rt.FLOAT
_SIG = {"flash_attention_launch": (P, P, P, P, I, I, I, I, I, I, I, I, F,
                                   P)}
MAX_HEAD_DIM = 256
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def flash_attention(q, k, v, *, causal: bool = True) -> torch.Tensor:
    """q: (B, Sq, Hq, D); k, v: (B, Skv, Hkv, D) -> (B, Sq, Hq, D) in
    q's dtype."""
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal)
    _check(q, k, v, causal)
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    lib = rt.load("flash_attention", _SIG)
    rc = lib.flash_attention_launch(
        rt.ptr(q), rt.ptr(k), rt.ptr(v), rt.ptr(out), B, Sq, Skv, Hq, Hkv,
        D, DTYPES[q.dtype], int(causal), D ** -0.5,
        rt.stream_handle(q.device))
    rt.count_launch("flash_attention")
    rt.check(lib, rc, "flash_attention")
    return out


def _check(q, k, v, causal):
    dev = q.device
    if q.dtype not in DTYPES:
        raise TypeError(f"flash_attention: dtype {q.dtype}, expected "
                        f"float32 or bfloat16")
    for name, t in (("q", q), ("k", k), ("v", v)):
        rt.require(t, name, q.dtype, dev, 4)
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    if k.shape != (B, Skv, Hkv, D) or v.shape != k.shape:
        raise ValueError(f"flash_attention: shapes disagree: q {tuple(q.shape)}"
                         f" k {tuple(k.shape)} v {tuple(v.shape)}")
    if Hkv < 1 or Hq % Hkv:
        raise ValueError(f"flash_attention: Hq={Hq} is not a multiple of "
                         f"Hkv={Hkv}")
    if not 1 <= D <= MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: head dim {D} not in "
                         f"[1, {MAX_HEAD_DIM}]")
    if causal and Sq > Skv:
        raise ValueError(f"flash_attention: causal needs Sq <= Skv, got "
                         f"Sq={Sq} Skv={Skv}")
