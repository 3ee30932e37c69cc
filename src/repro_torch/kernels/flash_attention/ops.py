"""Wrapper of the flash_attention CUDA kernels: the Hopper instance
(``csrc/flash_attention_sm90.cu``: wgmma, TMA, a K/V ring) for bfloat16
with head dim 64 or 128, and the general instance
(``csrc/flash_attention.cu``) for every other dtype and head dim.

A CPU tensor takes the plain version (``ref.py``).  A CUDA tensor
launches one kernel, the instance :func:`instance` picks from the dtype
and head dim before the launch, counted as ``flash_attention`` either
way, or raises on what the kernel does not take: q, k and v must be
contiguous float32 or bfloat16 tensors of one dtype, (B, S, H, D) with
Hq % Hkv == 0 and any head dim D (the general instance takes D > 256 in
chunks of output columns), and a causal call needs Sq <= Skv (every
query row then has at least one key).  The Hopper instance reads q, k
and v by TMA, which needs them 16-byte aligned.  Unlike the Pallas
wrapper, any Sq and Skv are taken: both kernels mask the ragged edge of
their tiles themselves.

The kernels have no backward yet (it comes with LM training), so a CUDA
call raises ``RuntimeError`` when grad mode is on and an input requires
grad, instead of returning an output that silently carries no gradient.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import runtime as rt
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

P, I, F = rt.PTR, rt.INT, rt.FLOAT
_SIG = {"flash_attention_launch": (P, P, P, P, I, I, I, I, I, I, I, I, F,
                                   P)}
_SIG_SM90 = {"flash_attention_sm90_launch": (P, P, P, P, I, I, I, I, I, I,
                                             I, F, P)}
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
SM90_HEAD_DIMS = (64, 128)


def instance(dtype: torch.dtype, head_dim: int) -> str:
    """The kernel a CUDA call launches: ``"sm90"`` (wgmma and TMA) for
    bfloat16 with a head dim in :data:`SM90_HEAD_DIMS`, else
    ``"general"``."""
    if dtype == torch.bfloat16 and head_dim in SM90_HEAD_DIMS:
        return "sm90"
    return "general"


def flash_attention(q, k, v, *, causal: bool = True) -> torch.Tensor:
    """q: (B, Sq, Hq, D); k, v: (B, Skv, Hkv, D) -> (B, Sq, Hq, D) in
    q's dtype."""
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal)
    _check(q, k, v, causal)
    rt.forbid_grad("flash_attention", q, k, v)
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    stream = rt.stream_handle(q.device)
    if instance(q.dtype, D) == "sm90":
        lib = rt.load("flash_attention_sm90", _SIG_SM90)
        rc = lib.flash_attention_sm90_launch(
            rt.ptr(q), rt.ptr(k), rt.ptr(v), rt.ptr(out), B, Sq, Skv, Hq,
            Hkv, D, int(causal), D ** -0.5, stream)
    else:
        lib = rt.load("flash_attention", _SIG)
        rc = lib.flash_attention_launch(
            rt.ptr(q), rt.ptr(k), rt.ptr(v), rt.ptr(out), B, Sq, Skv, Hq,
            Hkv, D, DTYPES[q.dtype], int(causal), D ** -0.5, stream)
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
    if D < 1:
        raise ValueError(f"flash_attention: head dim {D} < 1")
    if causal and Sq > Skv:
        raise ValueError(f"flash_attention: causal needs Sq <= Skv, got "
                         f"Sq={Sq} Skv={Skv}")
    if instance(q.dtype, D) == "sm90" and any(
            t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention: the Hopper instance reads q, k "
                         "and v by TMA and needs them 16-byte aligned")
