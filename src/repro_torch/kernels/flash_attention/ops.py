"""Wrapper of the flash_attention CUDA kernels, forward and backward, each
in two instances: the Hopper ones (``csrc/flash_attention_sm90.cu`` and
``csrc/flash_attention_bwd_sm90.cu``: wgmma, TMA, rings in shared
memory) for bfloat16 with a head dim in :data:`SM90_HEAD_DIMS` forward
(64, 80, 128 and 192: 80 as a 64-column box and a 16-column tail box,
192 as three boxes with 112-key tiles) and in
:data:`SM90_BWD_HEAD_DIMS` backward (the same four; at 192 its dk/dv
pass splits each 64-key tile's work between its two warpgroups), and
the general ones (``csrc/flash_attention.cu`` and
``csrc/flash_attention_bwd.cu``) for every other dtype and head dim.
Either backward reads the row log-sum-exps and float32 output every
forward writes alike.  The general ones run float32 on the tensor cores in split TF32
(``csrc/tf32.cuh``: each float32 product as three TF32 products, hi.hi +
hi.lo + lo.hi, within the float32 bar of 1e-5), bfloat16 on WMMA.

A CPU tensor takes the plain version (``ref.py``), whose gradient is
PyTorch's autograd of the same expression.  A CUDA tensor launches one
forward kernel, the instance :func:`instance` picks from the dtype and
head dim before the launch, counted as ``flash_attention`` either way,
or raises on what the kernel does not take (a failed build or launch
raises too: nothing falls back to another instance): q, k and v must be
contiguous float32 or bfloat16 tensors of one dtype, (B, S, H, D) with
Hq % Hkv == 0 and any head dim D (the general instance takes wide D in
chunks of output columns: past 256 in bfloat16, past 512 in float32),
and a causal call needs Sq <= Skv (every query row then has at least one
key) unless it gives ``q_offset``.  The
Hopper instance reads q, k and v by TMA, which needs them 16-byte
aligned; its backward reads q, k, v and the output's gradient so too,
and raises if one is not (the rows' strides, D * 2 and H * D * 2 bytes,
are multiples of 16 at each of its head dims).  A private
``_instance="general"`` takes the general instance instead, forward and
backward, to time the two against each other; nothing on a model path
passes it.  Unlike the Pallas wrapper, any Sq and Skv are taken: the
kernels mask the ragged edge of their tiles themselves.

A causal call masks the keys past each query row's position, row i
sitting at ``i + q_offset``: by default ``Skv - Sq`` (the last Sq of Skv
positions, the model's prefill), or the ``q_offset >= 0`` the caller
gives (a context-parallel shard's first position, its keys all-gathered
over the whole sequence); every kernel takes it, forward and backward,
and so does the plain version.  A negative ``q_offset`` raises.  At an
offset below ``Skv - Sq`` the keys past the last row's position are seen
by no query: the backward writes their dk and dv as zeros.

When grad mode is on and an input requires grad, the call goes through
one ``torch.autograd.Function``: the forward kernel also writes each
row's log-sum-exp and, for bfloat16, its output's float32 values before
rounding (the backward's ``D = rowsum(dO * O)`` takes the float32 O, as
the plain version's autograd does), and autograd's backward launches the
backward kernel :func:`backward_instance` picks (the general one when
the forward's was forced) once, counted as
``flash_attention_bwd`` either way.  Otherwise (serving) neither is
written and no autograd node is made.

A ``meta`` tensor (the dry run's shape trace, ``launch.op_cost``) takes
the same checks and autograd node as a CUDA one, but in place of each
launch its wrapper allocates the outputs the kernel writes (the row
LSEs and float32 output under autograd; the backward's scratch row
sums) as meta tensors and charges the trace one call with the kernel's
own counts (:func:`kernel_cost`).  It never launches, and a CUDA tensor
never takes it.
"""
from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from repro_torch.kernels import runtime as rt
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

P, I, F = rt.PTR, rt.INT, rt.FLOAT
_SIG = {"flash_attention_launch": (P, P, P, P, P, P, I, I, I, I, I, I, I,
                                   I, F, P, I)}
_SIG_SM90 = {"flash_attention_sm90_launch": (P, P, P, P, P, P, I, I, I, I,
                                             I, I, I, F, P, I)}
_BWD_ARGS = (P, P, P, P, P, P, P, P, P, P, I, I, I, I, I, I, I, I, F, P, I)
_SIG_BWD = {"flash_attention_bwd_launch": _BWD_ARGS}
_SIG_BWD_SM90 = {"flash_attention_bwd_sm90_launch": _BWD_ARGS}
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# head dims the Hopper instances take in bfloat16: the forward's
# (64-column TMA boxes, at 80 a 16-column tail box, at 192 112-key tiles)
# and the backward's (at 192 64-key dk/dv tiles, each split between the
# two warpgroups: half of S^T and dP^T, half of dK's and dV's columns)
SM90_HEAD_DIMS = (64, 80, 128, 192)
SM90_BWD_HEAD_DIMS = (64, 80, 128, 192)


def instance(dtype: torch.dtype, head_dim: int) -> str:
    """The forward kernel a CUDA call launches: ``"sm90"`` (wgmma and TMA)
    for bfloat16 with a head dim in :data:`SM90_HEAD_DIMS`, else
    ``"general"``."""
    if dtype == torch.bfloat16 and head_dim in SM90_HEAD_DIMS:
        return "sm90"
    return "general"


def backward_instance(dtype: torch.dtype, head_dim: int) -> str:
    """The backward kernel a call launches: ``"sm90"`` for bfloat16 with a
    head dim in :data:`SM90_BWD_HEAD_DIMS`, else ``"general"``."""
    if dtype == torch.bfloat16 and head_dim in SM90_BWD_HEAD_DIMS:
        return "sm90"
    return "general"


def flash_attention(q, k, v, *, causal: bool = True,
                    q_offset: int | None = None,
                    _instance: str | None = None) -> torch.Tensor:
    """q: (B, Sq, Hq, D); k, v: (B, Skv, Hkv, D) -> (B, Sq, Hq, D) in
    q's dtype; a causal call's query row i sits at ``i + q_offset``
    (default ``Skv - Sq``).  ``_instance`` ("general") takes the general
    kernels, forward and backward, in place of :func:`instance`'s."""
    _forced(_instance, "flash_attention")
    if q.device.type == "cpu":
        q_offset_of(q, k, causal, q_offset)
        given = {} if q_offset is None else {"q_offset": q_offset}
        return flash_attention_ref(q, k, v, causal=causal, **given)
    _check(q, k, v, causal, _instance, q_offset)
    grad = torch.is_grad_enabled() and any(t.requires_grad
                                           for t in (q, k, v))
    off = q_offset_of(q, k, causal, q_offset)
    if grad:
        return _FlashAttention.apply(q, k, v, causal, _instance, off)
    return _forward(q, k, v, causal, None, _instance=_instance, q_offset=off)


def q_offset_of(q, k, causal: bool, q_offset: int | None = None) -> int:
    """The position of query row 0 that a call's causal mask takes:
    ``q_offset``, or ``Skv - Sq`` by default; 0 for a call that is not
    causal (it masks nothing).  Raises on a negative ``q_offset``.  The
    backward kernels read the forward's offset."""
    if q_offset is not None and q_offset < 0:
        raise ValueError(f"flash_attention: q_offset {q_offset} < 0")
    if not causal:
        return 0
    return k.shape[1] - q.shape[1] if q_offset is None else int(q_offset)


def _forward(q, k, v, causal, lse, o32=None, _instance=None, q_offset=None):
    """One forward launch; writes each row's log-sum-exp into ``lse``
    (B, Hq, Sq) float32 and the output's float32 values before rounding
    into ``o32`` (B, Sq, Hq, D) unless they are None.  ``q_offset``
    None is the default, ``Skv - Sq``."""
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    off = q_offset_of(q, k, causal, q_offset)
    if q.device.type == "meta":
        from repro_torch.launch import op_cost
        op_cost.kernel_call(
            "flash_attention", kernel_cost("flash_attention", q, k, causal,
                                           off),
            (q, k, v), (out, lse, o32), remember=lse)
        return out
    stream = rt.stream_handle(q.device)
    if (_instance or instance(q.dtype, D)) == "sm90":
        lib = rt.load("flash_attention_sm90", _SIG_SM90)
        rc = lib.flash_attention_sm90_launch(
            rt.ptr(q), rt.ptr(k), rt.ptr(v), rt.ptr(out), rt.ptr(lse),
            rt.ptr(o32), B, Sq, Skv, Hq, Hkv, D, int(causal), D ** -0.5,
            stream, off)
    else:
        lib = rt.load("flash_attention", _SIG)
        rc = lib.flash_attention_launch(
            rt.ptr(q), rt.ptr(k), rt.ptr(v), rt.ptr(out), rt.ptr(lse),
            rt.ptr(o32), B, Sq, Skv, Hq, Hkv, D, DTYPES[q.dtype],
            int(causal), D ** -0.5, stream, off)
    rt.count_launch("flash_attention")
    rt.check(lib, rc, "flash_attention")
    return out


def flash_attention_bwd(q, k, v, o32, lse, dout, *, causal: bool,
                        q_offset: int | None = None,
                        _instance: str | None = None):
    """The backward kernel: (dq, dk, dv) of the inputs' shapes and dtype
    from the forward's inputs, its output in float32 ``o32`` (the output
    itself for float32 inputs, else its values before rounding), its row
    log-sum-exps ``lse`` (B, Hq, Sq) and the output's gradient
    ``dout``, with the forward's ``q_offset`` (default ``Skv - Sq``).
    The instance is :func:`backward_instance`'s; ``_instance``
    ("general") takes the general one instead, for timing the two
    against each other."""
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    rt.require(dout, "dout", q.dtype, q.device, 4)
    rt.require(o32, "o32", torch.float32, q.device, 4)
    rt.require(lse, "lse", torch.float32, q.device, 3)
    if (dout.shape != q.shape or o32.shape != q.shape
            or lse.shape != (B, Hq, Sq)):
        raise ValueError("flash_attention_bwd: shapes disagree")
    inst = bwd_instance(q, k, v, dout, _instance)
    off = q_offset_of(q, k, causal, q_offset)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    if q.numel() == 0:
        return dq, dk.zero_(), dv.zero_()
    dd = torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device)
    if q.device.type == "meta":
        from repro_torch.launch import op_cost
        op_cost.kernel_call(
            "flash_attention_bwd", kernel_cost("flash_attention_bwd", q, k,
                                               causal, off),
            (q, k, v, o32, lse, dout), (dq, dk, dv), recall=lse)
        return dq, dk, dv
    args = (rt.ptr(q), rt.ptr(k), rt.ptr(v), rt.ptr(o32), rt.ptr(dout),
            rt.ptr(lse), rt.ptr(dd), rt.ptr(dq), rt.ptr(dk), rt.ptr(dv), B,
            Sq, Skv, Hq, Hkv, D, DTYPES[q.dtype], int(causal), D ** -0.5,
            rt.stream_handle(q.device), off)
    if inst == "sm90":
        lib = rt.load("flash_attention_bwd_sm90", _SIG_BWD_SM90)
        rc = lib.flash_attention_bwd_sm90_launch(*args)
    else:
        lib = rt.load("flash_attention_bwd", _SIG_BWD)
        rc = lib.flash_attention_bwd_launch(*args)
    rt.count_launch("flash_attention_bwd")
    rt.check(lib, rc, "flash_attention_bwd")
    return dq, dk, dv


def attended_pairs(Sq: int, Skv: int, causal: bool, q_offset: int) -> int:
    """The (query, key) pairs a call computes: every pair, or under a
    causal mask at ``q_offset`` row i's keys 0 .. i + q_offset."""
    if not causal:
        return Sq * Skv
    full = min(max(Skv - q_offset, 0), Sq)     # rows i + q_offset < Skv
    a = q_offset + 1
    return full * a + full * (full - 1) // 2 + (Sq - full) * Skv


def kernel_cost(name: str, q, k, causal: bool, q_offset: int) -> int:
    """A call's FLOPs in ``PERF.md``'s convention: 4·D a (query, key)
    pair under the mask and query head forward (the two products), 10·D
    backward (its five products)."""
    B, Sq, Hq, D = q.shape
    per_pair = 10 * D if name == "flash_attention_bwd" else 4 * D
    return per_pair * B * Hq * attended_pairs(Sq, k.shape[1], causal,
                                              q_offset)


def bwd_instance(q, k, v, dout, forced: str | None = None) -> str:
    """The backward kernel a call launches: :func:`backward_instance`'s,
    or the general one where ``forced`` says so.  The Hopper instance
    reads q, k, v and ``dout`` by TMA: raises if one is not 16-byte
    aligned."""
    _forced(forced, "flash_attention_bwd")
    inst = forced or backward_instance(q.dtype, q.shape[-1])
    if inst == "sm90" and any(t.data_ptr() % 16 for t in (q, k, v, dout)):
        raise ValueError("flash_attention_bwd: the Hopper instance reads q, "
                         "k, v and dout by TMA and needs them 16-byte "
                         "aligned")
    return inst


def _forced(forced, what):
    """Only the general instance can be asked for."""
    if forced not in (None, "general"):
        raise ValueError(f"{what}: instance {forced!r}, expected None or "
                         f"'general'")


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, forced, q_offset):
        B, Sq, Hq, _ = q.shape
        lse = torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device)
        o32 = (None if q.dtype == torch.float32 else
               torch.empty(q.shape, dtype=torch.float32, device=q.device))
        out = _forward(q, k, v, causal, lse, o32, forced, q_offset)
        ctx.causal, ctx.forced, ctx.q_offset = causal, forced, q_offset
        ctx.save_for_backward(q, k, v, out if o32 is None else o32, lse)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, dout):
        q, k, v, o32, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o32, lse,
                                         dout.contiguous(),
                                         causal=ctx.causal,
                                         q_offset=ctx.q_offset,
                                         _instance=ctx.forced)
        return dq, dk, dv, None, None, None


def _check(q, k, v, causal, forced=None, q_offset=None):
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
    if causal and q_offset is None and Sq > Skv:
        raise ValueError(f"flash_attention: causal needs Sq <= Skv, got "
                         f"Sq={Sq} Skv={Skv}")
    if (forced or instance(q.dtype, D)) == "sm90" and any(
            t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention: the Hopper instance reads q, k "
                         "and v by TMA and needs them 16-byte aligned")
