"""Wrapper of the selective_scan CUDA kernels, forward
(``csrc/selective_scan.cu``) and backward (``csrc/selective_scan_bwd.cu``).

A CPU tensor takes the plain version (``ref.py``), whose gradient is
PyTorch's autograd of the same loop.  A CUDA tensor launches the forward
kernel, counted as ``selective_scan``, or raises on what the kernel does
not take: every input must be a contiguous float32 tensor (the Pallas
wrapper casts to float32 too).  Any L and any d_state N are taken, as by
the Pallas body: the scan needs no padding, and the kernels take N > 64
in groups of 64 states.

When grad mode is on and an input requires grad, the call goes through
one ``torch.autograd.Function``: the forward kernel also stores the state
before every 64 steps, and autograd's backward launches the backward
kernel once, counted as ``selective_scan_bwd``, which recomputes the
states from them.  Otherwise (serving) nothing is stored and no autograd
node is made.

A ``meta`` tensor (the dry run's shape trace, ``launch.op_cost``) takes
the same checks and autograd node as a CUDA one, but in place of each
launch its wrapper allocates what the kernel writes (the stored states
under autograd; the backward's partial sums) as meta tensors and charges
the trace one call: 2·B·L·Din·N FLOPs forward (the output's contraction
over the states, a multiply-add a state a step) and twice that backward
(the gradients of C and of the state), each input read once and each
output written once.  It never launches, and a CUDA tensor never takes
it.
"""
from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from repro_torch.kernels import runtime as rt
from repro_torch.kernels.selective_scan.ref import selective_scan_ref

P, I = rt.PTR, rt.INT
_SIG = {"selective_scan_launch": (P, P, P, P, P, P, I, I, I, I, P, P, P, I,
                                  P)}
_SIG_BWD = {"selective_scan_bwd_launch": (P, P, P, P, P, P, I, P, P, I, I, I,
                                          I, P, P, P, P, P, P, P, P, P),
            "selective_scan_bwd_blocks": (I, I)}
# steps between the states the forward stores; both launchers take it and
# refuse any other than their own
CHUNK = 64
# channels a CTA of the backward kernel (csrc/selective_scan_bwd.cu's
# kChannels: its grid, and its partial sums' blocks, are ceil(Din / 64))
BWD_CHANNELS = 64


def selective_scan(dt, x, A, Bt, Ct, h0):
    """dt, x: (B, L, Din); A: (Din, N); Bt, Ct: (B, L, N); h0: (B, Din, N).
    Returns (y (B, L, Din) f32, h_last (B, Din, N) f32)."""
    if x.device.type == "cpu":
        return selective_scan_ref(dt, x, A, Bt, Ct, h0)
    _check(dt, x, A, Bt, Ct, h0)
    args = (dt, x, A, Bt, Ct, h0)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        return _SelectiveScan.apply(*args)
    return _forward(*args, None)


def _forward(dt, x, A, Bt, Ct, h0, ckpt):
    """One forward launch; stores the state before every ``CHUNK`` steps
    into ``ckpt`` (B, ceil(L / CHUNK), Din, N) unless it is None."""
    B, L, Din = x.shape
    N = A.shape[1]
    y = torch.empty_like(x)
    h_last = torch.empty_like(h0)
    if B * Din == 0:
        return y, h_last
    if x.device.type == "meta":
        from repro_torch.launch import op_cost
        op_cost.kernel_call("selective_scan", 2 * B * L * Din * N,
                            (dt, x, A, Bt, Ct, h0), (y, h_last, ckpt),
                            remember=ckpt)
        return y, h_last
    lib = rt.load("selective_scan", _SIG)
    rc = lib.selective_scan_launch(
        rt.ptr(dt), rt.ptr(x), rt.ptr(A), rt.ptr(Bt), rt.ptr(Ct),
        rt.ptr(h0), B, L, Din, N, rt.ptr(y), rt.ptr(h_last), rt.ptr(ckpt),
        CHUNK, rt.stream_handle(x.device))
    rt.count_launch("selective_scan")
    rt.check(lib, rc, "selective_scan")
    return y, h_last


def selective_scan_bwd(dt, x, A, Bt, Ct, ckpt, dy, dh_last):
    """The backward kernel: (ddt, dx, dA, dB, dC, dh0) from the forward's
    inputs, its stored states ``ckpt`` and the gradients of its outputs
    ``dy`` (B, L, Din) and ``dh_last`` (B, Din, N)."""
    B, L, Din = x.shape
    N = A.shape[1]
    rt.require(dy, "dy", torch.float32, x.device, 3)
    rt.require(dh_last, "dh_last", torch.float32, x.device, 3)
    if dy.shape != x.shape or dh_last.shape != (B, Din, N):
        raise ValueError("selective_scan_bwd: shapes disagree")
    ddt, dx = torch.empty_like(x), torch.empty_like(x)
    dB, dC = torch.empty_like(Bt), torch.empty_like(Ct)
    dA = torch.empty_like(A)
    dh0 = torch.empty_like(dh_last)
    if B * L * Din == 0:         # no step: h_last is h0
        dh0.copy_(dh_last)
        return ddt.zero_(), dx.zero_(), dA.zero_(), dB.zero_(), \
            dC.zero_(), dh0
    meta = x.device.type == "meta"
    if meta:
        blocks = -(-Din // BWD_CHANNELS)
    else:
        lib = rt.load("selective_scan_bwd", _SIG_BWD)
        blocks = lib.selective_scan_bwd_blocks(Din, N)
    part_bc = torch.empty((2, B, blocks, L, N), dtype=torch.float32,
                          device=x.device)
    part_a = torch.empty((B, Din, N), dtype=torch.float32, device=x.device)
    if meta:
        from repro_torch.launch import op_cost
        op_cost.kernel_call("selective_scan_bwd", 4 * B * L * Din * N,
                            (dt, x, A, Bt, Ct, ckpt, dy, dh_last),
                            (ddt, dx, dA, dB, dC, dh0), recall=ckpt)
        return ddt, dx, dA, dB, dC, dh0
    rc = lib.selective_scan_bwd_launch(
        rt.ptr(dt), rt.ptr(x), rt.ptr(A), rt.ptr(Bt), rt.ptr(Ct),
        rt.ptr(ckpt), CHUNK, rt.ptr(dy), rt.ptr(dh_last), B, L, Din, N,
        rt.ptr(ddt), rt.ptr(dx), rt.ptr(dA), rt.ptr(dB), rt.ptr(dC),
        rt.ptr(dh0), rt.ptr(part_bc), rt.ptr(part_a),
        rt.stream_handle(x.device))
    rt.count_launch("selective_scan_bwd")
    rt.check(lib, rc, "selective_scan_bwd")
    return ddt, dx, dA, dB, dC, dh0


class _SelectiveScan(torch.autograd.Function):
    @staticmethod
    def forward(ctx, dt, x, A, Bt, Ct, h0):
        B, L, Din = x.shape
        ckpt = torch.empty((B, -(-L // CHUNK), Din, A.shape[1]),
                           dtype=torch.float32, device=x.device)
        y, h_last = _forward(dt, x, A, Bt, Ct, h0, ckpt)
        ctx.save_for_backward(dt, x, A, Bt, Ct, ckpt)
        return y, h_last

    @staticmethod
    @once_differentiable
    def backward(ctx, dy, dh_last):
        return selective_scan_bwd(*ctx.saved_tensors, dy.contiguous(),
                                  dh_last.contiguous())


def _check(dt, x, A, Bt, Ct, h0):
    dev = x.device
    for name, t, nd in (("dt", dt, 3), ("x", x, 3), ("A", A, 2),
                        ("Bt", Bt, 3), ("Ct", Ct, 3), ("h0", h0, 3)):
        rt.require(t, name, torch.float32, dev, nd)
    B, L, Din = x.shape
    N = A.shape[1]
    if (dt.shape != x.shape or A.shape != (Din, N)
            or Bt.shape != (B, L, N) or Ct.shape != Bt.shape
            or h0.shape != (B, Din, N)):
        raise ValueError("selective_scan: shapes disagree")
    if N < 1:
        raise ValueError(f"selective_scan: d_state {N} < 1")
