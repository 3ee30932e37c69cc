"""Wrapper of the selective_scan CUDA kernel (``csrc/selective_scan.cu``).

A CPU tensor takes the plain version (``ref.py``).  A CUDA tensor
launches the kernel, counted as ``selective_scan``, or raises on what the
kernel does not take: every input must be a contiguous float32 tensor
(the Pallas wrapper casts to float32 too).  Any L and any d_state N are
taken, as by the Pallas body: the scan needs no padding, and the kernel
takes N > 64 in groups of 64 states.

The kernel has no backward yet (it comes with LM training), so a CUDA
call raises ``RuntimeError`` when grad mode is on and an input requires
grad, instead of returning outputs that silently carry no gradient.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import runtime as rt
from repro_torch.kernels.selective_scan.ref import selective_scan_ref

P, I = rt.PTR, rt.INT
_SIG = {"selective_scan_launch": (P, P, P, P, P, P, I, I, I, I, P, P, P)}


def selective_scan(dt, x, A, Bt, Ct, h0):
    """dt, x: (B, L, Din); A: (Din, N); Bt, Ct: (B, L, N); h0: (B, Din, N).
    Returns (y (B, L, Din) f32, h_last (B, Din, N) f32)."""
    if x.device.type == "cpu":
        return selective_scan_ref(dt, x, A, Bt, Ct, h0)
    _check(dt, x, A, Bt, Ct, h0)
    rt.forbid_grad("selective_scan", dt, x, A, Bt, Ct, h0)
    B, L, Din = x.shape
    N = A.shape[1]
    y = torch.empty_like(x)
    h_last = torch.empty_like(h0)
    if B * Din == 0:
        return y, h_last
    lib = rt.load("selective_scan", _SIG)
    rc = lib.selective_scan_launch(
        rt.ptr(dt), rt.ptr(x), rt.ptr(A), rt.ptr(Bt), rt.ptr(Ct),
        rt.ptr(h0), B, L, Din, N, rt.ptr(y), rt.ptr(h_last),
        rt.stream_handle(x.device))
    rt.count_launch("selective_scan")
    rt.check(lib, rc, "selective_scan")
    return y, h_last


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
