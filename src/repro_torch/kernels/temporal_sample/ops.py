"""Wrapper of the temporal_sample CUDA kernel (``csrc/temporal_sample.cu``).

Same call as the plain versions in ``ref.py`` plus the scan width: the
page table may be wider than the ``scan`` newest pages the kernel reads
(the device mirror keeps only that prefix anyway).  A CPU tensor takes
the plain version; a CUDA tensor launches the kernel or raises.  Any
fanout k is taken, as by the Pallas bodies: uniform sampling with k > 32
keeps its reservoirs in shared memory, 32 k bytes a CTA, which a block's
limit caps at several thousand.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import runtime as rt
from repro_torch.kernels.temporal_sample.ref import (
    temporal_sample_ref, temporal_sample_uniform_ref)

P, I, F = rt.PTR, rt.INT, rt.FLOAT
_SIG = {"temporal_sample_launch": (
    P, I, I, I, P, P, I, P, P, P, P, I, P, P, P, P, P, I, I, I,
    P, P, P, P, P)}
POLICIES = ("recent", "uniform")


def temporal_sample(page_table, page_tmin, page_tmax, pages_nbr, pages_eid,
                    pages_ts, pages_valid, targets, t_end, t_start, tmask,
                    *, k: int, policy: str = "recent",
                    noise: Optional[torch.Tensor] = None,
                    scan: Optional[int] = None):
    """One sampling hop for N targets. ``noise`` (N, scan, C) is required
    for ``policy="uniform"``. Returns (nbr, eid, ts, mask) each (N, k)."""
    if policy not in POLICIES:
        raise ValueError(f"unknown policy {policy!r}")
    scan = page_table.shape[1] if scan is None else int(scan)
    if policy == "uniform" and noise is None:
        raise ValueError("uniform policy needs Gumbel noise")
    if targets.device.type == "cpu":
        args = (page_table[:, :scan], page_tmin, page_tmax, pages_nbr,
                pages_eid, pages_ts, pages_valid, targets, t_end, t_start,
                tmask)
        if policy == "uniform":
            return temporal_sample_uniform_ref(*args, noise, k=k)
        return temporal_sample_ref(*args, k=k)
    return _launch(page_table, page_tmin, page_tmax, pages_nbr, pages_eid,
                   pages_ts, pages_valid, targets, t_end, t_start, tmask,
                   noise, k=k, policy=policy, scan=scan)


def _launch(page_table, page_tmin, page_tmax, pages_nbr, pages_eid,
            pages_ts, pages_valid, targets, t_end, t_start, tmask, noise,
            *, k, policy, scan):
    dev = targets.device
    rows, stride = page_table.shape
    n_pages, cap = pages_ts.shape
    n = targets.shape[0]
    for name, t, dt, nd in (
            ("page_table", page_table, torch.int32, 2),
            ("page_tmin", page_tmin, torch.float32, 1),
            ("page_tmax", page_tmax, torch.float32, 1),
            ("pages_nbr", pages_nbr, torch.int32, 2),
            ("pages_eid", pages_eid, torch.int32, 2),
            ("pages_ts", pages_ts, torch.float32, 2),
            ("pages_valid", pages_valid, torch.bool, 2),
            ("targets", targets, torch.int32, 1),
            ("t_end", t_end, torch.float32, 1),
            ("t_start", t_start, torch.float32, 1),
            ("tmask", tmask, torch.bool, 1)):
        rt.require(t, name, dt, dev, nd)
    if not (pages_nbr.shape == pages_eid.shape == pages_valid.shape
            == (n_pages, cap)) or page_tmin.shape != (n_pages,) \
            or page_tmax.shape != (n_pages,):
        raise ValueError("page arrays disagree on (P, C)")
    if not (t_end.shape == t_start.shape == tmask.shape == (n,)):
        raise ValueError("per-target arrays must all be (N,)")
    if rows < 1 or n_pages < 1 or not 1 <= scan <= stride:
        raise ValueError(f"bad extents rows={rows} pages={n_pages} "
                         f"scan={scan} stride={stride}")
    if k < 1:
        raise ValueError(f"k={k}: need 1 <= k")
    if policy == "uniform":
        rt.require(noise, "noise", torch.float32, dev, 3)
        if noise.shape != (n, scan, cap):
            raise ValueError(f"noise {tuple(noise.shape)} != "
                             f"{(n, scan, cap)}")
    out_nbr = torch.empty((n, k), dtype=torch.int32, device=dev)
    out_eid = torch.empty((n, k), dtype=torch.int32, device=dev)
    out_ts = torch.empty((n, k), dtype=torch.float32, device=dev)
    out_mask = torch.empty((n, k), dtype=torch.bool, device=dev)
    if n == 0:
        return out_nbr, out_eid, out_ts, out_mask
    lib = rt.load("temporal_sample", _SIG)
    rc = lib.temporal_sample_launch(
        rt.ptr(page_table), rows, stride, scan, rt.ptr(page_tmin),
        rt.ptr(page_tmax), n_pages, rt.ptr(pages_nbr), rt.ptr(pages_eid),
        rt.ptr(pages_ts), rt.ptr(pages_valid), cap, rt.ptr(targets),
        rt.ptr(t_end), rt.ptr(t_start), rt.ptr(tmask),
        rt.ptr(noise if policy == "uniform" else None), n, k,
        POLICIES.index(policy), rt.ptr(out_nbr), rt.ptr(out_eid),
        rt.ptr(out_ts), rt.ptr(out_mask), rt.stream_handle(dev))
    rt.count_launch(f"temporal_sample_{policy}")
    rt.check(lib, rc, f"temporal_sample[{policy}]")
    return out_nbr, out_eid, out_ts, out_mask
