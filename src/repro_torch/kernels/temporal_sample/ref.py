"""Plain PyTorch versions of the temporal_sample kernel.

Recent: for each target with window ``[t_start, t_end)``, walk its pages
newest first (the page table lists them newest first; lanes within a
page are oldest first), collect valid in-window edges newest first and
return the first K.

Uniform: given the (N, S, C) Gumbel noise the kernel consumes, in
storage lane order, a single global top-k over all in-window candidates
(ties keep the lower storage index, as ``lax.top_k`` does).
"""
from __future__ import annotations

import torch

NULL = -1


def _candidates(page_table, page_tmin, page_tmax, pages_nbr, pages_eid,
                pages_ts, pages_valid, targets, t_end, t_start, tmask, *,
                newest_first: bool):
    """Flattened (N, S*C) candidate lanes and their in-window mask."""
    N = targets.shape[0]
    S = page_table.shape[1]
    C = pages_ts.shape[1]
    in_range = (targets >= 0) & (targets < page_table.shape[0])
    safe_t = targets.clamp(0, page_table.shape[0] - 1).long()
    pt = page_table[safe_t]                                # (N, S)
    pvalid = (pt != NULL) & (tmask & in_range)[:, None]
    ptc = pt.clamp(0, pages_ts.shape[0] - 1).long()
    p_hit = (pvalid & (page_tmin[ptc] < t_end[:, None])
             & (page_tmax[ptc] >= t_start[:, None]))

    def lanes(x):
        g = x[ptc]
        return (g.flip(-1) if newest_first else g).reshape(N, S * C)

    nbr, eid, ts, val = (lanes(x) for x in (pages_nbr, pages_eid,
                                             pages_ts, pages_valid))
    in_win = (val & p_hit.repeat_interleave(C, dim=1)
              & (ts >= t_start[:, None]) & (ts < t_end[:, None]))
    return nbr, eid, ts, in_win


def _take(order, m, nbr, eid, ts):
    g = lambda x: x.gather(1, order)
    return (torch.where(m, g(nbr), NULL), torch.where(m, g(eid), NULL),
            torch.where(m, g(ts), 0.0), m)


def _pad_lanes(k, nbr, eid, ts, in_win, score=None):
    """Degenerate tiny snapshot (S*C < k): pad with invalid lanes."""
    W = nbr.shape[1]
    if W >= k:
        return nbr, eid, ts, in_win, score
    pad = lambda x, v: torch.nn.functional.pad(x, (0, k - W), value=v)
    return (pad(nbr, NULL), pad(eid, NULL), pad(ts, 0.0),
            pad(in_win, False),
            None if score is None else pad(score, float("-inf")))


def temporal_sample_ref(page_table, page_tmin, page_tmax, pages_nbr,
                        pages_eid, pages_ts, pages_valid, targets, t_end,
                        t_start, tmask, *, k: int):
    """page_table: (N_nodes, S) int32 (newest-first page ids, -1 pad);
    pages_*: (P, C); targets: (N,) int32; t_end/t_start: (N,) f32;
    tmask: (N,) bool. Returns (nbr, eid, ts, mask) each (N, k)."""
    nbr, eid, ts, in_win = _candidates(
        page_table, page_tmin, page_tmax, pages_nbr, pages_eid, pages_ts,
        pages_valid, targets, t_end, t_start, tmask, newest_first=True)
    nbr, eid, ts, in_win, _ = _pad_lanes(k, nbr, eid, ts, in_win)
    order = torch.sort((~in_win).to(torch.uint8), dim=-1,
                       stable=True).indices[:, :k]
    return _take(order, in_win.gather(1, order), nbr, eid, ts)


def temporal_sample_uniform_ref(page_table, page_tmin, page_tmax,
                                pages_nbr, pages_eid, pages_ts,
                                pages_valid, targets, t_end, t_start,
                                tmask, noise, *, k: int):
    """Global Gumbel-top-k version of the uniform kernel. ``noise`` is
    the exact (N, S, C) array fed to the kernel (lanes in storage
    order)."""
    nbr, eid, ts, in_win = _candidates(
        page_table, page_tmin, page_tmax, pages_nbr, pages_eid, pages_ts,
        pages_valid, targets, t_end, t_start, tmask, newest_first=False)
    score = torch.where(in_win, noise.reshape(in_win.shape),
                        float("-inf"))
    nbr, eid, ts, in_win, score = _pad_lanes(k, nbr, eid, ts, in_win,
                                             score)
    top = torch.sort(score, dim=-1, descending=True, stable=True)
    order = top.indices[:, :k]
    return _take(order, top.values[:, :k] > float("-inf"), nbr, eid, ts)
