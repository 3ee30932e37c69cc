"""Sampler parity of the PyTorch port against the JAX package.

Same seeded numpy events go into both packages' dynamic graphs:
* the port's plain recent hop is bit-exact against the JAX
  ``temporal_sample_ref`` and the JAX ``TemporalSampler.sample``;
* the port's uniform plain versions agree exactly with the JAX
  ``temporal_sample_uniform_ref`` under shared Gumbel noise, and with it
  and the Pallas kernel (interpret mode) in order under heavily tied
  integer noise, which pins the tie rule (lower storage index first);
* the k-hop ``uniform`` and ``window`` policies pick only oracle
  candidates, and the full min(k, n) of them, and the uniform policy
  draws every candidate about equally often;
* donated and copy-on-write mirrors equal a fresh upload after
  interleaved adds and deletes, and a pinned copy-on-write dict is
  unchanged by later deltas.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.dgraph import DynamicGraph as JGraph
from repro.core.sampling import TemporalSampler as JSampler
from repro.core.snapshot import build_snapshot as j_build
from repro.kernels.temporal_sample.ref import (
    temporal_sample_ref as j_recent_ref,
    temporal_sample_uniform_ref as j_uniform_ref)
from repro.kernels.temporal_sample.temporal_sample import (
    temporal_sample_kernel as j_pallas_kernel)
from repro_torch.core.dgraph import NULL, DynamicGraph
from repro_torch.core.rand import gumbel_noise
from repro_torch.core.sampling import (DeviceMirror, TemporalSampler,
                                       _hop_plain, oracle_sample,
                                       sample_khop)
from repro_torch.core.snapshot import build_snapshot, refresh_snapshot
from repro_torch.kernels.temporal_sample.ops import temporal_sample


def _events(n_events=500, n_nodes=30, seed=0):
    rng = np.random.default_rng(seed)
    src = rng.zipf(1.6, n_events) % n_nodes
    dst = rng.integers(0, n_nodes, n_events)
    ts = np.sort(rng.uniform(0, 1000.0, n_events))
    return src, dst, ts


def _graphs(events, tau=8):
    gj = JGraph(threshold=tau, min_block=2, undirected=True)
    gt = DynamicGraph(threshold=tau, min_block=2, undirected=True)
    for g in (gj, gt):
        g.add_edges(*events)
    return gj, gt


def _query(n, seed):
    rng = np.random.default_rng(seed)
    targets = rng.integers(-2, n + 3, 3 * n).astype(np.int32)  # + out of range
    t_end = rng.uniform(100, 1100, len(targets)).astype(np.float32)
    t_start = np.where(rng.random(len(targets)) < 0.5, -np.inf,
                       t_end - 300).astype(np.float32)
    tmask = rng.random(len(targets)) < 0.9
    return targets, t_end, t_start, tmask


def _snap_args(snap):
    return (snap.page_table, snap.page_tmin, snap.page_tmax, snap.nbr,
            snap.eid, snap.ts, snap.valid)


@pytest.mark.parametrize("seed,k", [(0, 5), (1, 12), (2, 3)])
def test_recent_hop_bit_exact_against_jax_ref(seed, k):
    gj, gt = _graphs(_events(seed=seed))
    sj, st = j_build(gj), build_snapshot(gt)
    for a, b in zip(_snap_args(sj), _snap_args(st)):
        np.testing.assert_array_equal(a, b)
    q = _query(gt.n_nodes, seed)
    want = j_recent_ref(*(jnp.asarray(a) for a in _snap_args(sj)),
                        *(jnp.asarray(a) for a in q), k=k)
    targs = [torch.from_numpy(np.array(a)) for a in _snap_args(st) + q]
    got_ref = temporal_sample(*targs, k=k, policy="recent")
    mirror = DeviceMirror(scan_pages=st.page_table.shape[1], device="cpu")
    dev = mirror.sync(st)
    got_hop = _hop_plain(dev, *targs[7:], None, k=k, policy="recent",
                         scan_pages=st.page_table.shape[1])
    for got in (got_ref, got_hop):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("seed,k", [(3, 5), (4, 9), (6, 50)])
def test_uniform_exact_against_jax_ref_under_shared_noise(seed, k):
    gj, gt = _graphs(_events(seed=seed))
    sj, st = j_build(gj), build_snapshot(gt)
    q = _query(gt.n_nodes, seed)
    S, C = st.page_table.shape[1], st.ts.shape[1]
    noise = gumbel_noise(torch.Generator().manual_seed(seed),
                         (len(q[0]), S, C), "cpu")
    want = j_uniform_ref(*(jnp.asarray(a) for a in _snap_args(sj)),
                         *(jnp.asarray(a) for a in q),
                         jnp.asarray(noise.numpy()), k=k)
    targs = [torch.from_numpy(np.array(a)) for a in _snap_args(st) + q]
    got = temporal_sample(*targs, k=k, policy="uniform", noise=noise)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # the sampler's plain hop draws the same candidates from the same noise
    dev = DeviceMirror(scan_pages=S, device="cpu").sync(st)
    hop = _hop_plain(dev, *targs[7:], noise, k=k, policy="uniform",
                     scan_pages=S)
    m = got[3].numpy()
    np.testing.assert_array_equal(hop[3].numpy(), m)
    for g, h in zip(got[:3], hop[:3]):
        np.testing.assert_array_equal(np.sort(g.numpy(), 1),
                                      np.sort(h.numpy(), 1))


@pytest.mark.parametrize("seed,k", [(3, 5), (4, 9), (5, 10), (7, 50)])
def test_uniform_tied_noise_same_order_as_jax_ref_and_pallas(seed, k):
    """Integer noise in 0-3 ties most candidates: the port, the JAX
    oracle and the Pallas kernel must still pick the same neighbours in
    the same order (score descending, lower storage index first)."""
    gj, gt = _graphs(_events(seed=seed))
    sj, st = j_build(gj), build_snapshot(gt)
    q = _query(gt.n_nodes, seed)
    S, C = st.page_table.shape[1], st.ts.shape[1]
    noise = np.random.default_rng(seed).integers(
        0, 4, (len(q[0]), S, C)).astype(np.float32)
    targs = [torch.from_numpy(np.array(a)) for a in _snap_args(st) + q]
    got = temporal_sample(*targs, k=k, policy="uniform",
                          noise=torch.from_numpy(noise))
    jargs = [jnp.asarray(a) for a in _snap_args(sj)]
    targets, t_end, t_start, tmask = (jnp.asarray(a) for a in q)
    want = j_uniform_ref(*jargs, targets, t_end, t_start, tmask,
                         jnp.asarray(noise), k=k)
    # the Pallas kernel as its wrapper drives it, with this noise
    pt = np.asarray(sj.page_table)
    live = q[3] & (q[0] >= 0) & (q[0] < pt.shape[0])
    rows = np.where(live[:, None], pt[np.clip(q[0], 0, pt.shape[0] - 1)],
                    NULL).astype(np.int32)
    nbr, eid, ts, cnt = j_pallas_kernel(
        jnp.asarray(rows), *jargs[1:], jnp.stack([t_start, t_end], axis=1),
        tmask, k=k, policy="uniform", noise=jnp.asarray(noise))
    m = np.arange(k)[None, :] < np.asarray(cnt)[:, :1]
    pallas = (np.where(m, nbr, NULL), np.where(m, eid, NULL),
              np.where(m, ts, 0.0), m)
    assert m.sum() > 0 and (m.sum(1) == k).any()
    for name, g, w, p in zip(("nbr", "eid", "ts", "mask"), got, want,
                             pallas):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                      err_msg=name)
        np.testing.assert_array_equal(g.numpy(), p, err_msg=name)


@pytest.mark.parametrize("fanouts", [(4,), (5, 3)])
def test_recent_khop_bit_exact_against_jax_sampler(fanouts):
    events = _events(n_events=600, n_nodes=40, seed=7)
    gj, gt = _graphs(events)
    seeds = np.arange(-1, 42, dtype=np.int64)
    ts = np.random.default_rng(1).uniform(300, 1100, len(seeds))
    want = JSampler(gj, fanouts=fanouts, policy="recent",
                    scan_pages=8).sample(seeds, ts)
    got = TemporalSampler(gt, fanouts=fanouts, policy="recent",
                          scan_pages=8, device="cpu").sample(seeds, ts)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for f in ("dst_nodes", "dst_times", "dst_mask", "nbr_ids",
                  "nbr_eids", "nbr_ts", "mask"):
            np.testing.assert_array_equal(getattr(g, f).numpy(),
                                          np.asarray(getattr(w, f)),
                                          err_msg=f)


@pytest.mark.parametrize("policy", ["uniform", "window"])
def test_stochastic_khop_picks_only_oracle_candidates(policy):
    """The oracle-containment check of the JAX sampler tests: every
    sampled (eid, nbr) is an in-window candidate, and a target gets the
    full min(k, n_candidates) of them."""
    _, gt = _graphs(_events(n_events=400, n_nodes=30, seed=6))
    window = 80.0 if policy == "window" else 0.0
    seeds = np.arange(gt.n_nodes, dtype=np.int64)
    k = 5
    dev = DeviceMirror(scan_pages=64, device="cpu").sync(build_snapshot(gt))
    gen = torch.Generator().manual_seed(5)
    [layer, deeper] = sample_khop(dev, seeds, np.full(len(seeds), 800.0),
                                  fanouts=(k, 3), policy=policy,
                                  window=window, scan_pages=64,
                                  generator=gen)
    nbr, eid, msk = (layer.nbr_ids.numpy(), layer.nbr_eids.numpy(),
                     layer.mask.numpy())
    t_lo = 800.0 - window if policy == "window" else -np.inf
    for i, v in enumerate(seeds):
        cn, ce, _ = gt.neighbors_in_window(int(v), t_lo, 800.0)
        got = set(zip(eid[i][msk[i]].tolist(), nbr[i][msk[i]].tolist()))
        assert got <= set(zip(ce.tolist(), cn.tolist()))
        assert msk[i].sum() == min(k, len(cn))
    # hop 1 queries hop 0's neighbours at their edge times
    np.testing.assert_array_equal(deeper.dst_nodes.numpy(), nbr.reshape(-1))
    np.testing.assert_array_equal(deeper.dst_mask.numpy(), msk.reshape(-1))


def test_uniform_is_actually_uniform():
    """The distribution check of the JAX sampler tests: over 200 seeds,
    every one of 20 candidates is drawn and none more than 2.5x the
    mean."""
    g = DynamicGraph(threshold=8)
    g.add_edges(np.zeros(20, np.int64), np.arange(20),
                np.arange(20, dtype=float))
    snap = build_snapshot(g)
    counts = np.zeros(20)
    for s in range(200):
        smp = TemporalSampler(snap, fanouts=(5,), policy="uniform", seed=s,
                              scan_pages=16, device="cpu")
        [layer] = smp.sample(np.array([0]), np.array([100.0]))
        picked = layer.nbr_ids.numpy()[0][layer.mask.numpy()[0]]
        assert len(picked) == 5
        np.add.at(counts, picked, 1)
    assert (counts > 0).all()
    assert counts.max() / counts.mean() < 2.5


def _assert_mirror_equals_fresh(dev, g, page_cap):
    fresh = build_snapshot(g, page_cap=page_cap)
    nb, n = fresh.n_pages, fresh.n_live
    pt = dev["page_table"].numpy()
    w = min(pt.shape[1], fresh.page_table.shape[1])
    np.testing.assert_array_equal(pt[:n, :w], fresh.page_table[:n, :w])
    assert (pt[:n, w:] == NULL).all() and (pt[n:] == NULL).all()
    v = fresh.valid[:nb]
    np.testing.assert_array_equal(dev["pages_valid"].numpy()[:nb], v)
    np.testing.assert_array_equal(dev["page_tmin"].numpy()[:nb],
                                  fresh.page_tmin[:nb])
    np.testing.assert_array_equal(dev["page_tmax"].numpy()[:nb],
                                  fresh.page_tmax[:nb])
    for name, host in (("pages_nbr", fresh.nbr), ("pages_eid", fresh.eid),
                       ("pages_ts", fresh.ts)):
        np.testing.assert_array_equal(dev[name].numpy()[:nb][v],
                                      host[:nb][v], err_msg=name)


@pytest.mark.parametrize("donate,quantize", [(True, False), (False, True)])
@pytest.mark.parametrize("seed", [0, 1])
def test_mirror_deltas_equal_fresh_upload(donate, quantize, seed):
    rng = np.random.default_rng(seed)
    g = DynamicGraph(threshold=8, min_block=2, undirected=bool(seed % 2))
    mirror = DeviceMirror(scan_pages=4, donate=donate, quantize=quantize,
                          device="cpu")
    snap, t, pinned = None, 0.0, []
    for r in range(7):
        n_ev = int(rng.integers(20, 100))
        nmax = 30 + 10 * r
        ts = np.sort(rng.uniform(t, t + 100, n_ev))
        t += 100.0
        g.add_edges(rng.integers(0, nmax, n_ev), rng.integers(0, nmax, n_ev),
                    ts)
        if r % 3 == 1:
            live = np.unique(g.eid[:g.arena_used][g.valid[:g.arena_used]])
            g.delete_edges(rng.choice(live, size=min(7, len(live)),
                                      replace=False))
        snap = build_snapshot(g) if snap is None else refresh_snapshot(g, snap)
        dev = mirror.sync(snap)
        _assert_mirror_equals_fresh(dev, g, snap.page_cap)
        if not donate:
            pinned.append((dev, {k: v.clone() for k, v in dev.items()}))
    assert r == 6 and mirror.total_refresh_bytes > 0
    # copy-on-write: every dict handed out still holds its own version
    for dev, copy in pinned:
        for name in copy:
            assert torch.equal(dev[name], copy[name]), name


def test_pinned_cow_dict_samples_identically_after_later_deltas():
    src, dst, ts = _events(n_events=300, n_nodes=40, seed=3)
    g = DynamicGraph(threshold=8, undirected=True)
    g.add_edges(src[:100], dst[:100], ts[:100])
    snap = build_snapshot(g)
    mirror = DeviceMirror(scan_pages=16, donate=False, quantize=True,
                          device="cpu")
    old = mirror.sync(snap)
    seeds = np.arange(12)
    t_hi = np.full(12, 2000.0, np.float32)
    before = sample_khop(old, seeds, t_hi, fanouts=(4,))[0]
    for lo in (100, 150, 200, 250):
        g.add_edges(src[lo:lo + 50], dst[lo:lo + 50], ts[lo:lo + 50])
        snap = refresh_snapshot(g, snap)
        new = mirror.sync(snap)
    after = sample_khop(old, seeds, t_hi, fanouts=(4,))[0]
    for f in ("nbr_ids", "nbr_ts", "mask"):
        assert torch.equal(getattr(before, f), getattr(after, f))
    newest = sample_khop(new, seeds, t_hi, fanouts=(4,))[0]
    assert int(newest.mask.sum()) >= int(before.mask.sum())
    assert new is not old
    [want] = oracle_sample(g, seeds, t_hi.astype(np.float64), (4,))
    np.testing.assert_array_equal(newest.mask.numpy(), want.mask)
