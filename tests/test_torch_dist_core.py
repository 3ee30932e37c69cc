"""The distributed sampling core of the PyTorch port against the JAX
package (CPU): ``DistributedSamplerSystem`` (the static schedule),
``TemporalSampler.request_key``/``sample_hop`` and
``FeatureAssembler.collect_ids``.

* recent policy, P 4 x G 2: every (trainer machine, rank)'s k-hop layers
  identical to JAX's (ids, eids, timestamps, masks), and so are the
  load matrix and the request and response bytes;
* ``refresh`` chains SnapshotDeltas: steady-state bytes are O(batch)
  and a chained mirror samples as a fresh one;
* uniform policy: the draw is keyed by the request, not by the order in
  which a serving sampler sees requests, and every pick is an in-window
  candidate of the JAX package's ``DynamicGraph`` on the same events,
  min(K, n) of them with n counted by JAX.  The draws are the port's own
  (torch cannot replay JAX's threefry stream);
* ``collect_ids``: the same (node, edge, memory) id arrays as JAX's;
* the new modules import neither ``jax`` nor ``repro``.
"""
import subprocess
import sys
from collections import Counter

import numpy as np
import pytest

from repro.core import pipeline as JP
from repro.core.dgraph import DynamicGraph as JGraph
from repro.core.partition import Dispatcher as JDispatcher
from repro.core.partition import GraphPartition as JPartition
from repro.core.scheduler import DistributedSamplerSystem as JSystem
from repro_torch.configs.tgn_gdelt import tgn
from repro_torch.core import pipeline as TP
from repro_torch.core.dgraph import DynamicGraph
from repro_torch.core.partition import Dispatcher, GraphPartition
from repro_torch.core.sampling import TemporalSampler
from repro_torch.core.scheduler import DistributedSamplerSystem
from repro_torch.data.events import synth_ctdg

P, G = 4, 2


def _events(n=2000, nodes=200, seed=0):
    rng = np.random.default_rng(seed)
    w = rng.pareto(1.5, nodes) + 1
    p = w / w.sum()
    src = rng.choice(nodes, n, p=p)
    dst = rng.choice(nodes, n, p=p)
    ts = np.sort(rng.uniform(0, 1000.0, n))
    return src, dst, ts


def _port_system(events, *, n_parts=P, n_gpus=G, fanouts=(5, 3),
                 policy="recent", scan_pages=16, seed=0):
    parts = [GraphPartition(p, n_parts, threshold=16)
             for p in range(n_parts)]
    Dispatcher(parts, undirected=True).add_edges(*events)
    return DistributedSamplerSystem(parts, n_gpus, fanouts, policy=policy,
                                    scan_pages=scan_pages, seed=seed,
                                    device="cpu")


def _jax_system(events, *, fanouts=(5, 3)):
    parts = [JPartition(p, P, threshold=16) for p in range(P)]
    JDispatcher(parts, undirected=True).add_edges(*events)
    return JSystem(parts, G, fanouts, policy="recent", scan_pages=16)


def _layers_equal(a, b):
    for la, lb in zip(a, b, strict=True):
        for f in ("dst_nodes", "dst_times", "dst_mask", "nbr_ids",
                  "nbr_eids", "nbr_ts", "mask"):
            x, y = np.asarray(getattr(la, f)), np.asarray(getattr(lb, f))
            assert x.dtype == y.dtype, f
            np.testing.assert_array_equal(x, y, err_msg=f)


def _events32(seed):
    """Events whose times are float32 values, as the samplers' pages
    hold them, so that the JAX graph's float64 window test sees the same
    times as the kernels."""
    src, dst, ts = _events(seed=seed)
    return src, dst, ts.astype(np.float32).astype(np.float64)


def _jax_graph(events):
    g = JGraph(threshold=16, undirected=True)
    g.add_edges(*events)
    return g


def _assert_jax_candidates(g, layers, fanouts):
    """Every valid target's picks are distinct in-window candidate slots
    of the JAX graph ``g`` (ids and eids), min(K, n) of them; returns the
    number of targets with at least one candidate."""
    checked = 0
    for layer, k in zip(layers, fanouts, strict=True):
        for i in np.flatnonzero(np.asarray(layer.dst_mask)):
            cn, ce, _ = g.neighbors_in_window(
                int(layer.dst_nodes[i]), -np.inf, float(layer.dst_times[i]))
            row = np.asarray(layer.mask[i])
            got_e = np.asarray(layer.nbr_eids[i])[row].tolist()
            got_n = np.asarray(layer.nbr_ids[i])[row].tolist()
            cand = dict(zip(ce.tolist(), cn.tolist()))
            # a multiset: a self-loop is two adjacency entries, one eid
            assert not Counter(got_e) - Counter(ce.tolist()), (i, got_e)
            assert [cand[e] for e in got_e] == got_n
            assert len(got_e) == min(k, len(ce))
            checked += len(ce) > 0
    return checked


@pytest.fixture(scope="module")
def recent_pair():
    events = _events(seed=3)
    return _port_system(events), _jax_system(events)


def test_recent_schedule_matches_jax_for_every_worker(recent_pair):
    port, ref = recent_pair
    rng = np.random.default_rng(1)
    for rnd in range(2):
        for m in range(P):
            for r in range(G):
                seeds = rng.integers(-1, 205, 96)     # padding + unknowns
                ts = rng.uniform(100, 1000, 96).astype(np.float32)
                _layers_equal(port.sample(m, r, seeds, ts),
                              ref.sample(m, r, seeds, ts))
    a, b = port.load_stats(), ref.load_stats()
    np.testing.assert_array_equal(a.per_worker_targets,
                                  b.per_worker_targets)
    assert (a.request_bytes, a.response_bytes) == (b.request_bytes,
                                                   b.response_bytes)
    assert a.cv == b.cv and a.request_bytes > 0
    # one host read of an owner's hop per (worker, hop, owner) served
    assert 0 < port.syncs <= 2 * P * G * 2 * P
    port.reset_stats()
    assert port.load_stats().per_worker_targets.sum() == 0
    assert port.syncs == 0


def test_refresh_chains_deltas():
    stream = synth_ctdg(n_nodes=2000, n_events=26_000, seed=5)
    parts = [GraphPartition(p, P, threshold=16) for p in range(P)]
    disp = Dispatcher(parts, undirected=True)
    sys_ = DistributedSamplerSystem(parts, G, (4, 4), scan_pages=16,
                                    device="cpu")
    disp.add_edges(stream.src[:20_000], stream.dst[:20_000],
                   stream.ts[:20_000])
    first = sys_.refresh()          # mirror creation: full upload
    deltas = []
    for r in range(4):
        lo = 20_000 + r * 1_000
        disp.add_edges(stream.src[lo:lo + 1_000],
                       stream.dst[lo:lo + 1_000],
                       stream.ts[lo:lo + 1_000])
        deltas.append(sys_.refresh())
    deltas = deltas[1:]       # round 1 may pay a capacity growth
    assert all(0 < d < 0.35 * first for d in deltas), (first, deltas)
    assert max(deltas) < 3 * min(deltas), deltas
    for m in range(P):
        for s in sys_.samplers[m]:
            assert s._mirror.version == sys_.snaps[m].version
    assert sys_.mirror_bytes() > 0
    fresh = DistributedSamplerSystem(parts, 1, (4, 4), scan_pages=16,
                                     device="cpu")
    seeds = np.arange(64, dtype=np.int64)
    ts = np.full(64, float(stream.ts[23_999]), np.float32)
    _layers_equal(sys_.sample(0, 0, seeds, ts),
                  fresh.sample(0, 0, seeds, ts))


def test_uniform_draws_are_request_keyed():
    """Two systems, opposite service orders: bit-equal draws, each an
    in-window candidate set of JAX's graph; the per-(trainer, rank)
    request sequence advances the stream."""
    events = _events32(seed=11)
    ref = _jax_graph(events)
    rng = np.random.default_rng(2)
    seeds = {(m, r): rng.integers(0, 200, 48)
             for m in range(2) for r in range(2)}
    ts = np.full(48, 900.0, np.float32)

    def run(order):
        sys_ = _port_system(events, n_parts=2, n_gpus=2, fanouts=(4, 4),
                            policy="uniform", scan_pages=64)
        out = {}
        for rnd in range(2):
            for m, r in order:
                out[(rnd, m, r)] = sys_.sample(m, r, seeds[(m, r)], ts)
        return out

    a = run([(0, 0), (0, 1), (1, 0), (1, 1)])
    b = run([(1, 1), (1, 0), (0, 1), (0, 0)])
    checked = 0
    for key in a:
        _layers_equal(a[key], b[key])
        checked += _assert_jax_candidates(ref, a[key], (4, 4))
    assert checked > 400
    assert any(not np.array_equal(la.nbr_eids, lb.nbr_eids)
               for (m, r) in seeds
               for la, lb in zip(a[(0, m, r)], a[(1, m, r)]))


def test_request_key_is_a_pure_function_of_the_coordinate():
    g = DynamicGraph(threshold=16, undirected=True)
    g.add_edges(*_events(n=300, seed=4))
    s1 = TemporalSampler(g, (4,), policy="uniform", seed=7, device="cpu")
    s2 = TemporalSampler(g, (4,), policy="uniform", seed=7, device="cpu")
    s3 = TemporalSampler(g, (4,), policy="uniform", seed=8, device="cpu")
    s1.sample(np.arange(5), np.full(5, 500.0))    # moves s1's own stream
    assert s1.request_key(1, 2, 0) == s2.request_key(1, 2, 0)
    keys = {s2.request_key(m, q, h) for m in range(2) for q in range(3)
            for h in range(2)}
    assert len(keys) == 12 and s3.request_key(1, 2, 0) not in keys
    rec = TemporalSampler(g, (4,), policy="recent", device="cpu")
    assert rec.request_key(0, 0, 0) is None
    tg = np.arange(40) % 30
    tt = np.full(40, 900.0, np.float32)
    pm = np.ones(40, bool)
    pm[30:] = False
    k = s1.request_key(0, 3, 1)
    a = s1.sample_hop(tg, tt, pm, 4, key=k)
    b = s2.sample_hop(tg, tt, pm, 4, key=k)
    for x, y in zip(a, b):
        assert (x == y).all()
    assert not a[3][30:].any()           # masked lanes draw nothing


def test_uniform_picks_are_in_window_candidates():
    events = _events32(seed=6)
    ref = _jax_graph(events)
    sys_ = _port_system(events, fanouts=(5, 3), policy="uniform",
                        scan_pages=64)
    seeds = np.arange(120) % 200
    t = np.random.default_rng(0).uniform(200, 1000, 120).astype(np.float32)
    checked = 0
    for m in range(P):
        layers = sys_.sample(m, 1, seeds, t)
        assert np.asarray(layers[0].dst_mask).all()
        checked += _assert_jax_candidates(ref, layers, (5, 3))
    assert checked > 400


class _Memory:
    """The raw-message arrays ``collect_ids`` reads (both packages')."""

    def __init__(self, rng, n):
        self.raw_has = rng.random(n) < 0.5
        self.raw_other = rng.integers(0, n, n)
        self.raw_eid = np.where(rng.random(n) < 0.9,
                                rng.integers(0, 5000, n), -1)


def test_collect_ids_matches_jax(recent_pair):
    port, ref = recent_pair
    rng = np.random.default_rng(8)
    mem = _Memory(rng, 150)      # ids past its arrays are skipped
    cfg = tgn(d_node=8, d_edge=8, d_memory=12)
    noop = lambda ids: None
    seeds = rng.integers(0, 205, 90)
    ts = rng.uniform(100, 1000, 90).astype(np.float32)
    sampled = {"layers": port.sample(1, 0, seeds, ts)}
    for memory in (None, mem):
        want = JP.FeatureAssembler(cfg, fetch_node=noop, fetch_edge=noop,
                                   memory=memory).collect_ids(sampled)
        got = TP.FeatureAssembler(cfg, fetch_node=noop, fetch_edge=noop,
                                  memory=memory,
                                  device="cpu").collect_ids(sampled)
        for a, b in zip(got, want, strict=True):
            if b is None:
                assert a is None
            else:
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)
    assert len(got[2]) > 0


def test_dist_modules_import_neither_jax_nor_repro(subprocess_env):
    code = (
        "import sys\n"
        "import repro_torch.dist, repro_torch.dist.continuous\n"
        "import repro_torch.core.scheduler\n"
        "from repro_torch.dist import collectives, state, transport\n"
        "from repro_torch.core.sampling import TemporalSampler\n"
        "from repro_torch.core.pipeline import FeatureAssembler\n"
        "assert TemporalSampler.request_key and TemporalSampler.sample_hop\n"
        "assert FeatureAssembler.collect_ids\n"
        "bad = sorted(n for n in sys.modules if n in ('jax', 'repro') or\n"
        "             n.startswith(('jax.', 'repro.', 'jaxlib')))\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], env=subprocess_env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split()[-1] == "ok"
