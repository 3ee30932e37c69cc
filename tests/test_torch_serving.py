"""Serving parity of the PyTorch port against the JAX package.

The JAX ``QueryEngine`` and the port's ``QueryEngine`` (on the CPU) are
wired the same way — no trainer: each ingested batch goes through
``add_edges``, the state puts, ``build_snapshot``/``refresh_snapshot``
and ``on_publish`` — over one seeded stream, one state and the same
weights (``params_from_jax``).  With ``recent`` sampling, for tgat and
for tgn (memory rows put from seeded numpy), served link scores and
embeddings agree within 1e-4 and hop-0 neighbourhoods exactly; the
port's served answers match its own ``offline_forward``; the EdgeBank
tier answers as the JAX bank does; and queries racing an ingest each
match the version they pinned.
"""
import threading
import time

import jax
import numpy as np
import pytest

from repro.configs import tgn_gdelt as JC
from repro.core.dgraph import DynamicGraph as JGraph
from repro.core.feature_store import ReplicatedStateService as JState
from repro.core.snapshot import build_snapshot as j_build
from repro.core.snapshot import refresh_snapshot as j_refresh
from repro.data.events import synth_ctdg as j_synth
from repro.models import gnn as G
from repro.serve import EdgeBank as JBank
from repro.serve import HandlePublisher as JPub
from repro.serve import QueryEngine as JEngine
from repro_torch.configs import tgn_gdelt as TC
from repro_torch.core.dgraph import DynamicGraph
from repro_torch.core.feature_store import ReplicatedStateService
from repro_torch.core.snapshot import build_snapshot, refresh_snapshot
from repro_torch.data.events import synth_ctdg
from repro_torch.models.convert import params_from_jax
from repro_torch.serve import EdgeBank, HandlePublisher, QueryEngine

TOL = 1e-4
N_NODES, N_EVENTS, CHUNK = 50, 300, 100
SMALL = dict(d_node=6, d_edge=5, d_time=4, d_hidden=8, d_memory=6,
             sampling="recent")


class _Owner:
    def __init__(self, params):
        self.params = params


class _Side:
    """One package's serving stack, fed by the trainer's ingest order."""

    def __init__(self, pkg, cfg, params, **kw):
        graph, state, pub, eng, synth, self._build, self._refresh = pkg
        self.stream = synth(n_nodes=N_NODES, n_events=N_EVENTS,
                            d_node=cfg.d_node, d_edge=cfg.d_edge, seed=5)
        self.g = graph(threshold=8, undirected=True)
        self.state = state(1, d_node=cfg.d_node, d_edge=cfg.d_edge,
                           d_memory=cfg.d_memory if cfg.use_memory else 0)
        self.eng = eng(pub(**kw.pop("pub_kw", {})), cfg=cfg,
                       state=self.state, max_batch=8,
                       record_neighbors=True, **kw)
        self.owner = _Owner(params)
        self.snap = None

    def ingest(self, lo, hi):
        batch = self.stream.slice(lo, hi)
        eids = self.g.add_edges(batch.src, batch.dst, batch.ts)
        nodes = np.unique(np.concatenate([batch.src, batch.dst]))
        self.state.put_node_feats(nodes, batch.node_features(nodes))
        uniq = np.unique(eids)
        self.state.register_edges(uniq, np.zeros_like(uniq))
        self.state.put_edge_feats(uniq, batch.edge_features(uniq))
        self.snap = (self._build(self.g) if self.snap is None
                     else self._refresh(self.g, self.snap))
        self.eng.on_publish(self.owner, self.snap, batch, nodes, uniq)


JAX = (JGraph, JState, JPub, JEngine, j_synth, j_build, j_refresh)
PORT = (DynamicGraph, ReplicatedStateService,
        lambda **kw: HandlePublisher(device="cpu", **kw),
        lambda *a, **kw: QueryEngine(*a, device="cpu", **kw), synth_ctdg,
        build_snapshot, refresh_snapshot)


def _pair(model, **kw):
    cfg = getattr(JC, model)(**SMALL)
    tcfg = getattr(TC, model)(**SMALL)
    jparams = G.init_params(cfg, jax.random.PRNGKey(1))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams),
                              device="cpu")
    js = _Side(JAX, cfg, jparams, **dict(kw))
    ts = _Side(PORT, tcfg, tparams, **dict(kw))
    if cfg.use_memory:
        rng = np.random.default_rng(2)
        mem = rng.normal(size=(N_NODES, cfg.d_memory)).astype(np.float32)
        t_mem = rng.uniform(0, 10, N_NODES)
        for side in (js, ts):
            side.state.put_memory(np.arange(N_NODES), mem, t_mem)
    return js, ts


def _queries(rng, n, t_q):
    return [(rng.integers(0, N_NODES, 3), rng.integers(0, N_NODES, 3),
             np.full(3, t_q, np.float32)) for _ in range(n)]


@pytest.mark.parametrize("model", ["tgat", "tgn"])
def test_port_engine_matches_jax_engine(model):
    js, ts = _pair(model)
    for lo in range(0, N_EVENTS, CHUNK):
        js.ingest(lo, lo + CHUNK)
        ts.ingest(lo, lo + CHUNK)
    t_q = float(ts.stream.ts.max()) + 1.0
    rng = np.random.default_rng(0)
    links = _queries(rng, 5, t_q)
    embeds = [(rng.integers(0, N_NODES, 2), np.full(2, t_q, np.float32))
              for _ in range(3)]
    with js.eng, ts.eng:
        jf = [js.eng.submit_link(*q) for q in links] + \
             [js.eng.submit_embed(*q) for q in embeds]
        tf = [ts.eng.submit_link(*q) for q in links] + \
             [ts.eng.submit_embed(*q) for q in embeds]
        jr = [f.result(60) for f in jf]
        tr = [f.result(60) for f in tf]
    for i, (a, b) in enumerate(zip(jr, tr)):
        assert a.version == b.version and b.tier == "gnn"
        for key in ("ids", "mask", "ts") + (("dst_ids", "dst_mask")
                                            if i < len(links) else ()):
            np.testing.assert_array_equal(b.nbrs[key], a.nbrs[key],
                                          err_msg=key)
        if i < len(links):
            np.testing.assert_allclose(b.scores, a.scores, atol=TOL, rtol=0)
            off = ts.eng.offline_forward(b.version, *links[i])
            np.testing.assert_allclose(b.scores, off, atol=TOL, rtol=0)
        else:
            q = embeds[i - len(links)]
            assert b.emb.shape == (2, ts.eng.cfg.d_hidden)
            np.testing.assert_allclose(b.emb, a.emb, atol=TOL, rtol=0)
            off = ts.eng.offline_forward(b.version, q[0], ts=q[1])
            np.testing.assert_allclose(b.emb, off, atol=TOL, rtol=0)
    # both engines cached the same rows under the same padded traffic
    assert ts.eng.node_cache.contents() == js.eng.node_cache.contents()
    assert ts.eng.edge_cache.contents() == js.eng.edge_cache.contents()


def test_edgebank_tier_answers_like_jax():
    js, ts = _pair("tgat", edgebank=None, saturate_depth=0)
    js.eng.edgebank, ts.eng.edgebank = JBank(), EdgeBank()
    for side in (js, ts):
        side.ingest(0, 200)
    u, v = int(ts.stream.src[0]), int(ts.stream.dst[0])
    q = ([u, 49, 3], [v, 48, 7], np.full(3, 500.0, np.float32))
    a = js.eng.query_link(*q)
    b = ts.eng.query_link(*q)
    assert a.tier == b.tier == "edgebank"
    np.testing.assert_array_equal(b.scores, a.scores)
    assert b.scores[0] == 1.0 and b.version == a.version
    assert ts.eng.metrics.counter("serve.fallback").value == 1


def test_queries_racing_ingest_match_their_pinned_version():
    _, ts = _pair("tgat", pub_kw=dict(history=16))
    ts.ingest(0, CHUNK)
    t_q = float(ts.stream.ts.max()) + 1.0
    rng = np.random.default_rng(3)
    with ts.eng:
        ts.eng.query_embed([0, 1], np.full(2, t_q, np.float32))
        th = threading.Thread(
            target=lambda: [ts.ingest(lo, lo + 20)
                            for lo in range(CHUNK, N_EVENTS, 20)])
        pending = []
        th.start()
        while th.is_alive() or len(pending) < 12:
            if ts.eng.queue.depth < 32:      # don't outrun the worker
                q = _queries(rng, 1, t_q)[0]
                pending.append((q, ts.eng.submit_link(*q)))
            time.sleep(0.001)
        th.join(60)
        assert not th.is_alive()
        results = [(q, f.result(60)) for q, f in pending]
    assert {r.version for _, r in results} <= set(ts.eng.publisher.versions())
    for q, r in results:
        off = ts.eng.offline_forward(r.version, *q)
        np.testing.assert_allclose(r.scores, off, atol=TOL, rtol=0)
