"""The port's ``ShardedStateService`` and ``LocalTransport`` against the
JAX package's (CPU), and the port twins of the in-process tests of
``tests/test_state_service.py``.

* JAX's service and the port's, each as two single-shard services glued
  by a ``LocalTransport`` (writes to the peer go over the transport
  too), take the same random interleaving of puts, edge registrations
  and gets: every read identical, and so are the wire accounting and
  the resident bytes;
* sharded == replicated with every partition hosted; ~1/P resident
  bytes with one hosted; the coalesced ``state_batch`` equals the
  per-table ops; repeated ids are deduped before the wire; a prefetch
  serves the reads without new round trips; ``memory_staleness`` bounds
  buffered memory reads; a prefetch thread's error clears the staging
  buffer and is re-raised at the next entry point;
* a stress test: 12 client threads with their prefetch threads against
  two shared owners, every read exact and no served call uncounted.
"""
import numpy as np
import pytest

from repro.dist.state import ShardedStateService as JSharded
from repro.dist.transport import LocalTransport as JLocal
from repro_torch.core.feature_store import ReplicatedStateService
from repro_torch.dist.state import (ShardedStateService, pack_state_batch,
                                    unpack_state_batch)
from repro_torch.dist.transport import (OPS, STATS_KEYS, LocalTransport,
                                        SamplingTransport, transport_stats)

P = 2
D_NODE, D_EDGE, D_MEMORY = 6, 4, 5
N_IDS = 64


def _apply_ops(services, rng, n_ids=64, n_ops=30):
    """Drive the SAME random interleaved op sequence through every
    service; reads of every service identical after every op."""
    registered = np.zeros(0, np.int64)
    for _ in range(n_ops):
        kind = rng.integers(0, 7)
        ids = np.unique(rng.integers(0, n_ids, rng.integers(1, 12)))
        if kind == 0:
            vals = rng.normal(size=(len(ids), D_NODE)).astype(np.float32)
            for s in services:
                s.put_node_feats(ids, vals)
        elif kind == 1:
            src = rng.integers(0, n_ids, len(ids))
            fresh = ids[~np.isin(ids, registered)]
            for s in services:
                s.register_edges(ids, src)
            registered = np.union1d(registered, fresh)
        elif kind == 2 and len(registered):
            eids = np.unique(rng.choice(registered, rng.integers(1, 8)))
            vals = rng.normal(size=(len(eids), D_EDGE)).astype(np.float32)
            for s in services:
                s.put_edge_feats(eids, vals)
        elif kind == 3:
            mem = rng.normal(size=(len(ids), D_MEMORY)).astype(np.float32)
            ts = rng.uniform(0, 100, len(ids))
            for s in services:
                s.put_memory(ids, mem, ts)
        probe = np.concatenate([[-1], rng.integers(0, n_ids, 8)])
        for read in (lambda s: s.get_node_feats(probe),
                     lambda s: s.get_edge_feats(probe),
                     lambda s: s.get_memory(probe)[0],
                     lambda s: s.get_memory(probe)[1]):
            outs = [read(s) for s in services]
            for o in outs[1:]:
                assert o.dtype == outs[0].dtype
                np.testing.assert_array_equal(outs[0], o)


def _pair(cls, transport_cls, **kw):
    t = transport_cls()
    svc = {}
    for p in range(P):
        svc[p] = cls(P, d_node=D_NODE, d_edge=D_EDGE, d_memory=D_MEMORY,
                     hosted=(p,), transport=t, local_rank=p, **kw)
        t.bind_state(svc[p])
    return svc, t


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_sharded_service_matches_jax_over_a_local_transport(seed):
    port, _ = _pair(ShardedStateService, LocalTransport, spmd_writes=False)
    ref, _ = _pair(JSharded, JLocal, spmd_writes=False)
    rng = np.random.default_rng(seed)
    _apply_ops((ref[0], port[0], ref[1], port[1]), rng)
    for p in range(P):
        a, b = port[p].stats(), ref[p].stats()
        for k in ("calls", "bytes", "wire_calls", "wire_bytes",
                  "served_calls", "baseline_trips", "dedup_saved_bytes",
                  "pf_hits", "pf_misses", "wire_bytes_per_part",
                  "resident_bytes"):
            assert a[k] == b[k], k
    assert port[0].stats()["wire_calls"] > 0


def test_sharded_equals_replicated_in_process():
    rep = ReplicatedStateService(4, d_node=D_NODE, d_edge=D_EDGE,
                                 d_memory=D_MEMORY)
    shd = ShardedStateService(4, d_node=D_NODE, d_edge=D_EDGE,
                              d_memory=D_MEMORY)
    _apply_ops((rep, shd), np.random.default_rng(0))
    assert rep.resident_bytes() == shd.resident_bytes()
    assert shd.stats()["mode"] == "sharded"


def test_sharded_resident_bytes_are_one_over_p():
    n_parts, d_node, d_edge, d_memory = 4, 8, 6, 5
    rep = ReplicatedStateService(n_parts, d_node=d_node, d_edge=d_edge,
                                 d_memory=d_memory)
    shd = ShardedStateService(n_parts, d_node=d_node, d_edge=d_edge,
                              d_memory=d_memory, hosted=(1,), local_rank=1)
    full = ShardedStateService(n_parts, d_node=d_node, d_edge=d_edge,
                               d_memory=d_memory)
    rng = np.random.default_rng(3)
    ids = np.arange(400)
    feats = rng.normal(size=(400, d_node)).astype(np.float32)
    mem = rng.normal(size=(400, d_memory)).astype(np.float32)
    eids = np.arange(300)
    src = rng.integers(0, 400, 300)
    ef = rng.normal(size=(300, d_edge)).astype(np.float32)
    for s in (rep, shd, full):
        s.put_node_feats(ids, feats)
        s.register_edges(eids, src)
        s.put_edge_feats(eids, ef)
        s.put_memory(ids, mem, np.arange(400, dtype=np.float64))
    ratio = shd.resident_bytes() / rep.resident_bytes()
    assert 0.15 <= ratio <= 0.35, ratio
    # one machine's shard of an all-hosted service is that machine's
    assert full.shard_bytes(1) == shd.resident_bytes()
    assert sum(full.shard_bytes(p) for p in range(n_parts)) == \
        full.resident_bytes() == rep.resident_bytes()
    own = ids[ids % n_parts == 1]
    np.testing.assert_array_equal(shd.get_node_feats(own),
                                  rep.get_node_feats(own))
    m_s, t_s = shd.get_memory(own)
    m_r, t_r = rep.get_memory(own)
    np.testing.assert_array_equal(m_s, m_r)
    np.testing.assert_array_equal(t_s, t_r)


def _populated_pair():
    lt = LocalTransport()
    svc = {}
    for p in range(P):
        svc[p] = ShardedStateService(
            P, d_node=D_NODE, d_edge=D_EDGE, d_memory=D_MEMORY,
            hosted=(p,), transport=lt, local_rank=p)
        lt.bind_state(svc[p])
    ref = ReplicatedStateService(P, d_node=D_NODE, d_edge=D_EDGE,
                                 d_memory=D_MEMORY)
    rng = np.random.default_rng(42)
    ids = np.arange(N_IDS)
    nf = rng.normal(size=(N_IDS, D_NODE)).astype(np.float32)
    eids = np.arange(48)
    src = rng.integers(0, N_IDS, 48)
    ef = rng.normal(size=(48, D_EDGE)).astype(np.float32)
    mem = rng.normal(size=(N_IDS, D_MEMORY)).astype(np.float32)
    mts = rng.uniform(0, 50, N_IDS)
    for s in (ref, svc[0], svc[1]):
        s.put_node_feats(ids, nf)
        s.register_edges(eids, src)
        s.put_edge_feats(eids, ef)
        s.put_memory(ids, mem, mts)
    return lt, svc, ref, eids


@pytest.mark.parametrize("seed", range(6))
def test_state_batch_matches_per_table_ops(seed):
    t, svc, ref, eids_all = _populated_pair()
    rng = np.random.default_rng(seed)
    caller, peer = svc[0], 1

    def draw(table, pool):
        k = int(rng.integers(0, 10))
        sub = (rng.choice(pool, k).astype(np.int64) if k
               else np.zeros(0, np.int64))
        return sub[caller.owners(table, sub) == peer]

    nids = draw("node", np.arange(N_IDS))
    peids = draw("edge", eids_all)
    mids = draw("memory", np.arange(N_IDS))
    payload = pack_state_batch(nids, peids, mids)
    assert unpack_state_batch((None,) * 4) == (None,) * 4
    nf, ef, mem, ts = unpack_state_batch(t.state_batch(peer, *payload))
    if len(nids):
        np.testing.assert_array_equal(nf, t.feat_get(peer, "node", nids))
        np.testing.assert_array_equal(nf, ref.get_node_feats(nids))
    else:
        assert nf is None and payload[0] is None
    if len(peids):
        np.testing.assert_array_equal(ef, t.feat_get(peer, "edge", peids))
        np.testing.assert_array_equal(ef, ref.get_edge_feats(peids))
    else:
        assert ef is None and payload[1] is None
    if len(mids):
        m_w, t_w = t.mem_get(peer, mids)
        np.testing.assert_array_equal(mem, m_w)
        np.testing.assert_array_equal(ts, t_w)
        m_r, t_r = ref.get_memory(mids)
        np.testing.assert_array_equal(mem, m_r)
        np.testing.assert_array_equal(ts, t_r)
    else:
        assert mem is None and ts is None and payload[2] is None


def test_repeated_ids_dedup_before_wire():
    _, svc, ref, _ = _populated_pair()
    s0 = svc[0]
    base = s0.stats()
    ids = np.full(10, 1, np.int64)      # node 1: owner = partition 1
    np.testing.assert_array_equal(s0.get_node_feats(ids),
                                  ref.get_node_feats(ids))
    st = s0.stats()
    assert st["wire_calls"] - base["wire_calls"] == 1
    assert st["wire_bytes"] - base["wire_bytes"] == 8 + D_NODE * 4
    assert st["dedup_saved_bytes"] - base["dedup_saved_bytes"] \
        == 9 * (8 + D_NODE * 4)


def test_prefetch_serves_reads_without_new_round_trips():
    _, svc, ref, eids_all = _populated_pair()
    s0 = svc[0]
    nodes = np.arange(N_IDS)
    r_nodes = nodes[s0.remote_mask("node", nodes)]
    r_eids = eids_all[s0.remote_mask("edge", eids_all)]
    assert s0.prefetch_async(node_ids=r_nodes, eids=r_eids,
                             mem_ids=r_nodes) == 1   # ONE frame: peer 1
    nf = s0.get_node_feats(r_nodes)
    ef = s0.get_edge_feats(r_eids)
    mem, ts = s0.get_memory(r_nodes)
    st = s0.stats()
    assert st["round_trips"] == 1 and st["pf_misses"] == 0
    assert st["pf_hits"] == 2 * len(r_nodes) + len(r_eids)
    np.testing.assert_array_equal(nf, ref.get_node_feats(r_nodes))
    np.testing.assert_array_equal(ef, ref.get_edge_feats(r_eids))
    m_r, t_r = ref.get_memory(r_nodes)
    np.testing.assert_array_equal(mem, m_r)
    np.testing.assert_array_equal(ts, t_r)
    assert len(s0.pf_filter_new("node", r_nodes)) == 0
    s0.pf_reset()
    assert len(s0.pf_filter_new("node", r_nodes)) == len(r_nodes)


@pytest.mark.parametrize("staleness", [0, 1])
def test_memory_staleness_bounds_buffered_reads(staleness):
    lt = LocalTransport()
    svc = {}
    for p in range(P):
        svc[p] = ShardedStateService(
            P, d_node=4, d_edge=4, d_memory=3, hosted=(p,), transport=lt,
            local_rank=p, spmd_writes=False, memory_staleness=staleness)
        lt.bind_state(svc[p])
    s0 = svc[0]
    ids = np.arange(8)
    rid = np.array([1])                 # owner = partition 1: remote

    def commit(val, t):
        s0.put_memory(ids, np.full((8, 3), val, np.float32),
                      np.full(8, t, np.float64))

    commit(1.0, 1.0)
    s0.prefetch_async(mem_ids=rid)      # buffered @ version 1
    assert s0.get_memory(rid)[0][0, 0] == 1.0
    commit(2.0, 2.0)                    # the buffer is now 1 commit old
    m, _ = s0.get_memory(rid)
    if staleness == 0:
        assert m[0, 0] == 2.0 and s0.stats()["stale_served"] == 0
    else:
        assert m[0, 0] == 1.0 and s0.stats()["stale_served"] == 1
        commit(3.0, 3.0)                # 2 commits old > bound: refetch
        assert s0.get_memory(rid)[0][0, 0] == 3.0
        assert s0.get_memory(rid)[0][0, 0] == 3.0


class _FlakyTransport(LocalTransport):
    """``state_batch`` dies for the machines in ``fail_machines``."""

    def __init__(self):
        super().__init__()
        self.fail_machines = set()

    def state_batch(self, machine, node_ids, eids, mem_ids):
        if machine in self.fail_machines:
            raise ConnectionError(f"peer {machine} went away")
        return super().state_batch(machine, node_ids, eids, mem_ids)


def _flaky(n_parts):
    t = _FlakyTransport()
    svcs = {}
    for p in range(n_parts):
        svcs[p] = ShardedStateService(
            n_parts, d_node=4, d_edge=3, d_memory=0, hosted=(p,),
            transport=t, local_rank=p, spmd_writes=False)
        t.bind_state(svcs[p])
    return t, svcs[0]


def test_prefetch_error_clears_buffer_and_reraises_next_entry():
    t, client = _flaky(3)
    ids = np.arange(30)
    feats = np.random.default_rng(0).normal(size=(30, 4)).astype(np.float32)
    client.put_node_feats(ids, feats)
    t.fail_machines = {2}
    remote = ids[ids % 3 != 0]
    assert client.prefetch_async(node_ids=remote) == 2
    for th, _ in client._pf_jobs:      # join WITHOUT draining
        th.join()
    assert any(box["error"] is not None for _, box in client._pf_jobs)
    assert len(client._pf_rows["node"]) > 0   # partial rows staged
    with pytest.raises(ConnectionError, match="went away"):
        client.pf_reset()
    assert not client._pf_rows["node"] and not client._pf_rows["edge"]
    assert not client._pf_mem
    t.fail_machines = set()
    client.pf_reset()                  # the error does not ring twice
    np.testing.assert_array_equal(client.get_node_feats(ids), feats)
    assert client.prefetch_async(node_ids=remote) == 2
    client._pf_drain()
    np.testing.assert_array_equal(client.get_node_feats(remote),
                                  feats[remote])


def test_prefetch_error_surfaces_at_prefetch_entry_too():
    t, client = _flaky(2)
    ids = np.arange(10)
    client.put_node_feats(ids, np.ones((10, 4), np.float32))
    t.fail_machines = {1}
    remote = ids[ids % 2 == 1]
    assert client.prefetch_async(node_ids=remote) == 1
    for th, _ in client._pf_jobs:
        th.join()
    t.fail_machines = set()
    with pytest.raises(ConnectionError):
        client.prefetch_async(node_ids=remote)
    assert client.prefetch_async(node_ids=remote) == 1
    client._pf_drain()


def test_transport_surface():
    for op in ("ping", "close", "hop", "feat_get", "feat_put", "mem_get",
               "mem_put", "state_batch"):
        assert op in OPS
    assert OPS.group("hop") == "sample"
    assert OPS.group("state_batch") == "state"
    with pytest.raises(ValueError, match="unknown rpc op"):
        OPS.dispatch(None, "nope", ())
    assert OPS.dispatch(None, "ping", ()) == "pong"
    lt = LocalTransport()
    assert lt.stats() == transport_stats() and tuple(lt.stats()) == \
        STATS_KEYS
    assert lt.local_machines(3) == (0, 1, 2)
    lt.barrier("any")                   # in-process: a no-op
    with pytest.raises(NotImplementedError):
        SamplingTransport().sample_hop(0, 0, None, None, None, 1)
    with pytest.raises(RuntimeError, match="no state service bound"):
        lt.feat_get(3, "node", np.array([1]))


def test_concurrent_clients_and_prefetch_threads_lose_no_update():
    """12 client threads (more than this runner's cores), each with its
    own prefetch threads, read two shared owner services through one
    LocalTransport under a short switch interval: every read is exact,
    and every wire call is counted once on the server that served it."""
    import sys
    import threading

    n_parts, n_ids = 3, 90
    t = LocalTransport()
    rng = np.random.default_rng(5)
    feats = rng.normal(size=(n_ids, D_NODE)).astype(np.float32)
    owners = {}
    for p in (1, 2):
        owners[p] = ShardedStateService(n_parts, d_node=D_NODE,
                                        d_edge=D_EDGE, hosted=(p,),
                                        transport=t, local_rank=p)
        owners[p].put_node_feats(np.arange(n_ids), feats)
        t.bind_state(owners[p])
    clients = [ShardedStateService(n_parts, d_node=D_NODE, d_edge=D_EDGE,
                                   hosted=(0,), transport=t)
               for _ in range(12)]
    for c in clients:                   # each holds partition 0's rows
        c.put_node_feats(np.arange(n_ids), feats)
    errors = []

    def work(k, client):
        r = np.random.default_rng(k)
        try:
            for _ in range(25):
                ids = r.integers(0, n_ids, 20)
                client.prefetch_async(node_ids=ids[ids % n_parts != 0])
                client.pf_filter_new("node", ids)
                np.testing.assert_array_equal(
                    client.get_node_feats(ids), feats[ids])
            client.pf_reset()
        except Exception as e:          # surfaced by the main thread
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(k, c))
                   for k, c in enumerate(clients)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(th.is_alive() for th in threads)
    assert not errors, errors[0]
    wire = sum(c.stats()["wire_calls"] for c in clients)
    assert wire > 0
    assert wire == sum(o.stats()["served_calls"] for o in owners.values())
