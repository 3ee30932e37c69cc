"""The PyTorch port's multihost half (``repro_torch.dist.transport``'s
RPC transport, the collectives across processes,
``repro_torch.launch.multihost``) on the CPU, over gloo on loopback.

* two port ``RpcTransport``s in one process: hops equal the all-local
  port system's and the JAX package's ``DistributedSamplerSystem``'s on
  the same partitions (recent: ids, eids, masks exact); ``feat_get``,
  ``mem_get`` and ``state_batch`` over the wire equal
  ``LocalTransport``'s; an unregistered op is refused client-side, a
  state op to a server with no state bound raises, a malformed frame and
  a failing op re-raise on the caller, and ``barrier`` without a process
  group raises;
* two gloo processes x G 2: each of the three collectives equals the
  in-process function over the same 4 trees (within 1e-6, residuals
  included), and process 1's 20 hop RPCs to process 0 are served while
  process 0 sits in an ``all_reduce`` (60 s limit);
* fleet parity, P 2 x G 2, 3 rounds with the replay round, at the sizes
  of ``tests/test_multihost.py::_run_cfg``: TGN with sharded state
  (fenced) and TGAT (recent sampling, replicated state).  The workers
  agree within 1e-6; each is within 1e-6 of the port's in-process
  trainer (same thread count: CPU reductions split by threads) and
  within 1e-4 loss / 1e-3 AP of the JAX package's in-process trainer
  on the fake devices, all from JAX's initial parameters; RPC traffic
  every round; TGN with ``memory_staleness=1`` within 0.1 of the fenced
  run, with stale rows served.
"""
import json
import subprocess
import sys
import time

import jax
import numpy as np
import pytest
import torch

from repro.configs import tgn_gdelt as JC
from repro.core.partition import Dispatcher as JDispatcher
from repro.core.partition import GraphPartition as JPartition
from repro.core.scheduler import DistributedSamplerSystem as JSystem
from repro.data.events import synth_ctdg as j_synth
from repro.dist.continuous import DistributedContinuousTrainer as JDist
from repro_torch.core.partition import Dispatcher, GraphPartition
from repro_torch.core.scheduler import DistributedSamplerSystem
from repro_torch.dist import collectives as C
from repro_torch.dist.continuous import DistributedContinuousTrainer
from repro_torch.dist.state import ShardedStateService
from repro_torch.dist.transport import LocalTransport, RpcTransport
from repro_torch.launch import multihost
from repro_torch.models.convert import params_from_jax

P_, G_ = 2, 2
THREADS = 2            # the workers' and the in-process reference's


def _run_cfg(model: str) -> dict:
    """``tests/test_multihost.py::_run_cfg``'s sizes (copied: that
    module imports the JAX launcher), on a 1,500-unit time span as in
    ``tests/test_torch_dist_continuous.py``: over 20,000 units the time
    encoding lifts XLA's and PyTorch's one-ulp differences past 1e-4 by
    the third round (ROADMAP §3)."""
    model_kw = dict(d_node=8, d_edge=8, d_time=8, d_hidden=16,
                    batch_size=64)
    if model == "tgn":
        model_kw.update(fanouts=(4,), d_memory=12)
    else:
        model_kw.update(fanouts=(4, 4), sampling="recent")
    return {
        "model": model,
        "model_kw": model_kw,
        "stream": dict(n_nodes=192, n_events=1800, t_span=1_500,
                       d_node=8, d_edge=8, seed=7),
        "dist": {"collective": "bucketed"},
        "trainer": dict(threshold=16, cache_ratio=0.2, lr=5e-4,
                        seed=0, overlap=True),
        "warm": 512, "round_size": 256, "rounds": 3, "epochs": 2,
        "replay_ratio": 0.2, "replay_round": 2,
    }


# ---------------------------------------------------------------------------
# two RpcTransports in one process
# ---------------------------------------------------------------------------

def _events(n=3000, nodes=240, seed=3):
    rng = np.random.default_rng(seed)
    w = rng.pareto(1.5, nodes) + 1
    p = w / w.sum()
    return (rng.choice(nodes, n, p=p), rng.choice(nodes, n, p=p),
            np.sort(rng.uniform(0, 1000.0, n)))


def _parts(events, cls=GraphPartition, disp=Dispatcher):
    parts = [cls(p, P_, threshold=16) for p in range(P_)]
    disp(parts, undirected=True).add_edges(*events)
    return parts


def _filled_services(transports):
    """One single-shard state service per transport, both fed the same
    writes (each keeps its own shard's rows)."""
    rng = np.random.default_rng(5)
    svcs = [ShardedStateService(P_, d_node=6, d_edge=4, d_memory=5,
                                hosted=(p,), transport=t, local_rank=p)
            for p, t in enumerate(transports)]
    ids = np.arange(64)
    nf = rng.normal(size=(64, 6)).astype(np.float32)
    ef = rng.normal(size=(64, 4)).astype(np.float32)
    mem = rng.normal(size=(64, 5)).astype(np.float32)
    src = rng.integers(0, 64, 64)
    for s in svcs:
        s.put_node_feats(ids, nf)
        s.register_edges(ids, src)
        s.put_edge_feats(ids, ef)
        s.put_memory(ids, mem, np.arange(64.0))
    return svcs


@pytest.fixture
def rpc_pair():
    events = _events()
    ports = multihost.free_ports(P_)
    ts = [RpcTransport(p, P_, ports) for p in range(P_)]
    systems = [DistributedSamplerSystem([_parts(events)[p]], 1, (4, 4),
                                        scan_pages=16, n_machines=P_,
                                        transport=t, device="cpu")
               for p, t in enumerate(ts)]
    try:
        for t, s in zip(ts, systems):
            t.bind(s)
        for t in ts:
            t.connect()
        yield events, ts, systems
    finally:
        for t in ts:
            t.close()


def test_rpc_hops_equal_the_local_and_jax_systems(rpc_pair):
    events, ts, systems = rpc_pair
    local = DistributedSamplerSystem(_parts(events), 1, (4, 4),
                                     scan_pages=16, device="cpu")
    ref = JSystem(_parts(events, JPartition, JDispatcher), 1, (4, 4),
                  scan_pages=16)
    seeds = np.arange(-1, 80, dtype=np.int64)
    when = np.full(len(seeds), 900.0, np.float32)
    for machine, system in enumerate(systems):
        got = system.sample(machine, 0, seeds, when)
        for want in (local.sample(machine, 0, seeds, when),
                     ref.sample(machine, 0, seeds, when)):
            for la, lb in zip(got, want, strict=True):
                for f in ("nbr_ids", "nbr_eids", "nbr_ts", "mask"):
                    np.testing.assert_array_equal(
                        np.asarray(getattr(la, f)),
                        np.asarray(getattr(lb, f)), err_msg=f)
    for t in ts:        # both directions went over the wire
        assert t.calls > 1 and t.bytes_out > 0 and t.bytes_in > 0
        assert t.stats()["calls"] == t.calls


def test_state_ops_over_the_wire_equal_local_transport(rpc_pair):
    _, ts, _ = rpc_pair
    svcs = _filled_services(ts)
    for t, s in zip(ts, svcs):
        t.bind_state(s)
    local = LocalTransport()
    local.bind_state(svcs[1])
    ids = np.array([1, 3, 5, 7, 9, 3, 63])      # owner: id % 2
    eids = np.flatnonzero(svcs[0].owners("edge", np.arange(64)) == 1)[:6]
    for table, x in (("node", ids), ("edge", eids)):
        np.testing.assert_array_equal(ts[0].feat_get(1, table, x),
                                      local.feat_get(1, table, x))
    for a, b in zip(ts[0].mem_get(1, ids), local.mem_get(1, ids)):
        np.testing.assert_array_equal(a, b)
    got = ts[0].state_batch(1, ids, eids, ids)
    want = local.state_batch(1, ids, eids, ids)
    for a, b in zip(got, want, strict=True):
        np.testing.assert_array_equal(a, b)
        assert isinstance(a, np.ndarray)        # numpy on the wire
    # a sharded read through the service goes over the same wire
    np.testing.assert_array_equal(svcs[0].get_node_feats(ids),
                                  svcs[1].get_node_feats(ids))
    assert ts[0].stats()["state_calls"] >= 4
    assert svcs[1].stats()["served_calls"] > 0


def test_rpc_errors_surface_on_the_caller(rpc_pair):
    events, ts, _ = rpc_pair
    with pytest.raises(ValueError, match="unknown rpc op"):
        ts[0]._call(1, "bogus")                 # refused client-side
    calls = ts[0].calls
    with pytest.raises(RuntimeError, match="no state service"):
        ts[0]._call(1, "feat_get", "node", np.arange(4))
    with pytest.raises(RuntimeError, match="sampling server of machine 1"):
        ts[0]._call(1, "hop", 5, 0, np.zeros(4, np.int64),
                    np.zeros(4, np.float32), np.ones(4, bool), 4)
    assert ts[0].calls == calls + 2             # the unknown op never left
    conn = ts[0]._conns[1]
    with ts[0]._conn_locks[1]:
        conn.send_bytes(b"\x80\x05not a pickle")
        status, msg = __import__("pickle").loads(conn.recv_bytes())
    assert status == "err" and msg.startswith("UnpicklingError")
    assert ts[0]._call(1, "ping") == "pong"     # the link survives
    with pytest.raises(RuntimeError, match="process group"):
        ts[0].barrier("no-group")


# ---------------------------------------------------------------------------
# two gloo processes: the collectives and serving during a collective
# ---------------------------------------------------------------------------

_CHILD = r'''
import datetime, json, sys, time
import numpy as np, torch, torch.distributed as tdist
from repro_torch.core.partition import Dispatcher, GraphPartition
from repro_torch.core.scheduler import DistributedSamplerSystem
from repro_torch.dist import collectives as C
from repro_torch.dist.transport import RpcTransport
rank, coord, ports, data, out = (int(sys.argv[1]), sys.argv[2],
    [int(p) for p in sys.argv[3].split(",")], sys.argv[4], sys.argv[5])
tdist.init_process_group("gloo", init_method=f"tcp://{coord}", rank=rank,
                         world_size=2, timeout=datetime.timedelta(seconds=60))
d = np.load(data)
parts = [GraphPartition(p, 2, threshold=16) for p in range(2)]
Dispatcher(parts, undirected=True).add_edges(d["src"], d["dst"], d["ts"])
t = RpcTransport(rank, 2, ports, barrier_timeout_s=60)
system = DistributedSamplerSystem([parts[rank]], 1, (4,), scan_pages=16,
                                  n_machines=2, transport=t, device="cpu")
t.bind(system)
t.connect()
t.barrier("up")
res = {}
one = torch.ones(3)
if rank == 0:        # straight into the collective, serving meanwhile
    t0 = time.perf_counter()
    tdist.all_reduce(one)
    res["blocked_s"] = time.perf_counter() - t0
else:                # 20 hops to process 0 first, then the collective
    t0 = time.perf_counter()
    hops = [t.sample_hop(0, 0, d["targets"], d["times"], d["pmask"], 4,
                         req_machine=1, seq=i) for i in range(20)]
    res["hops_s"] = time.perf_counter() - t0
    tdist.all_reduce(one)
    for i, f in enumerate(("nbr", "eid", "ts", "mask")):
        res[f] = [np.asarray(h[i]).tolist() for h in hops]
res["sum"] = one.tolist()
G = tdist.group.WORLD
w = lambda k: [{"a": torch.from_numpy(d[f"{k}{i}a"]),
                "b": torch.from_numpy(d[f"{k}{i}b"])}
               for i in (2 * rank, 2 * rank + 1)]
trees, errs = w("g"), w("e")
flat = lambda tr: torch.cat([tr["a"].reshape(-1),
                             tr["b"].reshape(-1)]).tolist()
res["bucketed"] = flat(C.bucketed_psum(trees, bucket_bytes=64,
                                       per_machine=2, group=G))
for name, fn, kw in (("quantized", C.quantized_psum_grads, {"bits": 8}),
                     ("topk", C.topk_psum_grads, {"frac": 0.25})):
    red, new = fn(trees, errs, per_machine=2, group=G, **kw)
    res[name] = flat(red)
    res[name + "_err"] = [flat(e) for e in new]
json.dump(res, open(out, "w"))
t.barrier("done")
t.close()
tdist.destroy_process_group()
'''


def test_two_gloo_processes_collectives_and_serving(tmp_path,
                                                    subprocess_env):
    events = _events()
    rng = np.random.default_rng(11)
    owned0 = np.arange(0, 240, 2)[:48]           # machine 0's nodes
    targets = np.concatenate([owned0, np.full(16, owned0[0])])
    data = {"src": events[0], "dst": events[1], "ts": events[2],
            "targets": targets,
            "times": np.full(64, 950.0, np.float32),
            "pmask": np.arange(64) < 48}
    for i in range(4):                           # 4 workers' trees
        for k in ("g", "e"):
            data[f"{k}{i}a"] = rng.normal(size=(5, 7)).astype(np.float32)
            data[f"{k}{i}b"] = rng.normal(size=(13,)).astype(np.float32)
    np.savez(tmp_path / "data.npz", **data)
    ports = multihost.free_ports(3)
    env = dict(subprocess_env, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", _CHILD, str(r), f"127.0.0.1:{ports[0]}",
         f"{ports[1]},{ports[2]}", str(tmp_path / "data.npz"),
         str(tmp_path / f"out{r}.json")], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(2)]
    deadline = time.monotonic() + 60
    try:
        for p in procs:
            _, err = p.communicate(timeout=max(1, deadline - time.monotonic()))
            assert p.returncode == 0, err[-3000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    out = [json.load(open(tmp_path / f"out{r}.json")) for r in range(2)]
    assert out[0]["sum"] == out[1]["sum"] == [2.0] * 3
    # process 0 sat in the all_reduce while its server answered all 20
    # (process 1 joined it only after the last reply)
    assert out[0]["blocked_s"] >= 0.5 * out[1]["hops_s"] > 0
    local = DistributedSamplerSystem(_parts(events), 1, (4,),
                                     scan_pages=16, device="cpu")
    want = local.serve_hop(0, 0, targets, data["times"], data["pmask"], 4)
    for i, f in enumerate(("nbr", "eid", "ts", "mask")):
        for got in out[1][f]:
            np.testing.assert_array_equal(np.asarray(got), want[i])
    # every collective equals the in-process function over all 4 trees
    trees = [{"a": torch.from_numpy(data[f"g{i}a"]),
              "b": torch.from_numpy(data[f"g{i}b"])} for i in range(4)]
    errs = [{"a": torch.from_numpy(data[f"e{i}a"]),
             "b": torch.from_numpy(data[f"e{i}b"])} for i in range(4)]
    flat = lambda t: np.concatenate([t["a"].numpy().ravel(),
                                     t["b"].numpy().ravel()])
    want = {"bucketed": (C.bucketed_psum(trees, bucket_bytes=64,
                                         per_machine=2), None),
            "quantized": C.quantized_psum_grads(trees, errs, bits=8,
                                                per_machine=2),
            "topk": C.topk_psum_grads(trees, errs, frac=0.25,
                                      per_machine=2)}
    for name, (red, new) in want.items():
        for r in range(2):
            np.testing.assert_allclose(out[r][name], flat(red), rtol=0,
                                       atol=1e-6, err_msg=name)
            if new is not None:
                for j in range(2):
                    np.testing.assert_allclose(
                        out[r][name + "_err"][j], flat(new[2 * r + j]),
                        rtol=0, atol=1e-6, err_msg=name)
    # and without per_machine the same sum, within float noise
    np.testing.assert_allclose(flat(C.bucketed_psum(trees)),
                               flat(want["bucketed"][0]), atol=1e-6)


# ---------------------------------------------------------------------------
# fleet parity
# ---------------------------------------------------------------------------

def _port_inprocess(run_cfg):
    cfg, stream, dist, kw = multihost.build_run(run_cfg, P_, G_)
    tr = DistributedContinuousTrainer(cfg, stream, dist, device="cpu",
                                      **kw)
    multihost.load_init_params(run_cfg, tr)
    threads = torch.get_num_threads()
    torch.set_num_threads(THREADS)
    try:
        return tr, multihost.run_rounds(run_cfg, tr, stream)
    finally:
        torch.set_num_threads(threads)


def _fleet(run_cfg):
    outs = multihost.launch(
        P_, G_, run_cfg=run_cfg, device="cpu", timeout_s=300.0,
        extra_env={"OMP_NUM_THREADS": str(THREADS)})
    return multihost.parse_results(outs)


@pytest.fixture(scope="module")
def fleets(tmp_path_factory):
    """model -> (run config, JAX rounds, port in-process trainer and
    rounds, fleet results), all from the JAX trainer's initial
    parameters; plus the TGN fleet with memory_staleness=1."""
    out = {}
    for model, state in (("tgn", "sharded"), ("tgat", "replicated")):
        run_cfg = _run_cfg(model)
        jcfg = getattr(JC, model)(**run_cfg["model_kw"])
        jstream = j_synth(**run_cfg["stream"])
        jt = JDist(jcfg, jstream, JC.DistConfig(P_, G_, "bucketed"),
                   **run_cfg["trainer"])
        path = tmp_path_factory.mktemp(model) / "init.pt"
        torch.save(params_from_jax(jax.tree.map(np.asarray, jt.params),
                                   device="cpu"), path)
        jrounds = multihost.drive_rounds(
            jt, jstream, warm=run_cfg["warm"],
            round_size=run_cfg["round_size"], rounds=run_cfg["rounds"],
            epochs=run_cfg["epochs"], replay_ratio=run_cfg["replay_ratio"],
            replay_round=run_cfg["replay_round"])
        run_cfg["init_params"] = str(path)
        run_cfg["trainer"] = dict(run_cfg["trainer"], state=state)
        tr, rounds = _port_inprocess(run_cfg)
        out[model] = (run_cfg, jrounds, tr, rounds, _fleet(run_cfg))
    stale = dict(out["tgn"][0])
    stale["trainer"] = dict(stale["trainer"], memory_staleness=1)
    out["tgn_stale"] = _fleet(stale)
    return out


@pytest.mark.parametrize("model", ["tgn", "tgat"])
def test_fleet_matches_in_process_and_jax(fleets, model):
    run_cfg, jrounds, tr, rounds, results = fleets[model]
    assert len(results) == P_
    for r in results:
        assert len(r["rounds"]) == run_cfg["rounds"]
        assert r["device"] == "cpu" and r["n_local_devices"] == G_
    for a, b in zip(*[r["rounds"] for r in results]):     # workers agree
        for key in ("loss", "eval_loss", "ap"):
            assert abs(a[key] - b[key]) <= 1e-6, key
        np.testing.assert_allclose(a["step_losses"], b["step_losses"],
                                   rtol=0, atol=1e-6)
    for i, (want, jw) in enumerate(zip(rounds, jrounds, strict=True)):
        got = results[0]["rounds"][i]
        for key in ("loss", "eval_loss", "ap"):
            assert abs(getattr(want, key) - got[key]) <= 1e-6, (i, key)
        np.testing.assert_allclose(got["step_losses"], want.step_losses,
                                   rtol=0, atol=1e-6)
        assert abs(jw.loss - got["loss"]) <= 1e-4, (i, jw.loss)
        assert abs(jw.eval_loss - got["eval_loss"]) <= 1e-4, i
        assert abs(jw.ap - got["ap"]) <= 1e-3, (i, jw.ap, got["ap"])
        assert want.rpc_calls == 0               # in-process: no wire
        for r in results:                        # the fleet: every round
            rd = r["rounds"][i]
            assert rd["rpc_calls"] > 0 and rd["rpc_wire_bytes"] > 0
            assert rd["request_bytes"] > 0 and rd["dispatch_bytes"] > 0
            assert rd["collective_steps"] == len(rd["step_losses"]) > 0
    if model == "tgn":
        ref_resident = tr.state.resident_bytes()
        for r in results:
            ss = r["state"]
            assert ss["mode"] == "sharded" and ss["served_calls"] > 0
            assert ss["wire_calls"] > 0 and ss["wire_bytes"] > 0
            assert ss["resident_bytes"] <= 0.7 * ref_resident
            for rd in r["rounds"]:
                assert rd["state_round_trips"] > 0
                assert rd["state_pf_hits"] > 0
                assert rd["state_stale_served"] == 0      # fenced


def test_fleet_with_memory_staleness_stays_within_its_band(fleets):
    _, _, _, fenced, _ = fleets["tgn"]
    results = fleets["tgn_stale"]
    for a, b in zip(*[r["rounds"] for r in results]):
        assert abs(a["loss"] - b["loss"]) <= 1e-6
    for want, got in zip(fenced, results[0]["rounds"], strict=True):
        assert abs(want.loss - got["loss"]) <= 0.1
        assert abs(want.eval_loss - got["eval_loss"]) <= 0.1
    assert sum(rd["state_stale_served"] for r in results
               for rd in r["rounds"]) > 0
    assert all(rd["state_pf_hits"] > 0
               for r in results for rd in r["rounds"])
