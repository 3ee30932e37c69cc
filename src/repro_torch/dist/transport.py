"""Sampling and state transports (counterpart of ``repro.dist.transport``).

GNNFlow's distributed loop routes every k-hop request to the owner
machine's same-rank sampler (the static schedule, §4.4), and every
partition-remote feature/memory access of a ``ShardedStateService`` to
the owner's state shard.  *Where* an owner lives is a transport concern,
injected into ``repro_torch.core.scheduler.DistributedSamplerSystem``
and ``repro_torch.dist.state.ShardedStateService``:

``LocalTransport``
    The degenerate single-process case (and the default): every machine
    is hosted in this process, hops and state accesses are direct
    in-process calls.  Its ``barrier`` is a no-op.

``RpcTransport``
    One OS process per machine (``repro_torch.launch.multihost``).  Each
    process runs an ``RpcSamplingServer`` exposing its local machine's
    per-rank samplers and (once bound with ``bind_state``) its state
    shard over ``multiprocessing.connection`` (TCP on loopback; the
    protocol is length-prefixed pickled tuples, so real wire bytes are
    counted).  A request whose owner is remote blocks on the owner's
    server; the server answers on daemon threads, so every process
    keeps serving its peers while its own trainer loop runs, also while
    that loop waits in a collective.  Everything on the wire is numpy:
    the servers' ``serve_*`` entry points return host arrays.

Every op — ``hop``, ``ping``, ``close``, and the state ops
``feat_get``/``feat_put``/``mem_get``/``mem_put`` plus the coalesced
``state_batch`` — lives in ONE registered op table (:data:`OPS`) shared
by server dispatch and client validation: a client call with an
unregistered op fails locally, and a server receiving one (version
skew, corrupted frame) replies an error that re-raises on the caller.
Ops carry a stats group (``sample`` vs ``state``).

``barrier(tag)``: ingest (and the sharded TGN memory commit) mutate
state that remote peers read, so the trainer brackets those points with
barriers.  The RPC transport's barrier goes through the
``torch.distributed`` process group's key-value store (pure host sync,
no device work) and raises without an initialized group, where the
reference's returns silently.

Determinism: the ``recent`` policy is stateless per hop, so serving
order cannot change results; the stochastic policies key their noise
per REQUEST (``TemporalSampler.request_key``), so they are order
independent too.
"""
from __future__ import annotations

import datetime
import os
import pickle
import socket
import threading
import time
from multiprocessing.connection import Client, Listener
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np

from repro_torch.obs import trace
from repro_torch.obs.log import get_logger
from repro_torch.obs.metrics import MetricRegistry

log = get_logger("rpc")

_AUTHKEY = b"repro-multihost"
_CONNECT_TIMEOUT_S = 60.0   # for every peer's server to come up
_CLOSE_TIMEOUT_S = 10.0     # for each server thread to end at close
_OK, _ERR = "ok", "err"
_CLOSE = object()      # op-handler sentinel: tear down this connection


def transport_stats(*, calls: int = 0, bytes_out: int = 0,
                    bytes_in: int = 0, wait_s: float = 0.0,
                    state_calls: int = 0, state_bytes: int = 0,
                    state_wait_s: float = 0.0) -> Dict[str, Any]:
    """THE transport stats schema. Every ``stats()`` implementation
    builds its dict through this helper (keyword-only, defaults zero),
    so a new field cannot silently exist on one transport and not the
    other — add it here and every implementation gets it."""
    return {"calls": int(calls), "bytes_out": int(bytes_out),
            "bytes_in": int(bytes_in), "wait_s": round(float(wait_s), 6),
            "state_calls": int(state_calls),
            "state_bytes": int(state_bytes),
            "state_wait_s": round(float(state_wait_s), 6)}


STATS_KEYS: Tuple[str, ...] = tuple(transport_stats().keys())


# ---------------------------------------------------------------------------
# Registered op table (single source of truth for server AND client)
# ---------------------------------------------------------------------------


class OpTable:
    """Name -> (handler, stats group). The server dispatches through it;
    the client validates against it before sending, so an op that is
    not registered here simply does not exist on either side."""

    def __init__(self):
        self._handlers: Dict[str, Callable] = {}
        self._groups: Dict[str, str] = {}

    def register(self, name: str, group: str = "sample"):
        def deco(fn):
            assert name not in self._handlers, f"duplicate rpc op {name}"
            self._handlers[name] = fn
            self._groups[name] = group
            return fn
        return deco

    def __contains__(self, name) -> bool:
        return name in self._handlers

    def names(self) -> Tuple[str, ...]:
        return tuple(sorted(self._handlers))

    def group(self, name: str) -> str:
        return self._groups[name]

    def dispatch(self, server, name: str, payload):
        try:
            handler = self._handlers[name]
        except KeyError:
            raise ValueError(f"unknown rpc op {name!r} "
                             f"(registered: {self.names()})") from None
        return handler(server, *payload)


OPS = OpTable()


@OPS.register("ping", group="control")
def _op_ping(server):
    return "pong"


@OPS.register("close", group="control")
def _op_close(server):
    return _CLOSE


@OPS.register("hop", group="sample")
def _op_hop(server, machine, rank, targets, times, pmask, k,
            req_machine=0, seq=0, hop=0):
    if server.system is None:
        raise RuntimeError("no sampler system bound on this server")
    return server.system.serve_hop(machine, rank, targets, times, pmask,
                                   k, req_machine=req_machine, seq=seq,
                                   hop=hop)


def _state_of(server):
    if server.state is None:
        raise RuntimeError("no state service bound on this server "
                           "(bind_state was never called)")
    return server.state


@OPS.register("feat_get", group="state")
def _op_feat_get(server, table, ids):
    return _state_of(server).serve_feat_get(table, ids)


@OPS.register("feat_put", group="state")
def _op_feat_put(server, table, ids, vals):
    return _state_of(server).serve_feat_put(table, ids, vals)


@OPS.register("mem_get", group="state")
def _op_mem_get(server, ids):
    return _state_of(server).serve_mem_get(ids)


@OPS.register("mem_put", group="state")
def _op_mem_put(server, ids, mem, ts):
    return _state_of(server).serve_mem_put(ids, mem, ts)


@OPS.register("state_batch", group="state")
def _op_state_batch(server, node_ids, eids, mem_ids):
    # the coalesced read: ALL of a batch's node-feat + edge-feat +
    # memory requests for this peer in ONE framed round trip
    return _state_of(server).serve_state_batch(node_ids, eids, mem_ids)


# ---------------------------------------------------------------------------
# Transport interface
# ---------------------------------------------------------------------------


class SamplingTransport:
    """Interface the scheduler and the state service route through."""

    process_id: int = 0
    n_processes: int = 1

    def local_machines(self, n_machines: int) -> Tuple[int, ...]:
        """Machine ids hosted by THIS process (all of them by default)."""
        return tuple(range(n_machines))

    def bind(self, system) -> None:
        """Attach the locally hosted sampler system (starts servers)."""

    def bind_state(self, state) -> None:
        """Attach the locally hosted state service to the same server
        (no-op in-process: every partition is already local)."""

    def connect(self) -> None:
        """Dial every peer's server (retry until up)."""

    def sample_hop(self, machine: int, rank: int, targets: np.ndarray,
                   times: np.ndarray, pmask: np.ndarray, k: int,
                   req_machine: int = 0, seq: int = 0, hop: int = 0):
        raise NotImplementedError(
            "local transport never routes a remote hop")

    # -- state ops (ShardedStateService's wire) -------------------------
    def feat_get(self, machine: int, table: str, ids: np.ndarray):
        raise NotImplementedError(
            "transport does not route remote state reads")

    def feat_put(self, machine: int, table: str, ids: np.ndarray,
                 vals: np.ndarray):
        raise NotImplementedError(
            "transport does not route remote state writes")

    def mem_get(self, machine: int, ids: np.ndarray):
        raise NotImplementedError(
            "transport does not route remote state reads")

    def mem_put(self, machine: int, ids: np.ndarray, mem: np.ndarray,
                ts: np.ndarray):
        raise NotImplementedError(
            "transport does not route remote state writes")

    def state_batch(self, machine: int, node_ids, eids, mem_ids):
        raise NotImplementedError(
            "transport does not route remote state reads")

    def barrier(self, tag: str) -> None:
        pass

    def close(self) -> None:
        pass

    def stats(self) -> Dict[str, Any]:
        return transport_stats()


class LocalTransport(SamplingTransport):
    """Everything in-process: the 1-process degenerate case.

    The trainers' in-process state services host every partition, so
    their reads never reach the transport.  The state ops below exist
    for MULTI-SERVICE single-process setups (property/parity tests):
    ``bind_state`` registers each service under its ``local_rank`` and
    the ops dispatch straight into the target service's ``serve_*``
    entry points — same code path a remote peer would execute, minus
    the socket.
    """

    def __init__(self):
        self._states: Dict[int, Any] = {}

    def bind_state(self, state) -> None:
        self._states[int(getattr(state, "local_rank", 0))] = state

    def _state_for(self, machine: int):
        try:
            return self._states[machine]
        except KeyError:
            raise RuntimeError(
                f"no state service bound for machine {machine} on this "
                f"LocalTransport (bound: {sorted(self._states)})"
            ) from None

    def feat_get(self, machine: int, table: str, ids: np.ndarray):
        return self._state_for(machine).serve_feat_get(
            table, np.asarray(ids, np.int64))

    def feat_put(self, machine: int, table: str, ids: np.ndarray,
                 vals: np.ndarray):
        return self._state_for(machine).serve_feat_put(
            table, np.asarray(ids, np.int64), np.asarray(vals, np.float32))

    def mem_get(self, machine: int, ids: np.ndarray):
        return self._state_for(machine).serve_mem_get(
            np.asarray(ids, np.int64))

    def mem_put(self, machine: int, ids: np.ndarray, mem: np.ndarray,
                ts: np.ndarray):
        return self._state_for(machine).serve_mem_put(
            np.asarray(ids, np.int64), np.asarray(mem, np.float32),
            np.asarray(ts, np.float64))

    def state_batch(self, machine: int, node_ids, eids, mem_ids):
        return self._state_for(machine).serve_state_batch(
            node_ids, eids, mem_ids)


class RpcSamplingServer:
    """Serves one process's local samplers (and state shard) to peers.

    Accept loop + one handler thread per peer connection (all daemon):
    requests are ``(op, payload)`` pickles dispatched through the
    registered op table (:data:`OPS`) — ``hop`` into
    ``DistributedSamplerSystem.serve_hop`` (per-sampler locks inside,
    on the system's serving stream), the state ops into the bound
    ``ShardedStateService``, ``ping`` answers readiness probes.  Errors
    are pickled back and re-raised on the caller, so a crashing peer
    surfaces instead of hanging the fleet.
    """

    def __init__(self, system, port: int, machine: int = -1):
        self.system = system
        self.state = None             # a ShardedStateService, once bound
        self.machine = machine        # serving machine id, for log lines
        self.port = port
        self.listener = Listener(("127.0.0.1", port), authkey=_AUTHKEY)
        self._closing = False
        self._handlers: list = []
        self._accept = threading.Thread(target=self._accept_loop,
                                        daemon=True,
                                        name=f"rpc-accept:{port}")
        self._accept.start()

    def _accept_loop(self) -> None:
        while not self._closing:
            try:
                conn = self.listener.accept()
            except Exception as e:
                if self._closing:
                    return
                # a dead accept loop shows to peers as a connect hang:
                # log every failure
                log.error("rpc accept failed", machine=self.machine,
                          port=self.port, error=repr(e))
                time.sleep(0.05)   # don't busy-spin a broken listener
                continue
            if self._closing:        # close()'s wake-up connection
                conn.close()
                return
            th = threading.Thread(target=self._serve_conn, args=(conn,),
                                  daemon=True, name="rpc-serve")
            self._handlers.append((th, conn))
            th.start()

    def _serve_conn(self, conn) -> None:
        with conn:
            while True:
                try:
                    raw = conn.recv_bytes()
                except (EOFError, OSError):
                    return
                op = "<unpickle>"
                try:
                    # the unpickle is inside the try: a malformed frame
                    # replies an error (re-raised on the caller) instead
                    # of killing this thread and leaving the peer a bare
                    # EOFError
                    op, payload = pickle.loads(raw)
                    with trace.span("rpc.serve", op=op, bytes=len(raw)):
                        out = OPS.dispatch(self, op, payload)
                    if out is _CLOSE:
                        return
                    reply = (_OK, out)
                except Exception as e:  # surface on the caller
                    # logged here too: if the reply below also fails,
                    # this line is the only trace left
                    log.warn("rpc dispatch failed", machine=self.machine,
                             op=op, error=f"{type(e).__name__}: {e}")
                    reply = (_ERR, f"{type(e).__name__}: {e}")
                try:
                    conn.send_bytes(pickle.dumps(
                        reply, protocol=pickle.HIGHEST_PROTOCOL))
                except (BrokenPipeError, OSError) as e:
                    log.error("rpc reply undeliverable",
                              machine=self.machine, op=op, error=repr(e))
                    return

    def close(self) -> None:
        """Stop serving and end every server thread.  Call it once the
        peers are done (the fleet's shutdown barrier): a handler still
        waiting for its peer's next request is woken by shutting its
        socket down.  No server thread may outlive the process's Python
        code — a thread woken during interpreter teardown aborts the
        process."""
        self._closing = True
        try:    # a blocked accept() does not wake on close(): dial it
            Client(("127.0.0.1", self.port), authkey=_AUTHKEY).close()
        except OSError:
            pass
        self._accept.join(_CLOSE_TIMEOUT_S)
        try:
            self.listener.close()
        except OSError:
            pass
        for th, conn in self._handlers:
            try:
                with socket.socket(fileno=os.dup(conn.fileno())) as sk:
                    sk.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass            # the handler already closed it
            th.join(_CLOSE_TIMEOUT_S)
        alive = sum(th.is_alive() for th, _ in self._handlers)
        if alive:
            log.warn("rpc handler threads still alive at close",
                     machine=self.machine, alive=alive)


def _process_group_store():
    """The initialized default process group's key-value store; raises
    when there is none (a fleet barrier never passes silently)."""
    import torch.distributed as tdist
    if not (tdist.is_available() and tdist.is_initialized()):
        raise RuntimeError(
            "RpcTransport.barrier needs an initialized torch.distributed "
            "process group (repro_torch.launch.multihost."
            "init_worker_from_env); none is")
    from torch.distributed import distributed_c10d
    return distributed_c10d._get_default_store()


class RpcTransport(SamplingTransport):
    """One machine per process; remote requests go over loopback TCP.

    ``ports[m]`` is machine *m*'s server port.  ``barrier`` rides the
    key-value store of the ``torch.distributed`` process group that
    ``repro_torch.launch.multihost`` initializes — no device work, pure
    host sync.  Traffic is accounted per op group (``sample`` vs
    ``state``) on top of the flat totals.
    """

    def __init__(self, process_id: int, n_processes: int,
                 ports: Sequence[int], barrier_timeout_s: float = 600.0):
        assert len(ports) == n_processes, (ports, n_processes)
        self.process_id = process_id
        self.n_processes = n_processes
        self.ports = list(ports)
        self.barrier_timeout_s = barrier_timeout_s
        self.server: Optional[RpcSamplingServer] = None
        self._conns: Dict[int, Any] = {}
        self._conn_locks: Dict[int, threading.Lock] = {}
        self._bseq = 0
        # wire accounting in a MetricRegistry (thread-safe: the trainer
        # loop and the state-prefetch thread both call _call)
        self.metrics = MetricRegistry()
        self._c_calls = self.metrics.counter("rpc.calls")
        self._c_bytes_out = self.metrics.counter("rpc.bytes_out")
        self._c_bytes_in = self.metrics.counter("rpc.bytes_in")
        self._c_wait_s = self.metrics.counter("rpc.wait_s")
        self._group_counters: Dict[str, Tuple] = {}
        self._group_lock = threading.Lock()

    def _group(self, group: str) -> Tuple:
        with self._group_lock:
            g = self._group_counters.get(group)
            if g is None:
                g = tuple(self.metrics.counter(f"rpc.{group}.{k}")
                          for k in ("calls", "bytes_out", "bytes_in",
                                    "wait_s"))
                self._group_counters[group] = g
            return g

    @property
    def calls(self) -> int:
        return int(self._c_calls.value)

    @property
    def bytes_out(self) -> int:
        return int(self._c_bytes_out.value)

    @property
    def bytes_in(self) -> int:
        return int(self._c_bytes_in.value)

    @property
    def wait_s(self) -> float:
        return self._c_wait_s.value

    @property
    def group_stats(self) -> Dict[str, Dict[str, Any]]:
        with self._group_lock:
            groups = dict(self._group_counters)
        return {group: {"calls": int(c.value), "bytes_out": int(o.value),
                        "bytes_in": int(i.value), "wait_s": w.value}
                for group, (c, o, i, w) in groups.items()}

    def local_machines(self, n_machines: int) -> Tuple[int, ...]:
        assert n_machines == self.n_processes, (
            f"multihost runs one machine per process: P={n_machines} "
            f"machines need {n_machines} processes, got "
            f"{self.n_processes}")
        return (self.process_id,)

    def bind(self, system) -> None:
        self.server = RpcSamplingServer(
            system, self.ports[self.process_id],
            machine=self.process_id)

    def bind_state(self, state) -> None:
        assert self.server is not None, "bind() before bind_state()"
        self.server.state = state

    def connect(self) -> None:
        deadline = time.monotonic() + _CONNECT_TIMEOUT_S
        for m in range(self.n_processes):
            if m == self.process_id:
                continue
            addr = ("127.0.0.1", self.ports[m])
            while True:
                try:
                    conn = Client(addr, authkey=_AUTHKEY)
                    break
                except OSError:
                    if time.monotonic() > deadline:
                        raise TimeoutError(
                            f"sampling server of machine {m} at {addr} "
                            f"never came up")
                    time.sleep(0.05)
            self._conns[m] = conn
            self._conn_locks[m] = threading.Lock()
        for m in self._conns:
            if self._call(m, "ping") != "pong":
                raise RuntimeError(f"machine {m}'s server answered the "
                                   f"readiness probe wrongly")

    def _call(self, machine: int, op: str, *payload):
        if op not in OPS:       # client side of the shared op table
            raise ValueError(f"unknown rpc op {op!r} "
                             f"(registered: {OPS.names()})")
        data = pickle.dumps((op, payload),
                            protocol=pickle.HIGHEST_PROTOCOL)
        t0 = time.perf_counter()
        with trace.span("rpc.call", op=op, machine=machine) as sp:
            with self._conn_locks[machine]:
                conn = self._conns[machine]
                conn.send_bytes(data)
                raw = conn.recv_bytes()
            sp.set(bytes=len(data) + len(raw))
        dt = time.perf_counter() - t0
        self._c_wait_s.add(dt)
        self._c_calls.add(1)
        self._c_bytes_out.add(len(data))
        self._c_bytes_in.add(len(raw))
        gc, go, gi, gw = self._group(OPS.group(op))
        gc.add(1)
        go.add(len(data))
        gi.add(len(raw))
        gw.add(dt)
        status, result = pickle.loads(raw)
        if status == _ERR:
            raise RuntimeError(
                f"sampling server of machine {machine} failed: {result}")
        return result

    def sample_hop(self, machine: int, rank: int, targets: np.ndarray,
                   times: np.ndarray, pmask: np.ndarray, k: int,
                   req_machine: int = 0, seq: int = 0, hop: int = 0):
        return self._call(machine, "hop", machine, rank,
                          np.asarray(targets), np.asarray(times),
                          np.asarray(pmask), int(k), int(req_machine),
                          int(seq), int(hop))

    # -- state ops -------------------------------------------------------
    def feat_get(self, machine: int, table: str, ids: np.ndarray):
        return self._call(machine, "feat_get", table,
                          np.asarray(ids, np.int64))

    def feat_put(self, machine: int, table: str, ids: np.ndarray,
                 vals: np.ndarray):
        return self._call(machine, "feat_put", table,
                          np.asarray(ids, np.int64),
                          np.asarray(vals, np.float32))

    def mem_get(self, machine: int, ids: np.ndarray):
        return self._call(machine, "mem_get", np.asarray(ids, np.int64))

    def mem_put(self, machine: int, ids: np.ndarray, mem: np.ndarray,
                ts: np.ndarray):
        return self._call(machine, "mem_put",
                          np.asarray(ids, np.int64),
                          np.asarray(mem, np.float32),
                          np.asarray(ts, np.float64))

    def state_batch(self, machine: int, node_ids, eids, mem_ids):
        """One coalesced round trip: every table's reads for one peer
        in a single frame.  Any of the three id arrays may be None."""
        cvt = lambda a: None if a is None else np.asarray(a, np.int64)
        return self._call(machine, "state_batch",
                          cvt(node_ids), cvt(eids), cvt(mem_ids))

    def barrier(self, tag: str) -> None:
        """Host barrier over the process group's key-value store.

        Every process calls barrier() at identical program points with
        identical tags from its main thread, so the per-transport
        sequence number makes each barrier's key unique AND identical
        fleet-wide: ``repro-mh-{tag}-{seq}``.  Each process sets its
        own ``/<rank>`` entry under it and waits for all of them; past
        ``barrier_timeout_s`` it raises and names the tag, the sequence
        number and the processes that never arrived."""
        store = _process_group_store()
        self._bseq += 1
        key = f"repro-mh-{tag}-{self._bseq}"
        keys = [f"{key}/{p}" for p in range(self.n_processes)]
        with trace.span("barrier", tag=tag, seq=self._bseq):
            store.set(keys[self.process_id], b"1")
            try:
                store.wait(keys, datetime.timedelta(
                    seconds=self.barrier_timeout_s))
            except Exception as e:
                missing = [p for p, k in enumerate(keys)
                           if not store.check([k])]
                raise TimeoutError(
                    f"barrier {tag!r} (seq {self._bseq}) timed out after "
                    f"{self.barrier_timeout_s} s on process "
                    f"{self.process_id}: processes {missing} never "
                    f"arrived ({type(e).__name__}: {e})") from e

    def close(self) -> None:
        for m, conn in self._conns.items():
            try:
                conn.send_bytes(pickle.dumps(("close", ()),
                                             protocol=pickle.HIGHEST_PROTOCOL))
                conn.close()
            except OSError:
                pass
        self._conns.clear()
        if self.server is not None:
            self.server.close()

    def stats(self) -> Dict[str, Any]:
        st = self.group_stats.get("state", {})
        return transport_stats(
            calls=self.calls, bytes_out=self.bytes_out,
            bytes_in=self.bytes_in, wait_s=self.wait_s,
            state_calls=st.get("calls", 0),
            state_bytes=(st.get("bytes_out", 0)
                         + st.get("bytes_in", 0)),
            state_wait_s=st.get("wait_s", 0.0))
