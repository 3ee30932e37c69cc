"""Sampling and state transports (counterpart of the in-process half of
``repro.dist.transport``).

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

Every op — ``hop``, ``ping``, ``close``, and the state ops
``feat_get``/``feat_put``/``mem_get``/``mem_put`` plus the coalesced
``state_batch`` — lives in ONE registered op table (:data:`OPS`), the
dispatch table a sampling server answers peers through.  Ops carry a
stats group (``sample`` vs ``state``).  The server and the
cross-process transport, and a barrier over ``torch.distributed`` in
place of the reference's coordination service, come with the multihost
launcher.

Determinism: the ``recent`` policy is stateless per hop, so serving
order cannot change results; the stochastic policies key their noise
per REQUEST (``TemporalSampler.request_key``), so they are order
independent too.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import numpy as np

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
