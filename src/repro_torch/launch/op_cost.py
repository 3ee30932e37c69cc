"""Per-device cost trace of the port's eager program on the ``meta``
device (counterpart of ``repro.launch.hlo_cost``).

The JAX package compiles a step for devices it does not have and parses
the optimized HLO.  PyTorch has no HLO: the port's program is the
sequence of aten ops that eager mode runs.  So the dry run runs the step
itself on ``meta`` tensors (shapes and dtypes, no memory, no card)
inside :class:`CostMode`, a ``TorchDispatchMode`` that sees every aten
op, forward and backward, and charges it:

* **FLOPs**: the formulas of ``torch.utils.flop_counter`` for ``mm``,
  ``bmm``, ``addmm``, ``baddbmm`` and the convolutions: 2·M·N·K a
  product, as ``hlo_cost`` charges a ``dot``.  Every other op is 0.
  Eager runs each layer of the Python loop, so no trip count needs
  scaling: the undercount ``hlo_cost`` repairs does not arise.
* **Bytes**: the eager program's own HBM traffic, op by op, not XLA's
  fusion model.  ``hlo_cost`` makes casts, copies and pass-through
  operands free because they are XLA artefacts a TPU compiler fuses or
  aliases away; in eager PyTorch each is a kernel of its own, so here:
    - views and aliases (``view``, ``expand``, ``transpose``,
      ``permute``, ``slice``, ``select``, ``squeeze``, ``split``,
      ``as_strided``, ``alias``, ``detach``, ...: every op whose schema
      says its output aliases an input; and ``_unsafe_view``, which
      shares its input's storage though its schema does not say so:
      every 3-D ``matmul`` ends in one) are free;
    - an allocation (``empty``, ``empty_like``, ...) is free: it moves
      no byte;
    - an op with no tensor operand (``zeros``, ``arange``, ...), a fill
      (``fill_``, ``zero_``, ``zeros_like``, ...) writes its result
      only;
    - ``copy_`` reads its source and writes its destination;
    - a gather (``index``, ``index_select``, ``gather``, ``embedding``)
      charges 2 × its result plus its indices: it reads rows, not the
      table (``hlo_cost``'s gather rule);
    - a scatter (``index_put_``, ``scatter``, ``scatter_add``,
      ``index_add``, ``index_copy``, ``embedding_dense_backward``)
      charges 2 × its updates plus its indices (``hlo_cost``'s
      scatter rule);
    - every other op, copies and dtype casts included, its result plus
      every operand once.
* **Kernels**: the hand-written kernels' wrappers take a ``meta`` path
  that allocates the outputs the kernel writes and charges the kernel's
  own counts (:func:`kernel_call`): one *call* in the trace, never a
  launch (``runtime.count_launch`` counts launches on the card).
* **Collectives**: the local ``shard_map`` executor
  (``dist.sharding``) reports each collective it computes
  (:func:`record_collective`) in ``hlo_cost``'s on-wire convention:
  an all-gather and an all-to-all their result bytes a shard, a
  ``pmean`` (an all-reduce) 2 × its result; the ops that compute it
  (``cat``, ``split``, the sum) are charged nothing else
  (:meth:`CostMode.quiet`).
* **Live bytes**: each storage an op creates is followed by a weak
  reference, as ``torch.distributed._tools.mem_tracker`` follows them,
  and counted, rounded up to the caching allocator's 512 B, from its
  creation to its release; the trace keeps the peak.  Storages that
  existed before the trace (the state, the batch) are not counted.

Every op is charged to a *scope*: the shard of a ``shard_map`` body it
ran in (:func:`in_shard`), or none.  :meth:`CostMode.total_cost` gives
one device's share: ops outside any body ``÷ devices`` (an ideal split:
the port has no partitioner to say what would be replicated), plus the
largest shard's body costs.  A kernel's backward is charged to the shard
its forward ran in (``remember``/``recall`` of :func:`kernel_call`); the
backward of a body's other ops runs outside the body, so it takes the
ideal split, which is the mean over the shards, exact where the shards
do equal work.
"""
from __future__ import annotations

import threading
import weakref
from collections import defaultdict
from contextlib import contextmanager
from typing import Dict, List, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

aten = torch.ops.aten

# caching allocator's block size: memory_allocated counts each block
# rounded up to it
ALLOC_ROUND = 512

_FLOP_OPS = frozenset((aten.mm, aten.bmm, aten.addmm, aten.baddbmm,
                       aten.convolution, aten._convolution,
                       aten.convolution_backward))
_FREE = frozenset((aten.empty, aten.empty_like, aten.empty_strided,
                   aten.new_empty, aten.new_empty_strided, aten.detach,
                   aten.alias, aten.lift_fresh, aten._unsafe_view))
_WRITE_ONLY = frozenset((aten.fill_, aten.zero_, aten.zeros_like,
                         aten.ones_like, aten.full_like, aten.new_zeros,
                         aten.new_ones, aten.new_full, aten.fill))
# gathers: op -> the argument positions of its index tensors
_GATHERS = {aten.index: (1,), aten.index_select: (2,), aten.gather: (2,),
            aten.embedding: (1,)}
# scatters: op -> (index positions, the updates' position; a scalar value
# there moves one element of the target an index)
_SCATTERS = {aten.index_put: ((1,), 2), aten.index_put_: ((1,), 2),
             aten._index_put_impl_: ((1,), 2),
             aten.scatter: ((2,), 3), aten.scatter_: ((2,), 3),
             aten.scatter_add: ((2,), 3), aten.scatter_add_: ((2,), 3),
             aten.index_add: ((2,), 3), aten.index_add_: ((2,), 3),
             aten.index_copy: ((2,), 3), aten.index_copy_: ((2,), 3),
             aten.embedding_dense_backward: ((1,), 0)}


class _State(threading.local):
    def __init__(self):
        self.modes: List["CostMode"] = []   # the open traces, innermost last
        self.scope: list = []               # the running shard, if any


_STATE = _State()


def active() -> Optional["CostMode"]:
    """The innermost open :class:`CostMode`, or None."""
    return _STATE.modes[-1] if _STATE.modes else None


@contextmanager
def in_shard(key):
    """Ops run inside the block are charged to shard ``key`` (the shard's
    mesh coordinates); ``dist.sharding.shard_map`` enters it around each
    step of a shard's body."""
    _STATE.scope.append(key)
    try:
        yield
    finally:
        _STATE.scope.pop()


def _scope():
    return _STATE.scope[-1] if _STATE.scope else None


def nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def wire_bytes(kind: str, result: torch.Tensor) -> float:
    """One shard's on-wire bytes of a collective with this result, in
    ``hlo_cost``'s convention: all-gather and all-to-all the result, an
    all-reduce (``pmean``) twice it (ring reduce-scatter, all-gather)."""
    return (2.0 if kind == "pmean" else 1.0) * nbytes(result)


def record_collective(kind: str, bytes_per_shard: float, group, shard
                      ) -> None:
    """Charge one shard's share of a collective over the mesh axes
    ``group`` to the open trace (no-op without one)."""
    mode = active()
    if mode is not None:
        mode.collectives[shard][(kind, tuple(group))] += bytes_per_shard


def kernel_call(name: str, flops: float, reads, writes, *,
                remember: Optional[torch.Tensor] = None,
                recall: Optional[torch.Tensor] = None) -> None:
    """Charge one call of the hand-written kernel ``name`` (its meta
    path) to the open trace (no-op without one): its ``flops``, each
    tensor of ``reads`` read once and each of ``writes`` written once
    (None entries skipped).  ``remember``: a tensor the forward saves
    for its backward, on whose storage the running shard is noted;
    ``recall``: that tensor in the backward, whose noted shard the call
    is charged to (autograd runs a body's backward outside the body)."""
    mode = active()
    if mode is None:
        return
    scope = _scope()
    if recall is not None:
        scope = mode._noted.get(recall.untyped_storage()._cdata, scope)
    if remember is not None:
        mode._noted[remember.untyped_storage()._cdata] = scope
    moved = sum(nbytes(t) for t in tensors((reads, writes)))
    mode._charge(scope, f"kernel:{name}", flops, moved)
    mode.kernel_calls[name] += 1


def tensors(tree, out=None) -> list:
    """The tensors in nested tuples, lists and dicts (an op's arguments
    and results), in order."""
    out = [] if out is None else out
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            tensors(v, out)
    elif isinstance(tree, dict):
        for v in tree.values():
            tensors(v, out)
    return out


def _bytes_at(args, positions) -> int:
    total = 0
    for i in positions:
        if i < len(args):
            total += sum(nbytes(t) for t in tensors(args[i]))
    return total


def op_bytes(func, args, kwargs, out, operands=None) -> float:
    """The HBM bytes the module docstring's rules charge one aten op
    (``operands``: its tensor arguments, if the caller has them)."""
    pkt = func._overloadpacket
    if func.is_view or pkt in _FREE:
        return 0.0
    result = sum(nbytes(t) for t in tensors(out))
    if pkt in _GATHERS:
        return 2.0 * result + _bytes_at(args, _GATHERS[pkt])
    if pkt in _SCATTERS:
        idx_pos, upd_pos = _SCATTERS[pkt]
        idx = _bytes_at(args, idx_pos)
        upd = args[upd_pos] if upd_pos < len(args) else kwargs.get("src")
        if isinstance(upd, torch.Tensor):
            upd_bytes = nbytes(upd)
        else:
            upd_bytes = sum(t.numel() for t in tensors(args[idx_pos[0]])) \
                * args[0].element_size()
        return 2.0 * upd_bytes + idx
    if operands is None:
        operands = tensors((args, kwargs))
    if pkt in _WRITE_ONLY or not operands:
        return float(result)
    if pkt is aten.copy_:
        return float(nbytes(args[1]) + result)
    return float(result + sum(nbytes(t) for t in operands))


def op_flops(func, args, kwargs, out) -> float:
    pkt = func._overloadpacket
    if pkt not in _FLOP_OPS:
        return 0.0
    return float(flop_registry[pkt](*args, **kwargs, out_val=out))


class CostMode(TorchDispatchMode):
    """Charge every aten op run inside it (module docstring).

        with CostMode(devices=mesh.size) as trace:
            step(state, batch)            # meta tensors
        trace.total_cost()                # one device's share

    ``devices`` is the number of devices the ops outside any
    ``shard_map`` body split over."""

    def __init__(self, devices: int = 1):
        super().__init__()
        self.devices = devices
        self.cost: Dict = defaultdict(lambda: [0.0, 0.0])  # scope -> [F, B]
        self.collectives: Dict = defaultdict(lambda: defaultdict(float))
        self.kernel_calls: Dict[str, int] = defaultdict(int)
        self.ops: Dict[str, list] = defaultdict(lambda: [0, 0.0, 0.0])
        self.live_bytes = 0
        self.peak_live_bytes = 0
        self._live: Dict[int, tuple] = {}   # storage id -> (weakref, bytes)
        self._noted: Dict[int, object] = {}
        self._quiet = 0

    def __enter__(self):
        _STATE.modes.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            _STATE.modes.remove(self)

    @contextmanager
    def quiet(self):
        """Ops inside are charged nothing (a collective's own ``cat``,
        ``split`` and sum, whose bytes :func:`record_collective`
        charges); their storages are still followed."""
        self._quiet += 1
        try:
            yield
        finally:
            self._quiet -= 1

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if (func._overloadpacket is aten.bincount
                and args[0].device.type == "meta"):
            # no meta kernel: its length is max(minlength, max + 1), and
            # the moe layer's expert ids lie below its minlength
            weights = args[1] if len(args) > 1 else kwargs.get("weights")
            if weights is not None:
                raise NotImplementedError("bincount with weights on meta")
            n = args[2] if len(args) > 2 else kwargs.get("minlength", 0)
            out = torch.empty((n,), dtype=torch.long, device="meta")
        else:
            out = func(*args, **kwargs)
        operands = tensors((args, kwargs))
        self._follow(operands, out)
        if not self._quiet:
            self._charge(_scope(), func._overloadpacket.__name__,
                         op_flops(func, args, kwargs, out),
                         op_bytes(func, args, kwargs, out, operands))
        return out

    def _charge(self, scope, name, flops, nbytes_moved):
        c = self.cost[scope]
        c[0] += flops
        c[1] += nbytes_moved
        op = self.ops[name]
        op[0] += 1
        op[1] += flops
        op[2] += nbytes_moved

    def _follow(self, operands, out):
        outs = tensors(out)
        if not outs:
            return
        seen = {t.untyped_storage()._cdata for t in operands}
        for t in outs:
            st = t.untyped_storage()
            key = st._cdata
            if key in seen or key in self._live:
                continue
            seen.add(key)
            n = -(-st.nbytes() // ALLOC_ROUND) * ALLOC_ROUND
            self._live[key] = (weakref.ref(st, self._freed(key)), n)
            self.live_bytes += n
            self.peak_live_bytes = max(self.peak_live_bytes, self.live_bytes)

    def _freed(self, key):
        def done(_):
            entry = self._live.pop(key, None)
            if entry is not None:
                self.live_bytes -= entry[1]
            self._noted.pop(key, None)
        return done

    # ---- report ----

    def _device(self, values: Dict, index=None) -> float:
        """One device's share of a per-scope quantity: outside any body
        ÷ devices, plus the largest shard's."""
        get = (lambda v: v) if index is None else (lambda v: v[index])
        outside = get(values[None]) if None in values else 0.0
        shards = [get(v) for k, v in values.items() if k is not None]
        return outside / self.devices + (max(shards) if shards else 0.0)

    def collective_groups(self) -> Dict[tuple, float]:
        """(kind, mesh axes) -> one device's on-wire bytes: the largest
        shard's."""
        out: Dict[tuple, float] = defaultdict(float)
        for per in self.collectives.values():
            for key, b in per.items():
                out[key] = max(out[key], b)
        return dict(out)

    def total_cost(self) -> Dict[str, float]:
        """One device's ``flops``, ``bytes`` and ``collective_bytes``, and
        the trace's ``peak_live_bytes`` (all devices' together)."""
        return {
            "flops": self._device(self.cost, 0),
            "bytes": self._device(self.cost, 1),
            "collective_bytes": float(sum(self.collective_groups().values())),
            "peak_live_bytes": float(self.peak_live_bytes),
        }

    def top_ops(self, n: int = 12) -> Dict[str, list]:
        """The ``n`` ops (aten op names, ``kernel:<name>`` for a kernel)
        that moved the most bytes and did the most FLOPs, summed over
        every scope (``hlo_cost.collective_breakdown``'s counterpart)."""
        rows = [{"op": name, "calls": c, "flops": f, "bytes": b}
                for name, (c, f, b) in self.ops.items()]
        return {
            "by_bytes": sorted(rows, key=lambda r: -r["bytes"])[:n],
            "by_flops": [r for r in sorted(rows, key=lambda r: -r["flops"])
                         if r["flops"] > 0][:n],
        }
