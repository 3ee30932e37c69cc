"""Logical-axis sharding substrate (counterpart of
``repro.dist.sharding``): the rules table, the mesh context, and a local
``shard_map`` with the collectives its bodies use.

Model code never names mesh axes directly.  It speaks in *logical* axes
("batch", "seq_act", "tp", "expert", ...) and this module maps them onto
the active mesh through a ``ShardingRules`` table, with the JAX
package's resolution rules:

    rules = default_rules()
    with sharding_ctx(make_local_mesh(1, 4), rules):
        logits, state = make_prefill_step(cfg)(params, batch)

Outside a ``sharding_ctx`` every lookup degrades to None / 1, so the
same model code runs unsharded.  Resolution against the active mesh
drops axes missing from the mesh, never uses an axis twice within one
spec (first dim wins) and, when the tensor shape is known, replicates a
dim the mapping does not divide.

The port's mesh is logical (``launch.mesh``): every shard lives on the
mesh's one device and holds whole tensors, and there is no GSPMD to
hint; on a process mesh every process holds whole tensors outside the
bodies.  So ``constrain`` and ``gather_fsdp`` are the identity, and
``named_shardings`` returns the sanitized spec tree itself.  What a
mesh changes is which path a model takes (``axis_for``,
``axis_size_of``) and the explicit ``shard_map`` bodies: context
parallel attention and expert-parallel MoE.

``shard_map`` runs a body once per shard, one shard after another, on
per-shard views cut from the inputs by their specs, and puts the
outputs back together by theirs.  A body that communicates is a
generator that yields each collective and receives its result:

    def body(q_l, k_l, v_l):
        k_f = yield all_gather(k_l, "model", axis=1, tiled=True)
        ...
        return out

The executor advances every shard to its next collective, checks that
all of them asked for the same one, computes it over each group's list
of tensors (``torch.cat``, ``split``, a sum in shard order) and sends
each shard its result.  That is deterministic and needs no threads.  A
shard that raises closes the others and the error propagates.

Under autograd every sum the executor implies is explicit and in shard
order (row-major over the mesh axes), never left to autograd's
accumulation.  The cut of the inputs is one autograd node
(:class:`_Boundary`) that hands back, in the backward, each input's
shards' gradient blocks put together, those of the shards that share a
block (an input replicated over an axis) added in shard order; the
assembly of the outputs is one node too; a collective (:class:`_Joint`)
is one node for its whole group whose backward is its transpose (an
all-gather's: the members' gradients added in shard order, each member
its own piece; an all-to-all's: the inverse all-to-all; ``pmean``'s:
the same mean).  The
process mesh (``launch.mesh.make_process_mesh``) runs one shard a
process and the same arithmetic over ``torch.distributed`` (``dist.spmd``,
behind :func:`shard_map`), so the two executors give the same bits.

On a process mesh an input whose spec is a :class:`Held` is this
process's block already (the expert-stacked weights, which four ranks
of a full-width model could not each hold whole); on the logical mesh a
``Held`` spec is its ``P``.

Under the dry run's cost trace (``launch.op_cost.CostMode``) the
executor charges each shard's body ops to that shard
(``op_cost.in_shard``) and each collective as its on-wire bytes a shard
(``op_cost.record_collective``; nothing over a group of one shard), not
as the HBM traffic of the ``cat``, ``split`` and sum that compute it.
"""
from __future__ import annotations

import inspect
import itertools
import math
import threading
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple, Union

import torch

from repro_torch.launch import op_cost
from repro_torch.launch.mesh import Mesh

PyTree = Any
Axis = Union[str, Tuple[str, ...], None]

#: Canonical logical axes understood by the rules table.
LOGICAL_AXES = (
    "batch",       # data-parallel batch dim of activations
    "seq_act",     # context/sequence-parallel dim of activations
    "embed_act",   # model dim of activations (usually replicated)
    "fsdp",        # weight dim gathered per layer (ZeRO-3 style)
    "embed_fsdp",  # fsdp axis for embedding/unembedding tables
    "moe_fsdp",    # fsdp axis for expert weights
    "tp",          # tensor-parallel weight dim
    "expert",      # expert-parallel dim of MoE weights
    "vocab",       # vocab dim of embedding table / logits
)

_FSDP_AXES = ("fsdp", "embed_fsdp", "moe_fsdp")


class P(tuple):
    """A partition spec: one entry per leading dim, each a mesh axis
    name, a tuple of names (one dim split over several axes) or None
    (replicated).  A one-name tuple is kept as the name, as
    ``jax.sharding.PartitionSpec`` keeps it."""

    def __new__(cls, *entries: Axis):
        return super().__new__(cls, (
            e[0] if isinstance(e, tuple) and len(e) == 1 else e
            for e in entries))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


class Held(P):
    """A ``P`` for an input the caller holds as its own block on a process
    mesh (``dist.spmd.hold_blocks``): the executor takes it as the
    shard's view as it is.  On the logical mesh it is the ``P`` itself."""

    def __repr__(self) -> str:
        return f"Held{tuple.__repr__(self)}"


class ShardingRules:
    """Immutable logical-axis -> mesh-axis table.

    Values are a mesh axis name, a tuple of names (one tensor dim split
    over several mesh axes), or None (replicated). Missing keys resolve
    to None, so partial tables (tests) are fine.
    """

    def __init__(self, table: Mapping[str, Axis]):
        self.table: Dict[str, Axis] = dict(table)

    def get(self, logical: Optional[str]) -> Axis:
        if logical is None:
            return None
        return self.table.get(logical)

    def override(self, **overrides: Axis) -> "ShardingRules":
        t = dict(self.table)
        t.update(overrides)
        return ShardingRules(t)

    def __eq__(self, other: object) -> bool:
        return (isinstance(other, ShardingRules)
                and self.table == other.table)

    def __repr__(self) -> str:
        return f"ShardingRules({self.table!r})"


def default_rules(*, multi_pod: bool = False) -> ShardingRules:
    """Training-layout defaults for the production meshes in launch.mesh.

    batch/fsdp ride the 'data' axis (plus 'pod' for the batch under
    multi-pod); tp/seq_act/expert share the 'model' axis (a tensor is
    only ever sharded by one of them at a time — the sanitizer drops
    duplicate uses within a single spec).
    """
    dp = ("pod", "data") if multi_pod else ("data",)
    return ShardingRules({
        "batch": dp,
        "seq_act": "model",
        "embed_act": None,
        "fsdp": ("data",),
        "embed_fsdp": ("data",),
        "moe_fsdp": None,
        "tp": "model",
        "expert": "model",
        "vocab": None,
    })


# ---------------------------------------------------------------------------
# Context management
# ---------------------------------------------------------------------------


class _CtxStack(threading.local):
    def __init__(self):
        self.stack = []        # (mesh, rules) of the open sharding_ctx's
        self.shard = []        # (mesh, coordinates) of the running shard


_CTX = _CtxStack()


@contextmanager
def sharding_ctx(mesh: Mesh, rules: ShardingRules):
    """Activate (mesh, rules) for the axis lookups and path choices."""
    _CTX.stack.append((mesh, rules))
    try:
        yield mesh, rules
    finally:
        _CTX.stack.pop()


def _current() -> Optional[Tuple[Mesh, ShardingRules]]:
    return _CTX.stack[-1] if _CTX.stack else None


def carry_ctx(fn):
    """``fn`` bound to the (mesh, rules) open now, re-entered around each
    call: the context is per thread, as the JAX package's, and autograd
    runs a CUDA graph's backward (a ``torch.utils.checkpoint``
    recompute included) on its device thread, where the caller's
    ``sharding_ctx`` is not open.  Without the context the recompute
    would take the unsharded paths.  ``fn`` itself outside any
    context."""
    ctx = _current()
    if ctx is None:
        return fn

    def run(*args, **kwargs):
        with sharding_ctx(*ctx):
            return fn(*args, **kwargs)
    return run


def active_mesh() -> Optional[Mesh]:
    c = _current()
    return c[0] if c else None


def active_rules() -> Optional[ShardingRules]:
    c = _current()
    return c[1] if c else None


# ---------------------------------------------------------------------------
# Axis lookups
# ---------------------------------------------------------------------------


def _names(axis: Axis) -> Tuple[str, ...]:
    if axis is None:
        return ()
    if isinstance(axis, str):
        return (axis,)
    return tuple(axis)


def axis_for(logical: str) -> Axis:
    """Mesh axis the logical axis maps to under the active ctx.

    None when outside a ctx, unmapped, or the mapped axes are absent
    from the active mesh. Preserves str vs tuple form of the rule.
    """
    c = _current()
    if c is None:
        return None
    mesh, rules = c
    ax = rules.get(logical)
    kept = tuple(n for n in _names(ax) if n in mesh.shape)
    if not kept:
        return None
    return ax if isinstance(ax, str) else kept


def axis_size_of(logical: str) -> int:
    """Number of shards the logical axis is split into (1 outside a ctx)."""
    c = _current()
    if c is None:
        return 1
    have = c[0].shape
    return math.prod(have.get(n, 1) for n in _names(axis_for(logical)))


# ---------------------------------------------------------------------------
# Spec resolution / sanitization
# ---------------------------------------------------------------------------


def _sanitize_spec(mesh: Mesh, entries: Sequence[Axis],
                   shape: Optional[Tuple[int, ...]] = None
                   ) -> Tuple[Axis, ...]:
    """Resolve per-dim mesh-axis entries into a valid spec body.

    Drops axes absent from the mesh, axes already consumed by an earlier
    dim, and (when `shape` is known) whole mappings that do not evenly
    divide their dim.
    """
    have = mesh.shape
    used: set = set()
    out = []
    for i, ax in enumerate(entries):
        names = [n for n in _names(ax) if n in have and n not in used]
        if names and shape is not None and i < len(shape):
            size = math.prod(have[n] for n in names)
            if size > 1 and shape[i] % size != 0:
                names = []
        if not names:
            out.append(None)
        elif len(names) == 1:
            out.append(names[0])
        else:
            out.append(tuple(names))
        used.update(names)
    return tuple(out)


def constrain(x: torch.Tensor, *logical: Optional[str]) -> torch.Tensor:
    """The JAX package's sharding hint by logical axis names: the
    identity here, where every shard holds whole tensors."""
    return x


def held_totals(params: PyTree):
    """The optimizer update's context for ``params``: on a process mesh
    whose processes hold blocks of the expert-stacked leaves, the
    update's whole-leaf sums add the other blocks' (``dist.spmd``);
    elsewhere it changes nothing."""
    from repro_torch.dist import spmd
    return spmd.held_totals(params)


def gather_fsdp(params: PyTree) -> PyTree:
    """The JAX package's per-layer un-sharding of the fsdp weight dims:
    the identity here, where every shard holds whole weights."""
    return params


def _is_spec(x) -> bool:
    return isinstance(x, P)


def _tree_map(fn, tree, path=(), is_leaf=lambda x: False):
    """``fn(path, leaf)`` over nested dicts, lists, tuples and named
    tuples; a path is the tuple of dict keys and list indices, as
    strings.  None is an empty subtree, as in ``jax.tree``."""
    if is_leaf(tree):
        return fn(path, tree)
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, path + (str(k),), is_leaf)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        items = [_tree_map(fn, v, path + (str(i),), is_leaf)
                 for i, v in enumerate(tree)]
        return type(tree)(*items) if hasattr(tree, "_fields") \
            else type(tree)(items)
    return fn(path, tree)


def named_shardings(mesh: Mesh, tree: PyTree) -> PyTree:
    """Spec tree -> the same tree with each spec sanitized against
    ``mesh`` (axes absent from it dropped): the JAX package's
    ``NamedSharding`` tree, whose placement has no meaning here."""
    return _tree_map(lambda _, spec: P(*_sanitize_spec(mesh, tuple(spec))),
                     tree, is_leaf=_is_spec)


# ---------------------------------------------------------------------------
# Parameter partition rules (name-based)
# ---------------------------------------------------------------------------

# Trailing-"core"-dims logical axes by parameter leaf name. Any extra
# leading dims (layer stacking, hybrid superlayer stacking) are
# replicated. Norm scales, biases, conv taps and fp32 SSM leaves (A_log,
# D, dt_bias) are small and stay replicated.
_CORE2: Dict[str, Tuple[Optional[str], ...]] = {
    "wq": ("fsdp", "tp"), "wk": ("fsdp", "tp"), "wv": ("fsdp", "tp"),
    "wo": ("tp", "fsdp"),
    "w_up": ("fsdp", "tp"), "w_gate": ("fsdp", "tp"),
    "w_down": ("tp", "fsdp"),
    "in_proj": ("fsdp", "tp"), "out_proj": ("tp", "fsdp"),
    "x_proj": ("tp", None), "dt_proj": (None, "tp"),
    "embed": ("vocab", "embed_fsdp"),
    "lm_head": ("embed_fsdp", "vocab"),
    "router": (None, None),  # fp32, tiny; replicated for exact routing
    # GNN-side parameters (models/gnn.py): projection cores follow the
    # same fsdp x tp layout as the LM blocks; per-head GAT attention
    # vectors and time-encoding leaves are tiny and stay replicated
    # (1-D leaves never match a 2-entry rule).
    "w_out1": ("fsdp", "tp"), "w_out2": ("tp", "fsdp"),
    "w_self": ("fsdp", "tp"), "w_nbr": ("fsdp", "tp"),
    "w_dst": ("fsdp", "tp"),
    "a_dst": (None, None), "a_nbr": (None, None),
    "w_z": ("fsdp", "tp"), "w_r": ("fsdp", "tp"),
    "w_n": ("fsdp", "tp"),
    "w1": ("fsdp", "tp"), "w2": ("fsdp", "tp"),
}
# Stacked expert weights (E, d_in, d_out) under a "moe" subtree.
_MOE_CORE3: Dict[str, Tuple[Optional[str], ...]] = {
    "w_up": ("expert", "moe_fsdp", "tp"),
    "w_gate": ("expert", "moe_fsdp", "tp"),
    "w_down": ("expert", "tp", "moe_fsdp"),
}


def _logical_param_axes(names: Tuple[str, ...], ndim: int
                        ) -> Tuple[Optional[str], ...]:
    """Per-dim logical axes for a parameter leaf, from its tree path."""
    leaf = names[-1] if names else ""
    in_moe_experts = ("moe" in names[:-1] and "shared" not in names
                      and leaf in _MOE_CORE3)
    core = _MOE_CORE3[leaf] if in_moe_experts else _CORE2.get(leaf)
    if core is None or ndim < len(core):
        return (None,) * ndim
    return (None,) * (ndim - len(core)) + tuple(core)


def param_partition_specs(params: PyTree,
                          rules: Optional[ShardingRules] = None) -> PyTree:
    """Parameter tree (tensors, meta tensors included) -> spec tree via
    the name-based rules.  Inside a sharding_ctx the specs are also
    sanitized against the active mesh (axes dropped where a dim is not
    divisible), so reduced configs get valid specs from the same table
    as the full-size configs."""
    c = _current()
    if rules is None:
        if c is None:
            raise ValueError(
                "param_partition_specs needs explicit rules or an active "
                "sharding_ctx")
        rules = c[1]
    mesh = c[0] if c else None

    def one(path, leaf):
        entries = [rules.get(l) for l in
                   _logical_param_axes(path, leaf.ndim)]
        if mesh is not None:
            entries = _sanitize_spec(mesh, entries, tuple(leaf.shape))
        return P(*entries)

    return _tree_map(one, params)


# ---------------------------------------------------------------------------
# Collectives and the local shard_map
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class _Collective:
    """What a shard body yields: a collective over the mesh axes
    ``names`` on tensor ``x``, with its keyword arguments ``args``."""
    kind: str
    x: Any
    names: Tuple[str, ...]
    args: Tuple[Tuple[str, Any], ...] = ()

    def key(self):
        return self.kind, self.names, self.args


def all_gather(x: torch.Tensor, axis_name: Axis, *, axis: int = 0,
               tiled: bool = False) -> _Collective:
    """``lax.all_gather``: the group's tensors in axis order, stacked on
    a new dim ``axis`` or, ``tiled``, concatenated along ``axis``."""
    return _Collective("all_gather", x, _names(axis_name),
                       (("axis", axis), ("tiled", tiled)))


def all_to_all(x: torch.Tensor, axis_name: Axis, split_axis: int,
               concat_axis: int, *, tiled: bool = False) -> _Collective:
    """``lax.all_to_all``: shard i receives chunk i of dim
    ``split_axis`` from every member, concatenated along
    ``concat_axis`` in member order; untiled, ``split_axis`` is the
    group size, its chunks lose that dim and stack on a new dim
    ``concat_axis``."""
    return _Collective("all_to_all", x, _names(axis_name),
                       (("split_axis", split_axis),
                        ("concat_axis", concat_axis), ("tiled", tiled)))


def pmean(x: torch.Tensor, axis_name: Axis) -> _Collective:
    """``lax.pmean``: the group's sum, added in shard order, over its
    size."""
    return _Collective("pmean", x, _names(axis_name))


def axis_index(axis_name: Axis) -> int:
    """The running shard's index along ``axis_name`` (row-major over a
    tuple of names), as ``lax.axis_index``; raises outside a shard
    body."""
    if not _CTX.shard:
        raise RuntimeError("axis_index: not inside a shard_map body")
    mesh, coords = _CTX.shard[-1]
    return _index(mesh, coords, _names(axis_name))


def _index(mesh: Mesh, coords: Tuple[int, ...], names) -> int:
    """Row-major index of ``coords`` over the mesh axes ``names``."""
    pos = dict(zip(mesh.axis_names, coords))
    i = 0
    for n in names:
        i = i * mesh.shape[n] + pos[n]
    return i


def _compute(c: _Collective, xs: list) -> list:
    """Collective ``c`` over the group's tensors ``xs`` (in group order):
    each member's result, contiguous whatever the layouts of ``xs`` (so
    every op after it runs on the same layout on either executor: a
    reduction's order follows its operand's strides)."""
    a, n = dict(c.args), len(xs)
    if c.kind == "all_gather":
        out = (torch.cat if a["tiled"] else torch.stack)(xs, dim=a["axis"])
        return [out.contiguous()] * n
    if c.kind == "pmean":
        return [(_sum_in_order(xs) / n).contiguous()] * n
    split, concat = a["split_axis"], a["concat_axis"]
    if xs[0].shape[split] % n:
        raise ValueError(f"all_to_all: dim {split} of {tuple(xs[0].shape)} "
                         f"does not split into {n}")
    if not a["tiled"] and xs[0].shape[split] != n:
        raise ValueError(f"all_to_all: untiled, dim {split} of "
                         f"{tuple(xs[0].shape)} must be the group size {n}")
    parts = [x.chunk(n, dim=split) for x in xs]
    if a["tiled"]:
        return [torch.cat([p[i] for p in parts], dim=concat).contiguous()
                for i in range(n)]
    return [torch.stack([p[i].squeeze(split) for p in parts],
                        dim=concat).contiguous() for i in range(n)]


def _sum_in_order(xs: list) -> torch.Tensor:
    total = xs[0]
    for x in xs[1:]:
        total = total + x
    return total


def _inverse(c: _Collective) -> _Collective:
    """The all-to-all that undoes the all-to-all ``c``."""
    a = dict(c.args)
    return _Collective("all_to_all", None, c.names,
                       (("split_axis", a["concat_axis"]),
                        ("concat_axis", a["split_axis"]),
                        ("tiled", a["tiled"])))


def _transpose(c: _Collective, gs: list) -> list:
    """The transpose of collective ``c`` over its members' result
    gradients ``gs`` (in group order): each member's input gradient."""
    if c.kind == "pmean":
        return _compute(c, gs)
    if c.kind == "all_to_all":
        return _compute(_inverse(c), gs)
    a, n = dict(c.args), len(gs)
    total = _sum_in_order(gs)
    if not a["tiled"]:
        return [total.select(a["axis"], i).contiguous() for i in range(n)]
    size = total.shape[a["axis"]] // n
    return [total.narrow(a["axis"], i * size, size).contiguous()
            for i in range(n)]


class _Joint(torch.autograd.Function):
    """A collective over its group's tensors as one autograd node whose
    backward is its transpose (:func:`_transpose`)."""

    @staticmethod
    def forward(ctx, c, *xs):
        ctx.c = c
        seen, outs = set(), []
        for o in _compute(c, list(xs)):
            outs.append(o.clone() if id(o) in seen else o)  # one a member
            seen.add(id(o))
        return tuple(outs)

    @staticmethod
    def backward(ctx, *gs):
        return (None, *_transpose(ctx.c, list(gs)))


def _spec_names(mesh: Mesh, spec: P) -> list:
    """Each dim's mesh axes; raises on an axis not in the mesh or used
    twice."""
    dims, seen = [], set()
    for entry in spec:
        names = _names(entry)
        for nm in names:
            if nm not in mesh.shape or nm in seen:
                raise ValueError(f"shard_map: spec {spec!r} on mesh axes "
                                 f"{mesh.axis_names}")
            seen.add(nm)
        dims.append(names)
    return dims


def _map_specs(specs, tree, fn):
    """``fn(spec, leaf)`` over ``tree``, ``specs`` a prefix of it whose
    ``P`` entries apply to the whole subtree under them."""
    if isinstance(specs, P):
        return _tree_map(lambda _, leaf: fn(specs, leaf), tree)
    if isinstance(specs, dict):
        return {k: _map_specs(specs[k], v, fn) for k, v in tree.items()}
    if isinstance(specs, (list, tuple)):
        if len(specs) != len(tree):
            raise ValueError(f"shard_map: {len(specs)} specs for "
                             f"{len(tree)} values")
        return type(tree)(_map_specs(s, v, fn) for s, v in zip(specs, tree))
    raise TypeError(f"shard_map: spec {specs!r}")


def _shard_view(mesh: Mesh, coords, spec: P, x):
    """Shard ``coords``' block of ``x`` under ``spec`` (a view)."""
    if not isinstance(x, torch.Tensor):
        return x
    if mesh.device is not None and (
            x.device.type != mesh.device.type
            or (mesh.device.index is not None
                and x.device.index != mesh.device.index)):
        raise ValueError(f"shard_map: a tensor on {x.device}, the mesh's "
                         f"shards on {mesh.device}")
    for dim, names in enumerate(_spec_names(mesh, spec)):
        if not names:
            continue
        n = math.prod(mesh.shape[nm] for nm in names)
        if x.shape[dim] % n:
            raise ValueError(f"shard_map: dim {dim} of {tuple(x.shape)} "
                             f"does not split into {n} ({spec!r})")
        size = x.shape[dim] // n
        x = x.narrow(dim, _index(mesh, coords, names) * size, size)
    return x


def _assemble(mesh: Mesh, coords: list, spec: P, blocks: list, *,
              add: bool = False):
    """The global value of one output from each shard's block: blocks
    concatenated along the dims ``spec`` maps, in shard order; over the
    mesh axes it does not name, shard 0's (a ``P()`` output is shard
    0's value, which the body made the same on every shard) or, with
    ``add``, the sum of the shards' blocks in shard order (the gradient
    of an input replicated over those axes)."""
    dims = _spec_names(mesh, spec)
    at = {}
    for c, b in zip(coords, blocks):
        key = tuple(_index(mesh, c, names) for names in dims)
        if add and key in at:
            at[key] = at[key] + b
        elif add or _used(mesh, c, spec):
            at[key] = b
    out = _cat_blocks(mesh, dims, at, ())
    return out.contiguous() if isinstance(out, torch.Tensor) else out


def _cat_blocks(mesh: Mesh, dims: list, at: dict, prefix: tuple):
    """The blocks ``at`` (by their index along each dim) under ``prefix``
    concatenated.  A module function, not a closure that calls itself:
    such a closure is a reference cycle, and its blocks (activations, or
    a backward's gradient blocks, GBs at full width) would live on until
    the cyclic garbage collector ran."""
    d = len(prefix)
    if d == len(dims):
        return at[prefix]
    n = math.prod(mesh.shape[nm] for nm in dims[d])
    parts = [_cat_blocks(mesh, dims, at, prefix + (j,)) for j in range(n)]
    return parts[0] if n == 1 else torch.cat(parts, dim=d)


class _Boundary(torch.autograd.Function):
    """One autograd node for all of a ``shard_map``'s inputs that need a
    gradient (its cut), or all of its outputs (its assembly):
    ``fwd(xs) -> outputs``, ``bwd(output grads) -> input grads``.  One
    node, so the shards' gradients leave a body together and the nodes
    around it run in the same order on either executor."""

    @staticmethod
    def forward(ctx, fwd, bwd, *xs):
        ctx.bwd = bwd
        return tuple(fwd(list(xs)))

    @staticmethod
    def backward(ctx, *gs):
        return (None, None, *ctx.bwd(list(gs)))


def _needs_grad(x) -> bool:
    return (isinstance(x, torch.Tensor) and x.requires_grad
            and torch.is_grad_enabled())


def _leaves(specs, trees) -> list:
    """(spec, leaf) of every leaf of ``trees`` that needs a gradient, in
    ``_map_specs`` order."""
    out = []
    for sp, t in zip(specs, trees):
        _map_specs(sp, t, lambda spec, x: out.append((spec, x)) if
                   _needs_grad(x) else None)
    return out


def _cut_all(mesh: Mesh, coords: list, in_specs, args) -> list:
    """Each shard's views of ``args`` (a list a shard), the views of the
    inputs that need a gradient made by one :class:`_Boundary` whose
    backward puts each input's gradient together from the shards'
    blocks, adding those of shards that share a block in shard order."""
    grad = _leaves(in_specs, args)
    n = len(coords)
    if grad:
        specs = [sp for sp, _ in grad]
        flat = _Boundary.apply(
            lambda xs: [_shard_view(mesh, c, sp, x)
                        for sp, x in zip(specs, xs) for c in coords],
            lambda gs: [_assemble(mesh, coords, sp, gs[j * n:(j + 1) * n],
                                  add=True) for j, sp in enumerate(specs)],
            *[x for _, x in grad])
    views = []
    for s, c in enumerate(coords):
        it = iter(flat[s::n]) if grad else iter(())
        views.append([_map_specs(sp, a, lambda spec, x, c=c: next(it)
                                 if _needs_grad(x)
                                 else _shard_view(mesh, c, spec, x))
                      for sp, a in zip(in_specs, args)])
    return views


@contextmanager
def _in_shard(mesh: Mesh, coords):
    _CTX.shard.append((mesh, coords))
    try:
        with op_cost.in_shard(tuple(coords)):
            yield
    finally:
        _CTX.shard.pop()


def shard_map(f, *, mesh: Mesh, in_specs, out_specs):
    """Run ``f`` once per shard of ``mesh``, one shard after another on
    the mesh's device (the module docstring): each positional argument
    cut into per-shard views by its entry of ``in_specs`` (a prefix tree
    of ``P``), each output put together by ``out_specs``.  ``f`` may be
    a generator that yields collectives (:func:`all_gather`,
    :func:`all_to_all`, :func:`pmean`); every shard must yield the same
    ones in the same order."""
    if mesh.device is None:
        raise ValueError("shard_map: the mesh has no device (a shape-only "
                         "mesh)")
    if getattr(mesh, "groups", None) is not None:     # a ProcessMesh
        from repro_torch.dist import spmd
        return spmd.shard_map(f, mesh=mesh, in_specs=in_specs,
                              out_specs=out_specs)

    def run(*args):
        if not isinstance(in_specs, (tuple, list)) or len(in_specs) != len(
                args):
            raise ValueError("shard_map: in_specs needs one entry per "
                             "argument")
        coords = list(itertools.product(*(range(n)
                                          for n in mesh.axis_sizes)))
        outs = [None] * len(coords)
        gens = {}
        per_shard = _cut_all(mesh, coords, in_specs, args)
        try:
            for s, c in enumerate(coords):
                views = per_shard[s]
                with _in_shard(mesh, c):
                    r = f(*views)
                if inspect.isgenerator(r):
                    gens[s] = r
                else:
                    outs[s] = r
            if gens and len(gens) != len(coords):
                raise RuntimeError("shard_map: some shards' bodies are "
                                   "generators and some are not")
            sent = {s: None for s in gens}
            while gens:
                asked, done = {}, []
                for s, g in gens.items():
                    with _in_shard(mesh, coords[s]):
                        try:
                            asked[s] = g.send(sent[s])
                        except StopIteration as stop:
                            outs[s] = stop.value
                            done.append(s)
                for s in done:
                    del gens[s]
                if asked and done:
                    raise RuntimeError("shard_map: shards disagree on "
                                       "their collectives")
                if asked:
                    sent = _collect(mesh, coords, asked)
        finally:
            for s, g in gens.items():
                with _in_shard(mesh, coords[s]):
                    g.close()
        return _put_together(mesh, coords, out_specs, outs)

    return run


def _collect(mesh: Mesh, coords: list, asked: dict) -> dict:
    """Each shard's result of the collective every shard asked for."""
    keys = {c.key() if isinstance(c, _Collective) else None
            for c in asked.values()}
    if len(keys) != 1 or None in keys:
        raise RuntimeError(f"shard_map: shards asked for different "
                           f"collectives: {sorted(map(str, keys))}")
    first = next(iter(asked.values()))
    names = first.names
    for nm in names:
        if nm not in mesh.shape:
            raise ValueError(f"{first.kind}: axis {nm!r} not in the mesh "
                             f"{mesh.axis_names}")
    groups: Dict[tuple, list] = {}
    for s in asked:
        pos = dict(zip(mesh.axis_names, coords[s]))
        rest = tuple(pos[a] for a in mesh.axis_names if a not in names)
        groups.setdefault(rest, []).append(s)
    sent = {}
    trace = op_cost.active()
    for members in groups.values():
        members.sort(key=lambda s: _index(mesh, coords[s], names))
        xs = [asked[s].x for s in members]
        if any(_needs_grad(x) for x in xs):
            compute = lambda c, xs: list(_Joint.apply(
                _Collective(c.kind, None, c.names, c.args), *xs))
        else:
            compute = _compute
        if trace is None:
            res = compute(first, xs)
        else:      # a dry run: charged as the wire's bytes, a shard each
            with trace.quiet():
                res = compute(first, xs)
            for s, r in zip(members, res):
                if len(members) > 1:       # over one shard: no wire
                    op_cost.record_collective(
                        first.kind, op_cost.wire_bytes(first.kind, r),
                        names, tuple(coords[s]))
        sent.update(zip(members, res))
    return sent


def _walk_outputs(specs, per_shard: list, fn):
    """``fn(spec, blocks)`` for each output leaf (its shards' blocks), in
    one order, into the outputs' tree (a module function: see
    :func:`_cat_blocks`)."""
    if isinstance(specs, P):
        return _tree_map_multi(lambda blocks: fn(specs, blocks), per_shard)
    if isinstance(specs, dict):
        return {k: _walk_outputs(sp, [o[k] for o in per_shard], fn)
                for k, sp in specs.items()}
    if isinstance(specs, (list, tuple)):
        return type(specs)(_walk_outputs(sp, [o[i] for o in per_shard], fn)
                           for i, sp in enumerate(specs))
    raise TypeError(f"shard_map: spec {specs!r}")


def _used(mesh: Mesh, c, spec: P) -> bool:
    """Whether the assembly takes shard ``c``'s block of an output under
    ``spec`` (its coordinates on the axes the spec does not name are 0)."""
    used = {nm for names in _spec_names(mesh, spec) for nm in names}
    pos = dict(zip(mesh.axis_names, c))
    return all(pos[a] == 0 for a in mesh.axis_names if a not in used)


def _put_together(mesh: Mesh, coords: list, out_specs, outs: list):
    """The outputs' global values from the shards' outputs; those that
    need a gradient through one :class:`_Boundary`, whose backward gives
    each shard its block of the gradient (zeros to a shard whose block
    the assembly did not take)."""
    grad = []
    _walk_outputs(out_specs, outs, lambda spec, blocks: grad.append(
        (spec, blocks)) if any(map(_needs_grad, blocks)) else None)
    n = len(coords)
    shapes = [[b.shape for b in blocks] for _, blocks in grad]
    specs = [sp for sp, _ in grad]

    def back(gs):
        return [_shard_view(mesh, c, sp, g).contiguous()
                if _used(mesh, c, sp) else g.new_zeros(shape)
                for sp, sh, g in zip(specs, shapes, gs)
                for c, shape in zip(coords, sh)]
    done = iter(_Boundary.apply(
        lambda xs: [_assemble(mesh, coords, sp, xs[j * n:(j + 1) * n])
                    for j, sp in enumerate(specs)],
        back, *[b for _, blocks in grad for b in blocks]) if grad else ())
    return _walk_outputs(out_specs, outs, lambda spec, blocks: next(done)
                         if any(map(_needs_grad, blocks))
                         else _assemble(mesh, coords, spec, blocks))


def _tree_map_multi(fn, trees: list):
    """``fn(list of leaves)`` over trees of one structure."""
    t0 = trees[0]
    if isinstance(t0, dict):
        return {k: _tree_map_multi(fn, [t[k] for t in trees]) for k in t0}
    if isinstance(t0, (list, tuple)):
        return type(t0)(_tree_map_multi(fn, [t[i] for t in trees])
                        for i in range(len(t0)))
    return fn(trees)
