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
hint.  So ``constrain`` and ``gather_fsdp`` are the identity, and
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
each shard its result.  That is deterministic and needs no threads; the
collectives are tensor ops, so autograd runs through them (the
all-gather's transpose, a reduce-scatter of the gradient, falls out of
``cat``).  A shard that raises closes the others and the error
propagates.
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


def gather_fsdp(params: PyTree) -> PyTree:
    """The JAX package's per-layer un-sharding of the fsdp weight dims:
    the identity here, where every shard holds whole weights."""
    return params


def _is_spec(x) -> bool:
    return isinstance(x, P)


def _tree_map(fn, tree, path=(), is_leaf=lambda x: False):
    """``fn(path, leaf)`` over nested dicts, lists and tuples; a path is
    the tuple of dict keys and list indices, as strings."""
    if is_leaf(tree):
        return fn(path, tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, path + (str(k),), is_leaf)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v, path + (str(i),), is_leaf)
                          for i, v in enumerate(tree))
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
    each member's result."""
    a, n = dict(c.args), len(xs)
    if c.kind == "all_gather":
        out = (torch.cat if a["tiled"] else torch.stack)(xs, dim=a["axis"])
        return [out] * n
    if c.kind == "pmean":
        total = xs[0]
        for x in xs[1:]:
            total = total + x
        return [total / n] * n
    split, concat = a["split_axis"], a["concat_axis"]
    if xs[0].shape[split] % n:
        raise ValueError(f"all_to_all: dim {split} of {tuple(xs[0].shape)} "
                         f"does not split into {n}")
    if not a["tiled"] and xs[0].shape[split] != n:
        raise ValueError(f"all_to_all: untiled, dim {split} of "
                         f"{tuple(xs[0].shape)} must be the group size {n}")
    parts = [x.chunk(n, dim=split) for x in xs]
    if a["tiled"]:
        return [torch.cat([p[i] for p in parts], dim=concat)
                for i in range(n)]
    return [torch.stack([p[i].squeeze(split) for p in parts], dim=concat)
            for i in range(n)]


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


def _assemble(mesh: Mesh, coords: list, spec: P, blocks: list):
    """The global value of one output from each shard's block: blocks
    concatenated along the dims ``spec`` maps, in shard order; over the
    mesh axes it does not name, shard 0's (a ``P()`` output is shard
    0's value, which the body made the same on every shard)."""
    dims = _spec_names(mesh, spec)
    used = {nm for names in dims for nm in names}
    at = {}
    for c, b in zip(coords, blocks):
        pos = dict(zip(mesh.axis_names, c))
        if all(pos[a] == 0 for a in mesh.axis_names if a not in used):
            at[tuple(_index(mesh, c, names) for names in dims)] = b
    if not dims:
        return at[()]

    def cat(prefix):
        d = len(prefix)
        if d == len(dims):
            return at[prefix]
        n = math.prod(mesh.shape[nm] for nm in dims[d])
        parts = [cat(prefix + (j,)) for j in range(n)]
        return parts[0] if n == 1 else torch.cat(parts, dim=d)
    return cat(())


@contextmanager
def _in_shard(mesh: Mesh, coords):
    _CTX.shard.append((mesh, coords))
    try:
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

    def run(*args):
        if not isinstance(in_specs, (tuple, list)) or len(in_specs) != len(
                args):
            raise ValueError("shard_map: in_specs needs one entry per "
                             "argument")
        coords = list(itertools.product(*(range(n)
                                          for n in mesh.axis_sizes)))
        outs = [None] * len(coords)
        gens = {}
        try:
            for s, c in enumerate(coords):
                views = [_map_specs(sp, a, lambda spec, x, c=c:
                                    _shard_view(mesh, c, spec, x))
                         for sp, a in zip(in_specs, args)]
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
    for members in groups.values():
        members.sort(key=lambda s: _index(mesh, coords[s], names))
        res = _compute(first, [asked[s].x for s in members])
        sent.update(zip(members, res))
    return sent


def _put_together(mesh: Mesh, coords: list, out_specs, outs: list):
    """The outputs' global values from the shards' outputs."""
    def walk(specs, per_shard):
        if isinstance(specs, P):
            return _tree_map_multi(
                lambda blocks: _assemble(mesh, coords, specs, blocks),
                per_shard)
        if isinstance(specs, dict):
            return {k: walk(sp, [o[k] for o in per_shard])
                    for k, sp in specs.items()}
        if isinstance(specs, (list, tuple)):
            return type(specs)(walk(sp, [o[i] for o in per_shard])
                               for i, sp in enumerate(specs))
        raise TypeError(f"shard_map: spec {specs!r}")
    return walk(out_specs, outs)


def _tree_map_multi(fn, trees: list):
    """``fn(list of leaves)`` over trees of one structure."""
    t0 = trees[0]
    if isinstance(t0, dict):
        return {k: _tree_map_multi(fn, [t[k] for t in trees]) for k in t0}
    if isinstance(t0, (list, tuple)):
        return type(t0)(_tree_map_multi(fn, [t[i] for t in trees])
                        for i in range(len(t0)))
    return fn(trees)
