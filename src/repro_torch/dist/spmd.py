"""The process-group executor behind ``dist.sharding.shard_map``: one OS
process a shard, as JAX runs a ``shard_map`` body on every device of
the mesh at once.

On a :class:`~repro_torch.launch.mesh.ProcessMesh` each process runs
only its own shard's body:

* **the cut**: every input is whole on every process (what lies outside
  a body runs whole everywhere), and the shard's view is cut from it as
  the logical executor cuts it; a :class:`~repro_torch.dist.sharding.Held`
  input is the process's block already.  Under autograd the cut's
  backward all-gathers every shard's gradient block and puts the whole
  gradient together, the blocks of shards that share one added in shard
  order; a held block's adds the copies of the processes that hold the
  same block;
* **the collectives** the body yields run over the process's subgroup of
  the named axes, with the semantics and errors of the logical
  executor's ``_compute``: ``all_gather`` and ``pmean`` as an all-gather
  (``pmean`` then adds in shard order and divides, never a gloo
  ``all_reduce``, whose order is not shard order), ``all_to_all`` as
  point-to-point sends and receives (gloo lacks an all-to-all in some
  releases); each an autograd node whose backward is the transpose the
  logical executor computes (``sharding._transpose``);
* **the assembly**: every output's global value on every process, from
  the shards' blocks all-gathered (blocks along the dims its spec names,
  in shard order; over the axes it does not name, the coordinate-0
  shard's); its backward gives each process its own block of the
  gradient (zeros to a shard whose block the assembly did not take).

So the two executors do the same arithmetic in the same order and give
the same bits.  Before each collective every process sends its key
(kind, axes, arguments, shape, dtype, or that its body returned) to
every other; a mismatch raises on all of them ("shards asked for
different collectives") instead of hanging.  A process that dies leaves
its peers to the process group's timeout.

CUDA tensors are staged through host memory for gloo (NCCL refuses two
ranks on one card).  Each process keeps a record of the collectives it
ran (:func:`record`): kind, axes, forward or backward, what for, the
on-wire bytes by ``launch.op_cost.wire_bytes`` (the dry run's
convention), the bytes staged through the host and the wall seconds.

:func:`hold_blocks`, :func:`expert_keeper` and :func:`held_totals` are
the expert-parallel weights' side: a process holds only its
``(E / ep, ., .)`` block of each expert-stacked leaf, the optimizer
updates it where it lives, and the whole-leaf sums an update takes
(the global norm's squares, Adafactor's RMS) add the other blocks'
partial sums in shard order.
"""
from __future__ import annotations

import inspect
import math
import time
from contextlib import nullcontext
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.dist import sharding as S
from repro_torch.launch import op_cost

_RECORD: List[Dict] = []


def record() -> List[Dict]:
    """This process's collectives since the last :func:`reset_record`."""
    return list(_RECORD)


def reset_record() -> None:
    _RECORD.clear()


def summarize(rows: List[Dict]) -> Dict[str, Dict]:
    """Count, wire bytes, staged bytes and seconds of a record, by
    ``"<what> <kind> <axes>"``."""
    out: Dict[str, Dict] = {}
    for r in rows:
        key = f"{r['what']} {r['kind']} {','.join(r['axes'])}"
        agg = out.setdefault(key, {"count": 0, "bytes": 0.0,
                                   "staged": 0, "s": 0.0})
        agg["count"] += 1
        agg["bytes"] += r["bytes"]
        agg["staged"] += r["staged"]
        agg["s"] += r["s"]
    return out


# ---------------------------------------------------------------------------
# The wire
# ---------------------------------------------------------------------------


def _all_coords(mesh) -> list:
    return [mesh.coords_of(r) for r in range(mesh.size)]


def _host(x: torch.Tensor) -> Tuple[torch.Tensor, int]:
    """A contiguous host tensor of x's values for gloo, and the bytes
    staged through the host to make it."""
    x = x.detach()
    if x.device.type == "cpu":
        return x.contiguous(), 0
    return x.to("cpu", copy=True).contiguous(), op_cost.nbytes(x)


def _back(t: torch.Tensor, device) -> Tuple[torch.Tensor, int]:
    if device.type == "cpu":
        return t, 0
    return t.to(device), op_cost.nbytes(t)


def _note(kind, names, what, result_bytes, staged, t0) -> None:
    _RECORD.append({
        "kind": kind, "axes": list(names), "what": what,
        "dir": "fwd" if what in ("body", "assemble") else "bwd",
        "recompute": (what == "body"
                      and torch._C._current_autograd_node() is not None),
        "bytes": float(result_bytes), "staged": int(staged),
        "s": time.perf_counter() - t0})


def _group(mesh, names) -> tuple:
    """(process group, member ranks in shard order over ``names``)."""
    pg, members = mesh.group(names)
    return pg, sorted(members, key=lambda r: S._index(
        mesh, mesh.coords_of(r), names))


def _exchange(mesh, key) -> None:
    """Every process's key; raise on all of them unless all are equal."""
    import torch.distributed as tdist
    pg, members = mesh.group(mesh.axis_names)
    keys = [None] * len(members)
    tdist.all_gather_object(keys, key, group=pg)
    if any(k != keys[0] for k in keys):
        raise RuntimeError(f"shard_map: shards asked for different "
                           f"collectives: {sorted(set(map(str, keys)))}")


def _key_of(kind, names, args, x) -> tuple:
    shape = tuple(x.shape) if isinstance(x, torch.Tensor) else None
    dtype = str(x.dtype) if isinstance(x, torch.Tensor) else type(x).__name__
    return (kind, tuple(names), tuple(args), shape, dtype)


def _gather(mesh, names, x: torch.Tensor, what: str,
            kind: str = "all_gather") -> list:
    """Every member's ``x`` over the group of ``names``, in shard order,
    on x's device (this process's own is ``x``)."""
    import torch.distributed as tdist
    pg, members = _group(mesh, names)
    if len(members) == 1:
        return [x]
    if what != "body":                 # a body's key went with its yield
        _exchange(mesh, _key_of(f"{what}:{kind}", names, (), x))
    t0 = time.perf_counter()
    host, staged = _host(x)
    parts = [torch.empty_like(host) for _ in members]
    tdist.all_gather(parts, host, group=pg)
    by_rank = dict(zip(sorted(members), parts))
    me = mesh.rank
    out = []
    for r in members:
        if r == me:
            out.append(x)
        else:
            t, b = _back(by_rank[r], x.device)
            staged += b
            out.append(t)
    # the dry run's convention: an all-gather its result, a pmean (an
    # all-reduce) twice its result, which has x's shape
    wire = (op_cost.wire_bytes("pmean", x) if kind == "pmean"
            else len(members) * op_cost.nbytes(x))
    _note(kind, names, what, wire, staged, t0)
    return out


def _all_to_all(mesh, c, x: torch.Tensor, what: str) -> torch.Tensor:
    """``lax.all_to_all`` over the group of ``c.names``: member i gets
    chunk i of dim ``split_axis`` from every member, in member order."""
    import torch.distributed as tdist
    a = dict(c.args)
    pg, members = _group(mesh, c.names)
    n = len(members)
    split, concat = a["split_axis"], a["concat_axis"]
    if x.shape[split] % n:
        raise ValueError(f"all_to_all: dim {split} of {tuple(x.shape)} "
                         f"does not split into {n}")
    if not a["tiled"] and x.shape[split] != n:
        raise ValueError(f"all_to_all: untiled, dim {split} of "
                         f"{tuple(x.shape)} must be the group size {n}")
    if n == 1:
        return S._compute(c, [x])[0]
    if what != "body":
        _exchange(mesh, _key_of(f"{what}:all_to_all", c.names, c.args, x))
    t0 = time.perf_counter()
    chunks = x.chunk(n, dim=split)
    # point to point (gloo has no all-to-all in every release): post
    # every receive, then every send; this process's own chunk stays
    staged, reqs, got, sent = 0, [], [], []
    for i, r in enumerate(members):
        if r == mesh.rank:
            got.append(chunks[i])
            continue
        h, b = _host(chunks[i])
        buf = torch.empty_like(h)
        reqs.append(tdist.irecv(buf, src=r, group=pg))
        got.append(buf)
        sent.append((h, r))
        staged += b
    reqs += [tdist.isend(h, dst=r, group=pg) for h, r in sent]
    for q in reqs:
        q.wait()
    for i, r in enumerate(members):    # member order: what r sent me
        if r != mesh.rank:
            got[i], b = _back(got[i], x.device)
            staged += b
    if a["tiled"]:
        out = torch.cat(got, dim=concat).contiguous()
    else:
        out = torch.stack([g.squeeze(split) for g in got],
                          dim=concat).contiguous()
    _note("all_to_all", c.names, what, op_cost.wire_bytes("all_to_all", out),
          staged, t0)
    return out


def _run(mesh, c, x: torch.Tensor, what: str) -> torch.Tensor:
    """This process's result of collective ``c`` on its ``x``."""
    if c.kind == "all_to_all":
        return _all_to_all(mesh, c, x, what)
    me = S._index(mesh, mesh.coords, c.names)
    xs = _gather(mesh, c.names, x, what, c.kind)
    return S._compute(c, xs)[me]


class _Wire(torch.autograd.Function):
    """One collective of a body; its backward is the transpose."""

    @staticmethod
    def forward(ctx, mesh, c, x):
        ctx.mesh, ctx.c = mesh, c
        return _run(mesh, c, x, "body")

    @staticmethod
    def backward(ctx, g):
        mesh, c = ctx.mesh, ctx.c
        if c.kind == "all_to_all":
            return None, None, _all_to_all(mesh, S._inverse(c), g,
                                           "transpose")
        me = S._index(mesh, mesh.coords, c.names)
        gs = _gather(mesh, c.names, g, "transpose", c.kind)
        return None, None, S._transpose(c, gs)[me]


def _unnamed(mesh, spec) -> tuple:
    used = {nm for names in S._spec_names(mesh, spec) for nm in names}
    return tuple(a for a in mesh.axis_names if a not in used)


def _own_view(mesh, spec, x):
    if isinstance(spec, S.Held):
        S._spec_names(mesh, spec)
        if x.device != mesh.device:
            raise ValueError(f"shard_map: a tensor on {x.device}, the "
                             f"process's shard on {mesh.device}")
        return x
    return S._shard_view(mesh, mesh.coords, spec, x)


def _whole_grad(mesh, spec, g):
    """An input's gradient from this process's block ``g`` of it: every
    shard's block all-gathered and put together, the blocks of shards
    that share one added in shard order; for a held block, the sum of
    the copies of the processes holding the same block."""
    if isinstance(spec, S.Held):
        rest = _unnamed(mesh, spec)
        if not rest:
            return g.contiguous()
        return S._sum_in_order(_gather(mesh, rest, g, "held")).contiguous()
    gs = _gather(mesh, mesh.axis_names, g, "cut")
    return S._assemble(mesh, _all_coords(mesh), spec, gs, add=True)


def _cut_all(mesh, in_specs, args) -> list:
    """This process's views of ``args``; those of the inputs that need a
    gradient made by one ``sharding._Boundary`` whose backward is
    :func:`_whole_grad` of each."""
    grad = S._leaves(in_specs, args)
    if grad:
        specs = [sp for sp, _ in grad]
        flat = iter(S._Boundary.apply(
            lambda xs: [_own_view(mesh, sp, x) for sp, x in zip(specs, xs)],
            lambda gs: [_whole_grad(mesh, sp, g)
                        for sp, g in zip(specs, gs)],
            *[x for _, x in grad]))
    return [S._map_specs(sp, a, lambda spec, x: next(flat)
                         if S._needs_grad(x) else (
                             _own_view(mesh, spec, x)
                             if isinstance(x, torch.Tensor) else x))
            for sp, a in zip(in_specs, args)]


def _assemble(mesh, spec, block):
    blocks = _gather(mesh, mesh.axis_names, block, "assemble")
    return S._assemble(mesh, _all_coords(mesh), spec, blocks)


def _put_together(mesh, out_specs, out):
    """Every output's global value on this process; those that need a
    gradient through one ``sharding._Boundary`` whose backward gives
    this process its block of each (zeros where the assembly did not
    take its block)."""
    grad = []
    S._walk_outputs(out_specs, [out], lambda spec, blocks: grad.append(
        (spec, blocks[0])) if S._needs_grad(blocks[0]) else None)
    specs = [sp for sp, _ in grad]
    shapes = [b.shape for _, b in grad]
    done = iter(S._Boundary.apply(
        lambda xs: [_assemble(mesh, sp, x) for sp, x in zip(specs, xs)],
        lambda gs: [S._shard_view(mesh, mesh.coords, sp, g).contiguous()
                    if S._used(mesh, mesh.coords, sp) else g.new_zeros(sh)
                    for sp, sh, g in zip(specs, shapes, gs)],
        *[b for _, b in grad]) if grad else ())

    def one(spec, blocks):
        b = blocks[0]
        if S._needs_grad(b):
            return next(done)
        return _assemble(mesh, spec, b) if isinstance(b, torch.Tensor) \
            else b
    return S._walk_outputs(out_specs, [out], one)


# ---------------------------------------------------------------------------
# shard_map
# ---------------------------------------------------------------------------


def _shapes(tree) -> tuple:
    return tuple((tuple(t.shape), str(t.dtype))
                 for t in op_cost.tensors(tree))


def shard_map(f, *, mesh, in_specs, out_specs):
    """``dist.sharding.shard_map`` on a process mesh: this process's
    shard of ``f`` (the module docstring)."""

    def run(*args):
        if not isinstance(in_specs, (tuple, list)) or len(in_specs) != len(
                args):
            raise ValueError("shard_map: in_specs needs one entry per "
                             "argument")
        views = _cut_all(mesh, in_specs, args)
        with S._in_shard(mesh, mesh.coords):
            r = f(*views)
        gen = r if inspect.isgenerator(r) else None
        try:
            sent = None
            while gen is not None:
                with S._in_shard(mesh, mesh.coords):
                    try:
                        c = gen.send(sent)
                    except StopIteration as stop:
                        r = stop.value
                        break
                if not isinstance(c, S._Collective):
                    _exchange(mesh, ("not a collective", type(c).__name__))
                    raise TypeError(f"shard_map: a body yielded a "
                                    f"{type(c).__name__}, not a collective")
                _exchange(mesh, _key_of(c.kind, c.names, c.args, c.x))
                for nm in c.names:
                    if nm not in mesh.shape:
                        raise ValueError(f"{c.kind}: axis {nm!r} not in "
                                         f"the mesh {mesh.axis_names}")
                body = S._Collective(c.kind, None, c.names, c.args)
                sent = (_Wire.apply(mesh, body, c.x) if S._needs_grad(c.x)
                        else _run(mesh, body, c.x, "body"))
            _exchange(mesh, ("return", _shapes(r)))
        finally:
            if gen is not None:
                gen.close()
        return _put_together(mesh, out_specs, r)

    return run


# ---------------------------------------------------------------------------
# Expert weights held as blocks
# ---------------------------------------------------------------------------


def _active_process_mesh():
    ctx = S._current()
    if ctx is None or getattr(ctx[0], "groups", None) is None:
        return None, None
    return ctx


def _expert_split(path, ndim: int, mesh, rules) -> Optional[tuple]:
    """(dim, mesh axes) of an expert-stacked leaf's expert dim, or None
    for a leaf every process holds whole."""
    axes = S._logical_param_axes(tuple(path), ndim)
    if "expert" not in axes:
        return None
    names = tuple(n for n in S._names(rules.get("expert"))
                  if n in mesh.shape)
    if math.prod(mesh.shape[n] for n in names) <= 1:
        return None
    return axes.index("expert"), names


def _block(mesh, names, leaf: torch.Tensor, dim: int) -> torch.Tensor:
    n = math.prod(mesh.shape[nm] for nm in names)
    if leaf.shape[dim] % n:
        raise ValueError(f"hold_blocks: dim {dim} of {tuple(leaf.shape)} "
                         f"does not split into {n}")
    size = leaf.shape[dim] // n
    i = S._index(mesh, mesh.coords, names)
    return leaf.narrow(dim, i * size, size).clone()


def hold_blocks(tree):
    """Under a process mesh's ``sharding_ctx``: ``tree`` (a whole
    parameter tree) with each expert-stacked leaf cut to this process's
    block along its expert dim (a copy: the whole leaf can be dropped);
    every other leaf as it is.  Off a process mesh, ``tree``."""
    mesh, rules = _active_process_mesh()
    if mesh is None:
        return tree

    def one(path, leaf):
        split = _expert_split(path, leaf.ndim, mesh, rules)
        return leaf if split is None else _block(mesh, split[1], leaf,
                                                 split[0])
    return S._tree_map(one, tree)


def expert_keeper():
    """``keep(draw, dim)`` for ``lm_zoo.init_params``: an expert-stacked
    leaf drawn (``draw()``), cut to this process's block along ``dim``,
    the whole leaf dropped and, on a card, its memory given back to the
    device at once (no later allocation may split it and hold it
    reserved: other processes share the card); None off a process mesh
    (every leaf kept whole)."""
    mesh, rules = _active_process_mesh()
    if mesh is None:
        return None
    names = tuple(n for n in S._names(rules.get("expert"))
                  if n in mesh.shape)
    if math.prod(mesh.shape[n] for n in names) <= 1:
        return None

    def keep(draw, dim):
        block = _block(mesh, names, draw(), dim)
        if block.device.type == "cuda":
            torch.cuda.empty_cache()
        return block
    return keep


def _paths_sorted(tree, path=()):
    """(path, leaf) in ``train.optimizer.tree_leaves``' order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in _paths_sorted(tree[k], path + (str(k),))]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree)
                for x in _paths_sorted(v, path + (str(i),))]
    return [(path, tree)]


class _Totals:
    """The optimizer's whole-leaf sums (``train.optimizer.leaf_totals``)
    over leaves held as blocks: each block's partial sum all-gathered
    over the processes holding the leaf's other blocks, added in shard
    order."""

    def __init__(self, mesh, split: Dict[int, tuple]):
        self.mesh, self.split = mesh, split

    def held(self, i: int) -> bool:
        return i in self.split

    def blocks(self, i: int) -> int:
        return math.prod(self.mesh.shape[n] for n in self.split[i])

    def total(self, i: int, partial: torch.Tensor) -> torch.Tensor:
        return S._sum_in_order(_gather(self.mesh, self.split[i], partial,
                                       "optimizer"))


def held_totals(params):
    """The optimizer update's context for ``params``: on a process mesh
    whose ranks hold blocks of some leaves, ``train.optimizer``'s
    whole-leaf sums add the other blocks' (:class:`_Totals`); elsewhere
    nothing changes."""
    mesh, rules = _active_process_mesh()
    if mesh is None:
        return nullcontext()
    from repro_torch.train.optimizer import leaf_totals
    split = {}
    for i, (path, leaf) in enumerate(_paths_sorted(params)):
        s = _expert_split(path, leaf.ndim, mesh, rules)
        if s is not None:
            split[i] = s[1]
    return leaf_totals(_Totals(mesh, split)) if split else nullcontext()
