"""Gradient-reduction collectives for data-parallel training
(counterpart of ``repro.dist.collectives``).

Three schedules over one contract — sum each gradient leaf across the
W data-parallel workers:

* ``bucketed_psum``        exact; fuses small leaves into fixed-size
                           flat buckets, one reduction a bucket.
* ``quantized_psum_grads`` lossy; int8 (or fp16) quantize -> reduce ->
                           dequantize, with error feedback.
* ``topk_psum_grads``      lossy; magnitude top-k sparsification with
                           error feedback (deep gradient compression).

The JAX package runs them under ``shard_map``, each device holding its
worker's gradient and ``lax.psum`` summing across devices.  Here the
workers a process hosts run one after another on its device, so each
function takes those workers' gradient trees as a list (or one tree
whose leaves carry a leading worker axis) and returns the summed tree;
the lossy schedules also return each worker's residual.  In-process
the list holds all W workers.  Across processes (``group``, a
``torch.distributed`` process group, set by a multihost worker) each
process holds its G workers' trees: it sums those G contributions with
the same per-worker arithmetic, then the machines' sums are combined
over the group — one collective a bucket for ``bucketed``, one of the
float32 sum of the compressed vectors for the lossy schedules.  The
sum runs machine by machine (``per_machine``): each machine's workers
first, then the machines in order.  Across processes the machines'
sums are all-gathered (exact) and added in that order, the same
additions as in-process, so a fleet's sum is bit for bit the
in-process trainer's; an ``all_reduce`` would add them in the
backend's order, whose one-ulp differences the time encoding amplifies
over rounds.  Collectives are staged through host memory (the gloo
backend: several processes share one card, where NCCL refuses two
ranks).  The per-worker arithmetic is
the JAX package's: the int8 scale is ``max(max|e|, 1e-30) / 127`` in float32,
``torch.round`` rounds half to even as ``jnp.round`` does, and top-k
sends every coordinate whose magnitude reaches the k-th largest, ties
included.

Error feedback: the compression residual is returned and must be passed
back as ``err`` on the next call, so the transmitted running sum tracks
the true one (half a quantization step per coordinate per call; a top-k
residual is sent once it clears the threshold).
"""
from __future__ import annotations

from typing import Any, List, Optional, Sequence, Tuple

import torch

from repro_torch.obs import trace
from repro_torch.train.optimizer import tree_leaves, tree_unflatten

Tree = Any

_DEFAULT_BUCKET_BYTES = 4 * 1024 * 1024


def grad_payload_bytes(grads: Tree, mode: str, *, bits: int = 8,
                       frac: float = 0.01) -> int:
    """Per-step, per-worker wire payload of one gradient reduction of a
    tree shaped like ``grads``: ``bucketed`` sends every f32 coordinate;
    ``quantized`` bits/8 bytes a coordinate plus one f32 scale;
    ``topk`` an (int32 index, f32 value) pair for each of its k
    coordinates."""
    n = sum(l.numel() for l in tree_leaves(grads))
    if mode == "bucketed":
        return n * 4
    if mode == "quantized":
        return n * bits // 8 + 4
    if mode == "topk":
        return _topk_k(n, frac) * 8
    raise ValueError(f"unknown collective mode {mode!r}")


def all_gather_cat(t: torch.Tensor, group=None) -> torch.Tensor:
    """Every process's ``t`` (one shape fleet-wide) concatenated along
    dim 0 in process order (JAX's tiled ``all_gather``); None returns
    ``t``.  Staged through host memory; the result comes back on
    ``t``'s device."""
    if group is None:
        return t
    import torch.distributed as tdist
    host = t.detach().to("cpu", copy=True).contiguous()
    parts = [torch.empty_like(host)
             for _ in range(tdist.get_world_size(group))]
    with trace.span("all_gather", bytes=host.numel() * host.element_size()):
        tdist.all_gather(parts, host, group=group)
    return torch.cat(parts).to(t.device)


def machine_sum(vecs: Sequence[torch.Tensor],
                per_machine: Optional[int] = None,
                group=None) -> torch.Tensor:
    """Sum of the workers' same-shaped tensors, machine by machine: the
    ``per_machine`` consecutive workers of each machine first (all of
    ``vecs`` when None), then the machines in order.  With ``group``,
    ``vecs`` are this process's machine's workers and the machines'
    sums are all-gathered and added in process order: the same
    additions, in the same order, as the in-process sum."""
    per = per_machine or len(vecs)
    parts = [torch.stack(list(vecs[i:i + per])).sum(0)
             for i in range(0, len(vecs), per)]
    if group is not None:
        parts = list(all_gather_cat(torch.stack(parts), group))
    return parts[0] if len(parts) == 1 else torch.stack(parts).sum(0)


def _topk_k(n: int, frac: float) -> int:
    return max(1, min(n, int(round(frac * n))))


def _per_worker(grads) -> List[Tree]:
    """W per-worker trees: a list as given, or one tree of leaves with a
    leading W axis split along it."""
    if isinstance(grads, (list, tuple)):
        return list(grads)
    leaves = tree_leaves(grads)
    W = leaves[0].shape[0]
    return [tree_unflatten(grads, [l[w] for l in leaves]) for w in range(W)]


def _plan_buckets(leaves: Sequence[torch.Tensor],
                  bucket_bytes: int) -> List[List[int]]:
    """Greedy fill of leaf indices into <= bucket_bytes buckets, grouped
    by dtype; a leaf larger than bucket_bytes gets a bucket of its own."""
    by_dtype: dict = {}
    for i, leaf in enumerate(leaves):
        by_dtype.setdefault(leaf.dtype, []).append(i)
    buckets: List[List[int]] = []
    for idxs in by_dtype.values():
        cur: List[int] = []
        cur_bytes = 0
        for i in idxs:
            nbytes = leaves[i].numel() * leaves[i].element_size()
            if cur and cur_bytes + nbytes > bucket_bytes:
                buckets.append(cur)
                cur, cur_bytes = [], 0
            cur.append(i)
            cur_bytes += nbytes
        if cur:
            buckets.append(cur)
    return buckets


def bucketed_psum(grads, *, bucket_bytes: int = _DEFAULT_BUCKET_BYTES,
                  per_machine: Optional[int] = None, group=None) -> Tree:
    """Exact sum of every leaf over the workers, fused into flat
    buckets, each summed by :func:`machine_sum` (over the processes of
    ``group`` too, when given)."""
    trees = _per_worker(grads)
    per = [tree_leaves(t) for t in trees]
    if not per[0]:
        return trees[0]
    out: List[Optional[torch.Tensor]] = [None] * len(per[0])
    for idx in _plan_buckets(per[0], bucket_bytes):
        red = machine_sum([torch.cat([ls[i].reshape(-1) for i in idx])
                           for ls in per], per_machine, group)
        off = 0
        for i in idx:
            n = per[0][i].numel()
            out[i] = red[off:off + n].reshape(per[0][i].shape)
            off += n
    return tree_unflatten(trees[0], out)


def _with_feedback(trees: List[Tree], err) -> List[torch.Tensor]:
    """Per worker: e = grads + err (f32), flattened into one vector."""
    errs = _per_worker(err) if err is not None else [None] * len(trees)
    flats = []
    for t, r in zip(trees, errs):
        e = torch.cat([l.reshape(-1).float() for l in tree_leaves(t)])
        if r is not None:
            e = e + torch.cat([l.reshape(-1) for l in tree_leaves(r)])
        flats.append(e)
    return flats


def _split_back(flat: torch.Tensor, like: Tree, cast: bool) -> Tree:
    out = []
    off = 0
    for leaf in tree_leaves(like):
        n = leaf.numel()
        piece = flat[off:off + n].reshape(leaf.shape)
        out.append(piece.to(leaf.dtype) if cast else piece)
        off += n
    return tree_unflatten(like, out)


def _reduce(trees: List[Tree], flats: List[torch.Tensor], compress,
            per_machine=None, group=None) -> Tuple[Tree, List[Tree]]:
    sents = [compress(f) for f in flats]
    red = machine_sum(sents, per_machine, group)
    return (_split_back(red, trees[0], cast=True),
            [_split_back(f - s, trees[0], cast=False)
             for f, s in zip(flats, sents)])


def quantized_psum_grads(grads, err, *, bits: int = 8,
                         per_machine: Optional[int] = None, group=None
                         ) -> Tuple[Tree, List[Tree]]:
    """Quantize-reduce-dequantize with error feedback.

    bits=8: symmetric per-worker scale ``max|e| / 127``; the
    per-coordinate dequantization error is at most half a step.
    bits=16: fp16 round-trip.  Returns ``(reduced, new_err)`` with one
    residual tree per worker; feed ``new_err`` back on the next call."""
    if bits not in (8, 16):
        raise ValueError(f"bits must be 8 or 16, got {bits}")
    trees = _per_worker(grads)
    if not tree_leaves(trees[0]):
        return trees[0], trees

    def compress(flat):
        if bits == 16:
            return flat.half().float()
        levels = float(2 ** (bits - 1) - 1)
        scale = flat.abs().max().clamp_min(1e-30) / levels
        return torch.round(flat / scale) * scale

    return _reduce(trees, _with_feedback(trees, err), compress,
                   per_machine, group)


def topk_psum_grads(grads, err, *, frac: float = 0.01,
                    per_machine: Optional[int] = None, group=None
                    ) -> Tuple[Tree, List[Tree]]:
    """Magnitude top-k sparsified sum with error feedback.

    Each worker sends the coordinates of ``grads + err`` whose magnitude
    reaches its k-th largest (``k = round(frac * n)``, at least 1; ties
    at the threshold send a few extra); the rest accumulate in its
    residual.  Returns ``(reduced, new_err)``."""
    if not 0.0 < frac <= 1.0:
        raise ValueError(f"frac must be in (0, 1], got {frac}")
    trees = _per_worker(grads)
    if not tree_leaves(trees[0]):
        return trees[0], trees
    k = _topk_k(sum(l.numel() for l in tree_leaves(trees[0])), frac)

    def compress(flat):
        mag = flat.abs()
        thresh = torch.topk(mag, k, sorted=True).values[-1]
        return torch.where(mag >= thresh, flat, torch.zeros_like(flat))

    return _reduce(trees, _with_feedback(trees, err), compress,
                   per_machine, group)
