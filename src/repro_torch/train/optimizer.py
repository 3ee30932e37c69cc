"""Functional optimizers (counterpart of ``repro.train.optimizer``):
the schedules (``constant_schedule``, ``warmup_cosine_schedule``,
``linear_warmup_schedule``), ``global_norm``, ``clip_by_global_norm``,
``AdamWState``, ``Optimizer``, ``adamw``, ``SGDState``, ``sgd``,
``adafactor_lite`` and the ``OPTIMIZERS`` map.

Parameters, gradients and moments are trees of nested dicts and lists
of tensors, walked in the JAX package's leaf order (dict keys sorted).
Every ``update`` is functional as the JAX update is: it returns new
tensors and never writes a parameter or a moment in place.  The serving wing
relies on that, since every published handle holds the parameter tree
by reference, and a query pinned to an older version must keep its
answers while training goes on.

``torch.optim.AdamW`` is not a drop-in: this port keeps the JAX
package's defaults (b2 = 0.95, eps 1e-8, global-norm clip at 1.0) and
its decoupled decay ``p - lr * (step + wd * p)``.

A schedule takes the host-side integer step (the optimizer states count
steps on the host, so no update syncs with the device) and returns a
float; its arithmetic is float32, as the JAX schedules compute it.

Two updates take a sum over a whole leaf: the global norm's squares and
Adafactor's RMS.  A process of a process mesh may hold only a block of a
leaf (``dist.spmd``); under :func:`leaf_totals` those sums add the other
blocks' partial sums, and every other leaf's are as before.
"""
from __future__ import annotations

import math
import threading
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Any, Callable, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

Tree = Any
Schedule = Callable[[int], float]


def tree_leaves(tree: Tree) -> List[torch.Tensor]:
    """Leaves in the JAX package's order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    """``fn`` over the leaves of ``tree`` and the same-shaped ``rest``."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, *xs) for xs in zip(tree, *rest))
    return fn(tree, *rest)


def tree_unflatten(tree: Tree, leaves: List[torch.Tensor]) -> Tree:
    """A tree shaped like ``tree`` holding ``leaves`` (in the order of
    :func:`tree_leaves`)."""
    return _unflatten(tree, iter(leaves))


def _unflatten(t: Tree, it) -> Tree:
    # a module function, not a closure that calls itself: such a closure
    # is a reference cycle, and the iterator it held kept every leaf (a
    # train step's float32 masters and gradients) alive until the cyclic
    # garbage collector ran, a whole train state a step on the card
    if isinstance(t, dict):
        return {k: _unflatten(t[k], it) for k in sorted(t)}
    if isinstance(t, (list, tuple)):
        return type(t)(_unflatten(v, it) for v in t)
    return next(it)


def constant_schedule(lr: float) -> Schedule:
    return lambda step: float(lr)


def warmup_cosine_schedule(peak_lr: float, warmup_steps: int,
                           total_steps: int, final_frac: float = 0.1
                           ) -> Schedule:
    """Linear warmup to ``peak_lr``, then a cosine decay to
    ``final_frac * peak_lr`` at ``total_steps``."""
    f32 = np.float32
    peak, frac = f32(peak_lr), f32(final_frac)

    def sched(step: int) -> float:
        t = f32(step)
        if t < warmup_steps:
            return float(peak * t / f32(max(warmup_steps, 1)))
        prog = np.clip((t - f32(warmup_steps))
                       / f32(max(total_steps - warmup_steps, 1)),
                       f32(0), f32(1))
        # the JAX expression's order: ((1 - frac) * 0.5) * (1 + cos)
        cos = f32((1 - final_frac) * 0.5) * (f32(1)
                                             + np.cos(f32(math.pi) * prog))
        return float(peak * (frac + cos))
    return sched


def linear_warmup_schedule(peak_lr: float, warmup_steps: int) -> Schedule:
    """Linear warmup to ``peak_lr``, then constant."""
    f32 = np.float32

    def sched(step: int) -> float:
        return float(f32(peak_lr) * np.minimum(
            f32(1), f32(step) / f32(max(warmup_steps, 1))))
    return sched


class _Hook(threading.local):
    totals = None


_HOOK = _Hook()


@contextmanager
def leaf_totals(totals):
    """Within: the whole-leaf sums of the updates ask ``totals`` whether
    leaf ``i`` (in :func:`tree_leaves` order) is held as a block
    (``totals.held(i)``), of how many blocks (``totals.blocks(i)``), and
    for the sum over every block of this block's partial sum
    (``totals.total(i, partial)``)."""
    prev, _HOOK.totals = _HOOK.totals, totals
    try:
        yield
    finally:
        _HOOK.totals = prev


def _held(i: int) -> bool:
    return _HOOK.totals is not None and _HOOK.totals.held(i)


def _leaf_sum(i: int, x: torch.Tensor) -> torch.Tensor:
    s = torch.sum(x)
    return _HOOK.totals.total(i, s) if _held(i) else s


def _leaf_mean(i: int, x: torch.Tensor) -> torch.Tensor:
    if not _held(i):
        return x.mean()
    return _HOOK.totals.total(i, torch.sum(x)) / (
        x.numel() * _HOOK.totals.blocks(i))


def global_norm(tree: Tree) -> torch.Tensor:
    return torch.sqrt(torch.stack(
        [_leaf_sum(i, torch.square(x.float()))
         for i, x in enumerate(tree_leaves(tree))]).sum())


def clip_by_global_norm(tree: Tree, max_norm: float
                        ) -> Tuple[Tree, torch.Tensor]:
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / (norm + 1e-12), max=1.0)
    return tree_map(lambda g: g * scale, tree), norm


class AdamWState(NamedTuple):
    step: int            # host-side count: no device sync per step
    mu: Tree
    nu: Tree


@dataclass(frozen=True)
class Optimizer:
    init: Callable[[Tree], Any]
    update: Callable[[Tree, Any, Tree], Tuple[Tree, Any]]
    """update(grads, state, params) -> (new_params, new_state)"""


def adamw(lr: float | Schedule, *, b1: float = 0.9, b2: float = 0.95,
          eps: float = 1e-8, weight_decay: float = 0.1,
          max_grad_norm: Optional[float] = 1.0) -> Optimizer:
    sched = lr if callable(lr) else constant_schedule(lr)

    def init(params):
        zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                      device=p.device)
        return AdamWState(step=0, mu=tree_map(zeros, params),
                          nu=tree_map(zeros, params))

    @torch.no_grad()
    def update(grads, state, params):
        grads = tree_map(lambda g: g.float(), grads)
        if max_grad_norm is not None:
            grads, _ = clip_by_global_norm(grads, max_grad_norm)
        step = state.step + 1
        lr_t = sched(step)
        # bias corrections in float32, as the JAX update computes them
        t = np.float32(step)
        c1 = float(np.float32(1.0) - np.power(np.float32(b1), t))
        c2 = float(np.float32(1.0) - np.power(np.float32(b2), t))

        def upd(p, g, m, v):
            m = b1 * m + (1 - b1) * g
            v = b2 * v + (1 - b2) * torch.square(g)
            step_ = (m / c1) / (torch.sqrt(v / c2) + eps)
            p32 = p.float()
            p32 = p32 - lr_t * (step_ + weight_decay * p32)
            return p32.to(p.dtype), m, v

        new = [upd(*x) for x in zip(*map(tree_leaves, (
            params, grads, state.mu, state.nu)))]
        pick = lambda i: tree_unflatten(params, [n[i] for n in new])
        return pick(0), AdamWState(step=step, mu=pick(1), nu=pick(2))

    return Optimizer(init=init, update=update)


class SGDState(NamedTuple):
    step: int            # host-side count
    momentum: Tree


def sgd(lr: float | Schedule, *, momentum: float = 0.9,
        nesterov: bool = False, weight_decay: float = 0.0) -> Optimizer:
    """SGD with heavy-ball (or Nesterov) momentum and L2 weight decay
    folded into the gradient, as the JAX ``sgd``."""
    sched = lr if callable(lr) else constant_schedule(lr)

    def init(params):
        return SGDState(step=0, momentum=tree_map(
            lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device), params))

    @torch.no_grad()
    def update(grads, state, params):
        step = state.step + 1
        lr_t = sched(step)

        def upd(p, g, m):
            g = g.float()
            if weight_decay:
                g = g + weight_decay * p.float()
            m = momentum * m + g
            d = g + momentum * m if nesterov else m
            return (p.float() - lr_t * d).to(p.dtype), m

        new = [upd(*x) for x in zip(*map(tree_leaves, (
            params, grads, state.momentum)))]
        pick = lambda i: tree_unflatten(params, [n[i] for n in new])
        return pick(0), SGDState(step=step, momentum=pick(1))

    return Optimizer(init=init, update=update)


def adafactor_lite(lr: float | Schedule, *, decay: float = 0.8,
                   eps: float = 1e-30, weight_decay: float = 0.0
                   ) -> Optimizer:
    """Factored second moments (Adafactor without a first moment): a
    leaf of rank >= 2 keeps a (row, col) pair of mean squared gradients
    over its last axis and its second-last, any other leaf a full second
    moment; each update is clipped to an RMS of at most 1.  The state is
    an ``AdamWState`` with the factors in ``mu`` and ``nu`` None, as in
    the JAX ``adafactor_lite``."""
    sched = lr if callable(lr) else constant_schedule(lr)

    def init(params):
        def one(p):
            z = lambda shape: torch.zeros(shape, dtype=torch.float32,
                                          device=p.device)
            if p.dim() >= 2:
                return (z(p.shape[:-1]), z(p.shape[:-2] + p.shape[-1:]))
            return z(p.shape)
        return AdamWState(step=0, mu=tree_map(one, params), nu=None)

    @torch.no_grad()
    def update(grads, state, params):
        step = state.step + 1
        lr_t = sched(step)
        # beta in float32, as the JAX update computes it
        beta = float(np.float32(1) - np.power(np.float32(step),
                                              np.float32(-decay)))
        index = {id(p): i for i, p in enumerate(tree_leaves(params))}

        # The same arithmetic as the JAX update, with the leaf-sized
        # temporaries taken in place where no one else holds them: a
        # full-width MLP leaf is 5.4 GB of float32 (Nemotron-4), and the
        # update's peak is old leaves, gradients, new leaves and these.
        def upd(p, g, s):
            g = g.float()
            if p.dim() >= 2:
                g2 = torch.square(g).add_(eps)
                row, col = s
                row = beta * row + (1 - beta) * g2.mean(-1)
                col = beta * col + (1 - beta) * g2.mean(-2)
                del g2
                rmean = row.mean(-1, keepdim=True)
                u = (row[..., :, None] * col[..., None, :]).div_(
                    rmean[..., None] + eps)
                s = (row, col)
            else:
                s = beta * s + (1 - beta) * (torch.square(g) + eps)
                u = s.clone()
            u = torch.div(g, u.sqrt_().add_(1e-8), out=u)
            rms = torch.sqrt(_leaf_mean(index[id(p)], torch.square(u))
                             + 1e-12)
            u.div_(torch.clamp(rms, min=1.0))
            p32 = p.float()
            if weight_decay:
                u.add_(weight_decay * p32)
            return (p32 - u.mul_(lr_t)).to(p.dtype), s

        # walked in the parameters' structure, so a (row, col) state
        # reaches ``upd`` whole
        out = tree_map(upd, params, grads, state.mu)
        pick = lambda i: tree_map(lambda _, o: o[i], params, out)
        return pick(0), AdamWState(step=step, mu=pick(1), nu=None)

    return Optimizer(init=init, update=update)


OPTIMIZERS = {"adamw": adamw, "sgd": sgd, "adafactor": adafactor_lite}
