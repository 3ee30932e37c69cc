"""Functional AdamW with global-norm clipping (counterpart of
``repro.train.optimizer``: ``constant_schedule``, ``global_norm``,
``clip_by_global_norm``, ``AdamWState``, ``Optimizer``, ``adamw``).

Parameters, gradients and moments are trees of nested dicts and lists
of tensors, walked in the JAX package's leaf order (dict keys sorted).
``update`` is functional as the JAX update is: it returns new tensors
and never writes a parameter or a moment in place.  The serving wing
relies on that, since every published handle holds the parameter tree
by reference, and a query pinned to an older version must keep its
answers while training goes on.

``torch.optim.AdamW`` is not a drop-in: this port keeps the JAX
package's defaults (b2 = 0.95, eps 1e-8, global-norm clip at 1.0) and
its decoupled decay ``p - lr * (step + wd * p)``.
"""
from __future__ import annotations

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
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        return next(it)

    return build(tree)


def constant_schedule(lr: float) -> Schedule:
    return lambda step: float(lr)


def global_norm(tree: Tree) -> torch.Tensor:
    return torch.sqrt(torch.stack(
        [torch.sum(torch.square(x.float())) for x in tree_leaves(tree)]
    ).sum())


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

