"""Load a JAX parameter tree into the port.

The JAX package initialises weights with ``jax.random``, whose streams
torch cannot replay, so parity runs hand the JAX tree across as numpy
arrays (``jax.tree.map(np.asarray, tree)`` on the JAX side) and this
module turns it into the port's tree of tensors — same nesting of dicts
and lists, same names and shapes.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.device import resolve


def params_from_jax(tree: Any, *, device=None) -> Any:
    """Nested dicts/lists/tuples of numpy arrays -> the same nesting of
    tensors (private copies) on ``device``."""
    device = resolve(device)

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(conv(v) for v in x)
        return torch.from_numpy(np.array(x, copy=True)).to(device)

    return conv(tree)
