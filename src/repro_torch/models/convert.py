"""Load a JAX parameter tree into the port.

The JAX package initialises weights with ``jax.random``, whose streams
torch cannot replay, so parity runs hand the JAX tree across as numpy
arrays (``jax.tree.map(np.asarray, tree)`` on the JAX side) and this
module turns it into the port's tree of tensors — same nesting of dicts
and lists, same names, shapes and dtypes.  It takes the GNN wing's
trees and the LM wing's parameter trees and decode states alike.
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
        a = np.asarray(x)
        if a.dtype.name == "bfloat16":
            # ml_dtypes' bfloat16, which torch.from_numpy refuses; the
            # float32 round trip is exact
            return torch.from_numpy(a.astype(np.float32)).to(
                device=device, dtype=torch.bfloat16)
        return torch.from_numpy(np.array(a, copy=True)).to(device)

    return conv(tree)
