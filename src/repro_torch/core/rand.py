"""Shared sampling-noise primitive (counterpart of ``repro.core.rand``)."""
from __future__ import annotations

from typing import Sequence

import torch


def gumbel_noise(generator: torch.Generator, shape: Sequence[int],
                 device) -> torch.Tensor:
    """I.i.d. Gumbel scores for top-k sampling without replacement:
    ``-log(-log(u))`` with ``u`` uniform on ``[1e-9, 1)``, the formula of
    the JAX reference, drawn from ``generator`` (which must live on
    ``device``).  The two frameworks' streams differ draw for draw; the
    stochastic kernels therefore take this noise as an input so that
    kernel and plain version can be compared under the same noise."""
    u = torch.rand(tuple(shape), generator=generator, device=device,
                   dtype=torch.float32)
    u = u * (1.0 - 1e-9) + 1e-9
    return -torch.log(-torch.log(u))
