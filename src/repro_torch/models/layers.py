"""Layer helpers of the temporal GNNs (counterpart of the GNN part of
``repro.models.layers``: time encoding and dense initialisation)."""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def time_encode(dt: torch.Tensor, w: torch.Tensor, b: torch.Tensor
                ) -> torch.Tensor:
    """cos(dt * w + b); dt: (...,), w/b: (d_time,) -> (..., d_time)."""
    return torch.cos(dt[..., None].to(torch.float32) * w + b)


def time_encode_params(d_time: int, *, device) -> dict:
    # TGAT init: w = 1 / 10^linspace — covers multiple time scales.
    w = 1.0 / (10.0 ** torch.linspace(0.0, 9.0, d_time,
                                      dtype=torch.float32))
    return {"w": w.to(device),
            "b": torch.zeros((d_time,), dtype=torch.float32, device=device)}


def dense_init(generator: torch.Generator, shape: Tuple[int, ...], *,
               device, scale: Optional[float] = None) -> torch.Tensor:
    """Normal(0, fan_in^-1/2) weights, drawn from a CPU ``generator`` and
    then moved, so one seed gives the same weights on every device."""
    fan_in = shape[0] if len(shape) >= 2 else 1
    s = scale if scale is not None else fan_in ** -0.5
    w = torch.randn(tuple(shape), generator=generator,
                    dtype=torch.float32) * s
    return w.to(device)
