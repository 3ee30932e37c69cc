"""Device resolution for the port's entry points.

The card is the default: ``resolve(None)`` is ``cuda`` and raises when
no CUDA device is present.  The CPU runs only when the caller asks for
it explicitly (``device="cpu"``), as the CPU parity tests do — there is
no silent fallback that would hide a missing card.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda`` (raises without a card); anything else is
    taken as given, and a CUDA request still requires a card."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device available; pass device='cpu' to run the "
            "port's plain PyTorch path on the CPU")
    return dev
