"""Device meshes (counterpart of ``repro.launch.mesh``).

A :class:`Mesh` names its axes, gives their sizes and holds the one
torch device every logical shard lives on.  The port runs a mesh's
shards one after another on that device (``dist.sharding.shard_map``),
as the in-process distributed trainer runs its workers, so a mesh is
logical: a (1, 4) mesh runs on one card.

Functions, not module-level constants: importing this module touches no
device.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch

from repro_torch.device import DeviceLike, resolve


@dataclass(frozen=True)
class Mesh:
    """Axis names, their sizes, and the device every shard lives on
    (None for a mesh that only describes a shape)."""
    axis_names: Tuple[str, ...]
    axis_sizes: Tuple[int, ...]
    device: Optional[torch.device] = None

    def __post_init__(self):
        if len(self.axis_names) != len(self.axis_sizes):
            raise ValueError(f"Mesh: {len(self.axis_names)} names for "
                             f"{len(self.axis_sizes)} sizes")
        if len(set(self.axis_names)) != len(self.axis_names):
            raise ValueError(f"Mesh: repeated axis in {self.axis_names}")
        if any(n < 1 for n in self.axis_sizes):
            raise ValueError(f"Mesh: axis sizes {self.axis_sizes} < 1")

    @property
    def shape(self) -> Dict[str, int]:
        """Axis name -> size, in axis order (``jax.sharding.Mesh.shape``)."""
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        """The number of shards: the product of the axis sizes."""
        return math.prod(self.axis_sizes)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The production layout's shape (16 x 16, or 2 x 16 x 16 across
    pods), with no device: for shape arithmetic only."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(axes, shape)


def make_local_mesh(data: int = 1, model: int = 1, *,
                    device: DeviceLike = None) -> Mesh:
    """A (data, model) mesh of logical shards on one device (default:
    the card).  Unlike the JAX package's, which clamps both sizes to
    ``len(jax.devices())``, the sizes are taken as given: the shards run
    one after another on ``device``, so any shape fits one card."""
    return Mesh(("data", "model"), (data, model), resolve(device))


# One NVIDIA H100 SXM at its 700 W power limit (NVIDIA's data sheet; dense
# rates), the numbers PERF.md's bounds use.  A card set below 700 W runs
# slower under load: nvidia-smi's power.limit says which.
HW = {
    "peak_flops_bf16": 989e12,     # per card, tensor cores
    "hbm_bw": 3.35e12,             # bytes/s per card
    "nvlink_bw": 450e9,            # bytes/s each way per card (NVLink 4:
                                   # 900 GB/s to the host's other cards)
    "ib_bw": 50e9,                 # bytes/s each way per card between hosts:
                                   # one 400 Gb/s NDR InfiniBand port a card
                                   # (NVIDIA DGX H100 user guide: 8 ConnectX-7
                                   # ports for 8 cards)
    "hbm_bytes": 80e9,
}
