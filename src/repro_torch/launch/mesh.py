"""Device meshes (counterpart of ``repro.launch.mesh``).

A :class:`Mesh` names its axes, gives their sizes and holds the one
torch device every logical shard lives on.  The port runs a mesh's
shards one after another on that device (``dist.sharding.shard_map``),
as the in-process distributed trainer runs its workers, so a mesh is
logical: a (1, 4) mesh runs on one card.

A :class:`ProcessMesh` (:func:`make_process_mesh`) is the mesh as JAX
runs it: one OS process a shard, joined in a ``torch.distributed`` gloo
group, each holding its own coordinates, its device and one subgroup
for every set of axes a collective can name; ``shard_map`` then runs
only this process's shard and its collectives cross the processes
(``dist.spmd``).

Functions, not module-level constants: importing this module touches no
device.
"""
from __future__ import annotations

import math
import itertools
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

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


@dataclass(frozen=True, eq=False)
class ProcessMesh(Mesh):
    """A mesh of one process a shard: this process's ``rank`` (the
    row-major index of its ``coords``, as ``dist.sharding._index`` orders
    shards), its device, and ``groups``: for each set of axes, the
    process groups that set spans, keyed by the coordinates of the other
    axes, each with its members' ranks (:meth:`group`)."""
    rank: int = 0
    coords: Tuple[int, ...] = ()
    groups: Dict = field(default_factory=dict, repr=False)

    def group(self, names) -> Tuple[object, List[int]]:
        """(process group, member ranks in rank order) of this process's
        group over the axes ``names``."""
        pos = dict(zip(self.axis_names, self.coords))
        rest = tuple(pos[a] for a in self.axis_names if a not in names)
        return self.groups[frozenset(names)][rest]

    def coords_of(self, rank: int) -> Tuple[int, ...]:
        """The coordinates of ``rank`` (row-major over every axis)."""
        out = []
        for n in reversed(self.axis_sizes):
            out.append(rank % n)
            rank //= n
        return tuple(reversed(out))


def make_process_mesh(data: int = 1, model: int = 1, *,
                      device: DeviceLike = None) -> ProcessMesh:
    """A (data, model) mesh of one process a shard over the initialised
    ``torch.distributed`` group, whose world size must be ``data *
    model`` (it raises otherwise, and never falls back to a logical
    mesh).  Rank r holds the row-major coordinates of r and runs on
    ``cuda:{r % device_count}`` (the default; it raises without a card)
    or on the CPU when ``device="cpu"`` is asked for.  Every process
    must call it, in the same order as its peers: it makes one gloo
    subgroup for each group of processes that a collective over any
    set of the axes spans (``new_group`` is collective)."""
    import torch.distributed as tdist

    if not (tdist.is_available() and tdist.is_initialized()):
        raise RuntimeError("make_process_mesh: no initialised "
                           "torch.distributed process group")
    world, rank = tdist.get_world_size(), tdist.get_rank()
    if world != data * model:
        raise ValueError(f"make_process_mesh: a ({data}, {model}) mesh "
                         f"needs {data * model} processes, the group has "
                         f"{world}")
    if device is None or torch.device(device).type == "cuda":
        resolve("cuda")
        dev = torch.device(f"cuda:{rank % torch.cuda.device_count()}")
    elif torch.device(device).type == "cpu":
        dev = torch.device("cpu")
    else:
        raise ValueError(f"make_process_mesh: device {device!r}: a rank "
                         f"runs on its card or, when asked, on the CPU")
    names, sizes = ("data", "model"), (data, model)
    coords_of = ProcessMesh(names, sizes, None, 0, ()).coords_of
    groups: Dict = {}
    for k in range(1, len(names) + 1):
        for subset in itertools.combinations(names, k):
            by_rest: Dict = {}
            for r in range(world):
                pos = dict(zip(names, coords_of(r)))
                by_rest.setdefault(tuple(pos[a] for a in names
                                         if a not in subset), []).append(r)
            groups[frozenset(subset)] = {
                rest: (tdist.new_group(members, backend="gloo"), members)
                for rest, members in sorted(by_rest.items())}
    return ProcessMesh(names, sizes, dev, rank, coords_of(rank), groups)


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
