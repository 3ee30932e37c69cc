"""Distributed substrate (counterpart of ``repro.dist``): the
P-machine x G-rank continuous-learning loop run in one process, and the
LM wing's logical-axis sharding.

``repro_torch.dist.transport``   where a machine lives: the in-process
                                 ``LocalTransport`` and the op table.
``repro_torch.dist.state``       ``ShardedStateService``: owner-sharded
                                 features and TGN memory.
``repro_torch.dist.collectives`` gradient reduction over the W
                                 workers' trees (bucketed / quantized /
                                 top-k sparsified sum).
``repro_torch.dist.sharding``    the rules table, the mesh context and
                                 the local ``shard_map`` with its
                                 collectives (context-parallel
                                 attention, expert-parallel moe).
``repro_torch.dist.continuous``  ``DistributedContinuousTrainer``
                                 (imported lazily: it pulls in the
                                 model zoo).
"""
from repro_torch.dist import collectives, state, transport  # noqa: F401

__all__ = ["collectives", "state", "transport", "continuous"]


def __getattr__(name):          # PEP 562: lazy 'continuous' submodule
    if name == "continuous":
        import repro_torch.dist.continuous as m
        return m
    raise AttributeError(
        f"module 'repro_torch.dist' has no attribute {name!r}")
