"""Generic LM train loop: the train step, checkpointing and exact resume
(counterpart of ``repro.train.trainer``; the GNN wing has its own driver
in ``core/continuous.py``).

The step is plain eager PyTorch (``lm_zoo.make_train_step``): no
``jit`` counterpart is needed, and on the card it runs the hand-written
forward and backward kernels.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, Iterator, Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve
from repro_torch.models import lm_zoo
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.optimizer import Optimizer


@dataclasses.dataclass
class TrainerConfig:
    ckpt_dir: str = "checkpoints"
    ckpt_every: int = 100
    keep: int = 3
    log_every: int = 10
    max_steps: int = 1000


class LMTrainer:
    def __init__(self, cfg: ArchConfig, tcfg: TrainerConfig,
                 optimizer: Optional[Optimizer] = None, seed: int = 0, *,
                 device=None):
        self.cfg = cfg
        self.tcfg = tcfg
        self.device = resolve(device)
        self.optimizer = optimizer or lm_zoo.make_optimizer(cfg)
        self.ckpt = CheckpointManager(tcfg.ckpt_dir, keep=tcfg.keep)

        self.step = 0
        self.cursor = 0          # data-stream position for exact resume
        self.state = None
        self._seed = seed
        self._step_fn = None

    # -- lifecycle -------------------------------------------------------
    def init_or_restore(self) -> None:
        """Restore the latest checkpoint (state, step and cursor) into a
        zero template of ``train_state_specs``, or initialise from the
        seed when there is none."""
        latest = self.ckpt.latest_step()
        if latest is not None:
            template = lm_zoo.train_state_specs(self.cfg, self.optimizer)
            zeros = _zeros_like(template, self.device)
            self.step, self.state, extra = self.ckpt.restore(zeros)
            self.cursor = int(extra.get("cursor", 0))
        else:
            gen = torch.Generator(device=self.device).manual_seed(self._seed)
            self.state = lm_zoo.init_train_state(
                self.cfg, gen, self.optimizer, device=self.device)
        self._step_fn = lm_zoo.make_train_step(self.cfg, self.optimizer)

    # -- loop --------------------------------------------------------------
    def train(self, batches: Iterator[Dict[str, torch.Tensor]],
              max_steps: Optional[int] = None) -> Dict[str, float]:
        if self.state is None:
            raise RuntimeError("call init_or_restore() first")
        max_steps = max_steps or self.tcfg.max_steps
        metrics: Dict[str, float] = {}
        t_log = time.perf_counter()
        for batch in batches:
            if self.step >= max_steps:
                break
            self.state, m = self._step_fn(self.state, batch)
            self.step += 1
            self.cursor += 1
            if self.step % self.tcfg.log_every == 0:
                metrics = {k: float(v) for k, v in m.items()}
                metrics["steps_per_s"] = self.tcfg.log_every / (
                    time.perf_counter() - t_log)
                t_log = time.perf_counter()
            if self.step % self.tcfg.ckpt_every == 0:
                self.ckpt.save(self.step, self.state,
                               extra={"cursor": self.cursor})
        self.ckpt.save(self.step, self.state, extra={"cursor": self.cursor})
        self.ckpt.wait()
        return metrics


def _zeros_like(tree, device):
    """Zeros of each meta leaf's shape and dtype on ``device``; ints and
    None as they are."""
    if isinstance(tree, dict):
        return {k: _zeros_like(v, device) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_zeros_like(v, device) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_zeros_like(v, device) for v in tree)
    if isinstance(tree, torch.Tensor):
        return torch.zeros(tree.shape, dtype=tree.dtype, device=device)
    return tree
