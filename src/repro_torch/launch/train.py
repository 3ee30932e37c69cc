"""Unified launcher (counterpart of ``repro.launch.train``): continuous
GNN training (the paper's workload) or LM pretraining of a reduced
config of any ported architecture, on the card unless ``--device cpu``.

    PYTHONPATH=src python -m repro_torch.launch.train gnn --model tgn --rounds 4
    PYTHONPATH=src python -m repro_torch.launch.train lm --arch yi-6b --steps 50

``lm`` trains ``get_arch(arch).reduced()`` under ``LMTrainer`` on seeded
random batches, resuming from the latest checkpoint in
``--ckpt``/``<arch>`` (the JAX launcher runs ``examples/lm_pretrain.py``
for this; the port keeps its own copy of that loop and batch stream).
"""
from __future__ import annotations

import argparse
from typing import Dict, Iterator

import numpy as np
import torch

from repro_torch.configs import ASSIGNED_ARCHS, get_arch
from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve


def lm_batches(cfg: ArchConfig, batch: int, seq: int, seed: int = 0, *,
               device=None) -> Iterator[Dict[str, torch.Tensor]]:
    """Seeded random batches: token ids for a ``tokens`` input; bf16
    frames, labels and a 30 % mask for a ``frames`` input."""
    device = resolve(device)
    rng = np.random.default_rng(seed)
    to = lambda a: torch.from_numpy(a).to(device)
    while True:
        if cfg.input_kind == "tokens":
            yield {"tokens": to(rng.integers(0, cfg.vocab, (batch, seq))
                                .astype(np.int32))}
        else:
            yield {
                "frames": to(rng.normal(size=(batch, seq, cfg.d_model))
                             .astype(np.float32)).to(torch.bfloat16),
                "labels": to(rng.integers(0, cfg.vocab, (batch, seq))
                             .astype(np.int32)),
                "mask": to(rng.random((batch, seq)) < 0.3),
            }


def run_lm(args) -> None:
    from repro_torch.train.trainer import LMTrainer, TrainerConfig

    cfg = get_arch(args.arch).reduced()
    tcfg = TrainerConfig(ckpt_dir=f"{args.ckpt}/{args.arch}",
                         ckpt_every=20, log_every=min(10, args.steps),
                         max_steps=args.steps)
    tr = LMTrainer(cfg, tcfg, seed=0, device=args.device)
    tr.init_or_restore()
    print(f"[{args.arch}] starting at step {tr.step} "
          f"(family={cfg.family}, reduced config, {tr.device})")
    m = tr.train(lm_batches(cfg, args.batch, args.seq, device=tr.device),
                 args.steps)
    print(f"[{args.arch}] step {tr.step}: "
          + " ".join(f"{k}={v:.4f}" for k, v in m.items()))


def run_gnn(args) -> None:
    from repro_torch.configs.tgn_gdelt import GNN_MODELS
    from repro_torch.core.continuous import ContinuousTrainer
    from repro_torch.data.events import incremental_batches, synth_ctdg

    stream = synth_ctdg(n_nodes=2_000, n_events=args.events,
                        t_span=100_000, d_node=32, d_edge=16,
                        drift_every=30_000, seed=0)
    cfg = GNN_MODELS[args.model](
        d_node=32, d_edge=16, d_time=16, d_hidden=64, d_memory=32,
        fanouts=(10,) if args.model == "tgn" else (10, 10),
        batch_size=512)
    tr = ContinuousTrainer(cfg, stream, threshold=64,
                           cache_policy=args.cache_policy, cache_ratio=0.05,
                           lr=1e-3, seed=0, device=args.device)
    warm = args.events // 3
    cut = max(warm // 2, warm - 4000)
    tr.ingest(stream.slice(0, cut))
    tr.train_round(stream.slice(cut, warm), epochs=args.epochs)
    interval = (stream.ts[-1] - stream.ts[warm]) / args.rounds
    for r, batch in enumerate(incremental_batches(
            stream.slice(warm, len(stream)), interval)):
        if r >= args.rounds:
            break
        m = tr.train_round(batch, epochs=args.epochs,
                           replay_ratio=args.replay)
        print(f"[{args.model} round {r}] pre-AP={m.ap:.3f} "
              f"loss={m.loss:.4f} node_hit={m.node_hit_rate:.2f} "
              f"edge_hit={m.edge_hit_rate:.2f}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    dev = argparse.ArgumentParser(add_help=False)
    dev.add_argument("--device", default=None,
                     help="torch device (default: the card; 'cpu' runs the "
                          "plain PyTorch path)")
    sub = ap.add_subparsers(dest="mode", required=True)

    g = sub.add_parser("gnn", parents=[dev])
    g.add_argument("--model", default="tgn",
                   choices=["tgn", "tgat", "dysat", "graphsage", "gat"])
    g.add_argument("--rounds", type=int, default=4)
    g.add_argument("--events", type=int, default=20_000)
    g.add_argument("--epochs", type=int, default=2)
    g.add_argument("--cache-policy", default="lru",
                   choices=["lru", "lfu", "fifo"])
    g.add_argument("--replay", type=float, default=0.2)

    lm = sub.add_parser("lm", parents=[dev])
    lm.add_argument("--arch", default="qwen3-14b",
                    choices=list(ASSIGNED_ARCHS))
    lm.add_argument("--steps", type=int, default=50)
    lm.add_argument("--batch", type=int, default=4)
    lm.add_argument("--seq", type=int, default=64)
    lm.add_argument("--ckpt", default="checkpoints/lm")
    args = ap.parse_args(argv)
    (run_gnn if args.mode == "gnn" else run_lm)(args)


if __name__ == "__main__":
    main()
