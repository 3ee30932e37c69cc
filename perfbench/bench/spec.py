"""Find a cell's pieces by name.

``BENCHMARK.json`` names each cell's configuration and traffic mix; the
files are ``configs/<config>.json`` and ``traffic/<mix>.json`` under
this folder, and each per-layer metric is a reader in
``metrics/<metric>.py``.  Nothing here names a model, a mix or a metric:
a new cell, mix or metric is a new file and a new entry.
"""
from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, List

HERE = Path(__file__).resolve().parent.parent          # perfbench/
ROOT = HERE.parent                                     # the checkout
BENCHMARK = ROOT / "BENCHMARK.json"

@dataclass
class Cell:
    name: str
    config: dict          # the configuration as run (the share merged)
    traffic: dict
    end_to_end: List[dict]
    per_layer: List[dict]


def load_benchmark(path: Path | None = None) -> dict:
    return json.loads((path or BENCHMARK).read_text())


def config_path(name: str) -> Path:
    return HERE / "configs" / f"{name}.json"


def traffic_path(name: str) -> Path:
    return HERE / "traffic" / f"{name}.json"


def metric_path(name: str) -> Path:
    return HERE / "metrics" / f"{name}.py"


def run_config(name: str, share: str) -> dict:
    """The configuration file's published keys with the chip's share that
    a traffic mix names (``serve`` or ``train``, under the file's
    ``run``) laid over them."""
    raw = json.loads(config_path(name).read_text())
    share = raw.get("run", {}).get(share, {})
    cfg = {k: v for k, v in raw.items() if k != "run"}
    cfg.update(share)
    return cfg


def reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(name: str, bench: dict | None = None) -> Cell:
    bench = bench or load_benchmark()
    by_name = {w["name"]: w for w in bench["workloads"]}
    if name not in by_name:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; known: "
                       f"{sorted(by_name)}")
    w = by_name[name]
    traffic = json.loads(traffic_path(w["traffic"]).read_text())
    e2e = [m for m in bench["end_to_end"] if reports(m, name)]
    moved = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if reports(m, name) and m["moves"] in moved]
    return Cell(name, run_config(w["config"], traffic["share"]), traffic,
                e2e, layer)


def metric_reader(name: str) -> Callable[[Dict], float | None]:
    """The ``read(ctx)`` of ``metrics/<name>.py``, loaded by path (the
    metric names hold dots)."""
    path = metric_path(name)
    spec = importlib.util.spec_from_file_location(
        "perfbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def arch_config(cfg: dict):
    """The program's ``ArchConfig`` for a configuration as run."""
    from repro_torch.configs.base import ArchConfig, MoEConfig

    port = cfg["port"]
    moe = None
    if cfg.get("num_experts"):
        moe = MoEConfig(num_experts=cfg["num_experts"],
                        top_k=cfg["num_experts_per_tok"],
                        expert_d_ff=cfg["moe_intermediate_size"],
                        capacity_factor=port["capacity_factor"],
                        shared_expert_d_ff=0,
                        router_aux_weight=cfg["router_aux_loss_coef"])
    return ArchConfig(
        name=cfg["name"], family=port["family"],
        n_layers=cfg["num_hidden_layers"], d_model=cfg["hidden_size"],
        n_heads=cfg["num_attention_heads"],
        n_kv_heads=cfg["num_key_value_heads"],
        d_ff=cfg["moe_intermediate_size"] if moe else cfg["intermediate_size"],
        vocab=cfg["vocab_size"], head_dim=cfg["head_dim"], act=port["act"],
        qk_norm=port["qk_norm"], rope_theta=float(cfg["rope_theta"]),
        norm_eps=port["norm_eps"], moe=moe, remat=port["remat"],
        optimizer=port["optimizer"]["name"],
        tie_embeddings=cfg["tie_word_embeddings"], citation=cfg["source"])
