"""nemotron-4-340b — GQA dense decoder, squared-ReLU MLP. [arXiv:2402.16819]"""
from repro_torch.configs.base import ArchConfig, register

_SKIP = {"long_500k": "pure full-attention arch; skipped per assignment rule"}


@register("nemotron-4-340b")
def build() -> ArchConfig:
    return ArchConfig(
        name="nemotron-4-340b",
        family="dense",
        n_layers=96,
        d_model=18432,
        n_heads=96,
        n_kv_heads=8,
        d_ff=73728,
        vocab=256000,
        head_dim=192,
        act="sq_relu",
        qk_norm=False,
        rope_theta=1e4,
        skip_shapes=_SKIP,
        # AdamW at 340B on a 256-chip pod needs ~21 GB/chip for fp32
        # master+moments alone; factored second moments keep the train
        # cell within v5e HBM (see EXPERIMENTS.md dry-run notes).
        optimizer="adafactor",
        citation="arXiv:2402.16819",
    )
