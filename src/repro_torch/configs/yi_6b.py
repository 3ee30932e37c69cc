"""yi-6b — llama-arch GQA dense decoder. [arXiv:2403.04652; hf]"""
from repro_torch.configs.base import ArchConfig, register

_SKIP = {"long_500k": "pure full-attention arch; skipped per assignment rule"}


@register("yi-6b")
def build() -> ArchConfig:
    return ArchConfig(
        name="yi-6b",
        family="dense",
        n_layers=32,
        d_model=4096,
        n_heads=32,
        n_kv_heads=4,
        d_ff=11008,
        vocab=64000,
        head_dim=128,
        act="swiglu",
        qk_norm=False,
        rope_theta=5e6,
        skip_shapes=_SKIP,
        citation="arXiv:2403.04652",
    )
