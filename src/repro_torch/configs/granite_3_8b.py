"""granite-3-8b — GQA dense decoder. [hf:ibm-granite/granite-3.0-2b-base; hf]"""
from repro_torch.configs.base import ArchConfig, register

_SKIP = {"long_500k": "pure full-attention arch; skipped per assignment rule"}


@register("granite-3-8b")
def build() -> ArchConfig:
    return ArchConfig(
        name="granite-3-8b",
        family="dense",
        n_layers=40,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        d_ff=12800,
        vocab=49155,
        head_dim=128,
        act="swiglu",
        qk_norm=False,
        rope_theta=1e7,
        tie_embeddings=True,
        skip_shapes=_SKIP,
        citation="hf:ibm-granite/granite-3.0-2b-base",
    )
