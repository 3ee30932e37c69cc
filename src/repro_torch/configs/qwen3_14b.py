"""qwen3-14b — dense GQA decoder with qk-norm. [hf:Qwen/Qwen3-8B; hf]"""
from repro_torch.configs.base import ArchConfig, register

_SKIP = {"long_500k": "pure full-attention arch; 524k dense attention is "
                      "quadratic — skipped per assignment rule"}


@register("qwen3-14b")
def build() -> ArchConfig:
    return ArchConfig(
        name="qwen3-14b",
        family="dense",
        n_layers=40,
        d_model=5120,
        n_heads=40,
        n_kv_heads=8,
        d_ff=17408,
        vocab=151936,
        head_dim=128,
        act="swiglu",
        qk_norm=True,
        rope_theta=1e6,
        skip_shapes=_SKIP,
        citation="hf:Qwen/Qwen3-8B",
    )
