"""chameleon-34b — early-fusion VLM: VQ image tokens in one stream.

The VQ-GAN image tokenizer is a STUB; ``input_specs()`` provides token ids
drawn from the unified 65536 vocab (text + image codes). Backbone is a dense
decoder with qk-norm (chameleon uses qk-norm for stability).
[arXiv:2405.09818]
"""
from repro_torch.configs.base import ArchConfig, register

_SKIP = {"long_500k": "pure full-attention arch; skipped per assignment rule"}


@register("chameleon-34b")
def build() -> ArchConfig:
    return ArchConfig(
        name="chameleon-34b",
        family="vlm",
        n_layers=48,
        d_model=8192,
        n_heads=64,
        n_kv_heads=8,
        d_ff=22016,
        vocab=65536,
        head_dim=128,
        act="swiglu",
        qk_norm=True,
        rope_theta=1e4,
        skip_shapes=_SKIP,
        citation="arXiv:2405.09818",
    )
