"""zamba2-2.7b — hybrid: Mamba-2 backbone + shared attention block.

54 layers total; a shared (weight-tied) attention block is applied every
`attn_every` layers (we use 6 -> 9 attention applications), all other layers
are Mamba-2 blocks. Sub-quadratic end-to-end at decode (attention is
KV-cached; mamba state is O(1)), so it runs `long_500k` per assignment.
[arXiv:2411.15242; hf]
"""
from repro_torch.configs.base import ArchConfig, SSMConfig, register


@register("zamba2-2.7b")
def build() -> ArchConfig:
    return ArchConfig(
        name="zamba2-2.7b",
        family="hybrid",
        n_layers=54,
        d_model=2560,
        n_heads=32,
        n_kv_heads=32,
        d_ff=10240,
        vocab=32000,
        head_dim=80,
        act="gelu",
        qk_norm=False,
        rope_theta=1e4,
        ssm=SSMConfig(version=2, d_state=64, d_conv=4, expand=2,
                      headdim=64, chunk=128),
        attn_every=6,
        skip_shapes={},
        citation="arXiv:2411.15242",
    )
