"""falcon-mamba-7b — attention-free Mamba-1 LM. Runs long_500k (O(1) state).
[arXiv:2410.05355]
"""
from repro_torch.configs.base import ArchConfig, SSMConfig, register


@register("falcon-mamba-7b")
def build() -> ArchConfig:
    return ArchConfig(
        name="falcon-mamba-7b",
        family="ssm",
        n_layers=64,
        d_model=4096,
        n_heads=1,                   # unused (attention-free)
        n_kv_heads=1,                # unused
        d_ff=0,                      # attn-free, no MLP: mamba block only
        vocab=65024,
        head_dim=64,                 # unused
        act="swiglu",
        qk_norm=False,
        # chunk=32: §Perf C2 — assoc-scan traffic ~ log2(chunk) per element
        ssm=SSMConfig(version=1, d_state=16, d_conv=4, expand=2, chunk=32),
        skip_shapes={},
        citation="arXiv:2410.05355",
    )
