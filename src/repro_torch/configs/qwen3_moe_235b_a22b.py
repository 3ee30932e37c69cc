"""qwen3-moe-235b-a22b — 128-expert top-8 MoE, GQA, qk-norm.
[hf:Qwen/Qwen3-30B-A3B]
"""
from repro_torch.configs.base import ArchConfig, MoEConfig, register

_SKIP = {"long_500k": "pure full-attention arch; skipped per assignment rule"}


@register("qwen3-moe-235b-a22b")
def build() -> ArchConfig:
    return ArchConfig(
        name="qwen3-moe-235b-a22b",
        family="moe",
        n_layers=94,
        d_model=4096,
        n_heads=64,
        n_kv_heads=4,
        d_ff=1536,                     # per-expert hidden dim
        vocab=151936,
        head_dim=128,
        act="swiglu",
        qk_norm=True,
        rope_theta=1e6,
        moe=MoEConfig(num_experts=128, top_k=8, expert_d_ff=1536,
                      capacity_factor=1.25, shared_expert_d_ff=0),
        skip_shapes=_SKIP,
        citation="hf:Qwen/Qwen3-30B-A3B",
    )
