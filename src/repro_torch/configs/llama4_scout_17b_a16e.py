"""llama4-scout-17b-a16e — MoE 16 experts top-1 + shared expert, early fusion.

Early-fusion multimodality: image patches arrive as tokens from a stubbed
vision frontend; the backbone sees one token stream.
[hf:meta-llama/Llama-4-Scout-17B-16E]
"""
from repro_torch.configs.base import ArchConfig, MoEConfig, register

_SKIP = {"long_500k": "pure full-attention arch; skipped per assignment rule"}


@register("llama4-scout-17b-a16e")
def build() -> ArchConfig:
    return ArchConfig(
        name="llama4-scout-17b-a16e",
        family="moe",
        n_layers=48,
        d_model=5120,
        n_heads=40,
        n_kv_heads=8,
        d_ff=8192,                     # routed expert hidden dim
        vocab=202048,
        head_dim=128,
        act="swiglu",
        qk_norm=True,
        rope_theta=5e5,
        moe=MoEConfig(num_experts=16, top_k=1, expert_d_ff=8192,
                      capacity_factor=1.25, shared_expert_d_ff=8192),
        skip_shapes=_SKIP,
        citation="hf:meta-llama/Llama-4-Scout-17B-16E",
    )
