"""hubert-xlarge — encoder-only audio transformer backbone.

The modality frontend (wav2vec2-style conv feature extractor) is a STUB:
``input_specs()`` provides precomputed frame embeddings (B, S, d_model).
Training objective: masked-frame cluster prediction over 504 k-means units.
[arXiv:2106.07447]
"""
from repro_torch.configs.base import ArchConfig, register

_SKIP = {
    "decode_32k": "encoder-only arch: no autoregressive decode step "
                  "(assignment rule: skip decode shapes)",
    "long_500k": "encoder-only arch: no decode step; also full attention",
}


@register("hubert-xlarge")
def build() -> ArchConfig:
    return ArchConfig(
        name="hubert-xlarge",
        family="audio",
        n_layers=48,
        d_model=1280,
        n_heads=16,
        n_kv_heads=16,
        d_ff=5120,
        vocab=504,
        head_dim=80,
        act="gelu",
        qk_norm=False,
        causal=False,           # bidirectional encoder
        rope_theta=1e4,
        input_kind="frames",    # precomputed frame embeddings (frontend stub)
        skip_shapes=_SKIP,
        citation="arXiv:2106.07447",
    )
