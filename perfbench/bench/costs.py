"""The yardstick's arithmetic, frozen: the H100's published peaks, the
roofline bound of a call, and the model FLOPs and bytes of the cells'
steps, all counted from shapes alone.

The peaks and the bound are those the port's card script used for its
kernel table (NVIDIA's H100 SXM data sheet, dense rates at 700 W); they
are copied here so that the benchmark's yardstick does not move when the
program's scripts do.
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet, at 700 W
FP32_OPS_PER_S = 67e12         # float32 outside the tensor cores
BF16_OPS_PER_S = 989e12        # dense bf16 tensor cores
TF32_OPS_PER_S = 495e12        # dense TF32 tensor cores
# special-function units: 16 exp2 results a clock an SM (compute
# capability 9.0), 132 SMs at the 1.98 GHz boost clock
SFU_PER_S = 16 * 132 * 1.98e9


def bound_s(nbytes: float, ops: float, ops_per_s: float = BF16_OPS_PER_S,
            exps: float = 0.0) -> float:
    """The least time a call can take: the larger of its bytes over the
    memory rate and its operations over their peak rate, exponentials
    on the special-function units counting as operations too."""
    return max(nbytes / HBM_BYTES_PER_S, ops / ops_per_s, exps / SFU_PER_S)


def causal_pairs(B: int, H: int, S: int) -> float:
    """(query, key) pairs of a causal attention over S positions."""
    return B * H * (S * S + S) / 2


def flash_fwd_bound_s(B: int, S: int, Hq: int, Hkv: int, D: int) -> float:
    """The bf16 causal forward: q, k, v read and o written once (2 bytes
    an element), 4 D FLOP and one exp a (query, key) pair."""
    pairs = causal_pairs(B, Hq, S)
    nbytes = 2 * (2 * B * S * Hq * D + 2 * B * S * Hkv * D)
    return bound_s(nbytes, 4.0 * D * pairs, exps=pairs)


def flash_bwd_bound_s(B: int, S: int, Hq: int, Hkv: int, D: int) -> float:
    """The bf16 causal backward (5b): q, o, dO, dq and k, v, dk, dv once
    (2 bytes an element) and the row log-sum-exps (4 bytes a row); five
    products of 2 D FLOP a (query, key) pair (S, dP, dv, dk, dq) and one
    exp a pair."""
    pairs = causal_pairs(B, Hq, S)
    nbytes = 2 * 4 * (B * S * Hq * D + B * S * Hkv * D) + 4 * B * Hq * S
    return bound_s(nbytes, 10.0 * D * pairs, exps=pairs)


def layer_matmul_params(cfg: dict) -> float:
    """Matmul parameters one token meets in one block: the attention's
    four projections, then the MLP, or the router and ``top_k`` experts
    (the experts a token is routed to, not the capacity's padding)."""
    d, hq, hkv, dh = (cfg["hidden_size"], cfg["num_attention_heads"],
                      cfg["num_key_value_heads"], cfg["head_dim"])
    attn = d * hq * dh * 2 + d * hkv * dh * 2
    if cfg.get("num_experts"):
        per_expert = d * cfg["moe_intermediate_size"] * (
            3 if cfg["hidden_act"] == "silu" else 2)
        return attn + d * cfg["num_experts"] + (
            cfg["num_experts_per_tok"] * per_expert)
    mats = 3 if cfg["hidden_act"] == "silu" else 2
    return attn + d * cfg["intermediate_size"] * mats


def train_step_flops(cfg: dict, B: int, S: int) -> float:
    """Model FLOPs of one train step: 6 x matmul parameters x tokens (the
    blocks and the unembedding; the embedding is a lookup) plus the
    causal attention's 12 D FLOP a pair (forward 4 D, backward 8 D).
    Block remat's recompute is not model work and is not counted."""
    L = cfg["num_hidden_layers"]
    tokens = B * S
    mm = L * layer_matmul_params(cfg) + cfg["hidden_size"] * cfg["vocab_size"]
    pairs = L * causal_pairs(B, cfg["num_attention_heads"], S)
    return 6.0 * mm * tokens + 12.0 * cfg["head_dim"] * pairs


def prefill_flops(cfg: dict, B: int, S: int) -> float:
    """Model FLOPs of one prefill: 2 x the blocks' matmul parameters x
    tokens, the causal attention's 4 D FLOP a pair, and the unembedding
    of each sequence's last position."""
    L = cfg["num_hidden_layers"]
    pairs = L * causal_pairs(B, cfg["num_attention_heads"], S)
    return (2.0 * L * layer_matmul_params(cfg) * B * S
            + 4.0 * cfg["head_dim"] * pairs
            + 2.0 * cfg["hidden_size"] * cfg["vocab_size"] * B)


def decode_step_bytes(cfg: dict, B: int, kv_len: float) -> float:
    """Bytes one bf16 decode step must read: every block weight and the
    unembedding once (the embedding: B rows), and each sequence's K and
    V over its ``kv_len`` populated positions in every layer."""
    L, d = cfg["num_hidden_layers"], cfg["hidden_size"]
    weights = L * layer_matmul_params(cfg) + d * cfg["vocab_size"] + B * d
    kv = L * B * kv_len * 2 * cfg["num_key_value_heads"] * cfg["head_dim"]
    return 2.0 * (weights + kv)
