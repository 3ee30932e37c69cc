"""Weights and tokens made from the run's seed, on the device.

Every leaf of the parameter tree is drawn by a generator of its own on
the device, seeded from the run's seed and the leaf's index, in one call
and in the type it is used in: float32 masters for training, bf16 for
serving (the router stays float32).  So the benchmark can make any one
leaf again, alone, for the reference after the program's run, and the
same seed gives the same weights and the same tokens.

The tree has the program's layout (``lm_zoo``'s parameter tree: leaves
stacked on a leading layer axis) and the scales of its initialiser, but
it is drawn here: the program gets it as an input, as it gets its tokens.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

_MASK = (1 << 63) - 1
Path_ = Tuple[str, ...]


def mix(seed: int, stream: int) -> int:
    """A 63-bit generator seed for one stream of the run's seed (any
    whole number the command line gives)."""
    x = (int(seed) * 0x9E3779B97F4A7C15 + (stream + 1) * 0xBF58476D1CE4E5B9)
    x ^= x >> 31
    return (x * 0x94D049BB133111EB) & _MASK


def generator(device, seed: int, stream: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(mix(seed, stream))


def leaf_specs(cfg: dict) -> List[Tuple[Path_, tuple, object, bool]]:
    """(path, shape, scale or "ones", always float32) of each leaf, in a
    fixed order."""
    L, d = cfg["num_hidden_layers"], cfg["hidden_size"]
    hq, hkv, dh = (cfg["num_attention_heads"], cfg["num_key_value_heads"],
                   cfg["head_dim"])
    V, port = cfg["vocab_size"], cfg["port"]
    out = [(("embed",), (V, d), 0.02, False),
           (("layers", "ln1"), (L, d), "ones", False),
           (("layers", "ln2"), (L, d), "ones", False),
           (("layers", "attn", "wq"), (L, d, hq * dh), d ** -0.5, False),
           (("layers", "attn", "wk"), (L, d, hkv * dh), d ** -0.5, False),
           (("layers", "attn", "wv"), (L, d, hkv * dh), d ** -0.5, False),
           (("layers", "attn", "wo"), (L, hq * dh, d),
            (hq * dh) ** -0.5 / math.sqrt(2 * L), False)]
    if port["qk_norm"]:
        out += [(("layers", "attn", "q_norm"), (L, dh), "ones", False),
                (("layers", "attn", "k_norm"), (L, dh), "ones", False)]
    gated = port["act"] == "swiglu"
    if cfg.get("num_experts"):
        E, f = cfg["num_experts"], cfg["moe_intermediate_size"]
        out += [(("layers", "moe", "router"), (L, d, E), d ** -0.5, True),
                (("layers", "moe", "w_up"), (L, E, d, f), d ** -0.5, False),
                (("layers", "moe", "w_down"), (L, E, f, d), f ** -0.5,
                 False)]
        if gated:
            out.append((("layers", "moe", "w_gate"), (L, E, d, f),
                        d ** -0.5, False))
    else:
        f = cfg["intermediate_size"]
        out += [(("layers", "mlp", "w_up"), (L, d, f), d ** -0.5, False),
                (("layers", "mlp", "w_down"), (L, f, d), f ** -0.5, False)]
        if gated:
            out.append((("layers", "mlp", "w_gate"), (L, d, f), d ** -0.5,
                        False))
    out += [(("final_norm",), (d,), "ones", False)]
    if not cfg["tie_word_embeddings"]:
        out.append((("lm_head",), (d, V), d ** -0.5, False))
    return out


def make_leaf(spec, seed: int, index: int, dtype, device) -> torch.Tensor:
    _, shape, scale, f32 = spec
    dt = torch.float32 if f32 else dtype
    if scale == "ones":
        return torch.ones(shape, dtype=dt, device=device)
    w = torch.empty(shape, dtype=dt, device=device)
    return w.normal_(0.0, scale, generator=generator(device, seed, index))


def put(tree: Dict, path: Path_, leaf) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = leaf


def get(tree: Dict, path: Path_):
    for k in path:
        tree = tree[k]
    return tree


def make_params(cfg: dict, seed: int, dtype, device) -> Dict:
    """The whole tree, every leaf drawn on ``device`` in ``dtype`` (the
    router in float32)."""
    tree: Dict = {}
    for i, spec in enumerate(leaf_specs(cfg)):
        put(tree, spec[0], make_leaf(spec, seed, i, dtype, device))
    return tree


# token streams: far from the leaves' indices
TOKEN_STREAM = 1 << 20


def tokens(seed: int, index: int, shape, vocab: int, device) -> torch.Tensor:
    """Batch ``index``'s token ids, uniform over the vocabulary (int32)."""
    g = generator(device, seed, TOKEN_STREAM + index)
    return torch.randint(0, vocab, tuple(shape), generator=g, device=device,
                         dtype=torch.int64).to(torch.int32)
