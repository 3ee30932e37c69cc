"""Config system: architectures, input shapes, and the registry.

A copy of the JAX package's ``configs/base.py`` (pure-Python dataclasses):
every assigned architecture gets one module in this package that builds an
``ArchConfig`` with the exact published dimensions, plus a ``reduced()``
variant used by CPU tests.  ``get_arch`` imports the arch modules of this
package.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

# ---------------------------------------------------------------------------
# Input shapes (assignment spec, LM-family: seq_len x global_batch)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


# ---------------------------------------------------------------------------
# Architecture config
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 0
    top_k: int = 1
    expert_d_ff: int = 0
    capacity_factor: float = 1.25
    shared_expert_d_ff: int = 0  # 0 = no shared expert
    router_aux_weight: float = 0.01


@dataclass(frozen=True)
class SSMConfig:
    version: int = 1           # 1 = Mamba-1 selective scan, 2 = Mamba-2 / SSD
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    headdim: int = 64          # Mamba-2 only
    chunk: int = 128           # chunked-scan block length


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0          # 0 -> d_model // n_heads
    # --- layer flavor ---
    act: str = "swiglu"        # swiglu | sq_relu | gelu
    qk_norm: bool = False
    causal: bool = True        # False for encoder-only (hubert)
    tie_embeddings: bool = False
    rope_theta: float = 1e6
    norm_eps: float = 1e-6
    # --- mixture / ssm ---
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    # hybrid (zamba2-style): 1 shared attention block applied every
    # `attn_every` layers; all other layers are mamba2 blocks.
    attn_every: int = 0        # 0 -> pure attention or pure ssm per family
    # --- modality frontend stub ---
    input_kind: str = "tokens"  # tokens | frames (precomputed embeddings)
    # --- which assigned shapes run / skip (reason strings for DESIGN) ---
    skip_shapes: Dict[str, str] = field(default_factory=dict)
    # --- training ---
    remat: str = "block"       # none | block | full
    scan_layers: bool = True
    optimizer: str = "adamw"   # adamw | adafactor (340B-class memory relief)
    citation: str = ""

    # ----- derived -----
    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def is_encoder(self) -> bool:
        return not self.causal

    @property
    def has_attention(self) -> bool:
        return self.family != "ssm"

    @property
    def n_ssm_layers(self) -> int:
        if self.family == "ssm":
            return self.n_layers
        if self.family == "hybrid":
            return self.n_layers - self.n_layers // max(self.attn_every, 1)
        return 0

    def shapes(self) -> List[ShapeSpec]:
        """Shapes this arch runs (assignment skip rules applied)."""
        out = []
        for s in SHAPES.values():
            if s.name in self.skip_shapes:
                continue
            out.append(s)
        return out

    def reduced(self) -> "ArchConfig":
        """Tiny same-family config for CPU smoke tests."""
        kw = dict(
            n_layers=2,
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads else 0,
            d_ff=128,
            vocab=256,
            head_dim=16,
            scan_layers=True,
            remat="none",
        )
        if self.family == "hybrid":
            kw["n_layers"] = 4
            kw["attn_every"] = 2
        moe = None
        if self.moe is not None:
            moe = MoEConfig(
                num_experts=4,
                top_k=min(self.moe.top_k, 2),
                expert_d_ff=64,
                capacity_factor=2.0,
                shared_expert_d_ff=64 if self.moe.shared_expert_d_ff else 0,
            )
        ssm = None
        if self.ssm is not None:
            ssm = SSMConfig(
                version=self.ssm.version, d_state=8, d_conv=4, expand=2,
                headdim=16, chunk=16,
            )
        return dataclasses.replace(self, moe=moe, ssm=ssm, **kw)


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY: Dict[str, Callable[[], ArchConfig]] = {}


def register(name: str):
    def deco(fn: Callable[[], ArchConfig]):
        _REGISTRY[name] = fn
        return fn
    return deco


def get_arch(name: str) -> ArchConfig:
    import importlib

    if name not in _REGISTRY:
        # lazy import of the module with matching file name
        mod = name.replace("-", "_").replace(".", "_")
        importlib.import_module(f"repro_torch.configs.{mod}")
    if name not in _REGISTRY:
        raise KeyError(
            f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]()


ASSIGNED_ARCHS: Tuple[str, ...] = (
    "qwen3-14b",
    "yi-6b",
    "granite-3-8b",
    "nemotron-4-340b",
    "hubert-xlarge",
    "zamba2-2.7b",
    "llama4-scout-17b-a16e",
    "qwen3-moe-235b-a22b",
    "chameleon-34b",
    "falcon-mamba-7b",
)


def all_archs() -> List[ArchConfig]:
    return [get_arch(n) for n in ASSIGNED_ARCHS]


def dryrun_cells() -> List[Tuple[ArchConfig, ShapeSpec]]:
    """All runnable (arch x shape) dry-run cells (skips applied)."""
    cells = []
    for cfg in all_archs():
        for s in cfg.shapes():
            cells.append((cfg, s))
    return cells


def skipped_cells() -> List[Tuple[str, str, str]]:
    """(arch, shape, reason) for documented skips."""
    out = []
    for cfg in all_archs():
        for shape_name, reason in sorted(cfg.skip_shapes.items()):
            out.append((cfg.name, shape_name, reason))
    return out
