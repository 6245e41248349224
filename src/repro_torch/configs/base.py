"""Config system: model configs and the registry.

Port of ``repro/configs/base.py``. ``ModelConfig`` keeps every field of
the JAX package's, so a config reads the same in both packages. The
paper's nets (``fc_mnist``, ``cnn_cifar``) and all ten LM architectures
of the JAX package's ``ARCH_IDS`` are registered, in its order.
"""
from __future__ import annotations

import importlib
from dataclasses import dataclass, replace
from typing import Optional, Tuple


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_expert: int                  # per-expert FFN hidden dim
    capacity_factor: float = 1.25
    num_shared_experts: int = 0    # DeepSeek/Kimi-style always-on experts


@dataclass(frozen=True)
class SSMConfig:
    """Mamba-2 (SSD) block hyperparameters."""

    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    chunk_size: int = 256


@dataclass(frozen=True)
class RGLRUConfig:
    """RecurrentGemma RG-LRU block hyperparameters."""

    lru_width: int = 0             # 0 -> d_model
    d_conv: int = 4
    block_width_expand: int = 3 // 1  # gating expansion handled in block


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | hybrid | ssm | encdec | vlm | audio | mlp | cnn
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    d_head: int = 0                # 0 -> d_model // n_heads
    # attention layout
    attn_pattern: Tuple[str, ...] = ("global",)   # cycled over layers:
    #   "global" | "swa" | "local" | "rglru" | "ssd"
    window: int = 4096             # swa / local attention window
    rope_theta: float = 10000.0
    rope_style: str = "full"       # "full" | "half" (ChatGLM 2d-RoPE applies to half dims)
    mlp_variant: str = "swiglu"    # "swiglu" | "geglu" | "gelu"
    # submodule configs
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    rglru: Optional[RGLRUConfig] = None
    # encoder-decoder
    encoder_layers: int = 0        # >0 -> enc-dec; n_layers is the decoder depth
    # modality frontend stub: inputs arrive as precomputed embeddings
    frontend: Optional[str] = None  # None | "patch_embed" | "audio_frames"
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    # preferred GPipe stage count when the run's mesh carries a stage axis;
    # 1 = no pipelining. Must divide the model's homogeneous trunk depth
    # (choose_strategy degrades the knob when it does not fit the mesh).
    pipeline_stages: int = 1
    # sub-quadratic? (drives long_500k applicability)
    source: str = ""

    @property
    def head_dim(self) -> int:
        return self.d_head or self.d_model // self.n_heads

    @property
    def subquadratic(self) -> bool:
        return all(p in ("swa", "local", "rglru", "ssd") for p in self.attn_pattern)

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    def layer_kind(self, i: int) -> str:
        return self.attn_pattern[i % len(self.attn_pattern)]

    def reduced(self) -> "ModelConfig":
        """Smoke-test variant: same family/wiring, tiny dims. The pipeline
        preference is clamped to the reduced depth so the stage knob still
        divides the (now much shallower) trunk."""
        kw = dict(
            n_layers=min(self.n_layers, 2 * max(1, len(self.attn_pattern))),
            pipeline_stages=min(self.pipeline_stages,
                                2 * max(1, len(self.attn_pattern))),
            d_model=128,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) or 1,
            d_head=32,
            d_ff=256,
            vocab_size=256,
            window=min(self.window, 64),
            param_dtype="float32",
            compute_dtype="float32",
        )
        if self.moe:
            kw["moe"] = replace(
                self.moe, num_experts=min(self.moe.num_experts, 8),
                top_k=min(self.moe.top_k, 2), d_expert=64,
            )
        if self.ssm:
            kw["ssm"] = replace(self.ssm, d_state=16, head_dim=16, chunk_size=32)
        if self.rglru:
            kw["rglru"] = replace(self.rglru, lru_width=128)
        if self.encoder_layers:
            kw["encoder_layers"] = 2
        return replace(self, **kw)


PAPER_IDS = ["fc_mnist", "cnn_cifar"]
# the JAX package's ARCH_IDS, in its order
ARCH_IDS = [
    "llama3_8b",
    "chatglm3_6b",
    "starcoder2_3b",
    "granite_20b",
    "kimi_k2",
    "mixtral_8x7b",
    "recurrentgemma_9b",
    "mamba2_370m",
    "seamless_m4t_v2",
    "internvl2_2b",
]

_REGISTRY: dict = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    name = name.replace("-", "_")
    if name not in PAPER_IDS + ARCH_IDS:
        raise KeyError(f"unknown model {name!r}; have {PAPER_IDS + ARCH_IDS}")
    if name not in _REGISTRY:
        importlib.import_module(f"repro_torch.configs.{name}")
    return _REGISTRY[name]
