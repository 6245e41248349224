"""LM building blocks: RMSNorm, token embedding and the LM head.

Port of the corresponding parts of ``repro/models/layers.py``. Params are
nested dicts of tensors in the JAX package's shapes; every module is an
``(init, apply)`` pair of functions. Compute runs in ``cfg.compute_dtype``,
normalization statistics in fp32. Attention, RoPE, the MLPs and MoE come
with the rest of the LM zoo (ROADMAP item 8).
"""
from __future__ import annotations

import math
from typing import Any

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.types import dtype_of

Params = Any


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return dtype_of(cfg.compute_dtype)


def _pdtype(cfg: ModelConfig) -> torch.dtype:
    return dtype_of(cfg.param_dtype)


def init_normal(gen: torch.Generator, shape, scale: float, dtype, device=None) -> torch.Tensor:
    """``scale * N(0, 1)`` drawn in fp32 from ``gen``, cast to ``dtype``."""
    x = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return (scale * x).to(dtype)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def rmsnorm_init(d: int, dtype, device=None) -> Params:
    return {"scale": torch.ones((d,), dtype=dtype_of(dtype), device=device)}


def rmsnorm(params: Params, x: torch.Tensor, eps: float) -> torch.Tensor:
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * params["scale"].float()).to(x.dtype)


# ---------------------------------------------------------------------------
# embeddings / lm head
# ---------------------------------------------------------------------------

def embed_init(gen: torch.Generator, cfg: ModelConfig, device=None) -> Params:
    return {"embed": init_normal(gen, (cfg.vocab_size, cfg.d_model), 1.0,
                                 _pdtype(cfg), device)}


def embed_apply(params: Params, cfg: ModelConfig, tokens: torch.Tensor) -> torch.Tensor:
    # gather, then cast: the same values as the JAX package's cast-then-gather
    return params["embed"][tokens.long()].to(_dtype(cfg))


def lm_head_init(gen: torch.Generator, cfg: ModelConfig, device=None) -> Params:
    return {"lm_head": init_normal(gen, (cfg.d_model, cfg.vocab_size),
                                   1.0 / math.sqrt(cfg.d_model), _pdtype(cfg), device)}


def lm_head_apply(params: Params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    dt = _dtype(cfg)
    return x.to(dt) @ params["lm_head"].to(dt)
