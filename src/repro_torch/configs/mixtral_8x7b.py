"""Mixtral 8x7B — 8-expert top-2 MoE with sliding-window attention
[arXiv:2401.04088]."""
from .base import ModelConfig, MoEConfig, register

CONFIG = register(ModelConfig(
    name="mixtral_8x7b", family="moe",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, d_head=128,
    d_ff=14336, vocab_size=32000,
    attn_pattern=("swa",), window=4096, rope_theta=1000000.0,
    mlp_variant="swiglu",
    moe=MoEConfig(num_experts=8, top_k=2, d_expert=14336, capacity_factor=1.25),
    source="arXiv:2401.04088",
))
