"""Kimi K2 1T-A32B — trillion-parameter MoE, 384 experts top-8
(paper-table config) [arXiv:2501.kimi2]."""
from .base import ModelConfig, MoEConfig, register

CONFIG = register(ModelConfig(
    name="kimi_k2", family="moe",
    n_layers=61, d_model=7168, n_heads=64, n_kv_heads=8, d_head=112,
    d_ff=2048, vocab_size=163840,
    attn_pattern=("global",), rope_theta=50000.0, mlp_variant="swiglu",
    moe=MoEConfig(num_experts=384, top_k=8, d_expert=2048,
                  capacity_factor=1.25, num_shared_experts=1),
    source="arXiv:2501.kimi2",
))
