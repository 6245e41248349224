"""InternVL2-2B — InternLM2-1.8B language backbone; InternViT frontend is a
stub (precomputed patch embeddings as prefix tokens) [arXiv:2404.16821]."""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="internvl2_2b", family="vlm",
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=8, d_head=128,
    d_ff=8192, vocab_size=92553,
    frontend="patch_embed",
    attn_pattern=("global",), rope_theta=1000000.0, mlp_variant="swiglu",
    source="arXiv:2404.16821",
))
