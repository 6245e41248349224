"""RecurrentGemma-9B — Griffin hybrid: RG-LRU + local attention, 2:1
[arXiv:2402.19427]."""
from .base import ModelConfig, RGLRUConfig, register

CONFIG = register(ModelConfig(
    name="recurrentgemma_9b", family="hybrid",
    n_layers=38, d_model=4096, n_heads=16, n_kv_heads=1, d_head=256,
    d_ff=12288, vocab_size=256000,
    attn_pattern=("rglru", "rglru", "local"), window=2048,
    rope_theta=10000.0, mlp_variant="geglu",
    rglru=RGLRUConfig(lru_width=4096, d_conv=4),
    source="arXiv:2402.19427",
))
