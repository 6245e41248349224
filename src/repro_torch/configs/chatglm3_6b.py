"""ChatGLM3-6B — dense GQA(kv=2) decoder with 2d (half) RoPE [arXiv:2406.12793]."""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="chatglm3_6b", family="dense",
    n_layers=28, d_model=4096, n_heads=32, n_kv_heads=2, d_head=128,
    d_ff=13696, vocab_size=65024,
    attn_pattern=("global",), rope_theta=10000.0, rope_style="half",
    mlp_variant="swiglu", source="arXiv:2406.12793",
))
