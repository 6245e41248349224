"""StarCoder2-3B — dense GQA(kv=2) code model, GELU MLP [arXiv:2402.19173]."""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="starcoder2_3b", family="dense",
    n_layers=30, d_model=3072, n_heads=24, n_kv_heads=2, d_head=128,
    d_ff=12288, vocab_size=49152,
    attn_pattern=("global",), rope_theta=100000.0, mlp_variant="gelu",
    source="arXiv:2402.19173",
))
