"""Llama-3 8B — dense GQA decoder, 128k vocab [arXiv:2407.21783]."""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="llama3_8b", family="dense",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, d_head=128,
    d_ff=14336, vocab_size=128256,
    attn_pattern=("global",), rope_theta=500000.0, mlp_variant="swiglu",
    # realistic pipeline config: 8 homogeneous decoder layers per stage
    pipeline_stages=4,
    source="arXiv:2407.21783",
))
