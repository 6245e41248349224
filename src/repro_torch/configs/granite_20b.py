"""Granite-20B code — MQA (kv=1) deep decoder [arXiv:2405.04324]."""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="granite_20b", family="dense",
    n_layers=52, d_model=6144, n_heads=48, n_kv_heads=1, d_head=128,
    d_ff=24576, vocab_size=49152,
    attn_pattern=("global",), rope_theta=10000.0, mlp_variant="gelu",
    source="arXiv:2405.04324",
))
