"""Mamba2-370M — attention-free SSD (state-space duality) [arXiv:2405.21060]."""
from .base import ModelConfig, SSMConfig, register

CONFIG = register(ModelConfig(
    name="mamba2_370m", family="ssm",
    n_layers=48, d_model=1024, n_heads=0, n_kv_heads=0, d_head=0,
    d_ff=0, vocab_size=50280,
    attn_pattern=("ssd",),
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64, n_groups=1,
                  chunk_size=256),
    source="arXiv:2405.21060",
))
