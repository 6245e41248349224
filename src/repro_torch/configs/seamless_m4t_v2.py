"""SeamlessM4T-large-v2 — encoder-decoder multimodal backbone; audio frontend
is a stub (precomputed frame embeddings) [arXiv:2308.11596]."""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="seamless_m4t_v2", family="audio",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16, d_head=64,
    d_ff=8192, vocab_size=256206,
    encoder_layers=24, frontend="audio_frames",
    attn_pattern=("global",), rope_theta=10000.0, mlp_variant="gelu",
    source="arXiv:2308.11596",
))
