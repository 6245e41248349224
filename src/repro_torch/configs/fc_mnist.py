"""Paper's MNIST model: two-layer fully-connected net, 512 hidden units
(paper Section 5.1)."""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="fc_mnist", family="mlp",
    n_layers=2, d_model=512, n_heads=0, n_kv_heads=0, d_ff=0,
    vocab_size=10,   # num classes
    param_dtype="float32", compute_dtype="float32",
    source="paper §5.1 (MNIST FC-512)",
))
