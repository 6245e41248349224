"""Paper's CIFAR model class: ResNet18-style CNN (paper Section 5.1). We use a
compact ResNet (3 stages x 2 basic blocks) so CPU simulation of the four
algorithms is tractable; the comparison semantics (rounds/bits to equal
accuracy) are unchanged."""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="cnn_cifar", family="cnn",
    n_layers=6, d_model=64, n_heads=0, n_kv_heads=0, d_ff=0,
    vocab_size=10,
    param_dtype="float32", compute_dtype="float32",
    # smoke-sized pipeline config: the two full-width stage-1 blocks are the
    # homogeneous trunk (paper_nets.CNN_TRUNK_DEPTH), one block per stage
    pipeline_stages=2,
    source="paper §5.1 (ResNet18/CIFAR, compacted)",
))
