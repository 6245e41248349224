"""PyTorch / CUDA port of the SASG system (arXiv:2112.04088).

The JAX package ``repro`` is the reference; this package mirrors its module
layout (``repro/core/topk.py`` -> ``repro_torch/core/topk.py``, ...) and
computes the same functions in PyTorch. The TPU Pallas kernels become
hand-written CUDA kernels for Hopper (``csrc/``), built with ``nvcc`` at
first use (``repro_torch.kernels.build``).

Ported so far: the paper's main path, where M simulated workers (a stacked
leading dim on one device) train ``fc_mnist`` / ``cnn_cifar`` with SGD,
Sparse, LASG or SASG and every ``topk_ef`` compression on the card runs
the fused EF + top-k kernel; and serving ``mamba2_370m`` with the
continuous-batching engine (``serve``), where every prefill tick runs the
Mamba-2 SSD chunk kernel in every layer. Entry points run on ``cuda``
unless the caller passes ``device="cpu"``.
"""
