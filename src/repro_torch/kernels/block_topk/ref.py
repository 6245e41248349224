"""Plain PyTorch version of the block top-k kernel: the masked-argmax
selection of ``core.topk.masked_argmax_topk`` on ``x`` (no EF)."""
from __future__ import annotations

import torch

from repro_torch.core.topk import masked_argmax_topk


def block_topk_ref(x2d: torch.Tensor, kb: int):
    """x2d: (n_blocks, block_size). Returns (values, local indices) with the
    lowest index first among equal |x|."""
    vals, idx, _ = masked_argmax_topk(x2d.float(), kb)
    return vals, idx
