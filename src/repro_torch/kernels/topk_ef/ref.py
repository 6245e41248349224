"""Plain PyTorch version of the fused EF + block top-k kernel.

The Pallas kernel's own algorithm in torch ops (``core.topk.
masked_argmax_topk``): ``kb`` rounds of max, lowest index among the equal
magnitudes, mask to ``-inf``. Not ``torch.topk``, whose order among ties is
unspecified. ``ops`` runs it for CPU tensors; on the card it is what the
kernel is held to, bit for bit.
"""
from __future__ import annotations

import torch

from repro_torch.core.topk import masked_argmax_topk


def topk_ef_ref(grad2d: torch.Tensor, err2d: torch.Tensor, lr, kb: int):
    """Returns ``(new_err, values, local_indices)``: ``g = lr*grad + err``
    rounded twice (no FMA), the kb largest ``|g|`` per row, and ``new_err``
    with the selected coordinates zeroed."""
    g = grad2d.float() * float(lr) + err2d.float()
    vals, idx, taken = masked_argmax_topk(g, kb)
    new_err = torch.where(taken, torch.zeros_like(g), g)
    return new_err, vals, idx
