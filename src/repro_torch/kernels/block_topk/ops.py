"""Public entry of the block top-k kernel: SparsePayload out, matching
``repro/kernels/block_topk/ops.py``. A CPU tensor runs the plain version;
a CUDA tensor launches the kernel or raises."""
from __future__ import annotations

import torch

from repro_torch.core.topk import SparsePayload, payload_from_blocks
from repro_torch.core.types import ceil_div, pad_to_multiple

from .block_topk import block_topk_cuda
from .ref import block_topk_ref


def block_topk_rows(x2d: torch.Tensor, kb: int):
    """(values, local_indices) of a (rows, bc) view."""
    if x2d.device.type == "cpu":
        return block_topk_ref(x2d, kb)
    return block_topk_cuda(x2d, kb)


def block_topk(x: torch.Tensor, k: int, block_size: int = 2048) -> SparsePayload:
    """Block top-k over the last dim; the padded tail is zero-filled and
    out-of-range picks get value 0 and index d-1 (as in ``topk_ef.ops``)."""
    lead = x.shape[:-1]
    d = x.shape[-1]
    xp = pad_to_multiple(x.float(), block_size, axis=-1)
    nb = xp.shape[-1] // block_size
    kb = min(max(1, ceil_div(int(min(k, d)), nb)), block_size)
    vals, idx = block_topk_rows(xp.reshape(-1, block_size).contiguous(), kb)
    return payload_from_blocks(
        vals.reshape(lead + (nb, kb)), idx.reshape(lead + (nb, kb)), d, block_size
    )
