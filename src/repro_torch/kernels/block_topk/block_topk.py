"""CUDA launch wrapper of the plain block top-k kernel.

Replaces the Pallas kernel ``repro/kernels/block_topk/block_topk.py::
_topk_tile_kernel``. It is the EF-free entry of ``csrc/topk_ef.cu``: the
same selection device function, reading ``x`` only and writing the
values and block-local indices of the kb largest ``|x|`` per row.
"""
from __future__ import annotations

import torch

from .. import build
from ..topk_ef.topk_ef import check_rows, library

LAUNCHES = build.LaunchCounter()


def block_topk_cuda(x2d: torch.Tensor, kb: int):
    """Launch the kernel. Returns ``(values, local_indices)``, both
    ``(rows, kb)`` (f32, int32)."""
    check_rows("block_topk", x2d, kb)
    rows, bc = x2d.shape
    vals = torch.empty((rows, kb), dtype=torch.float32, device=x2d.device)
    idx = torch.empty((rows, kb), dtype=torch.int32, device=x2d.device)
    if rows == 0:
        return vals, idx
    with torch.cuda.device(x2d.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = library().repro_block_topk(
            x2d.data_ptr(), vals.data_ptr(), idx.data_ptr(), rows, bc, kb, stream,
        )
    build.check(rc, "block_topk")
    LAUNCHES.count += 1
    return vals, idx
