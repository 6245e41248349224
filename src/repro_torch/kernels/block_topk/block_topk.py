"""CUDA launch wrapper of the plain block top-k kernel.

Replaces the Pallas kernel ``repro/kernels/block_topk/block_topk.py::
_topk_tile_kernel``. It is the EF-free instance of ``csrc/topk_ef.cu``:
the same grouped launch (``topk_ef.run_group``) and selection, reading
``x`` only and writing the values and block-local indices of the kb
largest ``|x|`` per row.
"""
from __future__ import annotations

import torch

from .. import build
from ..topk_ef.topk_ef import run_group

LAUNCHES = build.LaunchCounter()
SEGMENTS = build.LaunchCounter()   # segments covered by those launches


def block_topk_group(xs, kbs):
    """Block top-k over a group of ``(rows, bc)`` fp32 CUDA views, each
    with its own kb, in one launch per table. Returns ``(vals, idxs)``:
    lists of per-view ``(rows, kb)`` f32 and int32 views."""
    _, vals, idxs = run_group(False, xs, None, 1.0, kbs, LAUNCHES, SEGMENTS, "block_topk")
    return vals, idxs


def block_topk_cuda(x2d: torch.Tensor, kb: int):
    """One view through the grouped entry. Returns ``(values,
    local_indices)``, both ``(rows, kb)`` (f32, int32)."""
    vals, idxs = block_topk_group([x2d], [kb])
    return vals[0], idxs[0]
