"""Public entries of the fused EF + top-k kernel: the per-shard blocked
view, alone or a group of them in one launch (the main path), a flat
vector, and plain block top-k through the same kernel. Port of
``repro/kernels/topk_ef/ops.py``.

A CPU tensor runs the plain version (``ref.py``); a CUDA tensor launches
the kernel (``topk_ef.py``), which raises on anything it does not take.
There is no fallback from one to the other.
"""
from __future__ import annotations

import torch

from repro_torch.core.topk import SparsePayload, payload_from_blocks
from repro_torch.core.types import ceil_div, pad_to_multiple

from .ref import topk_ef_ref
from .topk_ef import topk_ef_cuda, topk_ef_group


def topk_ef_rows(grad2d: torch.Tensor, err2d: torch.Tensor, lr, kb: int):
    """(new_err, values, local_indices) of a (rows, bc) view."""
    if grad2d.device.type == "cpu":
        return topk_ef_ref(grad2d, err2d, lr, kb)
    return topk_ef_cuda(grad2d, err2d, lr, kb)


def block_topk(x: torch.Tensor, k: int, block_size: int = 2048) -> SparsePayload:
    """Plain block top-k through the fused kernel (zero error, lr=1)."""
    p, _ = topk_ef(x, torch.zeros_like(x, dtype=torch.float32), 1.0, k, block_size)
    return p


def blocked_topk_ef(grad_blocked: torch.Tensor, err_blocked: torch.Tensor, kb: int):
    """Fused EF + top-kb on an already blocked view ``(*lead, nbc, bc)``.

    The per-shard path: lr is already folded into ``grad_blocked`` (lr=1
    here), and every leading dim, the worker dim included, is folded into
    the rows of ONE launch. Returns ``(values, indices, new_err)`` with
    values / block-local int32 indices shaped ``(*lead, nbc, kb)``.
    """
    if grad_blocked.shape != err_blocked.shape:
        raise ValueError("blocked_topk_ef: grad and err differ in shape")
    lead = grad_blocked.shape[:-1]
    bc = grad_blocked.shape[-1]
    g2 = grad_blocked.float().reshape(-1, bc).contiguous()
    e2 = err_blocked.float().reshape(-1, bc).contiguous()
    new_err, vals, idx = topk_ef_rows(g2, e2, 1.0, kb)
    return (
        vals.reshape(lead + (kb,)),
        idx.reshape(lead + (kb,)),
        new_err.reshape(grad_blocked.shape),
    )


def blocked_topk_ef_group(grads_blocked, errs_blocked, kbs):
    """``blocked_topk_ef`` over a group of blocked views, each with its own
    kb: on the card ONE grouped launch for all of them (one per table of
    ``topk_ef.plan_segments``), on the CPU the plain version view by view.
    Returns a list of ``(values, indices, new_err)``, one per view."""
    if not len(grads_blocked) == len(errs_blocked) == len(kbs):
        raise ValueError("blocked_topk_ef_group: grads, errs and kbs differ in length")
    if not grads_blocked:
        return []
    if not grads_blocked[0].is_cuda:
        if any(t.is_cuda for t in (*grads_blocked, *errs_blocked)):
            raise ValueError("blocked_topk_ef_group: views on the CPU and on a card")
        return [blocked_topk_ef(g, e, kb)
                for g, e, kb in zip(grads_blocked, errs_blocked, kbs)]
    new_errs, vals, idxs = topk_ef_group([g.float().contiguous() for g in grads_blocked],
                                         [e.float().contiguous() for e in errs_blocked],
                                         1.0, kbs)
    return list(zip(vals, idxs, new_errs))


def topk_ef(grad: torch.Tensor, err: torch.Tensor, lr, k: int,
            block_size: int = 2048):
    """Fused EF + block top-k over the last dim (leading dims are batch
    dims). The padded tail is ZERO-filled (not masked to -inf), so a block
    with fewer than kb nonzero entries can select tail slots; those get
    value 0 and an index clamped to d-1. Returns ``(SparsePayload,
    new_err)``."""
    if grad.shape != err.shape:
        raise ValueError("topk_ef: grad and err differ in shape")
    lead = grad.shape[:-1]
    d = grad.shape[-1]
    gp = pad_to_multiple(grad.float(), block_size, axis=-1)
    ep = pad_to_multiple(err.float(), block_size, axis=-1)
    nb = gp.shape[-1] // block_size
    kb = min(max(1, ceil_div(int(min(k, d)), nb)), block_size)
    new_err, vals, idx = topk_ef_rows(
        gp.reshape(-1, block_size).contiguous(),
        ep.reshape(-1, block_size).contiguous(), lr, kb,
    )
    payload = payload_from_blocks(
        vals.reshape(lead + (nb, kb)), idx.reshape(lead + (nb, kb)), d, block_size
    )
    return payload, new_err.reshape(lead + (-1,))[..., :d]
