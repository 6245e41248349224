"""Worker-axis exchange primitives for the M stacked workers of one device.

Port of the worker-axis part of ``repro/comm/collectives.py``. The worker
axis is the leading dim of every payload leaf, so the JAX package's
``psum`` / ``all_gather`` over the worker mesh axes become reductions over
dim 0. Sums over workers run in worker order — worker 0, then 1..M-1 one
at a time, then a division by M — the order of the JAX package's sparse
exchange. One ``index_add_`` or ``sum(0)`` of all workers would add in
another order (and with atomics on the card), breaking bitwise parity and
run-to-run determinism.
"""
from __future__ import annotations

import torch

from repro_torch.core.topk import BlockPayload, SparsePayload, _scatter_last
from repro_torch.core.types import Tree, tree_map


def _ordered_mean(x: torch.Tensor, num_workers: int) -> torch.Tensor:
    """((x[0] + x[1]) + ... + x[M-1]) / M over the leading worker dim."""
    acc = x[0]
    for m in range(1, num_workers):
        acc = acc + x[m]
    return acc / num_workers


def dense_mean(tree: Tree, num_workers: int) -> Tree:
    """Mean of a dense payload over the worker dim."""
    return tree_map(lambda x: _ordered_mean(x, num_workers), tree)


def _is_payload(x) -> bool:
    return isinstance(x, (SparsePayload, BlockPayload))


def sparse_allgather_mean(payload: Tree, num_workers: int) -> Tree:
    """Densify fixed-k sparse payloads and average them over workers.

    - SparsePayload leaves -> flat vectors: each worker's pairs are
      scatter-added in turn into one dense vector, then divided by M;
    - BlockPayload leaves  -> leaf-shaped arrays: the M block scatters (one
      batched scatter, rows never collide) summed in worker order, / M.
    """

    def leaf(p) -> torch.Tensor:
        if isinstance(p, SparsePayload):
            vals = p.values.to(torch.float32)
            idxs = p.indices.long()
            dense = torch.zeros((p.size,), dtype=torch.float32, device=vals.device)
            for m in range(num_workers):
                dense.index_put_((idxs[m],), vals[m], accumulate=True)
            return dense / num_workers
        dense = _scatter_last(
            p.values.to(torch.float32), p.indices.long(), p.blocked_shape[-1]
        )
        return _ordered_mean(dense, num_workers).reshape(p.orig_shape)

    return tree_map(leaf, payload, is_leaf=_is_payload)


def exchange(payload: Tree, kind: str, num_workers: int) -> Tree:
    """Dispatch on compressor kind. Output: the dense mean contribution.
    Sparse flat payloads come back as flat vectors; the transport reshapes
    them against its template."""
    if kind == "dense":
        return dense_mean(payload, num_workers)
    if kind == "sparse":
        return sparse_allgather_mean(payload, num_workers)
    raise ValueError(f"unknown payload kind {kind!r}")


def reshape_like(flat_tree: Tree, template: Tree) -> Tree:
    """Reshape a tree of flat vectors to the template's leaf shapes/dtypes."""
    return tree_map(
        lambda f, t: f[: t.numel()].reshape(t.shape).to(t.dtype), flat_tree, template
    )
