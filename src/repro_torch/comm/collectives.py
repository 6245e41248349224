"""Worker-axis exchange primitives for the M stacked workers.

Port of the worker-axis part of ``repro/comm/collectives.py``. The worker
axis is the leading dim of every payload leaf, so the JAX package's
``psum`` / ``all_gather`` over the worker mesh axes become reductions over
dim 0. Sums over workers run in worker order — worker 0, then 1..M-1 one
at a time, then a division by M — the order of the JAX package's sparse
exchange. One ``index_add_`` or ``sum(0)`` of all workers would add in
another order (and with atomics on the card), breaking bitwise parity and
run-to-run determinism.

With the workers spread over the processes of a ``WorkerGroup``
(``comm.process_group``), each rank holds a ``(M/P, ...)`` slice of every
payload leaf. ``gathered_exchange`` all-gathers those slices (values and
indices of sparse payloads, dense leaves alike) into ``(M, ...)`` in rank
order, which is worker order, and then runs the same ordered mean: given
the same payloads it gives the same bits as the stacked exchange. Leaves
travel as raw bytes, so every dtype crosses unchanged. Dense payloads are
all-gathered too, not all-reduced: a ring all-reduce sums in another
order.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

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


# ---------------------------------------------------------------------------
# across the processes of a worker group
# ---------------------------------------------------------------------------

def gather_workers(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``(M/P, ...)`` slice -> ``(M, ...)`` in rank order, on
    this rank's device, bit for bit. On gloo the bytes are staged to the
    host before the collective."""
    raw = x.contiguous().reshape(-1).view(torch.uint8)
    if group.backend == "gloo":
        raw = raw.cpu()
    parts = [torch.empty_like(raw) for _ in range(group.world_size)]
    dist.all_gather(parts, raw, group=group.pg)
    full = torch.cat(parts).to(x.device)
    return full.view(x.dtype).reshape((x.shape[0] * group.world_size,) + tuple(x.shape[1:]))


def psum_scalar(x: torch.Tensor, group) -> torch.Tensor:
    """Sum of a float32 scalar over the ranks (the counterpart of the JAX
    package's ``psum_scalar``); small integer counts are exact in fp32."""
    t = x.detach().to(torch.float32).reshape(1).clone()
    if group.backend == "gloo":
        t = t.cpu()
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group.pg)
    return t.to(x.device).reshape(())


def barrier(group) -> None:
    """Wait until every rank of ``group`` has come here."""
    dist.barrier(group=group.pg)


def gathered_exchange(payload: Tree, kind: str, num_workers: int, group) -> Tree:
    """``exchange`` of the M workers spread over ``group``: all-gather the
    ranks' payload slices, then the stacked exchange's ordered mean."""
    full = tree_map(lambda x: gather_workers(x, group), payload)  # values and indices
    return exchange(full, kind, num_workers)


# ---------------------------------------------------------------------------
# over the axes of a device mesh
# ---------------------------------------------------------------------------

def gather_dim(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in rank order, bit for
    bit (host-staged on gloo, as ``gather_workers``)."""
    if group.world_size == 1:
        return x
    full = gather_workers(x.movedim(dim, 0).contiguous(), group)
    return full.movedim(0, dim).contiguous()


def gather_spec(x: torch.Tensor, entries: tuple, groups: dict) -> torch.Tensor:
    """The full logical array of this rank's shard ``x`` of a leaf split as
    ``entries`` (a partition spec: per dim None, an axis name or a tuple of
    names, major first), gathered over ``groups`` (``{axis name:
    WorkerGroup}``; absent axes are not split). DTensor's own all-gather
    is not used: over gloo it crashes the process on CUDA tensors
    (``tools/dtensor_gloo_probe.py``)."""
    for d, entry in enumerate(tuple(entries)):
        names = () if entry is None else (entry if isinstance(entry, tuple) else (entry,))
        for name in reversed(names):   # innermost axis first
            if name in groups:
                x = gather_dim(x, d, groups[name])
    return x


def mean_over(x: torch.Tensor, group) -> torch.Tensor:
    """The mean of every rank's ``x``, summed in rank order (an all-gather,
    not a ring all-reduce, so it is the same sum on every rank and in a
    one-process run)."""
    if group.world_size == 1:
        return x
    return _ordered_mean(gather_workers(x.unsqueeze(0), group), group.world_size)


def sum_over(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of every rank's ``x`` in rank order, in fp32, cast back to
    ``x``'s dtype: the same bits on every rank."""
    if group.world_size == 1:
        return x
    parts = gather_workers(x.unsqueeze(0), group)
    acc = parts[0].float()
    for r in range(1, group.world_size):
        acc = acc + parts[r].float()
    return acc.to(x.dtype)
