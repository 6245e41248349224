"""Exchange primitives over the M stacked workers and the pipeline stages.

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

The pipeline's stage axis (``StageAxis``) lives in this process on a
``StackedMesh`` or spreads over the ranks of a device mesh's stage axis;
``ring_shift_parts``, ``ring_broadcast_parts``, ``psum_tree``,
``stage_combine_leaf`` and ``gather_block_payload`` give the same bits in
both forms.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.core.topk import BlockPayload, SparsePayload, _scatter_last
from repro_torch.core.types import Tree, tree_flatten, tree_map, tree_unflatten


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


# ---------------------------------------------------------------------------
# over the pipeline's stage axis
# ---------------------------------------------------------------------------

class StageAxis:
    """The pipeline's S stages as this process sees them.

    - no ``group`` (a ``StackedMesh``): all S stages live in this process;
      a per-stage quantity is a list of S values, stage order;
    - a ``WorkerGroup`` over the stage axis of a ``DeviceMesh``: this rank
      is stage ``group.rank``; a per-stage quantity is a list of one value.

    The collectives below take and give such lists. A shift hands stage s's
    parts to stage s + shift; a sum adds the stages' values in stage order
    (host-staged all-gathers on gloo, as ``gather_workers``), so both forms
    compute the same bits."""

    def __init__(self, size: int, group=None):
        if group is not None and group.world_size != size:
            raise ValueError(f"a stage axis of {size} over a group of {group.world_size}")
        self.size = size
        self.group = group

    @property
    def stages(self) -> tuple:
        """The stages this process runs, in order."""
        return tuple(range(self.size)) if self.group is None else (self.group.rank,)

    def _all(self, xs: list) -> list:
        """Every stage's tensor, stage order (one list per call)."""
        if self.group is None:
            return list(xs)
        (x,) = xs
        return list(gather_workers(x.unsqueeze(0), self.group).unbind(0))


def ring_shift_parts(parts: list, stage: StageAxis, shift: int = 1) -> list:
    """Per-stage tuples of wire parts -> what each local stage receives:
    stage s gets stage (s - shift) mod S's parts, in the same order."""
    n = len(parts[0])
    every = [stage._all([p[i] for p in parts]) for i in range(n)]
    return [tuple(every[i][(s - shift) % stage.size] for i in range(n))
            for s in stage.stages]


def ring_broadcast_parts(parts: list, stage: StageAxis, src: int) -> list:
    """Stage ``src``'s wire parts on every local stage (the JAX package's
    psum of the parts masked to ``src``: adding exact zeros, a copy)."""
    if stage.group is None:
        return [parts[src]] * stage.size
    n = len(parts[0])
    return [tuple(stage._all([p[i] for p in parts])[src] for i in range(n))]


def psum_tree(trees: list, stage: StageAxis) -> Tree:
    """The sum over all stages of per-stage trees, in stage order; the same
    tree on every local stage."""
    flat = [tree_flatten(t) for t in trees]
    treedef = flat[0][1]
    out = []
    for i in range(treedef.num_leaves):
        every = stage._all([f[0][i] for f in flat])
        acc = every[0]
        for x in every[1:]:
            acc = acc + x
        out.append(acc)
    return tree_unflatten(treedef, out)


def stage_combine_leaf(xs: list, stage: StageAxis, is_trunk: bool, dim: int) -> torch.Tensor:
    """Per-stage gradient leaves -> the full leaf: a trunk slice
    concatenates over stages along its layer ``dim``; any other leaf is a
    stage-0-masked partial and sums to its value."""
    every = stage._all(xs)
    if is_trunk:
        return torch.cat(every, dim=dim)
    acc = every[0]
    for x in every[1:]:
        acc = acc + x
    return acc


def gather_block_payload(ps: list, stage: StageAxis, dim: int) -> BlockPayload:
    """Per-stage ``BlockPayload`` slices of a trunk leaf -> the full leaf's
    payload: values and indices concatenated over stages along the
    blocked view's layer ``dim`` (the k-sized gather that replaces the
    d-sized trunk gather)."""
    vals = torch.cat(stage._all([p.values for p in ps]), dim=dim)
    idxs = torch.cat(stage._all([p.indices for p in ps]), dim=dim)
    p = ps[0]
    b = list(p.blocked_shape)
    o = list(p.orig_shape)
    b[0] *= stage.size
    o[0] *= stage.size
    return BlockPayload(vals, idxs, tuple(b), tuple(o))
