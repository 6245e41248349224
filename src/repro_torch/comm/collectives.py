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

The wire log (``wire_log``): while one is open, every collective function
here appends one row per tensor it moves, as each device of the mesh
would move it: its ``kind`` (``all-gather``, ``all-reduce``,
``reduce-scatter``, ``permute``), the mesh ``axes`` and ``group_size`` it
spans, the per-device ``result_bytes``, the ring model's ``wire_bytes``
(an all-gather (n-1)/n of its result, an all-reduce 2(n-1)/n, a
reduce-scatter n-1 times its result, a permute its result),
``moved_bytes`` (what this process handed to ``torch.distributed``: 0 in
one process), the result's ``shapes``, the seam function (``op``; the
model axis's operators of ``dist.tensor_parallel`` name themselves:
``copy_to``, ``reduce``, ``gather``, ``gather_for_local``,
``reduce_scatter``, and the transport's ``whole_leaf`` gather) and its
``caller`` outside ``repro_torch.comm``. The exchange,
``gather_workers``, ``psum_scalar`` and the stage-axis functions have a
stacked form, which logs what the ranks of the same mesh log; only
``moved_bytes`` differs. ``gather_dim``, ``gather_spec``, ``mean_over``,
``sum_over`` and ``reduce_scatter`` have none: a ``StackedMesh`` holds
full arrays and never calls them, so only ranks log the params and
updates gathered over a model axis, the tensor-parallel forward's and
backward's activations, the hierarchical strategy's mean over its inner
data axis and plain data parallelism's gradient mean. A row reads
shapes and dtypes, never a tensor's values; with no log open each
function pays one check. Collectives over one device move nothing and
log nothing.
"""
from __future__ import annotations

import contextlib
import math
import os
import sys
from typing import NamedTuple, Optional

import torch
import torch.distributed as dist

from repro_torch.core.topk import BlockPayload, SparsePayload, _scatter_last
from repro_torch.core.types import Tree, tree_flatten, tree_leaves, tree_map, tree_unflatten

_ROWS: Optional[list] = None   # the open wire log's rows; None: nothing is logged
_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class Span(NamedTuple):
    """The mesh axes a collective runs over and the devices along them."""

    axes: tuple
    size: int


@contextlib.contextmanager
def wire_log():
    """Log this module's collectives while the block runs; yields the list
    of rows (module docstring). Logs nest: an inner one takes the rows of
    its block, the outer one goes on after it."""
    global _ROWS
    outer, _ROWS = _ROWS, []
    try:
        yield _ROWS
    finally:
        _ROWS = outer


def wire_factor(kind: str, n: int) -> float:
    """Bytes a device sends per byte of a collective's result over ``n``
    devices, on a ring (the HLO audit's model)."""
    if kind == "all-gather":
        return (n - 1) / n
    if kind == "all-reduce":
        return 2.0 * (n - 1) / n
    if kind == "reduce-scatter":
        return float(n - 1)
    return 1.0


def _caller() -> str:
    """``module:function`` of the nearest frame outside ``repro_torch.comm``."""
    comm = os.path.join(_PKG, "comm") + os.sep
    f = sys._getframe(2)
    while f is not None and os.path.abspath(f.f_code.co_filename).startswith(comm):
        f = f.f_back
    if f is None:
        return "?"
    path = os.path.abspath(f.f_code.co_filename)
    if path.startswith(_PKG + os.sep):
        path = os.path.relpath(path, _PKG).replace(os.sep, "/")
    return f"{path}:{f.f_code.co_name}"


def _log(kind: str, op: str, span, x: torch.Tensor, shape, moved: bool,
         caller: Optional[str] = None) -> None:
    """One row: a collective of ``kind`` over ``span`` whose per-device
    result has ``shape`` and ``x``'s dtype; ``moved``: ``x`` went to
    ``torch.distributed``. No span (a stacked call that names no axes) or
    one device: nothing crosses, nothing is logged."""
    if span is None or span[1] <= 1:
        return
    axes, n = tuple(span[0]), int(span[1])
    shape = [int(d) for d in shape]
    nbytes = math.prod(shape) * x.element_size()
    _ROWS.append({
        "kind": kind, "op": op, "axes": list(axes), "group_size": n,
        "result_bytes": nbytes, "wire_bytes": wire_factor(kind, n) * nbytes,
        "moved_bytes": x.numel() * x.element_size() if moved else 0,
        "shapes": f"{str(x.dtype).replace('torch.', '')}{shape}",
        "caller": caller or _caller(),
    })


def _tensors(tree: Tree) -> list:
    """The tensors of a tree, payloads' values and indices included, in
    flatten order (the order ``tree_map`` moves them in)."""
    return [x for x in tree_leaves(tree) if isinstance(x, torch.Tensor)]


def _per_device(shape, share: int = 1, dim: Optional[int] = None, times: int = 1) -> list:
    """A worker-stacked shape as one device holds it (dim 0 over ``share``
    devices of the worker axes), ``dim`` grown ``times``-fold (a gather)."""
    out = [int(d) for d in shape]
    if out:
        out[0] //= share
    if dim is not None:
        out[dim] *= times
    return out


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


def exchange(payload: Tree, kind: str, num_workers: int, span: Span) -> Tree:
    """The mean over the M stacked workers. Output: the dense mean
    contribution; sparse flat payloads come back as flat vectors, which the
    transport reshapes against its template. ``span``: the worker axes the
    stacked workers stand for, over which the wire log counts the
    all-gather each device would make."""
    if _ROWS is not None:
        for x in _tensors(payload):
            _log("all-gather", "exchange", span, x, x.shape, False)
    return _mean(payload, kind, num_workers)


def _mean(payload: Tree, kind: str, num_workers: int) -> Tree:
    """The exchange's mean of the M workers' payloads, dispatched on the
    compressor kind; logs nothing."""
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

def _gather(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``(M/P, ...)`` slice -> ``(M, ...)`` in rank order, on
    this rank's device, bit for bit; staged to the host on gloo."""
    raw = x.contiguous().reshape(-1).view(torch.uint8)
    if group.backend == "gloo":
        raw = raw.cpu()
    parts = [torch.empty_like(raw) for _ in range(group.world_size)]
    dist.all_gather(parts, raw, group=group.pg)
    full = torch.cat(parts).to(x.device)
    return full.view(x.dtype).reshape((x.shape[0] * group.world_size,) + tuple(x.shape[1:]))


def _group_span(group) -> Span:
    return Span(group.axes, group.world_size)


def gather_workers(x: torch.Tensor, group, span: Optional[Span] = None) -> torch.Tensor:
    """Every rank's ``(M/P, ...)`` slice -> ``(M, ...)`` in rank order, on
    this rank's device, bit for bit, logged over the group's axes. On gloo
    the bytes are staged to the host before the collective.
    ``group=None``: this process holds every worker already; ``x`` comes
    back as it is, logged over ``span``, the axes the stacked workers
    stand for."""
    if group is None:
        if _ROWS is not None:
            _log("all-gather", "gather_workers", span, x, x.shape, False)
        return x
    if _ROWS is not None:
        _log("all-gather", "gather_workers", _group_span(group), x,
             _per_device(x.shape, dim=0, times=group.world_size), True)
    return _gather(x, group)


def psum_scalar(x: torch.Tensor, group, span: Optional[Span] = None) -> torch.Tensor:
    """Sum of a float32 scalar over the ranks (the counterpart of the JAX
    package's ``psum_scalar``); small integer counts are exact in fp32.
    ``group=None``: ``x`` is the sum already (logged over ``span``, as
    ``gather_workers``)."""
    if group is None:
        if _ROWS is not None:
            _log("all-reduce", "psum_scalar", span, x, [], False)
        return x
    t = x.detach().to(torch.float32).reshape(1).clone()
    if _ROWS is not None:
        _log("all-reduce", "psum_scalar", _group_span(group), t, [], True)
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
    span = _group_span(group)
    caller = _caller() if _ROWS is not None else None

    def one(x):   # values and indices alike
        if _ROWS is not None:
            _log("all-gather", "exchange", span, x,
                 _per_device(x.shape, dim=0, times=group.world_size), True, caller)
        return _gather(x, group)

    return _mean(tree_map(one, payload), kind, num_workers)


# ---------------------------------------------------------------------------
# over the axes of a device mesh
# ---------------------------------------------------------------------------

def gather_dim(x: torch.Tensor, dim: int, group, op: str = "gather_dim") -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in rank order, bit for
    bit (host-staged on gloo, as ``gather_workers``); ``op`` names the row
    in the wire log."""
    if group.world_size == 1:
        return x
    if _ROWS is not None:
        _log("all-gather", op, _group_span(group), x,
             _per_device(x.shape, dim=dim, times=group.world_size), True)
    full = _gather(x.movedim(dim, 0).contiguous(), group)
    return full.movedim(0, dim).contiguous()


def gather_spec(x: torch.Tensor, entries: tuple, groups: dict,
                op: str = "gather_dim") -> torch.Tensor:
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
                x = gather_dim(x, d, groups[name], op)
    return x


def mean_over(x: torch.Tensor, group) -> torch.Tensor:
    """The mean of every rank's ``x``, summed in rank order (an all-gather,
    not a ring all-reduce, so it is the same sum on every rank and in a
    one-process run)."""
    if group.world_size == 1:
        return x
    if _ROWS is not None:
        _log("all-gather", "mean_over", _group_span(group), x,
             [group.world_size] + list(x.shape), True)
    return _ordered_mean(_gather(x.unsqueeze(0), group), group.world_size)


def _rank_sum(parts: torch.Tensor, dtype) -> torch.Tensor:
    """``parts[0] + parts[1] + ...`` over the leading rank dim, in fp32,
    cast to ``dtype``."""
    acc = parts[0].float()
    for r in range(1, parts.shape[0]):
        acc = acc + parts[r].float()
    return acc.to(dtype)


def sum_over(x: torch.Tensor, group, op: str = "sum_over") -> torch.Tensor:
    """The sum of every rank's ``x`` in rank order, in fp32, cast back to
    ``x``'s dtype: the same bits on every rank."""
    if group.world_size == 1:
        return x
    if _ROWS is not None:
        _log("all-gather", op, _group_span(group), x,
             [group.world_size] + list(x.shape), True)
    return _rank_sum(_gather(x.unsqueeze(0), group), x.dtype)


def reduce_scatter(x: torch.Tensor, dim: int, group,
                   op: str = "reduce_scatter") -> torch.Tensor:
    """This rank's slice along ``dim`` of the sum of every rank's ``x``:
    ``sum_over(x)`` narrowed to slice ``group.rank`` of ``group.world_size``,
    bit for bit (the same rank-order fp32 sum), while each rank receives
    only its slice from the others (an all-to-all, host-staged on gloo)."""
    n = group.world_size
    if n == 1:
        return x
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split over {n} ranks")
    if _ROWS is not None:
        _log("reduce-scatter", op, _group_span(group), x,
             [s // n if i == dim else s for i, s in enumerate(x.shape)], True)
    moved = x.movedim(dim, 0)
    chunk = (moved.shape[0] // n,) + tuple(moved.shape[1:])
    raw = moved.contiguous().reshape(-1).view(torch.uint8)
    if group.backend == "gloo":
        raw = raw.cpu()
    recv = torch.empty_like(raw)
    dist.all_to_all_single(recv, raw, group=group.pg)
    parts = recv.to(x.device).view(x.dtype).reshape((n,) + chunk)
    return _rank_sum(parts, x.dtype).movedim(0, dim).contiguous()


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
    compute the same bits.

    ``name``: the mesh axis, for the wire log. ``share``: the devices of
    the worker axes whose workers this process's worker-stacked tensors
    hold (the worker axes' size on a ``StackedMesh``, 1 on a rank), so the
    log counts what one device moves."""

    def __init__(self, size: int, group=None, name: str = "stage", share: int = 1):
        if group is not None and group.world_size != size:
            raise ValueError(f"a stage axis of {size} over a group of {group.world_size}")
        self.size = size
        self.group = group
        self.name = name
        self.share = share

    @property
    def stages(self) -> tuple:
        """The stages this process runs, in order."""
        return tuple(range(self.size)) if self.group is None else (self.group.rank,)

    @property
    def span(self) -> Span:
        return Span((self.name,), self.size)

    def _log(self, kind: str, op: str, x: torch.Tensor, dim: Optional[int] = None) -> None:
        """A row for one stage's ``x`` (``dim``: gathered along it)."""
        _log(kind, op, self.span, x,
             _per_device(x.shape, self.share, dim, self.size if dim is not None else 1),
             self.group is not None)

    def _gather(self, xs: list) -> list:
        """Every stage's tensor, stage order."""
        if self.group is None:
            return list(xs)
        (x,) = xs
        return list(_gather(x.unsqueeze(0), self.group).unbind(0))

    def _all(self, xs: list) -> list:
        """Every stage's tensor, stage order (one list per call): an
        all-gather over the stages."""
        if _ROWS is not None:
            _log("all-gather", "stage_all", self.span, xs[0],
                 [self.size] + _per_device(xs[0].shape, self.share), self.group is not None)
        return self._gather(xs)


def ring_shift_parts(parts: list, stage: StageAxis, shift: int = 1) -> list:
    """Per-stage tuples of wire parts -> what each local stage receives:
    stage s gets stage (s - shift) mod S's parts, in the same order."""
    n = len(parts[0])
    if _ROWS is not None:
        for x in parts[0]:
            stage._log("permute", "ring_shift_parts", x)
    every = [stage._gather([p[i] for p in parts]) for i in range(n)]
    return [tuple(every[i][(s - shift) % stage.size] for i in range(n))
            for s in stage.stages]


def ring_broadcast_parts(parts: list, stage: StageAxis, src: int) -> list:
    """Stage ``src``'s wire parts on every local stage (the JAX package's
    psum of the parts masked to ``src``: adding exact zeros, a copy; the
    wire log counts that all-reduce)."""
    if _ROWS is not None:
        for x in parts[0]:
            stage._log("all-reduce", "ring_broadcast_parts", x)
    if stage.group is None:
        return [parts[src]] * stage.size
    n = len(parts[0])
    return [tuple(stage._gather([p[i] for p in parts])[src] for i in range(n))]


def psum_tree(trees: list, stage: StageAxis) -> Tree:
    """The sum over all stages of per-stage trees, in stage order; the same
    tree on every local stage."""
    flat = [tree_flatten(t) for t in trees]
    treedef = flat[0][1]
    out = []
    for i in range(treedef.num_leaves):
        if _ROWS is not None:
            stage._log("all-reduce", "psum_tree", flat[0][0][i])
        every = stage._gather([f[0][i] for f in flat])
        acc = every[0]
        for x in every[1:]:
            acc = acc + x
        out.append(acc)
    return tree_unflatten(treedef, out)


def stage_combine_leaf(xs: list, stage: StageAxis, is_trunk: bool, dim: int) -> torch.Tensor:
    """Per-stage gradient leaves -> the full leaf: a trunk slice
    concatenates over stages along its layer ``dim``; any other leaf is a
    stage-0-masked partial and sums to its value."""
    if _ROWS is not None:
        if is_trunk:
            stage._log("all-gather", "stage_combine_leaf", xs[0], dim)
        else:
            stage._log("all-reduce", "stage_combine_leaf", xs[0])
    every = stage._gather(xs)
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
    d-sized trunk gather). On a ``StackedMesh`` ``ps`` may also be
    ``[the full payload]`` (the stacked encode saw the full trunk): it
    comes back as it is, logged as the gather each stage's device makes."""
    if stage.group is None and len(ps) == 1 < stage.size:
        (p,) = ps
        if _ROWS is not None:
            for x in (p.values, p.indices):
                stage._log("all-gather", "gather_block_payload", x)
        return p
    if _ROWS is not None:
        for x in (ps[0].values, ps[0].indices):
            stage._log("all-gather", "gather_block_payload", x, dim)
    vals = torch.cat(stage._gather([p.values for p in ps]), dim=dim)
    idxs = torch.cat(stage._gather([p.indices for p in ps]), dim=dim)
    p = ps[0]
    b = list(p.blocked_shape)
    o = list(p.orig_shape)
    b[0] *= stage.size
    o[0] *= stage.size
    return BlockPayload(vals, idxs, tuple(b), tuple(o))
