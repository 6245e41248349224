"""The ``Transport`` seam: payload layout x compression x exchange.

Port of the worker-axis part of ``repro/comm/transport.py``:

    init_state(params_w)    -> compressor (EF) state for the wire layout
    zero_payload(params)    -> payload-shaped zeros (the empty stale cache)
    encode(state, g, gen)   -> (payload, candidate_state)
    exchange(payload)       -> mean contribution over the M workers
    densify(contrib, like)  -> full-shape fp32 update tree
    gather(g)               -> the stage-combined gradient (pipeline)
    gather_payload(p)       -> trunk payload slices gathered over stages
    diff_sq_norm(a, b)      -> the stage-aware norm of the selection rule
    bits_paper / bits_wire / bits_report   (comm/bits.py)

Trees handed to ``init_state`` / ``encode`` carry the leading worker dim
(``(M, *shape)``); ``densify`` and the bit accounting take the per-worker
template (the params tree). Dense payloads (identity and the quantizers
qsgd, signsgd_ef, terngrad) are worker-stacked dense trees; sparse ones
are ``BlockPayload`` leaves (topk_ef per shard) or ``SparsePayload`` flat
vectors (per tensor, or one ``__global__`` bucket in the flat layout).
randk realizes ``per_tensor`` (or ``flat``) whatever layout is configured.
``ActivationLayout`` is the pipeline ring's wire format (a dtype cast or
a blocked top-k through the block_topk kernel) and the paged KV cache's
codec.

Under pipeline stages the transport composes them as the JAX one does:
on the payload path (block-local per_shard topk_ef, a model whose
prepare / finish reads are disjoint) it gets a ``StageInfo``, encodes the
stage-local trunk slice with the as-if-full per-block k, gathers only the
k-sized payload over the stages, and gives the rule a stage-summed norm;
every other compressor or layout takes the dense stage combine
(``grad_combine``, ``dist.pipeline.build_stage_combine``).

On a mesh with a model axis, per_shard top-k takes its block geometry
from the params' partition specs (``leaf_specs``, ``axis_sizes``), as
the JAX transport does. On a device mesh (``local``) the trees handed in
are each rank's shards of the leaves, and ``encodes_local_shards`` picks
the path: per_shard top-k and identity encode the shard, whose payload is
that shard's slice of the global payload; every other compressor
(``whole_leaf``) gathers each leaf's shards over the split axes
(``shard_groups``, d-sized by design), encodes the whole leaf with the
same draws on every rank of those axes, so the payloads are the same
there, exchanges them over the worker axis as ever, and each rank keeps
its slice of the update and of any param-shaped EF buffer. Bits stay
those of the global leaves.

With a ``WorkerGroup`` (``comm.process_group``) the M workers are spread
over P processes (on a device mesh: the ranks of the worker axis):
``num_workers`` stays the global M, this process holds
``local_workers`` = M/P of them (``worker_start`` is the first), its
state and payloads are stacked over those, and ``exchange`` all-gathers
the slices before the ordered mean (``collectives.gathered_exchange``).
The wire log (``collectives.wire_log``) counts the exchange over the
group's axes, or on a stacked mesh over ``worker_axes``, the mesh axes
the stacked workers span.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, NamedTuple, Optional

import torch

from repro_torch.core.compressors import (
    RANDOMIZED,
    CompressorConfig,
    CompressorDef,
    build_compressor,
)
from repro_torch.core.topk import BlockPayload, WorkerSlice, _scatter_last
from repro_torch.core.types import (
    Tree,
    ceil_div,
    dtype_of,
    pad_to_multiple,
    tree_cast,
    tree_flatten,
    tree_flatten_concat,
    tree_flatten_with_paths,
    tree_leaves,
    tree_map,
    tree_unflatten,
    tree_unflatten_concat,
    tree_where,
)

from . import bits as bits_lib
from . import collectives


@dataclass(frozen=True)
class ActivationLayout:
    """Wire layout of an activation: a dtype cast, or a blocked top-k.

    Port of the JAX transport's layout, owned here so ``encode`` /
    ``decode`` and the bit accounting (``payload_bits`` ==
    ``bits.activation_payload_bits``) cannot drift apart. The pipeline's
    1F1B ring moves its carries in it (``dist/pipeline.py``); the paged KV
    cache quantizes on write through it (``serve.paged_cache.
    cache_layout``, ``k_ratio=0``).

    - default (fp32, ``k_ratio=0``): identity, ``encode`` returns the
      values unchanged;
    - ``wire_dtype="bfloat16"``: cast on the wire; ``decode`` casts back;
    - ``k_ratio > 0``: the flattened activation padded to whole blocks of
      ``block_size``, and the ``kb = ceil(block_size * k_ratio)`` largest
      ``|x|`` of each block kept (descending, the lowest index first among
      equals: ``lax.top_k``'s order), values at ``wire_dtype`` + block-local
      u8 / u16 / int32 indices. On a CUDA tensor the selection is the
      block_topk kernel, all of an encode's blocks in one launch; on the
      CPU its plain version (``kernels/block_topk/ops.py``). Lossy: the
      backward runs against the decoded forward. Never differentiated.

    ``batch_dims`` leading dims (the stacked workers) are encoded each on
    its own, as the JAX package encodes one device's activation: folded
    into the rows of the one launch.
    """

    wire_dtype: str = "float32"
    k_ratio: float = 0.0
    block_size: int = 256

    @property
    def is_identity(self) -> bool:
        return self.k_ratio <= 0.0 and dtype_of(self.wire_dtype) == torch.float32

    def kb(self) -> int:
        return min(max(1, math.ceil(self.block_size * self.k_ratio)), self.block_size)

    def index_dtype(self) -> torch.dtype:
        if self.block_size <= 256:
            return torch.uint8
        if self.block_size <= 65536:
            return torch.uint16
        return torch.int32

    def payload_bits(self, elems: int) -> float:
        """Wire bits of one encoded activation of ``elems`` elements."""
        return bits_lib.activation_payload_bits(
            self.wire_dtype, self.k_ratio, self.block_size, elems)

    def encode(self, x: torch.Tensor, batch_dims: int = 0) -> tuple:
        """Activation -> tuple of wire tensors."""
        if self.k_ratio <= 0.0:
            return (x.to(dtype_of(self.wire_dtype)),)
        from repro_torch.kernels.block_topk.ops import block_topk_rows

        lead = tuple(x.shape[:batch_dims])
        flat = x.detach().reshape(lead + (-1,)).float()
        nb = ceil_div(flat.shape[-1], self.block_size)
        flat = pad_to_multiple(flat, self.block_size, axis=-1)
        vals, idx = block_topk_rows(flat.reshape(-1, self.block_size).contiguous(), self.kb())
        shape = lead + (nb, self.kb())
        return (vals.reshape(shape).to(dtype_of(self.wire_dtype)),
                idx.reshape(shape).to(self.index_dtype()))

    def zero_parts(self, shape: tuple, device, batch_dims: int = 0) -> tuple:
        """The wire parts of nothing (all values 0) for an activation of
        ``shape``: what a stage with nothing to send puts on the ring."""
        if self.k_ratio <= 0.0:
            return (torch.zeros(shape, dtype=dtype_of(self.wire_dtype), device=device),)
        lead = tuple(shape[:batch_dims])
        pshape = lead + (ceil_div(math.prod(shape[batch_dims:]), self.block_size), self.kb())
        return (torch.zeros(pshape, dtype=dtype_of(self.wire_dtype), device=device),
                torch.zeros(pshape, dtype=self.index_dtype(), device=device))

    def decode(self, parts: tuple, shape: tuple, dtype=torch.float32,
               batch_dims: int = 0) -> torch.Tensor:
        """Wire parts -> dense activation of ``shape`` (the batch dims
        included)."""
        if self.k_ratio <= 0.0:
            return parts[0].to(dtype_of(dtype))
        vals, idxs = parts
        dense = _scatter_last(vals.float(), idxs.long(), self.block_size)
        lead = tuple(shape[:batch_dims])
        n = math.prod(shape[batch_dims:])
        return dense.reshape(lead + (-1,))[..., :n].reshape(shape).to(dtype_of(dtype))


class StageInfo(NamedTuple):
    """Pipeline-stage context of the payload-gather path.

    ``stage``: the ``collectives.StageAxis``; ``trunk_prefixes``:
    "/"-joined params-tree prefixes of the stage-sharded trunk leaves;
    ``trunk_dims``: each trunk leaf's path -> its FULL leading (layer) dim,
    so the compressor takes the as-if-full per-block k on a stage slice."""

    stage: Any
    trunk_prefixes: tuple
    trunk_dims: dict


def supports_stage_payload(cfg: CompressorConfig) -> bool:
    """True iff the compressor can encode a stage-local trunk slice whose
    gathered payload is bit-identical to compressing the full leaf: the
    block-local per_shard top-k (blocks never straddle the stage-slice
    boundary). Every other layout or compressor sees cross-slice state and
    takes the dense stage-combine fallback."""
    return cfg.name == "topk_ef" and cfg.resolved_layout() == "per_shard"


def is_trunk_path(path: str, prefixes) -> bool:
    return any(path == p or path.startswith(p + "/") for p in prefixes)


def encodes_local_shards(cfg: CompressorConfig) -> bool:
    """True iff encoding each TP shard of a leaf gives exactly that shard's
    part of the full leaf's payload: block-local top-k in the per_shard
    layout (blocks never straddle a shard) and the elementwise identity.
    Every other compressor sees the whole leaf (global or per-leaf top-k
    support, per-leaf norms, draws over the full leaf): on a device mesh
    its transport gathers the leaf first (``Transport.whole_leaf``)."""
    if cfg.name == "identity":
        return True
    return cfg.name == "topk_ef" and cfg.resolved_layout() == "per_shard"


class Transport:
    """One built wire transport for a compressor over M stacked workers.

    ``leaf_specs`` / ``axis_sizes``: the params' partition specs and the
    mesh's axis sizes, from which per_shard top-k takes its block geometry
    (blocks never straddle a TP shard). ``local``: the trees handed to
    ``init_state`` / ``encode`` / ``zero_payload`` / ``densify`` are this
    rank's TP shards of the leaves (a device mesh, whose ``mesh`` and
    ``shard_groups`` a whole-leaf compressor gathers and slices over);
    the bit accounting stays that of the global leaves."""

    def __init__(self, cfg: CompressorConfig, num_workers: int, group=None,
                 leaf_specs=None, axis_sizes=None, local: bool = False,
                 grad_combine: Optional[Callable[[Tree], Tree]] = None,
                 stage: Optional[StageInfo] = None, worker_axes: tuple = ("data",),
                 shard_groups: Optional[dict] = None, mesh=None):
        if stage is not None and not supports_stage_payload(cfg):
            raise ValueError(
                f"compressor {cfg.name!r} (layout {cfg.resolved_layout()!r}) cannot take "
                "the payload-level stage gather path; use the dense grad_combine fallback")
        if grad_combine is not None and stage is not None:
            raise ValueError("grad_combine (dense fallback) and stage (payload gather) are "
                             "mutually exclusive stage compositions")
        self.whole_leaf = local and not encodes_local_shards(cfg)
        if self.whole_leaf and (not shard_groups or mesh is None or leaf_specs is None):
            raise ValueError(f"compressor {cfg.name!r} encodes whole leaves: on local shards "
                             "it needs the leaf specs, the mesh and the split axes' groups")
        self.shard_groups = dict(shard_groups or {})
        self.mesh = mesh
        self.cfg = cfg
        self.num_workers = num_workers
        self.group = group
        self.leaf_specs = leaf_specs
        self.axis_sizes = dict(axis_sizes or {})
        self.grad_combine = grad_combine
        self.stage = stage
        self.worker_start, self.local_workers = (
            group.workers(num_workers) if group is not None else (0, num_workers))
        self.compressor: CompressorDef = build_compressor(
            cfg, leaf_specs=leaf_specs, axis_sizes=self.axis_sizes,
            local=local and not self.whole_leaf,
            stage_dims=stage.trunk_dims if stage is not None else None)
        self.kind = self.compressor.kind      # "sparse" | "dense"
        self.layout = self.compressor.layout
        # the worker axes and their devices, as the wire log counts the
        # exchange: the group's own, else the stacked mesh's devices along
        # ``worker_axes`` (one worker a device without a mesh)
        if group is not None:
            self.span = collectives.Span(group.axes, group.world_size)
        else:
            axes = tuple(worker_axes)
            self.span = collectives.Span(axes, math.prod(self.axis_sizes[a] for a in axes)
                                         if all(a in self.axis_sizes for a in axes)
                                         else num_workers)

    # -- whole leaves from local shards (``whole_leaf``) ---------------------

    def _by_spec(self, f, tree: Tree) -> Tree:
        """``f(leaf, spec)`` over a params-shaped tree and the leaf specs."""
        leaves, treedef = tree_flatten(tree)
        specs = _spec_leaves_of(self.leaf_specs)
        return tree_unflatten(treedef, [f(x, sp) for x, sp in zip(leaves, specs)])

    def _whole(self, tree: Tree, lead: int) -> Tree:
        """The full leaves of this rank's shards (``lead`` leading dims)."""
        return self._by_spec(lambda x, sp: collectives.gather_spec(
            x, (None,) * lead + tuple(sp), self.shard_groups, "whole_leaf"), tree)

    def _mine(self, tree: Tree, lead: int) -> Tree:
        """This rank's shards of full leaves."""
        from repro_torch.dist.sharding import P, take_local

        return self._by_spec(lambda x, sp: take_local(
            x, P(*((None,) * lead + tuple(sp))), self.mesh), tree)

    def _full_like(self, tree: Tree, lead: int, device=None) -> Tree:
        """Zeros (or, on ``device="meta"``, shapes) of the full leaves."""
        from repro_torch.dist.sharding import shard_counts

        def one(x, sp):
            counts = (1,) * lead + shard_counts(sp, self.axis_sizes, x.dim() - lead)
            shape = tuple(d * c for d, c in zip(x.shape, counts))
            return torch.zeros(shape, dtype=x.dtype, device=device or x.device)

        return self._by_spec(one, tree)

    def _state_is_leafwise(self, state: Tree) -> bool:
        """The compressor state has one buffer per leaf (EF of per_tensor
        top-k, signsgd_ef), split like the leaves; the flat layout's one
        vector is whole on every rank."""
        return self.layout != "flat" and bool(tree_leaves(state))

    # -- layout -------------------------------------------------------------

    def _lay_out(self, tree: Tree) -> Tree:
        """The flat layout views the workers' trees as one global vector per
        worker; other layouts keep the tree and let the compressor view each
        leaf."""
        if self.layout == "flat":
            return {"__global__": tree_flatten_concat(tree, batch_dims=1)}
        return tree

    # -- stage composition ---------------------------------------------------

    def gather(self, g: Tree) -> Tree:
        """The tree the exchange runs on from a pipelined gradient: the
        dense stage combine where one is threaded in (``grad_combine``, the
        fallback on a device mesh), else ``g`` itself (no stage axis, a
        stacked mesh whose pipeline returns the full tree, or the payload
        path, where gradients stay stage-local)."""
        return g if self.grad_combine is None else self.grad_combine(g)

    def _trunk(self, path: str) -> bool:
        return self.stage is not None and is_trunk_path(path, self.stage.trunk_prefixes)

    def gather_payload(self, payload: Tree) -> Tree:
        """The k-sized trunk payload slices gathered over the stage axis
        into the full-stack payload (the replacement of the d-sized trunk
        gather); non-trunk payloads were computed from replicated
        gradients and pass through. Identity without a stage, and on a
        stacked mesh, whose encode saw the full trunk already (there the
        wire log still counts the gather each stage's device makes)."""
        if self.stage is None:
            return payload
        paths, leaves, treedef = tree_flatten_with_paths(payload,
                                                         is_leaf=collectives._is_payload)
        out = [collectives.gather_block_payload([p], self.stage.stage, 1)
               if isinstance(p, BlockPayload) and self._trunk(path) else p
               for path, p in zip(paths, leaves)]
        return tree_unflatten(treedef, out)

    def diff_sq_norm(self, a: Tree, b: Tree) -> torch.Tensor:
        """Per-worker ||a - b||^2 of worker-stacked trees for the selection
        rule, stage-aware: each stage's trunk slice is summed on its own
        and the stages' sums added in stage order (a scalar per worker
        crosses the stage axis); non-trunk leaves are summed locally. Every
        stage, and the stacked mesh, computes the same bits."""
        st = self.stage.stage
        paths, la, _ = tree_flatten_with_paths(a)
        lb = tree_leaves(b)
        m = la[0].shape[0]
        per_stage = [torch.zeros((m,), dtype=torch.float32, device=la[0].device)
                     for _ in st.stages]
        local = torch.zeros_like(per_stage[0])

        def sq(d):
            return d.square().reshape(m, -1).sum(-1)

        for path, xa, xb in zip(paths, la, lb):
            d = xa.float() - xb.float()
            if not self._trunk(path):
                local = local + sq(d)
            elif st.group is not None:
                per_stage[0] = per_stage[0] + sq(d)
            else:
                n = d.shape[1] // st.size
                for s in st.stages:
                    per_stage[s] = per_stage[s] + sq(d[:, s * n:(s + 1) * n].contiguous())
        every = st._all(per_stage)
        trunk = every[0]
        for x in every[1:]:
            trunk = trunk + x
        return local + trunk

    # -- encode / exchange / densify ----------------------------------------

    def init_state(self, tree: Tree) -> Tree:
        """Compressor state (error-feedback buffers) for worker-stacked
        leaves."""
        if self.whole_leaf and self.layout == "flat":
            tree = self._full_like(tree, 1)
        return self.compressor.init(self._lay_out(tree))

    def draws(self, gen: torch.Generator):
        """The generator as this process's workers see it: whole in a
        stacked run, else a ``WorkerSlice`` of the M workers' draws."""
        if self.group is None:
            return gen
        return WorkerSlice(gen, self.num_workers, self.worker_start)

    def zero_payload(self, params: Tree) -> Tree:
        """Payload-shaped zeros for this process's workers: compress a zero
        tree. Values come out 0 and, by the lowest-index tie-break, indices
        0..kb-1 of every block (randk: indices drawn from a generator seeded
        0, as the JAX package draws them from ``PRNGKey(0)``). Only the
        randomized compressors' zero payloads differ from worker to worker;
        the others' are encoded for one worker and copied to the rest, so
        no worker-sized zero tree is made."""
        n = self.local_workers if self.cfg.name in RANDOMIZED else 1
        zeros = tree_map(
            lambda p: torch.zeros((n,) + tuple(p.shape), dtype=torch.float32, device=p.device),
            params,
        )
        gen = torch.Generator(device=tree_leaves(params)[0].device).manual_seed(0)
        if self.whole_leaf:   # the full leaves' payload, the same on every rank
            zeros = self._lay_out(self._full_like(zeros, 1))
            payload = self.compressor.compress(self.compressor.init(zeros), zeros,
                                               self.draws(gen))[0]
        else:
            payload = self.encode(self.init_state(zeros), zeros, self.draws(gen))[0]
        if n == self.local_workers:
            return payload
        return tree_map(lambda x: x.expand((self.local_workers,) + tuple(x.shape[1:]))
                        .contiguous(), payload)

    def encode(self, state: Tree, g: Tree, gen=None) -> tuple:
        """Lay out the worker-stacked quantity tree and compress it; the
        randomized compressors draw from ``gen``. Returns (payload,
        candidate_state). ``whole_leaf``: the leaves (and a leafwise state)
        are gathered first, and the state's new buffers sliced back."""
        if not self.whole_leaf:
            return self.compressor.compress(state, self._lay_out(g), gen)
        leafwise = self._state_is_leafwise(state)
        if leafwise:
            state = self._whole(state, 1)
        payload, state = self.compressor.compress(state, self._lay_out(self._whole(g, 1)), gen)
        return payload, (self._mine(state, 1) if leafwise else state)

    def exchange(self, payload: Tree) -> Tree:
        """Mean over the M workers: dense mean for dense payloads, ordered
        scatter-add mean for sparse ones; across the group's processes
        after an all-gather of their slices."""
        if self.group is not None:
            return collectives.gathered_exchange(payload, self.kind, self.num_workers,
                                                 self.group)
        return collectives.exchange(payload, self.kind, self.num_workers, self.span)

    def densify(self, contrib: Tree, like: Tree) -> Tree:
        """Reshape the exchanged mean against ``like``, the per-worker
        gradient template (the params tree). Sparse layouts come back
        fp32; dense contributions pass through. ``whole_leaf``: ``like``
        is this rank's shards; the full mean is densified and this rank
        keeps its slice."""
        if self.whole_leaf:
            full = self._densify(contrib, self._full_like(like, 0, "meta"))
            return self._mine(full, 0)
        return self._densify(contrib, like)

    def _densify(self, contrib: Tree, like: Tree) -> Tree:
        if self.kind == "dense":
            return contrib
        if self.layout == "flat":
            return tree_cast(tree_unflatten_concat(contrib["__global__"], like),
                             torch.float32)
        if self.layout == "per_shard":
            return tree_cast(contrib, torch.float32)
        return collectives.reshape_like(contrib, tree_cast(like, torch.float32))

    # -- bit accounting ------------------------------------------------------

    def bits_report(self, template: Tree) -> bits_lib.BitsReport:
        return bits_lib.account(self.cfg, template, self.leaf_specs, self.axis_sizes)

    def bits_paper(self, template: Tree) -> float:
        return self.bits_report(template).paper

    def bits_wire(self, template: Tree) -> float:
        return self.bits_report(template).wire


def _spec_leaves_of(specs) -> list:
    from repro_torch.dist.sharding import is_spec

    return tree_leaves(specs, is_leaf=lambda x: x is None or is_spec(x))


def build_transport(cfg: CompressorConfig, num_workers: int, *args, **kwargs) -> Transport:
    """``Transport(cfg, num_workers, ...)``."""
    return Transport(cfg, num_workers, *args, **kwargs)
