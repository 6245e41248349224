"""The ``Transport`` seam: payload layout x compression x exchange.

Port of the worker-axis part of ``repro/comm/transport.py``:

    init_state(params_w)    -> compressor (EF) state for the wire layout
    zero_payload(params)    -> payload-shaped zeros (the empty stale cache)
    encode(state, g, gen)   -> (payload, candidate_state)
    exchange(payload)       -> mean contribution over the M workers
    densify(contrib, like)  -> full-shape fp32 update tree
    bits_paper / bits_wire / bits_report   (comm/bits.py)

Trees handed to ``init_state`` / ``encode`` carry the leading worker dim
(``(M, *shape)``); ``densify`` and the bit accounting take the per-worker
template (the params tree). Dense payloads (identity and the quantizers
qsgd, signsgd_ef, terngrad) are worker-stacked dense trees; sparse ones
are ``BlockPayload`` leaves (topk_ef per shard) or ``SparsePayload`` flat
vectors (per tensor, or one ``__global__`` bucket in the flat layout).
randk realizes ``per_tensor`` (or ``flat``) whatever layout is configured.
``ActivationLayout`` is ported as far as the paged KV cache's codec uses it
(a dtype cast); the pipeline stage seam, the ring and the layout's blocked
top-k encode come with ROADMAP item 9.

On a mesh with a model axis, per_shard top-k takes its block geometry
from the params' partition specs (``leaf_specs``, ``axis_sizes``), as
the JAX transport does; on a device mesh each rank encodes its own TP
shard of every leaf (``local``), whose payload is that shard's slice of
the global payload.

With a ``WorkerGroup`` (``comm.process_group``) the M workers are spread
over P processes (on a device mesh: the ranks of the worker axis):
``num_workers`` stays the global M, this process holds
``local_workers`` = M/P of them (``worker_start`` is the first), its
state and payloads are stacked over those, and ``exchange`` all-gathers
the slices before the ordered mean (``collectives.gathered_exchange``).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.core.compressors import (
    CompressorConfig,
    CompressorDef,
    build_compressor,
)
from repro_torch.core.topk import WorkerSlice
from repro_torch.core.types import (
    Tree,
    dtype_of,
    tree_cast,
    tree_flatten_concat,
    tree_leaves,
    tree_map,
    tree_unflatten_concat,
)

from . import bits as bits_lib
from . import collectives


@dataclass(frozen=True)
class ActivationLayout:
    """Wire layout of an activation: a dtype cast, or a blocked top-k.

    Port of the JAX transport's layout, owned here so ``encode`` /
    ``decode`` and the bit accounting (``payload_bits`` ==
    ``bits.activation_payload_bits``) cannot drift apart. The paged KV
    cache quantizes on write through it (``serve.paged_cache.
    cache_layout``, ``k_ratio=0``).

    - default (fp32, ``k_ratio=0``): identity, ``encode`` returns the
      values unchanged;
    - ``wire_dtype="bfloat16"``: cast on the wire; ``decode`` casts back;
    - ``k_ratio > 0``: blocked top-k over the flattened activation, values
      at ``wire_dtype`` + block-local u8/u16 indices. Its bits are priced
      here; its encode is the pipeline ring's (ROADMAP item 9) and raises.
    """

    wire_dtype: str = "float32"
    k_ratio: float = 0.0
    block_size: int = 256

    @property
    def is_identity(self) -> bool:
        return self.k_ratio <= 0.0 and dtype_of(self.wire_dtype) == torch.float32

    def payload_bits(self, elems: int) -> float:
        """Wire bits of one encoded activation of ``elems`` elements."""
        return bits_lib.activation_payload_bits(
            self.wire_dtype, self.k_ratio, self.block_size, elems)

    def _sparse(self) -> NotImplementedError:
        return NotImplementedError(
            "ActivationLayout with k_ratio > 0 encodes the pipeline ring's "
            "activations, which are not ported to repro_torch yet (ROADMAP item 9)")

    def encode(self, x: torch.Tensor) -> tuple:
        """Activation -> tuple of wire tensors."""
        if self.k_ratio > 0.0:
            raise self._sparse()
        return (x.to(dtype_of(self.wire_dtype)),)

    def decode(self, parts: tuple, shape: tuple, dtype=torch.float32) -> torch.Tensor:
        """Wire parts -> dense activation of ``shape``."""
        if self.k_ratio > 0.0:
            raise self._sparse()
        return parts[0].to(dtype_of(dtype))


def encodes_local_shards(cfg: CompressorConfig) -> bool:
    """True iff encoding each TP shard of a leaf gives exactly that shard's
    part of the full leaf's payload: block-local top-k in the per_shard
    layout (blocks never straddle a shard) and the elementwise identity.
    Every other compressor sees the whole leaf (global or per-leaf top-k
    support, per-leaf norms, draws over the full leaf)."""
    if cfg.name == "identity":
        return True
    return cfg.name == "topk_ef" and cfg.resolved_layout() == "per_shard"


class Transport:
    """One built wire transport for a compressor over M stacked workers.

    ``leaf_specs`` / ``axis_sizes``: the params' partition specs and the
    mesh's axis sizes, from which per_shard top-k takes its block geometry
    (blocks never straddle a TP shard). ``local``: the trees handed to
    ``init_state`` / ``encode`` / ``zero_payload`` are this rank's TP
    shards of the leaves (a device mesh); the bit accounting stays that of
    the global leaves."""

    def __init__(self, cfg: CompressorConfig, num_workers: int, group=None,
                 leaf_specs=None, axis_sizes=None, local: bool = False):
        if local and not encodes_local_shards(cfg):
            raise NotImplementedError(
                f"compressor {cfg.name!r} (layout {cfg.resolved_layout()!r}) needs the "
                "whole leaf: on a device mesh with a model axis only topk_ef per_shard "
                "and identity encode TP shards (ROADMAP item 7b)")
        self.cfg = cfg
        self.num_workers = num_workers
        self.group = group
        self.leaf_specs = leaf_specs
        self.axis_sizes = dict(axis_sizes or {})
        self.worker_start, self.local_workers = (
            group.workers(num_workers) if group is not None else (0, num_workers))
        self.compressor: CompressorDef = build_compressor(
            cfg, leaf_specs=leaf_specs, axis_sizes=self.axis_sizes, local=local)
        self.kind = self.compressor.kind      # "sparse" | "dense"
        self.layout = self.compressor.layout

    # -- layout -------------------------------------------------------------

    def _lay_out(self, tree: Tree) -> Tree:
        """The flat layout views the workers' trees as one global vector per
        worker; other layouts keep the tree and let the compressor view each
        leaf."""
        if self.layout == "flat":
            return {"__global__": tree_flatten_concat(tree, batch_dims=1)}
        return tree

    # -- encode / exchange / densify ----------------------------------------

    def init_state(self, tree: Tree) -> Tree:
        """Compressor state (error-feedback buffers) for worker-stacked
        leaves."""
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
        0, as the JAX package draws them from ``PRNGKey(0)``)."""
        zeros = tree_map(
            lambda p: torch.zeros((self.local_workers,) + tuple(p.shape),
                                  dtype=torch.float32, device=p.device),
            params,
        )
        gen = torch.Generator(device=tree_leaves(params)[0].device).manual_seed(0)
        payload, _ = self.encode(self.init_state(zeros), zeros, self.draws(gen))
        return payload

    def encode(self, state: Tree, g: Tree, gen=None) -> tuple:
        """Lay out the worker-stacked quantity tree and compress it; the
        randomized compressors draw from ``gen``. Returns (payload,
        candidate_state)."""
        return self.compressor.compress(state, self._lay_out(g), gen)

    def exchange(self, payload: Tree) -> Tree:
        """Mean over the M workers: dense mean for dense payloads, ordered
        scatter-add mean for sparse ones; across the group's processes
        after an all-gather of their slices."""
        if self.group is not None:
            return collectives.gathered_exchange(payload, self.kind, self.num_workers,
                                                 self.group)
        return collectives.exchange(payload, self.kind, self.num_workers)

    def densify(self, contrib: Tree, like: Tree) -> Tree:
        """Reshape the exchanged mean against ``like``, the per-worker
        gradient template (the params tree). Sparse layouts come back
        fp32; dense contributions pass through."""
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


def build_transport(cfg: CompressorConfig, num_workers: int, group=None,
                    leaf_specs=None, axis_sizes=None, local: bool = False) -> Transport:
    return Transport(cfg, num_workers, group, leaf_specs, axis_sizes, local)
