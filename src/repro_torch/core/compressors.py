"""Gradient compressors: the paper's top-k + error feedback, and identity.

Port of ``repro/core/compressors.py``. A compressor is a pair (init,
compress) packaged as a ``CompressorDef``. Compression receives the
already gamma-folded quantity ``g = lr * grad`` and owns the error-feedback
state; it returns the payload and the *candidate* state, which the caller
(``sasg.py``) commits or discards with the send/skip decision.

Every tree handed to ``compress`` carries a leading worker dim: leaf
``(M, *shape)``. The block geometry and the per-leaf k come from the
per-worker ``shape``, exactly as in the JAX package, and the M workers are
compressed in one pass (with the fused kernel: one grouped launch for all
the leaves of an encode).

Implemented here: ``identity`` (SGD / LASG) and ``topk_ef`` (Sparse /
SASG) in the ``per_shard``, ``per_tensor`` and ``flat`` layouts.
``topk_ef``'s per-shard layout defaults to the fused EF + top-k kernel
(``repro_torch.kernels.topk_ef``: CUDA on the card, its plain version on
the CPU), with the unfused blocked operator kept as
``topk_impl="reference"``; under the default fp32 ``error_dtype`` both are
bit-identical. ``randk``, ``qsgd``, ``signsgd_ef`` and ``terngrad`` are not
ported yet.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, NamedTuple, Tuple

import torch

from . import topk as topk_lib
from .types import (
    Tree,
    dtype_of,
    tree_flatten_with_paths,
    tree_leaves,
    tree_map,
    tree_unflatten,
    tree_zeros_like,
)

_LEGACY_IMPLS = {"sharded": "reference", "block": "reference"}
_NOT_PORTED = ("randk", "qsgd", "signsgd_ef", "terngrad")


@dataclass(frozen=True)
class CompressorConfig:
    name: str = "topk_ef"
    k_ratio: float = 0.01          # paper uses top-1% (k = 0.01 d)
    # Layer-wise adaptive sparsification (Shi et al., 2019): ordered
    # (path_substring, ratio) pairs matched against the leaf's "/"-joined
    # tree path; first match wins, k_ratio is the fallback. The flat layout
    # has a single global bucket and ignores the schedule.
    k_ratio_per_layer: Tuple[Tuple[str, float], ...] = ()
    # block granularity: the per-shard impls select kb=ceil(k_ratio*block)
    # per block via iterative argmax; the flat impls use bigger blocks.
    block_size: int = 256
    # Wire layout — owned by the transport (repro_torch.comm.transport):
    #   "per_shard":  blocked view of each leaf in its natural layout
    #   "per_tensor": flat vector per leaf
    #   "flat":       one concatenated global vector (paper-exact T_k)
    #   "" (auto):    per_shard unless a legacy topk_impl spelling implies
    #                 otherwise. An explicit layout always wins.
    layout: str = ""
    # Selection impl within the layout:
    #   per_shard:         "kernel" (fused EF + top-k, the default)
    #                      | "reference" (unfused blocked_topk)
    #   per_tensor / flat: "exact" | "reference" (block-local) | "kernel"
    # Legacy aliases still resolve: "sharded" -> per_shard + reference,
    # "block" -> reference; "exact"/"block" imply the per_tensor layout.
    topk_impl: str = "kernel"
    bucket: str = "per_tensor"     # legacy: "global" -> layout="flat"
    wire_dtype: str = "float32"    # payload value dtype on the wire
    error_dtype: str = "float32"   # EF accumulator dtype
    # block-LOCAL indices fit in u8/u16 for block_size <= 256/65536
    compact_indices: bool = False

    def resolved_layout(self) -> str:
        """Wire layout with the legacy bucket/topk_impl spellings folded in."""
        if self.bucket == "global":
            return "flat"
        if self.layout:
            return self.layout
        if self.topk_impl in ("exact", "block"):
            return "per_tensor"
        return "per_shard"

    def resolved_impl(self) -> str:
        return _LEGACY_IMPLS.get(self.topk_impl, self.topk_impl)

    def ratio_for(self, path: str = "") -> float:
        if path != "__global__":
            for pattern, ratio in self.k_ratio_per_layer:
                if pattern and pattern in path:
                    return float(ratio)
        return self.k_ratio

    def leaf_k(self, size: int, path: str = "") -> int:
        # Python's round (banker's rounding), as in the JAX package
        return max(1, int(round(self.ratio_for(path) * size)))


class CompressorDef(NamedTuple):
    name: str
    kind: str    # "sparse" | "dense"
    layout: str  # realized payload layout: "per_shard" | "per_tensor" | "flat" | "dense"
    init: Callable[[Tree], Tree]
    # compress(state, g_tree) -> (payload_tree, candidate_state); the
    # randomized compressors of the JAX package add a PRNG key when ported
    compress: Callable[[Tree, Tree], tuple]


def index_dtype(cfg: CompressorConfig, block_c: int) -> torch.dtype:
    """On-wire index dtype of a payload bucket: block-LOCAL indices fit in
    u8/u16 when compact_indices is on (the payload cast and the wire
    accounting both read this)."""
    if not cfg.compact_indices:
        return torch.int32
    if block_c <= 256:
        return torch.uint8
    if block_c <= 65536:
        return torch.uint16
    return torch.int32


def _blocked_kb(cfg: CompressorConfig, shape: tuple, blocked: tuple,
                path: str = "") -> int:
    size = 1
    for d in shape:
        size *= d
    k = cfg.leaf_k(size, path)
    nblocks = size // blocked[-1]
    return min(max(1, -(-k // nblocks)), blocked[-1])


def leaf_geometry(cfg: CompressorConfig, shape: tuple, path: str = "") -> tuple:
    """(blocked view, kb) of one per-worker leaf in the per_shard layout."""
    blocked = topk_lib.blocked_view_shape(tuple(shape), None, cfg.block_size)
    return blocked, _blocked_kb(cfg, tuple(shape), blocked, path)


def _flat_topk(cfg: CompressorConfig, flat: torch.Tensor, k: int) -> topk_lib.SparsePayload:
    impl = cfg.resolved_impl()
    if impl == "exact":
        return topk_lib.exact_topk(flat, k)
    if impl == "reference":
        return topk_lib.block_topk(flat, k, cfg.block_size)
    if impl == "kernel":
        from repro_torch.kernels.topk_ef import ops as kops

        return kops.block_topk(flat, k, cfg.block_size)
    raise ValueError(f"unknown topk_impl {cfg.topk_impl!r}")


# ---------------------------------------------------------------------------
# identity (SGD / LASG transport)
# ---------------------------------------------------------------------------

def make_identity(cfg: CompressorConfig) -> CompressorDef:
    wdtype = dtype_of(cfg.wire_dtype)

    def init(tree):
        return ()

    def compress(state, g):
        # values cross the transport at wire_dtype (round-tripped back to the
        # compute dtype); a no-op for the default float32 wire
        payload = tree_map(
            lambda x: x.to(wdtype).to(x.dtype) if x.dtype != wdtype else x, g
        )
        return payload, state

    return CompressorDef("identity", "dense", "dense", init, compress)


# ---------------------------------------------------------------------------
# top-k with error feedback (the paper's operator)
# ---------------------------------------------------------------------------

def make_topk_ef(cfg: CompressorConfig) -> CompressorDef:
    edtype = dtype_of(cfg.error_dtype)
    wdtype = dtype_of(cfg.wire_dtype)
    layout = cfg.resolved_layout()
    impl = cfg.resolved_impl()
    if layout == "per_shard" and impl not in ("kernel", "reference"):
        raise ValueError(
            f"per_shard layout supports topk_impl 'kernel' | 'reference', "
            f"got {cfg.topk_impl!r}"
        )

    def init(tree):
        return tree_zeros_like(tree, dtype=edtype)

    def _block_payload(vals, idxs, blocked, shape):
        return topk_lib.BlockPayload(
            vals.to(wdtype), idxs.to(index_dtype(cfg, blocked[-1])), blocked, shape,
        )

    def _leaf_sharded(e, x, path):
        """Blocked view ``(M, *lead, nbc, bc)`` of the worker-stacked leaf;
        selection and EF residual are block-local (the unfused reference)."""
        m, shape = x.shape[0], tuple(x.shape[1:])
        blocked, kb = leaf_geometry(cfg, shape, path)
        g = (x.to(edtype) + e).reshape((m,) + blocked)
        p = topk_lib.blocked_topk(g, kb)
        new_e = (g - topk_lib._scatter_last(
            p.values.to(edtype), p.indices, blocked[-1]
        )).reshape(e.shape)
        return _block_payload(p.values, p.indices, blocked, shape), new_e

    def _sharded_kernel(err_leaves, leaves, paths):
        """The fused kernel on every leaf's blocked view in ONE grouped call
        (one launch per encode on the card)."""
        from repro_torch.kernels.topk_ef import ops as kops

        geo = [leaf_geometry(cfg, tuple(x.shape[1:]), p) for x, p in zip(leaves, paths)]
        outs = kops.blocked_topk_ef_group(
            [x.to(edtype).reshape(x.shape[:1] + b) for x, (b, _) in zip(leaves, geo)],
            [e.reshape(e.shape[:1] + b) for e, (b, _) in zip(err_leaves, geo)],
            [kb for _, kb in geo],
        )
        return [
            (_block_payload(v, i, b, tuple(x.shape[1:])), ne.to(edtype).reshape(e.shape))
            for (v, i, ne), (b, _), x, e in zip(outs, geo, leaves, err_leaves)
        ]

    def _leaf_flat(e, x, path):
        m = x.shape[0]
        k = cfg.leaf_k(x[0].numel(), path)
        if impl == "kernel":
            from repro_torch.kernels.topk_ef import ops as kops

            p, new_e = kops.topk_ef(
                x.reshape(m, -1).to(edtype), e.reshape(m, -1), 1.0, k,
                cfg.block_size,
            )
            new_e = new_e.to(edtype).reshape(e.shape)
        else:
            flat = x.reshape(m, -1).to(edtype) + e.reshape(m, -1)
            p = _flat_topk(cfg, flat, k)
            new_e = (flat - p.densify()).reshape(e.shape)
        return topk_lib.SparsePayload(p.values.to(wdtype), p.indices, p.size), new_e

    def compress(err, g):
        paths, leaves, treedef = tree_flatten_with_paths(g)
        err_leaves = tree_leaves(err)
        if layout == "per_shard" and impl == "kernel":
            pairs = _sharded_kernel(err_leaves, leaves, paths)
        else:
            leaf = _leaf_sharded if layout == "per_shard" else _leaf_flat
            pairs = [leaf(e, x, p) for e, x, p in zip(err_leaves, leaves, paths)]
        payload = tree_unflatten(treedef, [p for p, _ in pairs])
        new_err = tree_unflatten(treedef, [e for _, e in pairs])
        return payload, new_err

    return CompressorDef("topk_ef", "sparse", layout, init, compress)


def build_compressor(cfg: CompressorConfig) -> CompressorDef:
    if cfg.name == "identity":
        return make_identity(cfg)
    if cfg.name == "topk_ef":
        return make_topk_ef(cfg)
    if cfg.name in _NOT_PORTED:
        raise NotImplementedError(
            f"compressor {cfg.name!r} is not ported to repro_torch yet "
            "(queued in ROADMAP.md); have 'identity', 'topk_ef'"
        )
    raise ValueError(f"unknown compressor {cfg.name!r}")
