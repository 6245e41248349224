"""Gradient compressors: the paper's top-k + error feedback, and baselines.

Port of ``repro/core/compressors.py``. A compressor is a pair (init,
compress) packaged as a ``CompressorDef``. Compression receives the
already gamma-folded quantity ``g = lr * grad`` (the raw gradient with
``fold_lr=False``) and owns the error-feedback state; it returns the
payload and the *candidate* state, which the caller (``sasg.py``) commits
or discards with the send/skip decision.

Every tree handed to ``compress`` carries a leading worker dim: leaf
``(M, *shape)``. The block geometry and the per-leaf k come from the
per-worker ``shape``, exactly as in the JAX package, and the M workers are
compressed in one pass (with the fused kernel: one grouped launch for all
the leaves of an encode). Per-leaf scalars (qsgd's norm, signsgd_ef's
scale, terngrad's max) are taken per worker.

  identity     distributed SGD / LASG transport
  topk_ef      the paper's T_k with error feedback [Sparse / SASG], in the
               ``per_shard``, ``per_tensor`` and ``flat`` layouts
  randk        unbiased random-k (Wangni et al., 2018); realizes the
               ``per_tensor`` layout (``flat`` when asked for)
  qsgd         QSGD stochastic quantization (Alistarh et al., 2017)
  signsgd_ef   1-bit sign with error feedback (Karimireddy et al., 2019)
  terngrad     ternary stochastic quantization (Wen et al., 2017)

``compress(state, g, gen)`` takes an explicit ``torch.Generator`` on the
leaves' device, or a ``WorkerSlice`` of one; the deterministic compressors
ignore it. Each randomized leaf function is split in two: the draws come
from ``gen`` (``torch.rand`` of the worker-stacked leaf, ``topk.uniform``),
and ``_qsgd_leaf`` / ``_terngrad_leaf`` / ``topk.random_k_at`` quantize
given the draws. A process holding workers [start, start + n) of M draws for all
M workers and keeps its slice (``WorkerSlice``), so it draws what the
stacked run draws for them. JAX's threefry and torch's
Philox give other numbers, so parity with the JAX package holds per leaf
given the same draws, not per seed.

``topk_ef``'s per-shard layout defaults to the fused EF + top-k kernel
(``repro_torch.kernels.topk_ef``: CUDA on the card, its plain version on
the CPU), with the unfused blocked operator kept as
``topk_impl="reference"``; under the default fp32 ``error_dtype`` both are
bit-identical. The baselines are plain PyTorch ops, as they are ``jnp``
ops outside any kernel in the JAX package.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, NamedTuple, Optional, Tuple

import torch

from . import topk as topk_lib
from .topk import uniform
from .types import (
    Tree,
    dtype_of,
    tree_flatten,
    tree_flatten_with_paths,
    tree_leaves,
    tree_map,
    tree_unflatten,
    tree_zeros_like,
)

_LEGACY_IMPLS = {"sharded": "reference", "block": "reference"}


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
    qsgd_levels: int = 256         # QSGD quantization levels (8-bit default)

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
    # realized payload layout: "per_shard" | "per_tensor" | "flat" | "dense"
    # (randk has no blocked impl, so per_shard configs realize per_tensor)
    layout: str
    init: Callable[[Tree], Tree]
    # compress(state, g_tree, gen) -> (payload_tree, candidate_state)
    compress: Callable[[Tree, Tree, Optional[torch.Generator]], tuple]


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


def _sharded_axis_of(spec, shape, axis_sizes) -> tuple:
    """(axis index or None, axis size) of the last mesh-sharded leaf dim."""
    from repro_torch.dist.sharding import shard_counts

    counts = shard_counts(spec, axis_sizes, len(shape))[:len(shape)]
    split = [i for i, c in enumerate(counts) if c > 1]
    return (split[-1], counts[split[-1]]) if split else (None, 1)


def _spec_leaves(leaf_specs, template) -> list:
    """Per-leaf specs aligned with ``template``'s flatten order (all None
    when no specs were given). Raises when the spec tree and the leaves
    differ in length: the geometry, and so the wire format, follows the
    specs."""
    from repro_torch.dist.sharding import is_spec

    n = len(template) if isinstance(template, list) else len(tree_leaves(template))
    if leaf_specs is None:
        return [None] * n
    specs = tree_leaves(leaf_specs, is_leaf=lambda s: s is None or is_spec(s))
    if len(specs) != n:
        raise ValueError(f"{len(specs)} leaf specs for {n} leaves")
    return specs


def _blocked_kb(cfg: CompressorConfig, shape: tuple, blocked: tuple,
                path: str = "") -> int:
    size = 1
    for d in shape:
        size *= d
    k = cfg.leaf_k(size, path)
    nblocks = size // blocked[-1]
    return min(max(1, -(-k // nblocks)), blocked[-1])


def leaf_geometry(cfg: CompressorConfig, shape: tuple, path: str = "", spec=None,
                  axis_sizes=None, local: bool = False, full0: int = 0) -> tuple:
    """(blocked view, kb) of one per-worker leaf in the per_shard layout.

    The view is aligned to the leaf's sharded axis (``spec`` over
    ``axis_sizes``), so blocks never straddle a TP shard. ``shape`` is the
    leaf's global shape; with ``local=True`` it is this rank's shard, and
    the view returned is that shard's part of the global view (each
    sharded dim of the view divided by its shard count), with the global
    leaf's kb. ``full0``: the leaf arrives stage-sliced on its leading
    (layer) dim, whose full size this is (``stage_dims``); the view and kb
    are the full leaf's (as-if-full: k = ratio * size could round otherwise
    on a slice), the view's leading dim the slice's."""
    from repro_torch.dist.sharding import shard_counts

    sizes = axis_sizes or {}
    shape = tuple(shape)
    counts = shard_counts(spec, sizes, len(shape))[:len(shape)]
    full = tuple(d * c for d, c in zip(shape, counts)) if local else shape
    if full0:
        full = (full0,) + full[1:]
    ax, axsz = _sharded_axis_of(spec, full, sizes)
    blocked = topk_lib.blocked_view_shape(full, ax, cfg.block_size, axsz)
    kb = _blocked_kb(cfg, full, blocked, path)
    if local:
        blocked = tuple(b // counts[i] if i < len(counts) and i < len(blocked) - 1 else b
                        for i, b in enumerate(blocked))
    if full0:
        if len(blocked) < 3:
            raise ValueError(f"{path}: a stage-sliced leaf needs its layer dim ahead of the "
                             f"blocks; its view is {blocked}")
        blocked = (shape[0],) + tuple(blocked[1:])
    return blocked, kb


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

    def compress(state, g, gen=None):
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

def make_topk_ef(cfg: CompressorConfig, leaf_specs=None, axis_sizes=None,
                 local: bool = False, stage_dims=None) -> CompressorDef:
    """``leaf_specs`` / ``axis_sizes``: the per-shard block geometry follows
    each leaf's TP sharding (``leaf_geometry``); ``local``: the leaves
    handed to ``compress`` are this rank's shards of them. ``stage_dims``:
    ``{leaf path: full leading dim}`` of the leaves that arrive stage-sliced
    (the pipeline's payload-gather path): their kb is the full leaf's, so
    every stage selects what the flat run selects on its rows."""
    stage_dims = stage_dims or {}
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

    def geometry(x, path, spec):
        return leaf_geometry(cfg, tuple(x.shape[1:]), path, spec, axis_sizes, local,
                             stage_dims.get(path, 0))

    def _leaf_sharded(e, x, path, spec):
        """Blocked view ``(M, *lead, nbc, bc)`` of the worker-stacked leaf;
        selection and EF residual are block-local (the unfused reference)."""
        m, shape = x.shape[0], tuple(x.shape[1:])
        blocked, kb = geometry(x, path, spec)
        g = (x.to(edtype) + e).reshape((m,) + blocked)
        p = topk_lib.blocked_topk(g, kb)
        new_e = (g - topk_lib._scatter_last(
            p.values.to(edtype), p.indices, blocked[-1]
        )).reshape(e.shape)
        return _block_payload(p.values, p.indices, blocked, shape), new_e

    def _sharded_kernel(err_leaves, leaves, paths, specs):
        """The fused kernel on every leaf's blocked view in ONE grouped call
        (one launch per encode on the card)."""
        from repro_torch.kernels.topk_ef import ops as kops

        geo = [geometry(x, p, s) for x, p, s in zip(leaves, paths, specs)]
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

    def compress(err, g, gen=None):
        paths, leaves, treedef = tree_flatten_with_paths(g)
        err_leaves = tree_leaves(err)
        # the specs shape the per-shard geometry only (the flat layout's one
        # leaf has no spec of its own)
        specs = _spec_leaves(leaf_specs, leaves) if layout == "per_shard" else None
        if layout == "per_shard" and impl == "kernel":
            pairs = _sharded_kernel(err_leaves, leaves, paths, specs)
        elif layout == "per_shard":
            pairs = [_leaf_sharded(e, x, p, s)
                     for e, x, p, s in zip(err_leaves, leaves, paths, specs)]
        else:
            pairs = [_leaf_flat(e, x, p) for e, x, p in zip(err_leaves, leaves, paths)]
        payload = tree_unflatten(treedef, [p for p, _ in pairs])
        new_err = tree_unflatten(treedef, [e for _, e in pairs])
        return payload, new_err

    return CompressorDef("topk_ef", "sparse", layout, init, compress)


# ---------------------------------------------------------------------------
# the baselines' shared pieces
# ---------------------------------------------------------------------------

def _need_gen(name: str, gen) -> None:
    if gen is None:
        raise ValueError(f"{name} draws random numbers: pass a torch.Generator")


def _per_worker(s: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``(M,)`` -> ``(M, 1, ..., 1)``: a per-worker scalar that broadcasts
    against the worker-stacked leaf ``like``."""
    return s.reshape((s.shape[0],) + (1,) * (like.dim() - 1))


# ---------------------------------------------------------------------------
# random-k (unbiased, no EF needed)
# ---------------------------------------------------------------------------

def make_randk(cfg: CompressorConfig) -> CompressorDef:
    wdtype = dtype_of(cfg.wire_dtype)

    def init(tree):
        return ()

    def compress(state, g, gen=None):
        _need_gen("randk", gen)
        paths, leaves, treedef = tree_flatten_with_paths(g)

        def leaf(x, path):
            m = x.shape[0]
            sp = topk_lib.random_k(x.reshape(m, -1).float(), cfg.leaf_k(x[0].numel(), path),
                                   gen)
            # values cross the wire at wire_dtype, like topk_ef
            return topk_lib.SparsePayload(sp.values.to(wdtype), sp.indices, sp.size)

        return tree_unflatten(treedef, [leaf(x, p) for x, p in zip(leaves, paths)]), state

    layout = "flat" if cfg.resolved_layout() == "flat" else "per_tensor"
    return CompressorDef("randk", "sparse", layout, init, compress)


# ---------------------------------------------------------------------------
# QSGD stochastic quantization (dense transport of dequantized values)
# ---------------------------------------------------------------------------

def _qsgd_leaf(x: torch.Tensor, u: torch.Tensor, levels: int) -> torch.Tensor:
    """QSGD of a worker-stacked leaf given its uniforms ``u`` (same shape):
    |x| / ||x|| * s rounded down or up to a level, up with probability equal
    to the remainder, times ||x|| / s, per worker."""
    x32 = x.float()
    nrm = _per_worker(torch.linalg.vector_norm(x32.reshape(x.shape[0], -1), dim=-1), x) + 1e-12
    level = x32.abs() / nrm * levels
    low = torch.floor(level)
    q = (low + (u < level - low)) / levels
    return (torch.sign(x32) * nrm * q).to(x.dtype)


def make_qsgd(cfg: CompressorConfig) -> CompressorDef:
    def init(tree):
        return ()

    def compress(state, g, gen=None):
        _need_gen("qsgd", gen)
        return tree_map(
            lambda x: _qsgd_leaf(x, uniform(x, gen), cfg.qsgd_levels), g,
        ), state

    return CompressorDef("qsgd", "dense", "dense", init, compress)


# ---------------------------------------------------------------------------
# signSGD with error feedback (1 bit + per-leaf scale)
# ---------------------------------------------------------------------------

def make_signsgd_ef(cfg: CompressorConfig) -> CompressorDef:
    edtype = dtype_of(cfg.error_dtype)

    def init(tree):
        return tree_zeros_like(tree, dtype=edtype)

    def leaf(e, x):
        corr = x.to(edtype) + e
        scale = _per_worker(corr.abs().reshape(corr.shape[0], -1).mean(-1), corr)
        q = torch.sign(corr) * scale
        return q.to(x.dtype), corr - q

    def compress(err, g, gen=None):
        g_leaves, treedef = tree_flatten(g)
        pairs = [leaf(e, x) for e, x in zip(tree_leaves(err), g_leaves)]
        return (tree_unflatten(treedef, [p for p, _ in pairs]),
                tree_unflatten(treedef, [e for _, e in pairs]))

    return CompressorDef("signsgd_ef", "dense", "dense", init, compress)


# ---------------------------------------------------------------------------
# TernGrad ternary stochastic quantization
# ---------------------------------------------------------------------------

def _terngrad_leaf(x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """TernGrad of a worker-stacked leaf given its uniforms ``u``: each
    coordinate becomes sign(x) * s with probability |x| / s, else 0, where
    s = max |x| per worker."""
    x32 = x.float()
    s = _per_worker(x32.abs().reshape(x.shape[0], -1).amax(-1), x) + 1e-12
    t = torch.sign(x32) * (u < x32.abs() / s)
    return (s * t).to(x.dtype)


def make_terngrad(cfg: CompressorConfig) -> CompressorDef:
    def init(tree):
        return ()

    def compress(state, g, gen=None):
        _need_gen("terngrad", gen)
        return tree_map(
            lambda x: _terngrad_leaf(x, uniform(x, gen)), g,
        ), state

    return CompressorDef("terngrad", "dense", "dense", init, compress)


_REGISTRY = {
    "identity": make_identity,
    "topk_ef": make_topk_ef,
    "randk": make_randk,
    "qsgd": make_qsgd,
    "signsgd_ef": make_signsgd_ef,
    "terngrad": make_terngrad,
}
RANDOMIZED = ("randk", "qsgd", "terngrad")


def build_compressor(cfg: CompressorConfig, leaf_specs=None, axis_sizes=None,
                     local: bool = False, stage_dims=None) -> CompressorDef:
    if cfg.name not in _REGISTRY:
        raise ValueError(f"unknown compressor {cfg.name!r}; have {sorted(_REGISTRY)}")
    if cfg.name == "topk_ef":
        return make_topk_ef(cfg, leaf_specs=leaf_specs, axis_sizes=axis_sizes, local=local,
                            stage_dims=stage_dims)
    return _REGISTRY[cfg.name](cfg)
