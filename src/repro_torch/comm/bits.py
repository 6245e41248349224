"""Centralized bit accounting for the transport (paper Tables 1-3 inputs).

Port of ``repro/comm/bits.py``. Two views per upload, computed from the
per-worker parameter template:

- ``paper``: 32 bits per transmitted element (k for sparse compressors, d
  for dense ones), plus a 32-bit scalar per bucket where the method ships
  one (qsgd's norm, signsgd_ef's scale, terngrad's max);
- ``wire``: value bits at ``wire_dtype`` width plus index bits for sparse
  payloads (compact block-local u8/u16 when enabled), and the per-bucket
  scalars at ``wire_dtype`` width too.

Accounting is per bucket: one per leaf in the per-tensor and per-shard
layouts, one global bucket in the flat layout.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Tuple

import torch

from repro_torch.core.types import Tree, ceil_div, dtype_of, tree_flatten_with_paths, tree_size


def dtype_bits(dtype) -> int:
    return torch.empty((), dtype=dtype_of(dtype)).element_size() * 8


@dataclass(frozen=True)
class BucketBits:
    """One payload bucket's static accounting."""

    bucket: str          # "/"-joined leaf path ("__global__" for flat)
    size: int            # dense element count covered by the bucket
    k: int               # elements transmitted per upload (== size for dense)
    bits_paper: float
    bits_wire: float

    @property
    def ratio(self) -> float:
        return self.k / max(self.size, 1)


@dataclass(frozen=True)
class BitsReport:
    buckets: Tuple[BucketBits, ...]

    @property
    def paper(self) -> float:
        return float(sum(b.bits_paper for b in self.buckets))

    @property
    def wire(self) -> float:
        return float(sum(b.bits_wire for b in self.buckets))

    def rows(self) -> List[dict]:
        return [
            {
                "bucket": b.bucket, "size": b.size, "k": b.k,
                "k_ratio": b.ratio, "bits_paper": b.bits_paper,
                "bits_wire": b.bits_wire,
            }
            for b in self.buckets
        ]


def bucket_wire_bits(report: BitsReport, prefixes) -> float:
    """Wire bits of the buckets under the given "/"-joined path prefixes
    (the pipeline's k-sized stage gather moves the trunk buckets' bits)."""

    def match(b: BucketBits) -> bool:
        return any(b.bucket == p or b.bucket.startswith(p + "/") for p in prefixes)

    return float(sum(b.bits_wire for b in report.buckets if match(b)))


def _leaves_with_paths(template: Tree):
    paths, leaves, _ = tree_flatten_with_paths(template)
    return list(zip(paths, leaves))


def _block_k(size: int, k: int, block: int) -> int:
    """Realized k under per-block rounding (blocked / flat-kernel impls)."""
    nb = ceil_div(size, block)
    return nb * min(max(1, ceil_div(k, nb)), block)


def _topk_buckets(cfg, template: Tree, leaf_specs=None, axis_sizes=None) -> List[BucketBits]:
    from repro_torch.core.compressors import _spec_leaves, index_dtype, leaf_geometry

    layout = cfg.resolved_layout()
    impl = cfg.resolved_impl()
    vb = dtype_bits(cfg.wire_dtype)

    if layout == "flat":
        d = tree_size(template)
        k = cfg.leaf_k(d)
        if impl in ("reference", "kernel"):
            k = _block_k(d, k, cfg.block_size)
        k = min(k, d)
        return [BucketBits("__global__", d, k, 32.0 * k, float(vb + 32) * k)]

    out = []
    specs = _spec_leaves(leaf_specs, template)
    for (path, x), spec in zip(_leaves_with_paths(template), specs):
        size = x.numel()
        if layout == "per_tensor":
            k = cfg.leaf_k(size, path)
            if impl in ("reference", "kernel"):
                k = _block_k(size, k, cfg.block_size)
            k = min(k, size)
            out.append(BucketBits(path, size, k, 32.0 * k, float(vb + 32) * k))
            continue
        # per_shard: the blocked view aligned to the leaf's sharded axis
        blocked, kb = leaf_geometry(cfg, tuple(x.shape), path, spec, axis_sizes)
        k_eff = (size // blocked[-1]) * kb
        ib = dtype_bits(index_dtype(cfg, blocked[-1]))
        out.append(BucketBits(path, size, k_eff, 32.0 * k_eff, float(vb + ib) * k_eff))
    return out


def activation_payload_bits(
    wire_dtype: str, k_ratio: float, block_size: int, elems: int,
) -> float:
    """Static wire bits of ONE encoded activation block (``transport.
    ActivationLayout`` emits exactly this payload). ``k_ratio <= 0`` is the
    dense cast: every element at ``wire_dtype`` width. Otherwise the block
    top-k payload: ``ceil(elems / block)`` blocks of ``kb = ceil(block *
    k_ratio)`` values each, values at ``wire_dtype`` plus block-local
    indices (u8 for blocks <= 256, u16 up to 65536, as the gradient
    payloads)."""
    vb = dtype_bits(wire_dtype)
    if k_ratio <= 0.0:
        return float(vb * elems)
    nb = ceil_div(elems, block_size)
    kb = min(max(1, math.ceil(block_size * k_ratio)), block_size)
    ib = 8 if block_size <= 256 else (16 if block_size <= 65536 else 32)
    return float(nb * kb * (vb + ib))


def kv_cache_bits_per_token(
    n_paged_layers: int,
    n_kv_heads: int,
    head_dim: int,
    cache_dtype: str,
    pos_bits: int = 32,
) -> float:
    """Stored bits per token slot across the serve engine's paged KV pools:
    a K row and a V row (n_kv_heads * head_dim values each) at the cache
    codec's wire dtype, plus one ``pos_bits`` position entry, per paged
    (global-attention) layer. The one formula shared by the paged cache
    (``serve.paged_cache``) and the engine's ``cache_stats``."""
    vb = dtype_bits(cache_dtype)
    return float(n_paged_layers) * (2.0 * n_kv_heads * head_dim * vb + pos_bits)


def account(cfg, template: Tree, leaf_specs=None, axis_sizes=None) -> BitsReport:
    """Static per-upload accounting for one compressor config; ``template``
    is the per-worker parameter tree (no worker dim, global shapes), and
    ``leaf_specs`` / ``axis_sizes`` give the TP geometry of per_shard
    top-k."""
    name = cfg.name
    vb = dtype_bits(cfg.wire_dtype)
    if name == "topk_ef":
        return BitsReport(tuple(_topk_buckets(cfg, template, leaf_specs, axis_sizes)))
    if name == "randk":
        if cfg.resolved_layout() == "flat":
            d = tree_size(template)
            k = min(cfg.leaf_k(d), d)
            return BitsReport((BucketBits("__global__", d, k, 32.0 * k, float(vb + 32) * k),))
        buckets = []
        for path, x in _leaves_with_paths(template):
            k = min(cfg.leaf_k(x.numel(), path), x.numel())
            buckets.append(BucketBits(path, x.numel(), k, 32.0 * k, float(vb + 32) * k))
        return BitsReport(tuple(buckets))
    # dense transports: one bucket per leaf, every coordinate transmitted;
    # (per-coordinate paper, per-coordinate wire, scalar paper, scalar wire)
    rates = {
        # identity ships raw values at the configured value dtype
        "identity": (32.0, float(vb), 0.0, 0.0),
        # log2(s) + 1 bits per coordinate and one norm per bucket
        "qsgd": (math.log2(cfg.qsgd_levels) + 1.0, math.log2(cfg.qsgd_levels) + 1.0,
                 32.0, float(vb)),
        "signsgd_ef": (1.0, 1.0, 32.0, float(vb)),
        "terngrad": (math.log2(3.0), math.log2(3.0), 32.0, float(vb)),
    }
    if name not in rates:
        raise ValueError(f"unknown compressor {name!r}")
    paper, wire, s_paper, s_wire = rates[name]
    return BitsReport(tuple(
        BucketBits(path, x.numel(), x.numel(), paper * x.numel() + s_paper,
                   wire * x.numel() + s_wire)
        for path, x in _leaves_with_paths(template)
    ))
