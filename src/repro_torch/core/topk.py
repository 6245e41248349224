"""Top-k sparsification operators (paper Definition 1).

Port of ``repro/core/topk.py``. Every operator works on the LAST dim and
keeps any leading dims as batch dims, so the M stacked workers of the
exchange are compressed in one call.

- ``exact_topk``:   global top-k by |x| over the last dim (the paper's T_k).
- ``block_topk``:   top ``ceil(k/nblocks)`` of each fixed-size block, the
                    padded tail masked to ``-inf`` so it is never selected.
- ``blocked_topk``: top-kb per row of an already blocked view by iterative
                    masked argmax with a lowest-index tie-break — bit for
                    bit the algorithm of the fused EF + top-k kernel.
- ``random_k``:     unbiased random-k, values scaled by d/k (the randk
                    baseline); ``random_k_at`` takes the chosen indices.
- ``uniform``:      the randomized compressors' draws, from a generator or
                    a ``WorkerSlice`` of the M workers' draws.

Payloads are fixed-shape ``(values, indices)`` pairs.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .types import ceil_div, pad_to_multiple, register_node


class SparsePayload:
    """Fixed-size sparse representation of flat vectors.

    values:  (*B, k) float  selected coordinates (zero for padding slots)
    indices: (*B, k) int32  flat positions of the selected coordinates
    size:    int            logical dense length d
    """

    __slots__ = ("values", "indices", "size")

    def __init__(self, values, indices, size: int):
        self.values = values
        self.indices = indices
        self.size = size

    def densify(self) -> torch.Tensor:
        """Scatter-add the payload back to dense ``(*B, size)`` vectors."""
        lead = self.values.shape[:-1]
        out = torch.zeros(lead + (self.size,), dtype=self.values.dtype,
                          device=self.values.device)
        return out.scatter_add_(-1, self.indices.long(), self.values)

    def __repr__(self):
        return f"SparsePayload(k={tuple(self.values.shape)}, d={self.size})"


register_node(
    SparsePayload,
    lambda p: ((p.values, p.indices), p.size),
    lambda size, ch: SparsePayload(ch[0], ch[1], size),
)


def _stable_topk_idx(mag: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest entries of the last dim, lowest index first
    among equal values (``jax.lax.top_k``'s order; ``torch.topk`` leaves
    the order among ties unspecified)."""
    return torch.sort(mag, dim=-1, descending=True, stable=True).indices[..., :k]


def exact_topk(x: torch.Tensor, k: int) -> SparsePayload:
    """Exact top-k by absolute value over the last dim."""
    d = x.shape[-1]
    k = int(min(k, d))
    idx = _stable_topk_idx(x.abs(), k)
    vals = x.gather(-1, idx)
    return SparsePayload(vals, idx.to(torch.int32), d)


def block_topk(x: torch.Tensor, k: int, block_size: int = 2048) -> SparsePayload:
    """Block-local top-k: keep ceil(k/nblocks) per block of ``block_size``.

    Padding tail positions are masked to -inf magnitude so they are never
    selected unless a block is all padding; such slots get value 0 and an
    index clamped to d-1.
    """
    lead = x.shape[:-1]
    d = x.shape[-1]
    xb = pad_to_multiple(x, block_size, axis=-1)
    nb = xb.shape[-1] // block_size
    xb = xb.reshape(lead + (nb, block_size))
    kb = max(1, ceil_div(int(min(k, d)), nb))
    kb = min(kb, block_size)
    pos = torch.arange(nb * block_size, device=x.device).reshape(nb, block_size)
    mag = xb.abs().masked_fill(pos >= d, float("-inf"))
    idx = _stable_topk_idx(mag, kb)                       # (*lead, nb, kb)
    return payload_from_blocks(xb.gather(-1, idx), idx, d, block_size)


def random_k_at(x: torch.Tensor, idx: torch.Tensor) -> SparsePayload:
    """The random-k payload of ``x`` (last dim) at the chosen indices
    ``idx``: the picked values scaled by d/k, so E[densify] == x over a
    uniform choice of indices (Wangni et al., 2018)."""
    d, k = x.shape[-1], idx.shape[-1]
    return SparsePayload(x.gather(-1, idx.long()) * (d / k), idx.to(torch.int32), d)


class WorkerSlice(NamedTuple):
    """The draws of workers [start, start + n) out of ``total``, where n is
    the leading dim of the leaf drawn for."""

    gen: torch.Generator
    total: int
    start: int


def uniform(like: torch.Tensor, gen) -> torch.Tensor:
    """Uniforms in [0, 1) of the worker-stacked ``like``'s shape, on its
    device, from a ``torch.Generator`` or a ``WorkerSlice`` of one (drawn
    for all ``total`` workers, then sliced)."""
    if isinstance(gen, WorkerSlice):
        full = torch.rand((gen.total,) + tuple(like.shape[1:]), generator=gen.gen,
                          device=like.device)
        return full[gen.start:gen.start + like.shape[0]]
    return torch.rand(like.shape, generator=gen, device=like.device)


def random_k(x: torch.Tensor, k: int, gen) -> SparsePayload:
    """Unbiased random-k over the last dim; leading dims are batch dims, each
    row with its own subset. A uniform k-subset without replacement per row:
    ``uniform`` draws of ``x``'s shape from ``gen`` (a ``torch.Generator``
    on ``x``'s device, or a ``WorkerSlice`` of one when the leading dim is a
    slice of the workers), then the positions of each row's k largest
    draws."""
    u = uniform(x, gen)
    return random_k_at(x, torch.topk(u, int(min(k, x.shape[-1])), dim=-1).indices)


def payload_from_blocks(vals: torch.Tensor, idx: torch.Tensor, d: int,
                        block_size: int) -> SparsePayload:
    """Flat payload from per-block picks ``(*lead, nb, kb)`` of a vector of
    length d zero-padded to ``nb`` blocks of ``block_size``: block-local
    indices become flat ones, and picks in the padded tail get value 0 and
    index d-1."""
    nb = vals.shape[-2]
    lead = vals.shape[:-2]
    offs = torch.arange(nb, dtype=torch.int32, device=vals.device) * block_size
    flat_idx = idx.to(torch.int32) + offs[:, None]
    in_range = flat_idx < d
    vals = torch.where(in_range, vals, torch.zeros_like(vals))
    flat_idx = torch.where(in_range, flat_idx, torch.full_like(flat_idx, d - 1))
    return SparsePayload(vals.reshape(lead + (-1,)), flat_idx.reshape(lead + (-1,)), d)


class BlockPayload:
    """Sparse payload over a blocked view of a leaf.

    values / indices: (*B, *lead, nbc, kb) — kb selected per (lead, block);
    indices are LOCAL positions within the block (int32 < block_c). ``*B``
    are batch dims (the worker dim in the exchange) that the shapes below
    do not include.
    blocked_shape: (*lead, nbc, block_c); orig_shape: the leaf shape.
    """

    __slots__ = ("values", "indices", "blocked_shape", "orig_shape")

    def __init__(self, values, indices, blocked_shape, orig_shape):
        self.values = values
        self.indices = indices
        self.blocked_shape = tuple(blocked_shape)
        self.orig_shape = tuple(orig_shape)

    def densify(self) -> torch.Tensor:
        """Scatter back to ``(*B, *orig_shape)``."""
        dense = _scatter_last(self.values, self.indices, self.blocked_shape[-1])
        nbatch = self.values.dim() - len(self.blocked_shape)
        return dense.reshape(tuple(dense.shape[:nbatch]) + self.orig_shape)

    def __repr__(self):
        return (f"BlockPayload(blocked={self.blocked_shape}, "
                f"kb={self.values.shape[-1]})")


register_node(
    BlockPayload,
    lambda p: ((p.values, p.indices), (p.blocked_shape, p.orig_shape)),
    lambda aux, ch: BlockPayload(ch[0], ch[1], aux[0], aux[1]),
)


def _scatter_last(vals: torch.Tensor, idx: torch.Tensor, block_c: int) -> torch.Tensor:
    """Batched scatter-add along the last axis: (*B, kb) -> (*B, block_c).

    Adds into zeros, as the JAX package does (``0 + v``), so a selected
    ``-0.0`` densifies to ``+0.0`` there and here alike."""
    out = torch.zeros(vals.shape[:-1] + (block_c,), dtype=vals.dtype,
                      device=vals.device)
    return out.scatter_add_(-1, idx.long(), vals)


def _largest_divisor_leq(n: int, cap: int) -> int:
    cap = min(cap, n)
    for b in range(cap, 0, -1):
        if n % b == 0:
            return b
    return 1


def blocked_view_shape(shape: tuple, sharded_axis: int | None,
                       target_block: int, axis_size: int = 1) -> tuple:
    """Choose the blocked view (*lead, nbc, block_c) for a leaf.

    - sharded axis is LAST: subdivide it so nbc is a multiple of the axis
      size (blocks never straddle shard boundaries).
    - sharded axis is interior (or None): merge all trailing unsharded dims
      into C and block that; the sharded axis stays a leading batch dim.

    ``core.compressors.leaf_geometry`` takes the sharded axis and its size
    from the leaf's partition spec on the mesh (``dist.sharding``), as the
    JAX package does; ``None`` without a mesh or for an unsharded leaf.
    """
    shape = tuple(shape)
    nd = len(shape)
    if sharded_axis is not None and sharded_axis == nd - 1:
        c_local = shape[-1] // max(axis_size, 1)
        bc = _largest_divisor_leq(c_local, target_block)
        nbc = shape[-1] // bc
        return shape[:-1] + (nbc, bc)
    cut = (sharded_axis + 1) if sharded_axis is not None else max(nd - 1, 1)
    if cut >= nd:
        cut = nd - 1
    c = 1
    for d in shape[cut:]:
        c *= d
    bc = _largest_divisor_leq(c, target_block)
    nbc = c // bc
    return shape[:cut] + (nbc, bc)


def masked_argmax_topk(x: torch.Tensor, kb: int):
    """Top-kb by |x| per row (last dim) by ``kb`` rounds of masked argmax:
    take the max magnitude, then the LOWEST index among the entries equal
    to it, then mask that entry to ``-inf``.

    Returns ``(values, indices, taken)``: the signed fp32 values and int32
    row-local indices ``(*B, kb)`` in selection order, and the ``(*B, bc)``
    bool mask of selected entries. This is the plain version of the CUDA
    kernel's selection (``csrc/topk_ef.cu``), and the algorithm of the JAX
    package's ``blocked_topk`` and Pallas kernels.
    """
    x32 = x.float()
    mag = x32.abs()
    bc = x.shape[-1]
    col = torch.arange(bc, device=x.device)
    vals, idxs = [], []
    for _ in range(kb):
        mx = mag.amax(dim=-1, keepdim=True)
        first = torch.where(mag == mx, col, bc).amin(dim=-1, keepdim=True)
        # a NaN row has no entry equal to its (NaN) max: value 0 at column
        # bc, nothing taken — what the JAX package computes there
        v = x32.gather(-1, first.clamp(max=bc - 1))
        vals.append(torch.where(first < bc, v, torch.zeros_like(v)))
        idxs.append(first)
        mag = mag.masked_fill(col == first, float("-inf"))
    if kb:
        values = torch.cat(vals, dim=-1)
        indices = torch.cat(idxs, dim=-1).to(torch.int32)
    else:
        values = x32.new_zeros(x.shape[:-1] + (0,))
        indices = torch.zeros(x.shape[:-1] + (0,), dtype=torch.int32,
                              device=x.device)
    taken = mag == float("-inf")
    return values, indices, taken


def blocked_topk(x_blocked: torch.Tensor, kb: int) -> BlockPayload:
    """Top-kb by |x| within each block (last axis) via iterative masked
    argmax (``masked_argmax_topk``)."""
    vals, idxs, _ = masked_argmax_topk(x_blocked, kb)
    return BlockPayload(
        values=vals, indices=idxs,
        blocked_shape=x_blocked.shape,
        orig_shape=x_blocked.shape,  # caller overwrites with the leaf shape
    )
