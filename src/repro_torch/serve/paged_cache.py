"""Cache plumbing of the continuous-batching serve engine.

Port of ``repro/serve/paged_cache.py`` (DESIGN.md §9). The paged cache
itself is built by ``Model.init_paged_cache`` (block pools per
global-attention layer + one per-sequence block table); this module owns
everything around it:

- :class:`BlockAllocator`, the host-side free list of cache blocks, which
  the scheduler takes for all-or-nothing admission (prompt + max_new
  tokens' worth up front, so an admitted request never waits on blocks and
  the high-water mark equals the tokens in flight);
- the cache *codec*: pools are stored at an :class:`~repro_torch.comm.
  transport.ActivationLayout` wire dtype (``k_ratio=0``, a dtype cast on
  write). The identity layout (wire dtype == compute dtype) is bitwise the
  dense cache; narrower dtypes are held to a stated tolerance;
- the slot lifecycle ops on a decode cache tree: :func:`select_slots`
  (commit only the active slots of a tick), :func:`reset_slots` (recycle a
  slot for a new request), :func:`release_blocks` (poison a freed block's
  positions);
- :func:`cache_bytes`.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Union

import torch

from repro_torch.comm.bits import kv_cache_bits_per_token
from repro_torch.comm.transport import ActivationLayout
from repro_torch.configs.base import ModelConfig
from repro_torch.core.types import tree_flatten_with_paths, tree_leaves, tree_unflatten

# leaves owned by the paged pools / block table: never batch-masked (a
# frozen slot's writes never reach them, ``layers._write_paged``)
_POOL_KEYS = ("pk", "pv", "ppos", "bt")
# recurrent per-slot states (RG-LRU / SSD rows) that must be zeroed on reuse
_RECURRENT_KEYS = ("h", "conv")


def cache_layout(cfg: ModelConfig, wire_dtype: Optional[str] = None) -> ActivationLayout:
    """The cache write codec: an ActivationLayout with ``k_ratio=0``, whose
    ``encode`` is the dtype cast the pool writes apply and whose
    ``payload_bits`` prices the stored bytes. ``None`` selects the model's
    compute dtype (identity)."""
    return ActivationLayout(wire_dtype=wire_dtype or cfg.compute_dtype, k_ratio=0.0)


def paged_bits_per_token(cfg: ModelConfig, layout: ActivationLayout) -> float:
    """Stored bits per token across this config's paged layers."""
    n_paged = sum(1 for i in range(cfg.n_layers) if cfg.layer_kind(i) == "global")
    return kv_cache_bits_per_token(n_paged, cfg.n_kv_heads, cfg.head_dim, layout.wire_dtype)


class BlockAllocator:
    """Host-side free-list allocator over a fixed pool of cache blocks.

    Block ids index every paged layer's pool identically (one table, N
    pools). Tracks the pool high-water mark for ``cache_stats``."""

    def __init__(self, num_blocks: int, block_size: int):
        self.num_blocks = num_blocks
        self.block_size = block_size
        self._free = list(range(num_blocks - 1, -1, -1))  # pop() -> low ids first
        self.high_water = 0

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def used_blocks(self) -> int:
        return self.num_blocks - len(self._free)

    def blocks_for(self, n_tokens: int) -> int:
        return -(-n_tokens // self.block_size)

    def can_allocate(self, n: int) -> bool:
        return len(self._free) >= n

    def allocate(self, n: int) -> List[int]:
        if not self.can_allocate(n):
            raise RuntimeError(
                f"paged cache exhausted: want {n} blocks, {len(self._free)} free"
            )
        ids = [self._free.pop() for _ in range(n)]
        self.high_water = max(self.high_water, self.used_blocks)
        return ids

    def free(self, ids: List[int]) -> None:
        for i in ids:
            if not 0 <= i < self.num_blocks or i in self._free:
                raise ValueError(f"block {i} is not an allocated block")
            self._free.append(i)


def _slot_mask(mask: torch.Tensor, keys: list, ndim: int) -> torch.Tensor:
    """``mask`` shaped to broadcast over a leaf's batch axis: axis 1 under
    the stacked LM layers (``"unit"``), axis 0 elsewhere."""
    ax = 1 if "unit" in keys else 0
    return mask.reshape((1,) * ax + tuple(mask.shape) + (1,) * (ndim - ax - 1))


def _map_keyed(f, tree, *rest):
    """``f(keys, leaf, *other_leaves)`` over a tree, ``keys`` the leaf's
    path as a list of strings."""
    paths, leaves, treedef = tree_flatten_with_paths(tree)
    others = [tree_leaves(r) for r in rest]
    return tree_unflatten(treedef, [
        f(path.split("/"), *xs) for path, *xs in zip(paths, leaves, *others)
    ])


def select_slots(new_cache, old_cache, active: torch.Tensor):
    """Per-slot tick commit: recurrent-state rows of ``new_cache`` where
    ``active``, the old rows otherwise. KV leaves (dense K/V and pos
    tables, pools) pass through unchanged: attention drops a frozen slot's
    writes itself (``layers._write_dense``, ``layers._write_paged``). SSD /
    RG-LRU states update unconditionally inside the forward, so a frozen
    slot's padding tokens would corrupt its recurrence without this
    select."""

    def leaf(keys, n, o):
        if keys[-1] not in _RECURRENT_KEYS:
            return n
        return torch.where(_slot_mask(active, keys, n.dim()), n, o)

    return _map_keyed(leaf, new_cache, old_cache)


def reset_slots(cache, mask: torch.Tensor):
    """Recycle slots for new occupants: attention position rows -> -1 (no
    stale reads of the previous occupant's keys), recurrent rows -> 0 (a
    fresh sequence start). Dense K/V values become unreachable once their
    positions are negative and need no zeroing; the pools and the block
    table pass through (the engine rewrites a slot's table row)."""

    def leaf(keys, x):
        key = keys[-1]
        if key in _POOL_KEYS:
            return x
        if key == "pos":
            return torch.where(_slot_mask(mask, keys, x.dim()), torch.full_like(x, -1), x)
        if key in _RECURRENT_KEYS:
            return torch.where(_slot_mask(mask, keys, x.dim()), torch.zeros_like(x), x)
        return x

    return _map_keyed(leaf, cache)


def release_blocks(cache, block_ids: Union[Sequence[int], torch.Tensor]):
    """Poison the position rows of freed blocks so a recycled block never
    exposes the previous sequence's positions. Values may remain in the
    pools: they are unreachable once ``ppos < 0`` and are overwritten
    before the positions go live again. ``block_ids`` are the freed ids
    themselves (the JAX package pads them with out-of-range ids and drops
    those; here every id must be a pool block)."""

    def leaf(keys, x):
        if keys[-1] != "ppos":
            return x
        ids = torch.as_tensor(block_ids, dtype=torch.long).to(x.device)
        out = x.clone()
        # stacked (n_units, NB, bs) or flat (NB, bs): poison on the NB dim
        if x.dim() == 3:
            out[:, ids] = -1
        else:
            out[ids] = -1
        return out

    return _map_keyed(leaf, cache)


def cache_bytes(cache) -> int:
    """Total device bytes held by a decode cache tree."""
    return sum(x.numel() * x.element_size() for x in tree_leaves(cache))
