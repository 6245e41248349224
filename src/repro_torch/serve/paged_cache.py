"""Cache plumbing of the continuous-batching serve engine: the dense half.

Port of ``repro/serve/paged_cache.py`` (DESIGN.md §9) without the paged
pools. This module owns:

- :class:`BlockAllocator`, the host-side free list of cache blocks, which
  the scheduler takes for all-or-nothing admission;
- the slot lifecycle ops on a decode cache tree: :func:`select_slots`
  (commit only the active slots of a tick) and :func:`reset_slots`
  (recycle a slot for a new request);
- :func:`cache_bytes`.

The paged KV pools, ``cache_layout`` and ``release_blocks`` wait for the
port's ``ActivationLayout`` (ROADMAP item 10).
"""
from __future__ import annotations

from typing import List

import torch

from repro_torch.core.types import tree_flatten_with_paths, tree_leaves, tree_unflatten

# recurrent per-slot states (RG-LRU / SSD rows) that must be zeroed on reuse
_RECURRENT_KEYS = ("h", "conv")


class BlockAllocator:
    """Host-side free-list allocator over a fixed pool of cache blocks.

    Block ids index every paged layer's pool identically (one table, N
    pools). Tracks the pool high-water mark."""

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
    tables) pass through unchanged: attention drops a frozen slot's writes
    itself (``layers._write_dense``). SSD / RG-LRU states update
    unconditionally inside the forward, so a frozen slot's padding tokens
    would corrupt its recurrence without this select."""

    def leaf(keys, n, o):
        if keys[-1] not in _RECURRENT_KEYS:
            return n
        return torch.where(_slot_mask(active, keys, n.dim()), n, o)

    return _map_keyed(leaf, new_cache, old_cache)


def reset_slots(cache, mask: torch.Tensor):
    """Recycle slots for new occupants: attention position rows -> -1 (no
    stale reads of the previous occupant's keys), recurrent rows -> 0 (a
    fresh sequence start). Dense K/V values become unreachable once their
    positions are negative and need no zeroing."""

    def leaf(keys, x):
        m = _slot_mask(mask, keys, x.dim())
        if keys[-1] == "pos":
            return torch.where(m, torch.full_like(x, -1), x)
        if keys[-1] in _RECURRENT_KEYS:
            return torch.where(m, torch.zeros_like(x), x)
        return x

    return _map_keyed(leaf, cache)


def cache_bytes(cache) -> int:
    """Total device bytes held by a decode cache tree."""
    return sum(x.numel() * x.element_size() for x in tree_leaves(cache))
