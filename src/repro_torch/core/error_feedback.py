"""Standalone error-feedback (memory) transform.

Port of ``repro/core/error_feedback.py``. The paper's EF is built into
``compressors.make_topk_ef`` (the compressor owns its residual so the
send/skip branch can commit or discard it at once). This module exposes EF
as a wrapper around *any* compression function, the formulation of Stich
et al. (2018) and Karimireddy et al. (2019):

    e_{t+1} = (g_t + e_t) - C(g_t + e_t)

Invariant: compressed + residual == corrected input, exactly, for any C
that returns a subset or projection of its input. The residual is kept in
fp32.

Sharded EF: on a device mesh the residual buffers are split like the
params (``dist.sharding.ef_specs``), each rank holding the residuals of
its own TP shard. The residual of a coordinate depends only on that
coordinate, never on the shard count, because the per-shard encode uses
the blocked geometry of the whole leaf. Checkpoints store the full
logical arrays, so a restore onto another mesh is pure resharding:
``remap_error_state``.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from .types import Tree, tree_flatten, tree_leaves, tree_unflatten, tree_zeros_like


class EFState(NamedTuple):
    error: Tree


def ef_init(template: Tree, dtype=torch.float32) -> EFState:
    return EFState(error=tree_zeros_like(template, dtype=dtype))


def ef_apply(
    state: EFState,
    g: Tree,
    compress_fn: Callable[[torch.Tensor], torch.Tensor],
) -> tuple:
    """Apply C to the error-corrected gradient; return (compressed, state').

    ``compress_fn`` maps a flat fp32 vector to its compressed *dense*
    representation (e.g. densified top-k)."""

    def leaf(e, x):
        corrected = x.to(e.dtype).reshape(-1) + e.reshape(-1)
        out = compress_fn(corrected)
        new_e = (corrected - out).reshape(e.shape)
        return out.reshape(x.shape).to(x.dtype), new_e

    g_leaves, treedef = tree_flatten(g)
    pairs = [leaf(e, x) for e, x in zip(tree_leaves(state.error), g_leaves)]
    compressed = tree_unflatten(treedef, [c for c, _ in pairs])
    return compressed, EFState(error=tree_unflatten(treedef, [e for _, e in pairs]))


def remap_error_state(comp_state: Tree, specs: Tree, mesh=None) -> Tree:
    """Re-place restored compressor/EF state (full logical arrays) by the
    specs of the TARGET mesh (``dist.sharding.ef_specs`` of the new mesh
    and strategy, behind the worker dim).

    Bit-preserving: values are only sliced, never moved to another
    coordinate. On a ``DeviceMesh`` each leaf becomes a DTensor holding
    this rank's shard; on a ``StackedMesh`` nothing is split and the
    arrays come back as they are. A ``specs`` leaf of None keeps its
    array. A raw spec needs ``mesh``. Spec axes that the target mesh
    lacks, or holds at size 1, are stripped first: sharding over such an
    axis is replication."""
    from repro_torch.dist.sharding import is_spec, live_spec, place

    leaves, treedef = tree_flatten(comp_state)
    spec_leaves = tree_leaves(specs, is_leaf=lambda s: s is None or is_spec(s))
    if len(spec_leaves) != len(leaves):
        raise ValueError(f"{len(spec_leaves)} specs for {len(leaves)} leaves")
    out = []
    for x, s in zip(leaves, spec_leaves):
        if s is None:
            out.append(x)
            continue
        if mesh is None:
            raise ValueError("remap_error_state got a raw spec; pass the target mesh "
                             "to bind it")
        out.append(place(x, live_spec(s, mesh), mesh))
    return tree_unflatten(treedef, out)


def worker_dims_match(wstate: Tree, num_workers: int) -> bool:
    """True iff every worker-stacked leaf has leading dim ``num_workers``
    (global shapes). Equal worker sets carry the state bitwise
    (``remap_error_state`` is pure data movement); a changed worker set
    re-initializes it (DESIGN.md §5: a stale residual belongs to a worker
    that no longer exists)."""
    leaves = tree_leaves(wstate)
    if not leaves:
        return True  # plain strategy: no worker state, nothing to mismatch
    return all(x.dim() >= 1 and x.shape[0] == num_workers for x in leaves)
