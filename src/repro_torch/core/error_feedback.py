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
