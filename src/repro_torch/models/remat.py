"""Rematerialization of a layer stack's units: the port of ``jax.checkpoint``.

The JAX package wraps each unit of its layer stack in ``jax.checkpoint``
(``repro/models/lm.py::_stack_body``, ``encdec.py``), with the policy
``checkpoint_dots_with_no_batch_dims`` for ``remat="dots"``. The port's
per-worker gradients come from ``torch.func.vmap(grad)``, under which
``torch.utils.checkpoint`` does not run (its saved-tensor hooks are refused
by the ``torch.func`` transforms). So the recompute is an
``autograd.Function`` of its own, ``Remat``:

- forward runs the unit under ``no_grad`` and saves only its inputs;
- backward recomputes the unit with ``torch.func.vjp`` on the saved inputs
  and applies the cotangent, returned detached: ``torch.func.grad``
  differentiates with ``create_graph``, and a gradient that kept the
  recompute's graph would hold its activations, with every other unit's,
  to the end of the backward (no double backward goes through a unit).

``"dots"`` is accepted, as the JAX launcher accepts it, and runs as
``"full"``: keeping the weight products' outputs measured slower and no
smaller than ``"full"`` on the card (PERF.md), with the same gradients.

``Remat`` carries ``generate_vmap_rule``: under ``vmap`` over the workers
the forward and the backward run batched, so nested Functions (the SSD
chunk term, ``kernels/ssd_scan/ops.py``) fold the workers into their
batch as they do without remat. The recompute replays the same ops on the
same inputs, so gradients equal the run without remat bitwise. The SSD
Functions nest in the recompute: their forward runs again, their backward
once; no double backward is taken.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.core.types import tree_flatten, tree_unflatten

POLICIES = ("none", "full", "dots")


class Remat(torch.autograd.Function):
    """``fn(*flat)`` (one tensor out) recomputed in the backward."""

    generate_vmap_rule = True

    @staticmethod
    def forward(fn, *flat):
        with torch.no_grad():
            return fn(*flat)

    @staticmethod
    def setup_context(ctx, inputs, output):
        fn, *flat = inputs
        ctx.fn = fn
        ctx.save_for_backward(*flat)

    @staticmethod
    def backward(ctx, grad):
        # torch.func's grad runs the backward with create_graph: the
        # gradients would keep the recompute's graph, and with it every
        # unit's activations, to the end of the backward. Detached, the
        # graph goes with this call (the recompute itself runs in the same
        # grad mode as the forward without remat: the same kernels)
        _, vjp_fn = torch.func.vjp(ctx.fn, *ctx.saved_tensors)
        return (None,) + tuple(g.detach() for g in vjp_fn(grad))


def checkpoint(fn: Callable, policy: str) -> Callable:
    """``fn(*trees) -> tensor`` under the remat ``policy`` (``"none"``
    returns ``fn`` itself; ``"dots"`` runs as ``"full"``). The trees'
    leaves are the recompute's saved inputs."""
    if policy not in POLICIES:
        raise ValueError(f"unknown remat policy {policy!r}; have {POLICIES}")
    if policy == "none":
        return fn

    def wrapped(*trees):
        leaves, treedef = tree_flatten(list(trees))

        def flat_fn(*xs):
            return fn(*tree_unflatten(treedef, list(xs)))

        return Remat.apply(flat_fn, *leaves)

    return wrapped
