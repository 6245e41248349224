"""Adaptive aggregation: the LASG-style selection rule used by SASG (eq. 6).

Port of ``repro/core/selection.py``. Worker m uploads at step t iff

    || grad(w^t; xi_t) - grad(w^{t-tau_m}; xi_t) ||^2
        >  (1/M^2) * sum_{d=1..D} alpha_d * || w^{t+1-d} - w^{t-d} ||^2

or its staleness hit the cap (tau_m >= D). Both gradients are evaluated on
the *same* minibatch xi_t (paper Section 3.2).

``tau`` may be a scalar (one worker) or ``(M,)`` (the stacked workers of
the exchange); with ``batch_dims=1`` the gradient trees carry the worker
dim and the rule is evaluated per worker.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional, Sequence

import torch

from .types import Tree, tree_sq_norm, tree_sub


@dataclass(frozen=True)
class SelectionConfig:
    enabled: bool = True
    max_delay: int = 10                      # D (paper uses D=10)
    # alpha_d weights; if None, alpha_d = alpha_scale / lr as in the paper's
    # experiments (alpha_d = 1/gamma or 1/(2 gamma)).
    alphas: Optional[Sequence[float]] = None
    alpha_scale: float = 1.0
    # Beyond-paper: straggler mitigation by deadline. A worker whose step
    # time exceeds the deadline is forced into the skip branch, the
    # algorithm's own M_c path (``force_skip`` below is how it arrives).
    # The JAX package reads the flag nowhere; the straggler fault of
    # ``train.faults`` drives ``force_skip``, and ``train.build_train_step``
    # refuses True rather than ignore it.
    deadline_skip: bool = False
    # Beyond-paper: evaluate rule (6) on a probe sub-batch, the first
    # round(p * B_m) samples of each worker's slice, both sides on the same
    # probe data. Costs 2p extra gradients instead of 1x; the staleness cap
    # D still bounds the delay, only the rule's variance grows.
    probe_fraction: float = 1.0


class SelectionState(NamedTuple):
    tau: torch.Tensor        # () or (M,) int32 staleness counters
    window: torch.Tensor     # (D,) f32 ||w^{t+1-d} - w^{t-d}||^2


def resolve_alphas(cfg: SelectionConfig, lr: torch.Tensor) -> torch.Tensor:
    """alpha_d: the configured weights, else ``alpha_scale / lr`` in fp32."""
    if cfg.alphas is not None:
        a = torch.as_tensor(cfg.alphas, dtype=torch.float32, device=lr.device)
        if a.shape != (cfg.max_delay,):
            raise ValueError(f"alphas must have shape ({cfg.max_delay},)")
        return a
    lr = torch.as_tensor(lr, dtype=torch.float32)
    a = cfg.alpha_scale / torch.clamp(lr, min=1e-12)
    return a.to(torch.float32).expand(cfg.max_delay)


def should_send(
    cfg: SelectionConfig,
    g_fresh: Tree,
    g_stale: Tree,
    state: SelectionState,
    alphas: torch.Tensor,
    num_workers: int,
    force_skip: Optional[torch.Tensor] = None,
    batch_dims: int = 0,
    diff_sq_norm=None,
) -> torch.Tensor:
    """Evaluate rule (6); True => upload the fresh gradient.
    ``diff_sq_norm(a, b)`` replaces ``||a - b||^2`` (the pipeline's
    stage-aware norm, ``comm.transport.Transport.diff_sq_norm``)."""
    if diff_sq_norm is not None:
        lhs = diff_sq_norm(g_fresh, g_stale)
    else:
        lhs = tree_sq_norm(tree_sub(g_fresh, g_stale), batch_dims=batch_dims)
    rhs = torch.sum(alphas * state.window) / float(num_workers) ** 2
    send = (lhs > rhs) | (state.tau >= cfg.max_delay)
    if force_skip is not None:
        # straggler deadline: force the skip branch unless staleness capped
        send = torch.where(force_skip & (state.tau < cfg.max_delay),
                           torch.zeros_like(send), send)
    return send


def advance_tau(state: SelectionState, send: torch.Tensor) -> torch.Tensor:
    return torch.where(send, torch.ones_like(state.tau), state.tau + 1)


def push_window(state: SelectionState, update_sq_norm: torch.Tensor) -> torch.Tensor:
    """Shift in ||w^{t+1} - w^t||^2 as the newest window entry (d=1)."""
    return torch.cat([update_sq_norm.reshape(1).to(torch.float32), state.window[:-1]])
