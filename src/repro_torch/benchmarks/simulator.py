"""Single-device M-worker SASG simulator (paper Section 5.1 setting).

Port of ``benchmarks/simulator.py``. The paper's own experiments
"simulated ten workers"; this does the same: one step computes the M
workers' gradients (one vmap), applies the selection rule and the
compressor per worker and aggregates per eq. (8). It is the port's
exchange, ``build_exchange(cfg, M).run`` over its ``Transport``, with no
second copy of the step, so rounds, bits and payloads are those of the
training step.

Rules of the simulator, kept from the reference where they differ from
``train/step.py``:

- the selection window takes ``||new_params - params||^2`` of the applied
  step (the training step pushes ``||delta||^2``);
- ``rounds`` and ``bits_paper`` are Python floats summed on the host, from
  the step's ``nsent`` read on the host every step (the training step
  keeps float32 tensors on the device);
- with ``fold_lr=False`` the exchanged mean gradient is scaled by lr (no
  optimizer).

As in ``exchange.run``: every worker sends at step 0 (``send |
(step == 0)``) and the rule's weights are ``alpha_scale / max(lr,
1e-12)``. The exchange also honours ``SelectionConfig.alphas`` and
``probe_fraction``, which the reference simulator ignores; the paper's
tables set neither.

Runs on the card unless ``device`` says otherwise, and raises without one.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.core.sasg import (
    GlobalState,
    SASGConfig,
    WorkerState,
    build_exchange,
    per_worker_grad_fn,
    update_global_state,
)
from repro_torch.core.types import Tree, tree_map, tree_scale, tree_sq_norm, tree_sub
from repro_torch.optim import apply_updates
from repro_torch.train.step import resolve_device


@dataclass
class SimState:
    params: Tree
    wstate: WorkerState     # per-worker (stacked M): EF state, stale cache, params, tau
    gstate: GlobalState     # window and step
    rounds: float = 0.0
    bits_paper: float = 0.0


def make_simulator(cfg: SASGConfig, loss_fn: Callable, M: int, device=None):
    """Returns ``(init, step, bits_paper, bits_wire)``:

    - ``init(params) -> SimState``;
    - ``step(state, batches, lr, gen=None) -> (state, nsent)``, where
      ``batches`` holds the worker-stacked ``(M, B_m, ...)`` arrays (numpy
      or tensors) and ``gen`` feeds the randomized compressors;
    - ``bits_paper(template)`` / ``bits_wire(template)``: per-upload bits.
    """
    device = resolve_device(device)
    exchange = build_exchange(cfg, M)
    grad_fn = per_worker_grad_fn(loss_fn)
    bits_paper = exchange.bits_per_upload_paper

    def init(params: Tree) -> SimState:
        params = tree_map(lambda p: p.to(device), params)
        return SimState(params, exchange.init_worker(params), exchange.init_global(device))

    def _batches(batches: dict) -> dict:
        out = {}
        for k, v in batches.items():
            t = v if isinstance(v, torch.Tensor) else torch.as_tensor(np.asarray(v))
            out[k] = t.to(device).long() if k == "labels" else t.to(device)
        return out

    def step(state: SimState, batches: dict, lr: float,
             gen: Optional[torch.Generator] = None):
        lr_t = torch.tensor(lr, dtype=torch.float32, device=device)
        update, wstate, info = exchange.run(
            state.params, _batches(batches), state.wstate, state.gstate, lr_t, grad_fn,
            gen=gen,
        )
        if not cfg.fold_lr:
            update = tree_scale(update, lr_t)
        params = apply_updates(state.params, update)
        gstate = update_global_state(
            state.gstate, tree_sq_norm(tree_sub(params, state.params)))
        nsent = float(info.num_sent)
        return SimState(
            params=params, wstate=wstate, gstate=gstate,
            rounds=state.rounds + nsent,
            bits_paper=state.bits_paper + nsent * bits_paper(state.params),
        ), nsent

    return init, step, bits_paper, exchange.bits_per_upload_wire
