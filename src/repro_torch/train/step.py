"""Training-step builder: model x SASG exchange, M workers on one device.

Port of the flat strategy of ``repro/train/step.py``. The M workers of the
paper's simulation are a leading dim of stacked tensors on one device, as
the paper simulated its ten workers: worker m trains on the contiguous
slice ``[m*B/M, (m+1)*B/M)`` of the global batch (what ``P("data")`` on
dim 0 gives in the JAX package).

Per-worker gradients for all M workers come from one ``torch.func.vmap``
of ``grad_and_value`` over the worker dim (``core.sasg.per_worker_grad_fn``).
The model is a pure function of a param dict, so no ``functional_call``
is needed.

With ``fold_lr=False`` the exchange returns the compressed mean gradient
and the step applies ``optimizer.update(update, opt_state, params)``; the
selection window then takes ||delta||^2 of the applied delta.

Randomness: the state carries a per-run ``seed``, and step t's draws (the
randomized compressors) come from a generator seeded by
``step_seed(seed, t)``, a pure function of the two, the counterpart of the
JAX package's ``fold_in(rng, step)``. A replay after recovery then draws
the same numbers without saving any generator state.

Workers as processes: with a ``WorkerGroup`` (``comm.process_group``) this
process runs workers ``r*M/P .. (r+1)*M/P - 1`` of the M: it takes exactly
the rows those workers get in the stacked run, draws every worker's random
numbers and keeps its own, and exchanges through the gathered path, so
its update and counters equal the stacked run's on every rank.

Entry points run on ``cuda`` unless the caller passes another device, and
raise when there is no card. On the card they turn TF32 off for cuDNN
convolutions and cuBLAS matmuls (``torch.backends.cudnn.allow_tf32`` is
True by default): the configs are float32, and TF32 keeps ~3 digits. They
also turn off cuBLAS's reduced-precision reduction in bf16 products
(``allow_bf16_reduced_precision_reduction``, True by default, lets a
split-K sum round its partial sums to bf16): XLA accumulates a bf16 dot in
fp32, and the bf16 LMs keep the JAX package's rounding points.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core import metrics as CM
from repro_torch.core.compressors import RANDOMIZED
from repro_torch.core.sasg import (
    SASGConfig,
    build_exchange,
    per_worker_grad_fn,
    update_global_state,
)
from repro_torch.core.types import CommCounters, tree_sq_norm
from repro_torch.models.model import Model
from repro_torch.optim import GradientTransformation, apply_updates

_MASK64 = (1 << 64) - 1


class TrainState(NamedTuple):
    params: Any
    opt_state: Any         # () unless fold_lr=False with an optimizer
    wstate: Any            # worker-stacked SASG state
    gstate: Any
    counters: CommCounters
    seed: torch.Tensor     # () int64 on the CPU: the run's seed


class BuiltStep(NamedTuple):
    step: Callable          # (state, batch[, force_skip]) -> (state, metrics)
    init: Callable          # (seed=0, params=None) -> TrainState
    exchange: Any
    num_workers: int
    device: torch.device
    bits_paper: float
    bits_wire: float
    group: Any = None       # the WorkerGroup of a multi-process run


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless asked otherwise.
    Raises when CUDA is asked for and there is no card; never falls back
    to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on the card by default and no CUDA device is "
                "available; pass device='cpu' to run the plain versions on the CPU"
            )
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    return dev


def step_seed(seed: int, step: int) -> int:
    """The seed of step ``step``'s generator: splitmix64 of the pair, a pure
    function of (seed, step) whose nearby inputs give unrelated streams."""
    z = (int(seed) * 0x9E3779B97F4A7C15 + int(step) + 1) & _MASK64
    for shift, mult in ((30, 0xBF58476D1CE4E5B9), (27, 0x94D049BB133111EB)):
        z = ((z ^ (z >> shift)) * mult) & _MASK64
    return (z ^ (z >> 31)) & ((1 << 63) - 1)


def worker_batch(batch: dict, num_workers: int, device, workers=None) -> dict:
    """Global batch (B, ...) -> worker-stacked (M, B/M, ...) on ``device``;
    worker m gets the contiguous rows [m*B/M, (m+1)*B/M). ``workers =
    (start, count)`` keeps workers start .. start+count-1 only (a process
    of a worker group). Takes numpy arrays or tensors (already on the
    device, from ``data.ShardedLoader``)."""
    start, count = workers or (0, num_workers)
    out = {}
    for k, v in batch.items():
        t = v if isinstance(v, torch.Tensor) else torch.as_tensor(np.asarray(v))
        if t.shape[0] % num_workers:
            raise ValueError(
                f"global batch {t.shape[0]} does not split over {num_workers} workers"
            )
        per = t.shape[0] // num_workers
        t = t[start * per:(start + count) * per].to(device)
        if k == "labels":
            t = t.long()
        out[k] = t.reshape((count, per) + tuple(t.shape[1:]))
    return out


def build_train_step(
    model: Model,
    sasg_cfg: SASGConfig,
    num_workers: int,
    lr_schedule: Callable,
    device=None,
    optimizer: Optional[GradientTransformation] = None,
    group=None,
) -> BuiltStep:
    """The training step; with a ``WorkerGroup`` this process's share of
    the ``num_workers`` workers, on the group's device."""
    device = resolve_device(group.device if group is not None else device)
    if not sasg_cfg.fold_lr and optimizer is None:
        raise ValueError("fold_lr=False exchanges the gradient: pass an optimizer")
    if sasg_cfg.selection.deadline_skip:
        raise NotImplementedError(
            "selection.deadline_skip: the straggler deadline comes from the fault "
            "plan, which the port does not have yet (ROADMAP item 11); pass a "
            "force_skip mask to the step instead"
        )
    M = num_workers
    randomized = sasg_cfg.compressor.name in RANDOMIZED
    exchange = build_exchange(sasg_cfg, M, group)
    t = exchange.transport
    workers = (t.worker_start, t.local_workers)
    template = model.init(torch.Generator().manual_seed(0), device="cpu")
    bits_paper = exchange.bits_per_upload_paper(template)
    bits_wire = exchange.bits_per_upload_wire(template)

    grad_fn = per_worker_grad_fn(model.loss_fn)

    def init(seed: int = 0, params=None) -> TrainState:
        if params is None:
            gen = torch.Generator(device=device).manual_seed(seed)
            params = model.init(gen, device=device)
        return TrainState(
            params=params,
            opt_state=optimizer.init(params) if optimizer is not None else (),
            wstate=exchange.init_worker(params),
            gstate=exchange.init_global(device),
            counters=CommCounters.zeros(device),
            seed=torch.tensor(seed, dtype=torch.int64),
        )

    def step(state: TrainState, batch: dict,
             force_skip: Optional[torch.Tensor] = None):
        lr = lr_schedule(state.gstate.step)
        wbatch = worker_batch(batch, M, device, workers)
        if force_skip is not None:   # the (M,) mask -> this process's workers
            force_skip = force_skip[workers[0]:workers[0] + workers[1]]
        gen = None
        if randomized:   # reading the step waits for the device
            gen = torch.Generator(device=device).manual_seed(
                step_seed(int(state.seed), int(state.gstate.step)))
        update, wstate, info = exchange.run(
            state.params, wbatch, state.wstate, state.gstate, lr, grad_fn,
            force_skip=force_skip, gen=gen,
        )
        if sasg_cfg.fold_lr:
            delta, opt_state = update, state.opt_state
        else:
            delta, opt_state = optimizer.update(update, state.opt_state, state.params)
        new_params = apply_updates(state.params, delta)
        gstate = update_global_state(state.gstate, tree_sq_norm(delta))
        counters = CM.accumulate(state.counters, info.num_sent, bits_paper, bits_wire)
        mets = {
            "loss": info.loss.mean(),
            "num_sent": info.num_sent,
            "lr": lr,
            "rounds_total": counters.rounds,
            "bits_paper_total": counters.bits_paper,
            "bits_wire_total": counters.bits_wire,
        }
        return TrainState(new_params, opt_state, wstate, gstate, counters, state.seed), mets

    return BuiltStep(step, init, exchange, M, device, bits_paper, bits_wire, group)
