"""SASG: the paper's algorithm as a gradient-exchange transform.

Port of ``repro/core/sasg.py`` for M workers stacked on one device. One
engine expresses all four paper algorithms (Section 5.1):

                     selection OFF            selection ON
  identity           distributed SGD          LASG
  topk_ef            Sparse (top-k + EF)      SASG   <- the paper

Each worker m, all M at once along the leading worker dim:

  1. computes its fresh local gradient and, if selection is on, the
     gradient at its stale parameters **on the same minibatch** (eq. 6/7);
  2. decides send-vs-skip with the LASG rule (worker-local);
  3. folds the learning rate: g = lr * grad (error feedback is folded in
     by the compressor: g + e, eq. 8); with ``fold_lr=False`` g = grad and
     the exchange returns the compressed mean gradient, for an optimizer
     to consume (``optim.optimizers``);
  4. compresses (top-k -> fixed-k values + indices);
  5. contributes its fresh payload, or its cached stale payload when it
     skips, to the mean over workers.

The returned ``update`` is eq. (8)'s (1/M) [sum fresh T_k(g) + sum stale
T_k(g)], ready for ``params - update``.

On a mesh the exchange takes its block geometry from the params'
partition specs; on a device mesh each rank holds its TP shard of the
gradient (computed on its shards, or cut by ``build_exchange``'s
``shard_fn`` from a full one) and encodes it, or gathers the whole leaf
first where the compressor needs it (``comm.transport``).

With a ``WorkerGroup`` (``comm.process_group``) each of P processes holds
M/P of the workers: its state is stacked over those, the rule keeps the
global M in its threshold, the exchange all-gathers the payload slices,
``num_sent`` is summed over the group and the losses are gathered, so
every process computes the same update and counters as the stacked run.
``force_skip`` and ``ExchangeInfo.send`` are the process's slice.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, NamedTuple, Optional

import torch

from repro_torch.comm import collectives
from repro_torch.comm.transport import ActivationLayout, Transport, build_transport

from .compressors import CompressorConfig, CompressorDef
from .selection import (
    SelectionConfig,
    SelectionState,
    advance_tau,
    push_window,
    resolve_alphas,
    should_send,
)
from .types import (
    Tree,
    dtype_of,
    tree_cast,
    tree_leaves,
    tree_map,
    tree_scale,
    tree_where,
)


@dataclass(frozen=True)
class SASGConfig:
    compressor: CompressorConfig = field(default_factory=CompressorConfig)
    selection: SelectionConfig = field(default_factory=SelectionConfig)
    fold_lr: bool = True                  # paper folds gamma into the compressed g
    stale_params_dtype: str = "float32"
    name: str = "sasg"
    # pipeline knobs (no effect without a stage axis):
    pipeline_engine: str = "1f1b"         # "1f1b" | "gpipe" (the reference engine)
    act_layout: Optional[ActivationLayout] = None  # the 1F1B ring's wire format
    # overlap: the JAX package's per-bucket dispatch. Accepted for config
    # parity and run as the synchronous exchange: in this process every
    # bucket's exchange would run one after another, with nothing for a
    # dispatch to overlap (the JAX package's result is bitwise the
    # synchronous one too)
    overlap: bool = False


# -- presets: the paper's four algorithms -----------------------------------

def sgd_config(**kw) -> SASGConfig:
    return SASGConfig(
        compressor=CompressorConfig(name="identity"),
        selection=SelectionConfig(enabled=False),
        name="sgd", **kw,
    )


def sparse_config(k_ratio: float = 0.01, **kw) -> SASGConfig:
    return SASGConfig(
        compressor=CompressorConfig(name="topk_ef", k_ratio=k_ratio),
        selection=SelectionConfig(enabled=False),
        name="sparse", **kw,
    )


def lasg_config(max_delay: int = 10, **kw) -> SASGConfig:
    return SASGConfig(
        compressor=CompressorConfig(name="identity"),
        selection=SelectionConfig(enabled=True, max_delay=max_delay),
        name="lasg", **kw,
    )


def sasg_config(k_ratio: float = 0.01, max_delay: int = 10, **kw) -> SASGConfig:
    return SASGConfig(
        compressor=CompressorConfig(name="topk_ef", k_ratio=k_ratio),
        selection=SelectionConfig(enabled=True, max_delay=max_delay),
        name="sasg", **kw,
    )


PRESETS = {
    "sgd": sgd_config,
    "sparse": sparse_config,
    "lasg": lasg_config,
    "sasg": sasg_config,
}


class WorkerState(NamedTuple):
    """Per-worker SASG state; every leaf has the leading worker dim."""

    comp_state: Tree        # compressor state (EF error buffers)
    stale_cache: Tree       # last-sent payload (the distributed "server memory")
    stale_params: Tree      # w^{t - tau_m}; () when selection is off
    tau: torch.Tensor       # (M,) int32


class GlobalState(NamedTuple):
    """State shared by all workers."""

    window: torch.Tensor    # (D,) ||w^{t+1-d} - w^{t-d}||^2
    step: torch.Tensor      # () int32


class ExchangeInfo(NamedTuple):
    loss: torch.Tensor       # (M,) f32 — each worker's fresh minibatch loss
    send: torch.Tensor       # (M/P,) bool — this process's workers uploaded
    num_sent: torch.Tensor   # () f32   — |M^t| over all M workers


# grad_fn(params, batch, stacked_params) -> (loss (M,), grads (M, ...)):
# per-worker value-and-grad on the worker-stacked batch; ``stacked_params``
# says whether params carry the worker dim (the stale-params gradient) or
# are shared by all workers (the fresh gradient).
GradFn = Callable[[Tree, Tree, bool], tuple]


def per_worker_grad_fn(loss_fn: Callable) -> GradFn:
    """The ``GradFn`` of a model's ``loss_fn(params, batch)``: one
    ``torch.func.vmap`` of ``grad_and_value`` over the worker dim (the
    counterpart of ``jax.vmap``), so the launches per step do not grow
    with M. The fresh gradient maps over the batch only (params shared),
    the stale-params gradient over the per-worker params too."""
    vag = torch.func.grad_and_value(loss_fn)
    vag_shared = torch.func.vmap(vag, in_dims=(None, 0))
    vag_stacked = torch.func.vmap(vag, in_dims=(0, 0))

    def grad_fn(params, batch, stacked_params: bool):
        grads, loss = (vag_stacked if stacked_params else vag_shared)(params, batch)
        return loss, grads

    return grad_fn


class SASGExchange(NamedTuple):
    """Built exchange: functions to be called from the training step."""

    config: SASGConfig
    transport: Transport
    compressor: CompressorDef
    num_workers: int
    init_worker: Callable[[Tree], WorkerState]
    init_global: Callable[..., GlobalState]
    # run(params, batch, wstate, gstate, lr, grad_fn[, force_skip, gen])
    #   -> (update, wstate, info)
    run: Callable[..., tuple]
    bits_per_upload_paper: Callable[[Tree], float]
    bits_per_upload_wire: Callable[[Tree], float]


def _stack(params: Tree, m: int) -> Tree:
    return tree_map(lambda p: p.unsqueeze(0).expand((m,) + tuple(p.shape)).clone(), params)


def build_exchange(cfg: SASGConfig, num_workers: int, group=None, leaf_specs=None,
                   axis_sizes=None, local: bool = False,
                   shard_fn: Optional[Callable[[Tree], Tree]] = None,
                   grad_combine=None, stage=None,
                   worker_axes: tuple = ("data",), diff_sq_norm=None,
                   shard_groups=None, mesh=None) -> SASGExchange:
    """Build the SASG exchange over a ``repro_torch.comm`` Transport; with a
    ``WorkerGroup``, this process's share of the ``num_workers`` workers.

    ``leaf_specs`` / ``axis_sizes``: the params' partition specs on the
    mesh, which set per_shard top-k's block geometry. ``local``: params
    and worker state are this rank's TP shards; ``grad_fn`` then returns
    either this rank's shards of the gradients, with ``diff_sq_norm``
    giving the rule the full trees' per-worker ||a - b||^2, or the full
    gradients (the rule reads those), and ``shard_fn`` cuts this rank's
    shard of them for the encode. ``shard_groups`` / ``mesh``: the groups
    of the axes that split the leaves, over which a whole-leaf compressor
    gathers them (``comm.transport``).

    Under pipeline stages: ``grad_combine`` (the dense fallback,
    ``dist.pipeline.build_stage_combine``) makes the full gradient tree of
    the stages' gradients before the rule and the encode; ``stage`` (a
    ``comm.transport.StageInfo``, the payload path) keeps gradients
    stage-local, encodes the local trunk slice and gathers only the
    k-sized payload over the stages (``Transport.gather_payload``), with
    the rule on the transport's stage-summed norm. ``worker_axes``: the
    mesh axes the workers span, which the wire log names on a stacked
    mesh (a group names its own)."""
    transport = build_transport(cfg.compressor, num_workers, group, leaf_specs,
                                axis_sizes, local, grad_combine, stage, worker_axes,
                                shard_groups, mesh)
    sel = cfg.selection
    M = num_workers
    local = transport.local_workers
    stale_dtype = dtype_of(cfg.stale_params_dtype)

    def init_worker(params: Tree) -> WorkerState:
        device = tree_leaves(params)[0].device
        stacked = _stack(params, local)
        comp_state = transport.init_state(stacked)
        stale_cache = transport.zero_payload(params)
        stale_params = tree_cast(stacked, stale_dtype) if sel.enabled else ()
        tau = torch.ones((local,), dtype=torch.int32, device=device)
        return WorkerState(comp_state, stale_cache, stale_params, tau)

    def init_global(device=None) -> GlobalState:
        return GlobalState(
            window=torch.zeros((max(sel.max_delay, 1),), dtype=torch.float32,
                               device=device),
            step=torch.zeros((), dtype=torch.int32, device=device),
        )

    def run(params: Tree, batch: Tree, wstate: WorkerState, gstate: GlobalState,
            lr: torch.Tensor, grad_fn: GradFn,
            force_skip: Optional[torch.Tensor] = None,
            gen: Optional[torch.Generator] = None):
        """One SASG exchange over the stacked workers; the randomized
        compressors draw from ``gen`` (every worker's draws, sliced to
        this process's)."""
        loss, g_fresh = grad_fn(params, batch, False)
        g_fresh = transport.gather(g_fresh)
        if sel.enabled:
            stale_p = tree_map(lambda s, p: s.to(p.dtype), wstate.stale_params, params)
            if sel.probe_fraction < 1.0:
                # rule (6) on a probe sub-batch: the first round(p * B_m)
                # samples of each worker's slice, both sides on it
                def probe(x):
                    return x[:, :max(1, int(round(sel.probe_fraction * x.shape[1])))]

                pbatch = tree_map(probe, batch)
                g_rule_fresh = transport.gather(grad_fn(params, pbatch, False)[1])
                g_stale = transport.gather(grad_fn(stale_p, pbatch, True)[1])
            else:
                g_rule_fresh = g_fresh
                g_stale = transport.gather(grad_fn(stale_p, batch, True)[1])
            sstate = SelectionState(tau=wstate.tau, window=gstate.window)
            # payload path: trunk gradients are stage-local slices, so the
            # rule's norm sums them over the stages (all stages agree)
            send = should_send(sel, g_rule_fresh, g_stale, sstate, resolve_alphas(sel, lr),
                               M, force_skip, batch_dims=1,
                               diff_sq_norm=(transport.diff_sq_norm
                                             if transport.stage is not None else diff_sq_norm))
            del g_rule_fresh, g_stale, stale_p   # each tree goes after its last reader
        else:
            send = torch.ones((local,), dtype=torch.bool, device=loss.device)

        # always upload on the very first step (empty caches)
        send = send | (gstate.step == 0)

        if shard_fn is not None:
            g_fresh = shard_fn(g_fresh)
        g = tree_scale(g_fresh, lr) if cfg.fold_lr else g_fresh
        del g_fresh
        # the densify template: the per-worker gradient tree, full also
        # where a stage combine made it so from stage-local params
        like = params if transport.grad_combine is None else tree_map(lambda x: x[0], g)
        payload_fresh, comp_state_cand = transport.encode(
            wstate.comp_state, g, None if gen is None else transport.draws(gen))
        del g
        # payload path: the trunk payload slices are gathered over the
        # stages here (identity otherwise); the stale cache keeps the full
        # payload, so a skip replays it with no stage collective
        payload_fresh = transport.gather_payload(payload_fresh)
        payload = tree_where(send, payload_fresh, wstate.stale_cache)
        comp_state_new = tree_where(send, comp_state_cand, wstate.comp_state)
        del comp_state_cand
        update = transport.densify(transport.exchange(payload), like)

        if sel.enabled:
            stale_params_new = tree_where(
                send, tree_cast(params, stale_dtype), wstate.stale_params
            )
        else:
            stale_params_new = ()

        new_wstate = WorkerState(
            comp_state=comp_state_new,
            stale_cache=payload,
            stale_params=stale_params_new,
            tau=advance_tau(SelectionState(wstate.tau, gstate.window), send),
        )
        num_sent = send.to(torch.float32).sum()
        # across the group's ranks (stacked: logged only, as each device
        # of the worker axes would move them)
        loss = collectives.gather_workers(loss, group, transport.span)
        num_sent = collectives.psum_scalar(num_sent, group, transport.span)
        info = ExchangeInfo(loss=loss, send=send, num_sent=num_sent)
        return update, new_wstate, info

    return SASGExchange(
        config=cfg,
        transport=transport,
        compressor=transport.compressor,
        num_workers=M,
        init_worker=init_worker,
        init_global=init_global,
        run=run,
        bits_per_upload_paper=transport.bits_paper,
        bits_per_upload_wire=transport.bits_wire,
    )


def update_global_state(gstate: GlobalState, applied_delta_sq_norm: torch.Tensor) -> GlobalState:
    """Push ||w^{t+1} - w^t||^2 into the window and advance the step."""
    sstate = SelectionState(tau=torch.zeros_like(gstate.step), window=gstate.window)
    return GlobalState(
        window=push_window(sstate, applied_delta_sq_norm),
        step=gstate.step + 1,
    )
