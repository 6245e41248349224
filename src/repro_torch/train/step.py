"""Training-step builder: model x SASG exchange on a mesh.

Port of ``repro/train/step.py``: the flat, hierarchical and plain
strategies (``dist.strategy``) on a mesh (``launch.mesh``); a step built
without one runs the flat strategy on a 1-D ``data`` mesh of its workers.
The M workers of the
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
numbers and keeps its own, and exchanges through the gathered path over
the worker axis's ranks, so its update and counters equal the stacked
run's on every rank.

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

import math
from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.comm.collectives import StageAxis
from repro_torch.comm.transport import (
    ActivationLayout,
    StageInfo,
    is_trunk_path,
    supports_stage_payload,
)
from repro_torch.core import metrics as CM
from repro_torch.core.compressors import RANDOMIZED
from repro_torch.core.sasg import (
    SASGConfig,
    WorkerState,
    build_exchange,
    per_worker_grad_fn,
    update_global_state,
)
from repro_torch.core.types import (
    CommCounters,
    Tree,
    tree_flatten,
    tree_flatten_with_paths,
    tree_leaves,
    tree_map,
    tree_size,
    tree_sq_norm,
    tree_unflatten,
)
from repro_torch.dist.pipeline import (
    build_pipelined_vag,
    build_stage_combine,
    resolve_microbatches,
)
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
    exchange: Any           # None for the plain strategy
    num_workers: int
    device: torch.device
    bits_paper: float
    bits_wire: float
    group: Any              # the WorkerGroup of a multi-process run, or None
    strategy: Any           # the run's dist.strategy.Strategy
    mesh: Any               # its StackedMesh or DeviceMesh
    param_specs: Any
    # state -> its full logical arrays (plain tensors; a collective on a
    # device mesh, so every rank calls it), and back onto this rank
    gather_state: Callable
    place_state: Callable
    # the state's params -> fresh SASG worker state (a cold start); None
    # for the plain strategy
    init_worker: Optional[Callable]
    # where the gradient is computed over a model axis of ranks: "sharded"
    # (each rank on its shards), "gathered (<reason>)" (the params gathered
    # first) or "none" (no model axis splits the params across ranks)
    tp_compute: str = "none"


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


def pipeline_gather_bits(transport, template, pdef, strategy, selection) -> float:
    """Static stage-axis gradient-exchange wire bits per step per stage.

    On the payload path: one k-sized trunk payload gather ((S-1)/S of the
    trunk buckets' wire bits) plus the prepare-side sum per gradient
    computation; on the dense fallback: the d-sized trunk gather plus the
    non-trunk sum per gradient computation (``dist.pipeline.
    build_stage_combine``). Gradient computations per step: the fresh one,
    plus the stale-params one with selection on (two probe gradients with
    a probe fraction below 1)."""
    from repro_torch.comm import bits as bits_lib

    S = strategy.pipeline_stages
    n_combines = 1 if not selection.enabled else (3 if selection.probe_fraction < 1.0 else 2)
    paths, leaves, _ = tree_flatten_with_paths(template)
    trunk_pfx = ("/".join(str(k) for k in pdef.trunk_path),)

    def dense_bits(prefixes, invert=False):
        return float(sum(x.numel() * x.element_size() * 8 for pth, x in zip(paths, leaves)
                         if is_trunk_path(pth, prefixes) != invert))

    if transport.stage is not None:
        trunk_wire = bits_lib.bucket_wire_bits(transport.bits_report(template), trunk_pfx)
        prep_pfx = tuple("/".join(str(k) for k in p) for p in pdef.prepare_paths)
        return ((S - 1) / S * trunk_wire
                + n_combines * 2 * (S - 1) / S * dense_bits(prep_pfx))
    return n_combines * ((S - 1) / S * dense_bits(trunk_pfx)
                         + 2 * (S - 1) / S * dense_bits(trunk_pfx, invert=True))


# ---------------------------------------------------------------------------
# helpers of the step
# ---------------------------------------------------------------------------

def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def _local(tree: Tree) -> Tree:
    """DTensor leaves -> this rank's local tensors (the kernels and the
    exchange take plain tensors)."""
    return tree_map(lambda x: x.to_local() if _is_dtensor(x) else x, tree)


def _spec_list(specs) -> list:
    from repro_torch.dist.sharding import is_spec

    return tree_leaves(specs, is_leaf=lambda x: x is None or is_spec(x))


def _zip_specs(f, tree: Tree, specs) -> Tree:
    """``f(leaf, spec)`` over a tree and its spec tree (flatten order)."""
    leaves, treedef = tree_flatten(tree)
    spec_leaves = _spec_list(specs)
    if len(spec_leaves) != len(leaves):
        raise ValueError(f"{len(spec_leaves)} specs for {len(leaves)} leaves")
    return tree_unflatten(treedef, [f(x, sp) for x, sp in zip(leaves, spec_leaves)])


def _split_rows(grad_fn, d: int):
    """The per-worker gradient of the hierarchical strategy in one process:
    each worker's rows split into ``d`` slices (the in-pod data axis), one
    gradient per slice, their mean summed in slice order."""

    def mean_slices(x, m):
        x = x.reshape((m, d) + tuple(x.shape[1:]))
        acc = x[:, 0]
        for j in range(1, d):
            acc = acc + x[:, j]
        return acc / d

    def fn(params, batch, stacked):
        m = tree_leaves(batch)[0].shape[0]
        sub = tree_map(lambda x: x.reshape((m * d, x.shape[1] // d) + tuple(x.shape[2:])),
                       batch)
        if stacked:
            params = tree_map(lambda w: w.repeat_interleave(d, dim=0), params)
        loss, grads = grad_fn(params, sub, stacked)
        return mean_slices(loss, m), tree_map(lambda g: mean_slices(g, m), grads)

    return fn


def _opt_specs(opt_state, params, pspecs):
    """Optimizer moments (keys mu / m / v shaped like the params) take the
    param specs; everything else is replicated."""
    from repro_torch.dist.sharding import P

    pstruct = tree_flatten(params)[1].skeleton

    def rec(t):
        if isinstance(t, dict):
            return {k: (pspecs if k in ("mu", "m", "v") and tree_flatten(v)[1].skeleton == pstruct
                        else rec(v)) for k, v in t.items()}
        if isinstance(t, (tuple, list)) and not hasattr(t, "_fields"):
            return type(t)(rec(v) for v in t)
        return tree_map(lambda _x: P(), t)

    return rec(opt_state)


def build_train_step(
    model: Model,
    sasg_cfg: SASGConfig,
    num_workers: Optional[int],
    lr_schedule: Callable,
    device=None,
    optimizer: Optional[GradientTransformation] = None,
    group=None,
    mesh=None,
    strategy=None,
) -> BuiltStep:
    """The training step of a strategy on a mesh (port of the JAX step's
    shard_map and plain branches).

    - No ``mesh``: the flat strategy on a 1-D ``data`` mesh of the
      ``num_workers`` workers: a ``StackedMesh`` in one process or, with a
      ``WorkerGroup``, a ``DeviceMesh`` over its ranks.
    - ``StackedMesh``: one process, nothing split in memory. The workers
      are the stacked leading dim; the exchange takes its per_shard block
      geometry from ``param_specs`` on the mesh. ``num_workers`` defaults
      to the strategy's M and may be any multiple of it.
    - ``DeviceMesh`` (with the ``WorkerGroup`` of its ranks): the worker
      axis's ranks hold M / size workers each (the rows those workers get
      in the stacked run) and exchange over that axis's sub-group. Where a
      mesh axis splits the params (TP, FSDP), params, optimizer moments,
      EF buffers and stale params are DTensors placed by ``param_specs`` /
      ``ef_specs`` behind the worker dim; elsewhere the state keeps plain
      local tensors. Where ``tensor_parallel.compute_path`` says
      ``sharded`` (``BuiltStep.tp_compute``) each rank computes its
      workers' gradients with ``vmap(grad)`` on its own model-axis shards
      (the rule's norms add the ranks' partials of the split leaves);
      elsewhere a step gathers the params over the model axis (the
      host-staged collectives of ``comm.collectives``) and computes the
      workers' full gradients. It runs the rule, and each rank encodes
      its own TP shard
      (``to_local()`` seams; blocks never straddle shards). The densified
      update is gathered once for the window's norm, so counters and bits
      are the global ones on every rank.

    hierarchical: each pod is a worker; its rows are split over the in-pod
    ``data`` axis and its gradient is the mean over those slices, summed
    in slice order (gathered over the data sub-group on a device mesh).
    plain: dense data-parallel SGD, no worker state, one send a step,
    ``32 * size`` bits.
    """
    from repro_torch.comm import collectives
    from repro_torch.comm.process_group import axis_group
    from repro_torch.dist import tensor_parallel
    from repro_torch.dist.sharding import (P, as_dtensor, ef_specs, live_spec, param_specs,
                                           shard_counts, splits_over, stage_only_spec,
                                           strip_stage_spec, take_local, with_leading,
                                           without_axes)
    from repro_torch.dist.strategy import axis_sizes, choose_strategy
    from repro_torch.launch.mesh import is_device_mesh, make_test_mesh

    if mesh is None:
        if num_workers is None or strategy is not None:
            raise ValueError("without a mesh, pass num_workers and no strategy")
        mesh = make_test_mesh((group.world_size if group is not None else num_workers,),
                              ("data",), group=group)
        strategy = choose_strategy(mesh)   # flat: the exchange runs for every algo
    on_devices = is_device_mesh(mesh)
    if on_devices and group is None:
        raise ValueError("a DeviceMesh needs the WorkerGroup of its ranks (group=...)")
    if not on_devices and group is not None:
        raise ValueError("a StackedMesh runs in one process: pass no group")
    device = resolve_device(group.device if group is not None else device)
    if not sasg_cfg.fold_lr and optimizer is None:
        raise ValueError("fold_lr=False exchanges the gradient: pass an optimizer")
    if sasg_cfg.selection.deadline_skip:
        raise NotImplementedError(
            "selection.deadline_skip: the JAX package reads this flag nowhere; a "
            "straggler reaches the rule as the step's force_skip mask, which the "
            "fault plan's straggler fault drives (train.faults, train.elastic)")
    sizes = axis_sizes(mesh)
    if strategy is None:
        strategy = choose_strategy(mesh, sasg_enabled=sasg_cfg.name != "sgd")
    # the stage axis engages only with the exchange (the JAX package's
    # manual region) and needs the model's stage-stackable trunk
    stage = strategy.stage_axis if strategy.pipelined and strategy.uses_shard_map else None
    pdef = model.pipeline
    if stage is not None:
        if pdef is None:
            raise ValueError(
                f"strategy requests pipeline_stages={strategy.pipeline_stages} but model "
                f"{model.config.name!r} has no PipelineDef (no homogeneous "
                "stage-stackable trunk)")
        if pdef.n_layers % strategy.pipeline_stages:
            raise ValueError(
                f"trunk depth {pdef.n_layers} does not divide over "
                f"{strategy.pipeline_stages} pipeline stages; pass trunk_layers to "
                "choose_strategy for the soft fallback")
    trunk_paths = (tuple(str(k) for k in pdef.trunk_path),) if stage else ()
    template = model.init(torch.Generator().manual_seed(0), device="meta")   # shapes
    pspecs = param_specs(template, mesh, strategy.fsdp_axis, strategy.tp_axis,
                         stage_axis=stage, trunk_paths=trunk_paths)
    groups = ({n: axis_group(group, mesh, n) for n, sz in sizes.items() if sz > 1}
              if on_devices else {})
    # the gradient gathers the params over every split axis but the stage
    # axis: a stage computes on its own trunk slice
    grad_groups = {n: g for n, g in groups.items() if n != stage}
    split = on_devices and any(c > 1 for sp in _spec_list(pspecs)
                               for c in shard_counts(sp, sizes))

    tp_split = on_devices and any(c > 1 for sp in _spec_list(pspecs)
                                  for c in shard_counts(strip_stage_spec(sp, stage), sizes))
    # tensor-parallel compute: each rank's gradient on its model-axis
    # shards (the JAX package's automatic model axis), where the model has
    # the forward for it; elsewhere the params are gathered first
    tp_axis = strategy.tp_axis
    tp_size = sizes.get(tp_axis, 1) if on_devices and tp_axis else 1
    fsdp_split = any(c > 1 for sp in _spec_list(pspecs)
                     for c in shard_counts(without_axes(sp, (tp_axis, stage)), sizes))
    tp_compute = "none" if tp_size == 1 else tensor_parallel.compute_path(
        model.config, tp_size, model.remat, stages=stage is not None,
        fsdp=strategy.fsdp_axis if fsdp_split and strategy.uses_shard_map else None)
    sharded = tp_compute == "sharded"
    maxis = tensor_parallel.ModelAxis(groups[tp_axis], tp_axis) if sharded else None
    compute_model = tensor_parallel.local_model(model, maxis) if sharded else model
    # what the sharded compute still gathers (FSDP, on the plain strategy)
    beside_tp = {n: g for n, g in grad_groups.items() if n != tp_axis}
    tp_groups = {tp_axis: groups[tp_axis]} if sharded else {}

    def gathered(tree, specs, lead: int = 0, over=None):
        """Full logical arrays of this rank's shards over the axes of
        ``over`` (default: every split axis); identity unsplit."""
        over = groups if over is None else over
        if not over:
            return tree
        return _zip_specs(lambda x, sp: collectives.gather_spec(
            x, (None,) * lead + tuple(sp), over), tree, specs)

    def stage_sliced(tree, specs, lead: int = 0):
        """This stage's slice of stage-full trees (identity without stages
        or on a stacked mesh)."""
        if stage is None or not on_devices:
            return tree
        return _zip_specs(lambda x, sp: take_local(
            x, P(*((None,) * lead + tuple(stage_only_spec(sp, stage)))), mesh), tree, specs)

    def sliced(tree, specs, lead: int = 0, keep=()):
        """This rank's shards of full arrays; ``keep``: axes along which
        the arrays are this rank's already."""
        return _zip_specs(lambda x, sp: take_local(
            x, P(*((None,) * lead + tuple(without_axes(sp, keep)))), mesh), tree, specs)

    def tp_sq_norm(parts, specs):
        """The full tree's squared norm from this rank's per-leaf partial
        sums, where the leaves are model-axis shards (``sharded``)."""
        return maxis.sq_norm(parts, [splits_over(sp, tp_axis, sizes) for sp in _spec_list(specs)])

    def wrapped(tree, specs):
        """Local shards -> DTensors of the global shapes (a device mesh that
        splits the params; elsewhere the local tensors as they are)."""
        if not split:
            return tree

        def one(x, sp):
            sp = live_spec(sp, mesh)
            counts = shard_counts(sp, sizes, x.dim())
            return as_dtensor(x, sp, mesh, tuple(d * c for d, c in zip(x.shape, counts)))

        return _zip_specs(one, tree, specs)

    num_params = tree_size(template)

    # -- plain: dense data parallelism, no exchange ---------------------------
    if not strategy.uses_shard_map:
        bits = 32.0 * num_params
        vag = torch.func.grad_and_value(compute_model.loss_fn)
        data_axes = tuple(strategy.batch_axes)
        n_slices = 1
        for a in data_axes:
            n_slices *= sizes[a]

        def opt_specs_of(opt_state, params):
            return _opt_specs(opt_state, params, pspecs)

        def init(seed: int = 0, params=None) -> TrainState:
            if params is None:
                params = model.init(torch.Generator(device=device).manual_seed(seed),
                                    device=device)
            opt_state = optimizer.init(params) if optimizer is not None else ()
            ospecs = opt_specs_of(opt_state, params)
            return TrainState(wrapped(sliced(params, pspecs), pspecs),
                              wrapped(sliced(opt_state, ospecs), ospecs), (), (),
                              CommCounters.zeros(device), torch.tensor(seed, dtype=torch.int64))

        def rows(batch):
            if not on_devices:
                return worker_batch(batch, 1, device)
            idx = 0
            for a in data_axes:
                idx = idx * sizes[a] + mesh.get_local_rank(a)
            return worker_batch(batch, n_slices, device, (idx, 1))

        def step(state: TrainState, batch: dict, force_skip=None):
            # no selection rule: a straggler mask has nothing to act on
            lr = lr_schedule(state.counters.rounds.to(torch.int32))
            # sharded: the params stay this rank's shards over the model axis
            params = gathered(_local(state.params), pspecs, over=beside_tp if sharded else None)
            grads, loss = vag(params, tree_map(lambda x: x[0], rows(batch)))
            for a in reversed(data_axes):   # the mean over the data slices
                if a in groups:
                    grads = tree_map(lambda g, a=a: collectives.mean_over(g, groups[a]), grads)
                    loss = collectives.mean_over(loss, groups[a])
            opt_state = state.opt_state
            keep = ()
            if optimizer is not None:
                # the optimizer runs on the full arrays
                params = gathered(params, pspecs, over=tp_groups)
                grads = gathered(grads, pspecs, over=tp_groups)
                ospecs = opt_specs_of(opt_state, params)
                delta, full_opt = optimizer.update(grads, gathered(_local(opt_state), ospecs),
                                                   params)
                opt_state = wrapped(sliced(full_opt, ospecs), ospecs)
            else:
                delta = tree_map(lambda g: lr * g.float(), grads)
                keep = tuple(tp_groups)
            new_params = sliced(apply_updates(params, delta), pspecs, keep=keep)
            one = torch.ones((), dtype=torch.float32, device=device)
            counters = CM.accumulate(state.counters, one, bits, bits)
            mets = {"loss": loss, "num_sent": one, "lr": lr,
                    "rounds_total": counters.rounds, "bits_paper_total": counters.bits_paper,
                    "bits_wire_total": counters.bits_wire}
            return TrainState(wrapped(new_params, pspecs), opt_state, (), (), counters,
                              state.seed), mets

        def state_specs(state):
            return TrainState(pspecs, opt_specs_of(state.opt_state, state.params), (), (),
                              tree_map(lambda _x: P(), state.counters), None)

        gather_state, place_state = _state_movers(state_specs, gathered, sliced, wrapped,
                                                  mesh, on_devices, split)
        return BuiltStep(step, init, None, n_slices, device, bits, bits, group, strategy,
                         mesh, pspecs, gather_state, place_state, None, tp_compute)

    # -- flat / hierarchical: the SASG exchange over the worker axis -----------
    wa = strategy.worker_axes[0]
    M = num_workers or strategy.num_workers
    if M % strategy.num_workers:
        raise ValueError(f"{M} workers are not a multiple of the {wa!r} axis's "
                         f"{strategy.num_workers}")
    inner = strategy.inner_dp
    D = sizes[inner] if inner else 1
    wgroup = groups.get(wa)
    # a hierarchical strategy with fsdp_axis runs too (the JAX package
    # refuses it, an XLA partitioner CHECK): the params are gathered before
    # the gradient either way.
    # Stages: the exchange's specs never carry the stage axis (its geometry
    # is the flat run's, the support-exactness of the stage-local encode).
    # The payload path (block-local per_shard topk_ef, a model with
    # disjoint prepare / finish reads) encodes each stage's trunk slice and
    # gathers the k-sized payload; every other path takes the dense stage
    # combine (on a stacked mesh the pipeline returns the full tree).
    exchange_specs = ef_specs(pspecs, stage, False)
    payload_mode = (stage is not None and pdef.prepare_paths is not None
                    and supports_stage_payload(sasg_cfg.compressor))
    stage_ax = grad_combine = stage_info = None
    if stage is not None:
        # a stacked mesh's worker-stacked tensors hold the workers of every
        # device of the data axes: the wire log counts one device's share
        share = 1 if on_devices else math.prod(sizes[a] for a in strategy.batch_axes)
        stage_ax = StageAxis(strategy.pipeline_stages, groups.get(stage), stage, share)
        if payload_mode:
            tpaths, tleaves, _ = tree_flatten_with_paths(template)
            prefixes = tuple("/".join(p) for p in trunk_paths)
            stage_info = StageInfo(stage_ax, prefixes, {
                pth: x.shape[0] for pth, x in zip(tpaths, tleaves)
                if is_trunk_path(pth, prefixes)})
        elif on_devices:
            combine = build_stage_combine(pdef, stage_ax)
            grad_combine = lambda g: combine([g])   # noqa: E731
        base = build_pipelined_vag(pdef, stage_ax, strategy.microbatches,
                                   stage_local=payload_mode, act_layout=sasg_cfg.act_layout,
                                   engine=sasg_cfg.pipeline_engine)
    else:
        base = per_worker_grad_fn(compute_model.loss_fn)
    if D > 1 and not on_devices:
        base = _split_rows(base, D)

    def grad_fn(params, batch, stacked: bool):
        """Per-worker losses and gradients: this rank's shards of them when
        ``sharded``, else the full gradients of the gathered params."""
        if tp_split and not sharded:
            params = gathered(params, pspecs, 1 if stacked else 0, grad_groups)
        loss, grads = base(params, batch, stacked)
        if D > 1 and on_devices:   # the pod's gradient: mean over its data slices
            grads = tree_map(lambda g: collectives.mean_over(g, groups[inner]), grads)
            loss = collectives.mean_over(loss, groups[inner])
        return loss, grads

    def tp_diff_sq_norm(a, b):
        """The rule's per-worker ||a - b||^2 of model-axis shards (each
        leaf's difference squared in place: one leaf-sized temporary)."""
        return tp_sq_norm([(x.float() - y.float()).square_().reshape(x.shape[0], -1).sum(-1)
                           for x, y in zip(tree_leaves(a), tree_leaves(b))], exchange_specs)

    exchange = build_exchange(
        sasg_cfg, M, wgroup, leaf_specs=exchange_specs, axis_sizes=sizes, local=tp_split,
        shard_fn=(lambda g: sliced(g, exchange_specs, 1)) if tp_split and not sharded else None,
        grad_combine=grad_combine, stage=stage_info, worker_axes=tuple(strategy.worker_axes),
        diff_sq_norm=tp_diff_sq_norm if sharded else None,
        shard_groups=grad_groups if tp_split else None, mesh=mesh)
    t = exchange.transport
    workers = (t.worker_start, t.local_workers)
    randomized = sasg_cfg.compressor.name in RANDOMIZED
    bits_paper = exchange.bits_per_upload_paper(template)
    bits_wire = exchange.bits_per_upload_wire(template)

    def wstate_specs(ws):
        """Worker dim over the worker axis; EF buffers, stale params and
        dense payloads behind it take the param specs; per_shard payloads
        take them on their blocked view."""
        from repro_torch.core.topk import BlockPayload

        nparams = len(_spec_list(pspecs))
        plist = _spec_list(pspecs)

        def behind(tree, specs_list):
            leaves, treedef = tree_flatten(tree, is_leaf=collectives._is_payload)
            if len(leaves) != nparams:
                return tree_map(lambda x: P(wa), tree)
            out = []
            for x, sp in zip(leaves, specs_list):
                if isinstance(x, BlockPayload):
                    nb = len(x.blocked_shape)
                    ent = tuple(sp)[: nb - 1] + (None,) * max(0, nb - 1 - len(sp))
                    vs = P(wa, *ent, None, None)
                    out.append(BlockPayload(vs, vs, x.blocked_shape, x.orig_shape))
                else:
                    out.append(with_leading(sp, wa))
            return tree_unflatten(treedef, out)

        # a whole-leaf compressor's payloads are the same on every rank of
        # the split axes: the stale cache is replicated over them
        return WorkerState(
            comp_state=behind(ws.comp_state, _spec_list(ef_specs(pspecs, stage, payload_mode))),
            stale_cache=(tree_map(lambda x: P(wa), ws.stale_cache) if t.whole_leaf
                         else behind(ws.stale_cache, _spec_list(exchange_specs))),
            stale_params=behind(ws.stale_params, plist) if ws.stale_params != () else (),
            tau=P(wa))

    def wrap_wstate(ws, specs):
        return ws._replace(comp_state=wrapped(ws.comp_state, specs.comp_state),
                           stale_params=wrapped(ws.stale_params, specs.stale_params))

    def new_worker_state(params_local):
        if stage_ax is None or stage_ax.group is None:
            ws = exchange.init_worker(params_local)
        else:
            # the stale cache (the gathered payload) and a fallback's EF
            # buffers are stage-full; stale params mirror the local params
            ws = exchange.init_worker(gathered(params_local, pspecs, over={stage: groups[stage]}))
            ws = ws._replace(stale_params=stage_sliced(ws.stale_params, pspecs, 1))
            if payload_mode:
                ws = ws._replace(comp_state=stage_sliced(ws.comp_state, pspecs, 1))
        return wrap_wstate(ws, wstate_specs(ws))

    def init(seed: int = 0, params=None) -> TrainState:
        if params is None:
            params = model.init(torch.Generator(device=device).manual_seed(seed),
                                device=device)
        opt_state = optimizer.init(params) if optimizer is not None else ()
        ospecs = _opt_specs(opt_state, params, pspecs)
        local = sliced(params, pspecs)
        opt_state = wrapped(sliced(opt_state, ospecs), ospecs)
        del params   # on a device mesh the full params go before the worker state is made
        return TrainState(
            params=wrapped(local, pspecs),
            opt_state=opt_state,
            wstate=new_worker_state(local),
            gstate=exchange.init_global(device),
            counters=CommCounters.zeros(device),
            seed=torch.tensor(seed, dtype=torch.int64),
        )

    gather_bits = (pipeline_gather_bits(t, template, pdef, strategy, sasg_cfg.selection)
                   if stage is not None else 0.0)

    pipe_models = {}

    def pipe_model(wbatch):
        """The stage traffic model of a step on ``wbatch``'s shapes: one
        worker's prepare output, on the meta device (once per shapes)."""
        key = tuple((tuple(x.shape), x.dtype) for x in tree_leaves(wbatch))
        if key in pipe_models:
            return pipe_models[key]
        one = tree_map(lambda x: torch.empty(x.shape[1:], dtype=x.dtype, device="meta"),
                       wbatch)
        h = pdef.prepare(template, one)
        nm = resolve_microbatches(h.shape[0], strategy.microbatches
                                  or strategy.pipeline_stages)
        act = h.numel() // nm
        layout = sasg_cfg.act_layout or ActivationLayout()
        pipe_models[key] = CM.PipelineCommModel(
            stages=strategy.pipeline_stages, n_micro=nm, act_elems=act,
            bits_per_elem=h.element_size() * 8, gather_bits=gather_bits,
            engine=sasg_cfg.pipeline_engine, hop_payload_bits=layout.payload_bits(act),
            bcast_payload_bits=layout.payload_bits(nm * act))
        return pipe_models[key]

    def step(state: TrainState, batch: dict, force_skip: Optional[torch.Tensor] = None):
        lr = lr_schedule(state.gstate.step)
        wbatch = worker_batch(batch, M, device, workers)
        if D > 1 and on_devices:   # this rank's slice of each worker's rows
            d = mesh.get_local_rank(inner)
            wbatch = tree_map(lambda x: x.reshape(
                (x.shape[0], D, x.shape[1] // D) + tuple(x.shape[2:]))[:, d], wbatch)
        if force_skip is not None:
            force_skip = force_skip[workers[0]:workers[0] + workers[1]]
        gen = None
        if randomized:
            gen = torch.Generator(device=device).manual_seed(
                step_seed(int(state.seed), int(state.gstate.step)))
        params = _local(state.params)
        update, wstate, info = exchange.run(
            params, wbatch, _local(state.wstate), state.gstate, lr, grad_fn,
            force_skip=force_skip, gen=gen)
        opt_state = state.opt_state
        # the update is full over the stages (the exchange densifies the
        # gathered payload) and this rank's over a model axis
        if sasg_cfg.fold_lr and sharded:   # the window's norm from the shards' partials
            delta = update
            delta_sq = tp_sq_norm([x.float().square().sum() for x in tree_leaves(update)],
                                  exchange_specs)
        elif sasg_cfg.fold_lr:
            full_delta = gathered(update, exchange_specs, over=grad_groups)
            delta = stage_sliced(update, pspecs)
            delta_sq = tree_sq_norm(full_delta)
        else:
            ospecs = _opt_specs(opt_state, params, pspecs)
            full_delta, full_opt = optimizer.update(
                gathered(update, exchange_specs, over=grad_groups),
                gathered(_local(opt_state), ospecs), gathered(params, pspecs))
            delta = sliced(full_delta, pspecs)
            opt_state = wrapped(sliced(full_opt, ospecs), ospecs)
            delta_sq = tree_sq_norm(full_delta)
        new_params = apply_updates(params, delta)
        gstate = update_global_state(state.gstate, delta_sq)
        counters = CM.accumulate(state.counters, info.num_sent, bits_paper, bits_wire)
        mets = {
            "loss": info.loss.mean(),
            "num_sent": info.num_sent,
            "lr": lr,
            "rounds_total": counters.rounds,
            "bits_paper_total": counters.bits_paper,
            "bits_wire_total": counters.bits_wire,
        }
        if stage is not None:
            # the static per-step stage traffic (PipelineCommModel), every
            # step whatever the send decisions
            pipe = pipe_model(wbatch)
            bits_step = torch.tensor(pipe.bits_per_step(), dtype=torch.float32, device=device)
            mets.update({
                "pipe_stages": torch.tensor(float(strategy.pipeline_stages), device=device),
                "pipe_ring_bits_step": torch.tensor(pipe.ring_bits_per_step(),
                                                    dtype=torch.float32, device=device),
                "pipe_gather_bits_step": torch.tensor(pipe.gather_bits, dtype=torch.float32,
                                                      device=device),
                "pipe_bits_step": bits_step,
                "pipe_bits_total": bits_step * gstate.step.to(torch.float32),
            })
        new_state = TrainState(wrapped(new_params, pspecs), opt_state,
                               wrap_wstate(wstate, wstate_specs(wstate)), gstate, counters,
                               state.seed)
        return new_state, mets

    def state_specs(state):
        # () worker state: a remap places the rest before a cold start
        return TrainState(pspecs, _opt_specs(state.opt_state, state.params, pspecs),
                          wstate_specs(state.wstate) if state.wstate != () else (),
                          tree_map(lambda _x: P(), state.gstate),
                          tree_map(lambda _x: P(), state.counters), None)

    gather_state, place_state = _state_movers(state_specs, gathered, sliced, wrapped, mesh,
                                              on_devices, split)

    def init_worker(params):
        return new_worker_state(_local(params))

    return BuiltStep(step, init, exchange, M, device, bits_paper, bits_wire, group,
                     strategy, mesh, pspecs, gather_state, place_state, init_worker, tp_compute)


def _state_movers(state_specs, gathered, sliced, wrapped, mesh, on_devices, split):
    """(gather_state, place_state) of a mesh run: a state -> the full
    logical arrays every rank agrees on (the checkpoint's form), and full
    arrays -> this rank's shards, DTensors where the run keeps them
    (params, optimizer state, EF buffers and stale params; the EF buffers
    through ``remap_error_state``)."""
    from repro_torch.core.error_feedback import remap_error_state

    def gather_state(state: TrainState) -> TrainState:
        if not on_devices:
            return state
        specs = state_specs(state)
        out = []
        for name in ("params", "opt_state", "wstate", "gstate", "counters"):
            sub, sp = getattr(state, name), getattr(specs, name)
            out.append(gathered(_local(sub), sp) if sub != () else sub)
        return TrainState(*out, state.seed)

    def place_state(full: TrainState) -> TrainState:
        if not on_devices:
            return full
        specs = state_specs(full)
        params = wrapped(sliced(full.params, specs.params), specs.params)
        opt_state = wrapped(sliced(full.opt_state, specs.opt_state), specs.opt_state)
        wstate = full.wstate
        if wstate != ():
            ws = sliced(wstate, specs.wstate)
            comp = remap_error_state(full.wstate.comp_state, specs.wstate.comp_state, mesh)
            wstate = ws._replace(
                comp_state=comp if split else _local(comp),
                stale_params=wrapped(ws.stale_params, specs.wstate.stale_params))
        return TrainState(params, opt_state, wstate, full.gstate, full.counters, full.seed)

    return gather_state, place_state
