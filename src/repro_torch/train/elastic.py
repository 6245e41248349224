"""Elastic worker membership of the port: in-run resizes without a restart.

Port of ``repro/train/elastic.py``. SASG's adaptive aggregation already
tolerates stale and absent workers, so a resize is a state remap, not a
change of algorithm (DESIGN.md §5). A resize event:

1. builds the step at the new worker count (``WorkerMembership.build``:
   the mesh of ``mesh_fn``, ``choose_strategy`` on it, ``build_train_step``;
   cached per count, so growing back reuses the first build);
2. carries params, optimizer state, global SASG state, counters and the
   seed exactly (``remap_state``: the old step's full logical arrays,
   placed by the new step's specs);
3. carries the worker state bitwise when the membership is unchanged
   (``Strategy.membership`` and the worker-stacked dims), else starts it
   cold from the carried params (``BuiltStep.init_worker``): a residual
   belongs to a worker that no longer exists, and a fresh start is the
   paper's t = 0 condition relative to the resize;
4. goes on at the same step: with a replayable stream
   (``data.ReplayableStream``) batch t is the same whatever the resize
   history.

The Trainer's restore takes the same cold start when a checkpoint's
worker count differs from its own, so an in-run resize and a restart from
a checkpoint at the new count end in bitwise equal states.

**One departure from the reference** (ROADMAP queue 3). ``faults.py``
promises that a rewound run goes through the membership history of an
uninterrupted run. The JAX ``ElasticTrainer`` restores into the worker
count current at the failure, so a crash whose restore point comes before
a resize replays the steps in between at the post-resize count: on
fc_mnist (4 workers, SASG k 0.1, checkpoints every 4 steps),
``FaultPlan().worker_drop(6, to=2).crash(7)`` replays steps 4-5 with 2
workers where the run without the crash used 4, and its final params end
0.0151 (max abs) from that run's. On recovery this ``ElasticTrainer``
first rebuilds at the count the restored checkpoint was saved at (its
manifest's ``num_workers``; the initial count when it restores to step
0), restores the worker state bitwise, and lets the membership events
apply again as the replay passes their steps. A faulted run then equals
the same plan without the fault, bitwise, wherever the restore point
falls. At the start of a run, a checkpoint saved at another count
restores into the built step's count, as the base Trainer's does (restart
elasticity).

In a multi-process run (``BuiltStep.group``) a torch.distributed group
cannot change its size in-run. A resize retargets M among multiples of
the worker axis's size (each rank holds M / size workers); a target that
is not such a multiple, and a ``crash`` or ``data_hiccup`` fault (the
loop ends the whole group on any failure), are refused with a
``ValueError`` when the trainer is built. Stragglers, save failures and
checkpoint corruption (of rank 0's files) work as in one process.
"""
from __future__ import annotations

from typing import Any, Callable, Iterator, Optional

import numpy as np
import torch

from repro_torch.core.error_feedback import worker_dims_match
from repro_torch.core.types import tree_flatten

from .faults import DataStreamError, FaultInjector, FaultPlan, InjectedFault, corrupt_checkpoint
from .loop import Trainer, TrainerConfig
from .step import BuiltStep, TrainState, build_train_step


def fresh_worker_state(built: BuiltStep, params: Any) -> Any:
    """Per-worker SASG state started from ``params`` (DESIGN.md §5's cold
    start) at the built step's M and placement, as ``built.init`` makes it:
    the stale params start at the CURRENT params, the t = 0 condition
    relative to a resize. () for the plain strategy."""
    if built.init_worker is None:
        return ()
    return built.init_worker(params)


def remap_state(state: TrainState, new_built: BuiltStep,
                old_built: Optional[BuiltStep] = None) -> TrainState:
    """Carry a TrainState of ``old_built`` onto ``new_built`` (another worker
    count, mesh or strategy).

    params, opt_state, counters and seed move exactly; so does gstate, unless
    its structure changes (plain <-> SASG), when it starts afresh. The
    worker state is carried bitwise when the membership is unchanged
    (``place_state``, through ``remap_error_state`` on a device mesh), else
    started cold from the carried params. Without ``old_built`` the state
    is taken as the full logical arrays and its worker state as changed."""
    full = state if old_built is None else old_built.gather_state(state)
    if new_built.init_worker is None:   # plain: no worker or global SASG state
        return new_built.place_state(TrainState(full.params, full.opt_state, (), (),
                                                full.counters, full.seed))
    same = (old_built is not None
            and old_built.strategy.membership == new_built.strategy.membership
            and worker_dims_match(full.wstate, new_built.num_workers))
    gstate = full.gstate
    fresh_g = new_built.exchange.init_global(new_built.device)
    if tree_flatten(gstate)[1] != tree_flatten(fresh_g)[1]:
        gstate = fresh_g
    placed = new_built.place_state(TrainState(full.params, full.opt_state,
                                              full.wstate if same else (), gstate,
                                              full.counters, full.seed))
    if same:
        return placed
    return placed._replace(wstate=fresh_worker_state(new_built, placed.params))


class WorkerMembership:
    """Maps a worker count to its BuiltStep and remaps state across
    resizes.

    ``mesh_fn(num_workers)`` gives the mesh at that count (the launcher's
    keeps the non-worker axes of ``--mesh-shape``); without one, the step
    is the 1-D ``data`` mesh that ``build_train_step`` makes without a mesh:
    stacked in one process (any count), or over ``group``'s ranks.
    ``choose_kwargs`` go to ``choose_strategy`` on ``mesh_fn``'s meshes.
    Built steps are cached per count.
    """

    def __init__(self, model, sasg_cfg, lr_schedule: Callable, optimizer=None,
                 mesh_fn: Optional[Callable[[int], Any]] = None, device=None, group=None,
                 **choose_kwargs):
        self.model = model
        self.sasg_cfg = sasg_cfg
        self.lr_schedule = lr_schedule
        self.optimizer = optimizer
        self.mesh_fn = mesh_fn
        self.device = device
        self.group = group
        self.choose_kwargs = dict(choose_kwargs)
        self._cache: dict = {}

    def build(self, num_workers: int) -> BuiltStep:
        if num_workers in self._cache:
            return self._cache[num_workers]
        mesh = strategy = None
        if self.mesh_fn is not None:
            from repro_torch.dist.strategy import choose_strategy

            mesh = self.mesh_fn(num_workers)
            strategy = choose_strategy(mesh, **self.choose_kwargs)
        built = build_train_step(self.model, self.sasg_cfg, num_workers, self.lr_schedule,
                                 device=self.device, optimizer=self.optimizer,
                                 group=self.group, mesh=mesh, strategy=strategy)
        self._cache[num_workers] = built
        return built

    def resize(self, state: TrainState, old_built: BuiltStep,
               num_workers: int) -> tuple:
        new_built = self.build(num_workers)
        return new_built, remap_state(state, new_built, old_built)


class ElasticTrainer(Trainer):
    """Trainer with membership events and fault injection.

    ``membership`` enables in-run resizes (worker_drop / worker_join faults
    retarget the worker count without a restart); ``plan`` schedules faults
    through :class:`~repro_torch.train.faults.FaultInjector`. The order
    within a step is fixed: resize -> corrupt_ckpt -> save_fail arming ->
    crash (raises) -> data hiccup (raises, from the batch fetch) ->
    straggler mask (into the step). Recovery rebuilds at the restored
    checkpoint's worker count first (module docstring); the rest
    (replayable data seek, checkpoint meta, the kernel-fault rule) is the
    base Trainer's.
    """

    def __init__(self, built: BuiltStep, data: Iterator[dict], cfg: TrainerConfig,
                 membership: Optional[WorkerMembership] = None,
                 plan: Optional[FaultPlan] = None, fault_hook=None, log_fn=print):
        super().__init__(built, data, cfg, fault_hook=fault_hook, log_fn=log_fn)
        self.membership = membership
        self.injector = FaultInjector(plan) if plan is not None else None
        self._initial_workers = built.num_workers
        if membership is not None:
            # growing back, and a recovery's rebuild, hit this cache
            membership._cache.setdefault(built.num_workers, built)
        if plan is not None and self._multi_process:
            refused = sorted({f.kind for f in plan.faults if f.kind in ("crash", "data_hiccup")})
            if refused:
                raise ValueError(f"{', '.join(refused)} faults in a multi-process run: the "
                                 "loop ends the whole group on any failure, so nothing "
                                 "would recover")
            axis = built.strategy.num_workers
            for f in plan.faults:
                if f.kind in ("worker_drop", "worker_join") and f.workers % axis:
                    raise ValueError(f"{f.kind} at step {f.step} to {f.workers} workers: a "
                                     "multi-process run resizes among multiples of its "
                                     f"worker axis's {axis} ranks")

    # -- fault hooks -----------------------------------------------------------

    def _pre_step(self, state: TrainState, step: int) -> TrainState:
        state = super()._pre_step(state, step)
        inj = self.injector
        if inj is None:
            return state

        target = inj.resize_to(step)
        if target is not None and target != self.built.num_workers:
            if self.membership is None:
                raise RuntimeError("FaultPlan schedules a membership event but the "
                                   "ElasticTrainer has no WorkerMembership")
            old = self.built.num_workers
            self.built, state = self.membership.resize(state, self.built, target)
            self.log(f"[trainer] step {step}: resized worker axis {old} -> {target} "
                     f"(strategy {self.built.strategy.name}, state carried in-run)")
            self.events.append({"kind": "resize", "step": step, "from": old, "to": target})

        cf = inj.corrupt_at(step)
        if cf is not None and self.cfg.ckpt_dir:
            # the newest COMMITTED checkpoint: let the save in flight land first,
            # so which one is hit does not depend on the writer's speed
            self._join_save()
            victim = corrupt_checkpoint(self.cfg.ckpt_dir, cf.target_step) if self._writer \
                else None
            self.log(f"[trainer] step {step}: corrupted checkpoint step_{victim}")
            self.events.append({"kind": "corrupt_ckpt", "step": step, "victim": victim})

        attempts = inj.save_fail_attempts(step)
        if attempts:
            self._ckpt_fail_attempts = attempts
            self.events.append({"kind": "save_fail_armed", "step": step, "attempts": attempts})

        if inj.crash_at(step):
            self.events.append({"kind": "crash", "step": step})
            raise InjectedFault(f"injected node failure at step {step}")
        return state

    def _fetch_batch(self, step: int) -> dict:
        if self.injector is not None and self.injector.data_hiccup_at(step):
            self.events.append({"kind": "data_hiccup", "step": step})
            raise DataStreamError(f"injected data-stream failure at step {step}")
        return super()._fetch_batch(step)

    def _force_skip(self, step: int) -> Optional[torch.Tensor]:
        if self.injector is None:
            return super()._force_skip(step)
        mask = self.injector.straggler_mask(step, self.built.num_workers)
        if mask is None:
            return None
        self.events.append({"kind": "straggler", "step": step,
                            "workers": [int(i) for i in np.flatnonzero(mask)]})
        return torch.from_numpy(mask).to(self.built.device)

    def _recover(self) -> tuple:
        if self.membership is None:
            return super()._recover()

        def template_at(workers: Optional[int]) -> TrainState:
            """The restore template at the checkpoint's worker count."""
            if workers is not None and workers != self.built.num_workers:
                self.log(f"[trainer] rebuilding at the checkpoint's {workers} workers "
                         f"(from {self.built.num_workers})")
                self.built = self.membership.build(workers)
            return self.built.init(self._seed)

        state, step = self._restore_latest(None, template_at)
        if state is None:   # nothing restored: the run's start, at its first count
            state = template_at(self._initial_workers)
        self._seek(step)
        return state, step
