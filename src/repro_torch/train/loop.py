"""Fault-tolerant training loop of the port.

Port of ``repro/train/loop.py::Trainer``:

- periodic checkpoints (asynchronous, atomic, keep-last-N) with surfaced
  save failures: the writer retries with backoff and a checkpoint that
  still cannot be written is declared LOST (logged and recorded in
  ``events``) instead of pretending success; a lost checkpoint never rolls
  training back, it only widens the replay window of the next recovery;
- restore-and-continue after a failed step, falling back through the
  checkpoints newest first until one passes ``verify``;
- deterministic replay: recovery seeks the data source to the restored
  step (``data.ReplayableStream``), and step t's random draws are a pure
  function of (seed, t) (``train.step``), so a faulted run ends bitwise
  equal to an uninterrupted one;
- straggler hook: a per-step (M,) worker mask goes into the SASG
  selection rule as ``force_skip`` (the algorithm's own M_c path is the
  mitigation, DESIGN.md §5);
- hooks (``_pre_step`` / ``_fetch_batch`` / ``_force_skip``, the save
  failure armed in ``_ckpt_fail_attempts``, and ``fault_hook(step)``,
  which may raise before a step) are the surface that
  ``train.elastic.ElasticTrainer`` drives for in-run membership resizes
  and fault injection (``train.faults``).

In a multi-process run (``BuiltStep.group``) every rank runs the loop on
the same counters and only rank 0 logs. Its checkpoints hold what a
one-process run saves: every rank gathers the full logical arrays
(``BuiltStep.gather_state``: worker state over the worker axis, TP shards
over the model axis) and rank 0 writes them, with the mesh's axes and
shape and the strategy's name in the manifest's meta. A restore, onto
any mesh or none, reads those arrays and places each leaf by the new
run's specs (``BuiltStep.place_state``): equal worker membership carries
the worker state bitwise, a changed one cold-starts it from the restored
params (``core.error_feedback.worker_dims_match``; DESIGN.md §5). Such a
run does not recover from a failed step: the ranks' collectives pair up
by call order, so a rank that restarted alone would exchange its step-0
payloads with the others' step-t ones. Any failure on one rank ends the
whole group.

A kernel fault ends the run. The recovery branch re-raises
``KernelBuildError``, ``KernelLaunchError``, any other error raised inside
``repro_torch.kernels`` (a wrapper refusing its inputs) and CUDA, cuDNN or
cuBLAS runtime errors instead of restoring: a refusal is deterministic, so
a replay only repeats it; a CUDA error is sticky for the context (every
later call on it fails too); and a replay that succeeded after either
would have hidden a broken kernel behind a restore, or run on another path
than the one under test. Such a fault reaches the caller (a non-zero exit from
``launch/train.py``).
"""
from __future__ import annotations

import os
import re
import time
import traceback
from dataclasses import dataclass
from typing import Callable, Iterator, Optional

import torch

from repro_torch.core.error_feedback import worker_dims_match
from repro_torch.kernels import build as _kernels_build
from repro_torch.kernels.build import KernelBuildError, KernelLaunchError

from . import checkpoint as CKPT
from .step import BuiltStep, TrainState


@dataclass
class TrainerConfig:
    total_steps: int = 100
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 50
    ckpt_keep: int = 3
    ckpt_async: bool = True
    log_every: int = 10
    max_restarts: int = 3
    record_batches: bool = False  # log (step, fingerprint) per applied batch


_KERNELS_DIR = os.path.dirname(os.path.abspath(_kernels_build.__file__)) + os.sep
_CUDA_RUNTIME = re.compile(r"CUDA|cuDNN|CUDNN|cuBLAS|CUBLAS")


def _raised_in_kernels(e: BaseException) -> bool:
    """True when the error was raised by code of ``repro_torch.kernels``."""
    return any(os.path.abspath(frame.f_code.co_filename).startswith(_KERNELS_DIR)
               for frame, _ in traceback.walk_tb(e.__traceback__))


def is_kernel_fault(e: BaseException, device: torch.device) -> bool:
    """True for an error that must end the run rather than be recovered
    from: a kernel that did not build or launch, a kernel wrapper that
    refused its inputs, or a CUDA, cuDNN or cuBLAS runtime error."""
    if isinstance(e, (KernelBuildError, KernelLaunchError)) or _raised_in_kernels(e):
        return True
    accel = getattr(torch, "AcceleratorError", None)
    if accel is not None and isinstance(e, accel):
        return True
    return (device.type == "cuda" and isinstance(e, RuntimeError)
            and _CUDA_RUNTIME.search(str(e)) is not None)


def _silent(msg: str) -> None:
    pass


class Trainer:
    def __init__(
        self,
        built: BuiltStep,
        data: Iterator[dict],
        cfg: TrainerConfig,
        fault_hook: Optional[Callable[[int], None]] = None,
        log_fn: Callable[[str], None] = print,
    ):
        group = built.group
        self._multi_process = group is not None and group.world_size > 1
        self._writer = group is None or group.rank == 0
        self.built = built
        self.data = data
        self.cfg = cfg
        self.fault_hook = fault_hook
        self.log = log_fn if group is None or group.rank == 0 else _silent
        self._save_handle: Optional[CKPT.SaveHandle] = None
        self._ckpt_fail_attempts = 0  # armed by fault injection (save_fail)
        self._seed = 0
        self._warned_unseekable = False
        self.history: list[dict] = []
        self.events: list[dict] = []      # recoveries, lost checkpoints
        self.batch_log: list[tuple] = []  # (step, fingerprint) when recording

    # -- checkpointing -----------------------------------------------------

    def _membership(self) -> list:
        """The worker-membership identity of this run: ``Strategy.
        membership`` with the run's M (a multiple of the worker axis's
        size)."""
        s = self.built.strategy
        return [s.uses_shard_map, list(s.worker_axes), self.built.num_workers]

    def _ckpt_meta(self) -> dict:
        # the restore needs the worker membership to decide whether the
        # SASG worker state can be carried or must be re-initialized
        mesh = self.built.mesh
        return {"num_workers": self.built.num_workers, "membership": self._membership(),
                "mesh_axes": list(mesh.mesh_dim_names), "mesh_shape": list(mesh.shape),
                "strategy": self.built.strategy.name}

    def _lost(self, step: int, e: CKPT.CheckpointSaveError):
        self.log(f"[trainer] checkpoint LOST: {e}")
        self.events.append({"kind": "ckpt_lost", "step": step, "error": str(e.cause)})

    def _join_save(self):
        """Wait for the save in flight; a lost checkpoint is an event, not a
        training error."""
        if self._save_handle is None:
            return
        handle, self._save_handle = self._save_handle, None
        try:
            handle.join()
        except CKPT.CheckpointSaveError as e:
            self._lost(handle.step, e)

    def _maybe_ckpt(self, state: TrainState, step: int, force=False):
        c = self.cfg
        if not c.ckpt_dir:
            return
        if force or (step > 0 and step % c.ckpt_every == 0):
            full = self.built.gather_state(state)   # every rank takes part
            if not self._writer:
                return
            self._join_save()  # backpressure: one save in flight
            fail_attempts, self._ckpt_fail_attempts = self._ckpt_fail_attempts, 0
            try:
                handle = CKPT.save(full, c.ckpt_dir, step, blocking=not c.ckpt_async,
                                   meta=self._ckpt_meta(), fail_attempts=fail_attempts)
            except CKPT.CheckpointSaveError as e:  # blocking save exhausted its retries
                self._lost(step, e)
            else:
                if c.ckpt_async:
                    self._save_handle = handle
            CKPT.gc_old(c.ckpt_dir, c.ckpt_keep)

    def _restore_latest(self, template: Optional[TrainState],
                        template_at: Optional[Callable] = None) -> tuple:
        """The newest *verified* checkpoint, falling back through older ones
        when verification fails (corrupt or truncated files). With
        ``template_at``, the template comes from ``template_at(num_workers)``
        once a checkpoint is chosen, with the worker count it was saved at
        (None when its manifest has none); ``template`` is what is returned
        when no checkpoint restores."""
        c = self.cfg
        if not c.ckpt_dir:
            return template, 0
        for step in CKPT.candidate_steps(c.ckpt_dir):
            if not CKPT.verify(c.ckpt_dir, step):
                self.log(f"[trainer] checkpoint step_{step} failed verification; "
                         "trying an older one")
                continue
            meta = CKPT.manifest_meta(c.ckpt_dir, step)
            saved_m = meta.get("num_workers")
            if template_at is not None:
                template = template_at(saved_m)
            full = CKPT.restore(self.built.gather_state(template), c.ckpt_dir, step)
            m = self.built.num_workers
            state = self.built.place_state(full)
            same = (meta.get("membership", [True, ["data"], saved_m]) == self._membership()
                    and worker_dims_match(full.wstate, m))
            if saved_m is not None and not same and self.built.init_worker is not None:
                # the checkpoint's workers are gone: their per-worker state
                # restored as template values; start it afresh from the
                # RESTORED params
                state = state._replace(wstate=self.built.init_worker(state.params))
                what = (f"worker count changed {saved_m} -> {m}" if saved_m != m else
                        f"worker membership changed {meta.get('membership')} -> "
                        f"{self._membership()}")
                self.log(f"[trainer] {what}; re-initialized SASG worker state from "
                         "restored params")
            self.log(f"[trainer] restored checkpoint at step {step}")
            return state, step
        return template, 0

    # -- hooks ---------------------------------------------------------------

    def _pre_step(self, state: TrainState, step: int) -> TrainState:
        if self.fault_hook is not None:
            self.fault_hook(step)  # may raise
        return state

    def _fetch_batch(self, step: int) -> dict:
        """Replayable sources are indexed by step; plain iterators consumed."""
        if hasattr(self.data, "batch_at"):
            return self.data.batch_at(step)
        return next(self.data)

    def _force_skip(self, step: int) -> Optional[torch.Tensor]:
        """(M,) bool straggler mask of the global M on the step's device, or
        None (no stragglers)."""
        return None

    def _seek(self, step: int, initial: bool = False):
        if hasattr(self.data, "seek"):
            self.data.seek(step)
        elif initial and step == 0:
            pass  # a fresh iterator at a fresh start: nothing to rewind
        elif not self._warned_unseekable:
            self._warned_unseekable = True
            self.log("[trainer] WARNING: data source is not seekable; batches "
                     "between the restored checkpoint and the failure are lost "
                     "(use repro_torch.data.ReplayableStream for exact replay)")

    def _recover(self) -> tuple[TrainState, int]:
        # the restore template comes from the caller's seed, so a recovery
        # with no checkpoint restarts the same run
        state, step = self._restore_latest(self.built.init(self._seed))
        self._seek(step)
        return state, step

    # -- main loop -----------------------------------------------------------

    def run(self, seed: int = 0, state: Optional[TrainState] = None) -> TrainState:
        c = self.cfg
        self._seed = seed
        if state is None:
            state = self.built.init(seed)
        state, start = self._restore_latest(state)
        self._seek(start, initial=True)
        step = start
        restarts = 0
        while step < c.total_steps:
            try:
                state = self._pre_step(state, step)
                batch = self._fetch_batch(step)
                state, mets = self.built.step(state, batch, self._force_skip(step))
                row = {k: float(v) for k, v in mets.items()}
                self.history.append(row)
                if step % c.log_every == 0 or step == c.total_steps - 1:
                    self.log(
                        f"[trainer] step {step:5d} loss {row['loss']:8.4f} "
                        f"sent {row['num_sent']:4.0f}/{self.built.num_workers} "
                        f"rounds {row['rounds_total']:9.0f} "
                        f"bits(paper) {row['bits_paper_total']:.3e}"
                    )
                if c.record_batches:
                    from repro_torch.data.replay import batch_fingerprint

                    self.batch_log.append((step, batch_fingerprint(batch)))
                step += 1
                self._maybe_ckpt(state, step)
            except KeyboardInterrupt:
                self._join_save()
                raise
            except Exception as e:  # node or data failure: recover
                restarts += 1
                if (is_kernel_fault(e, self.built.device) or self._multi_process
                        or restarts > c.max_restarts):
                    self._join_save()  # no writer outlives the run
                    raise
                t0 = time.monotonic()
                self.log(f"[trainer] step {step} failed ({type(e).__name__}: {e}); "
                         f"recovering ({restarts}/{c.max_restarts})")
                self._join_save()  # commit (or mourn) the save in flight first
                state, new_step = self._recover()
                self.events.append({
                    "kind": "recovery", "failed_step": step, "restored_step": new_step,
                    "steps_lost": step - new_step, "error": type(e).__name__,
                    "latency_s": time.monotonic() - t0,
                })
                step = new_step
        self._maybe_ckpt(state, step, force=True)
        self._join_save()
        if self._multi_process and self.cfg.ckpt_dir:
            # no rank goes on (to a restore, say) before rank 0's save is in place
            from repro_torch.comm import collectives

            collectives.barrier(self.built.group)
        return state
