"""Fault plans of the chaos harness: which fault strikes at which step.

Port of ``repro/train/faults.py`` (numpy only there too; copied, not
imported). A :class:`FaultPlan` is an immutable schedule of faults keyed
on the training-step index, with a seed: the same plan replays the same
faults, so a faulted run can be held bitwise to a clean one.

Fault kinds and where ``train.elastic.ElasticTrainer`` applies them:

==============  ==========================================================
``crash``        raise :class:`InjectedFault` before the step (node loss;
                 fired once, recovery restores and replays)
``worker_drop``  resize the worker axis down to ``workers`` (stateless:
                 applies again when a replay passes its step)
``worker_join``  resize the worker axis up to ``workers`` (stateless)
``straggler``    force the skip path for ``indices`` over ``duration``
                 steps (the step's ``force_skip`` mask: the algorithm's
                 own M_c path is the mitigation, no recovery involved)
``corrupt_ckpt`` flip bytes in a committed checkpoint leaf (fired once;
                 the restore falls back to the newest *verified* one)
``save_fail``    make the next checkpoint save fail its first ``attempts``
                 write attempts (fired once; up to the writer's retries
                 it recovers, more declares the checkpoint lost without
                 ending the run)
``data_hiccup``  raise :class:`DataStreamError` from the batch fetch
                 (fired once; a replayable stream makes recovery lossless)
==============  ==========================================================

Faults that raise or change the disk fire once: they must not fire again
when recovery rewinds the step past them (a crash loop). Membership and
straggler faults are pure functions of the step and apply again on a
replay, so a rewound run goes through the membership history of an
uninterrupted run.
"""
from __future__ import annotations

import os
from dataclasses import dataclass, replace
from typing import Dict, Optional, Tuple

import numpy as np


class InjectedFault(RuntimeError):
    """A simulated node failure (the crash fault)."""


class DataStreamError(RuntimeError):
    """A simulated input-pipeline failure (the data_hiccup fault)."""


_ONCE_KINDS = frozenset({"crash", "corrupt_ckpt", "save_fail", "data_hiccup"})
_STATELESS_KINDS = frozenset({"worker_drop", "worker_join", "straggler"})
KINDS = _ONCE_KINDS | _STATELESS_KINDS


@dataclass(frozen=True)
class Fault:
    kind: str
    step: int
    workers: int = 0                   # resize target (worker_drop / join)
    indices: Tuple[int, ...] = ()      # straggler worker ids (() = 1 drawn)
    duration: int = 1                  # straggler steps
    attempts: int = 1                  # save_fail's failing write attempts
    target_step: Optional[int] = None  # corrupt_ckpt's victim (None = newest)

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}")
        if self.step < 0:
            raise ValueError(f"fault step must be >= 0, got {self.step}")
        if self.kind in ("worker_drop", "worker_join") and self.workers < 1:
            raise ValueError(f"{self.kind} needs workers >= 1")


@dataclass(frozen=True)
class FaultPlan:
    """Immutable fault schedule. Each fault method returns an extended
    copy, so plans compose by chaining (or ``plan_a + plan_b``)::

        plan = (FaultPlan(seed=7)
                .worker_drop(step=20, to=2)
                .worker_join(step=40, to=4)
                .crash(step=55))
    """

    faults: Tuple[Fault, ...] = ()
    seed: int = 0

    def _with(self, fault: Fault) -> "FaultPlan":
        return replace(self, faults=self.faults + (fault,))

    def crash(self, step: int) -> "FaultPlan":
        return self._with(Fault("crash", step))

    def worker_drop(self, step: int, to: int) -> "FaultPlan":
        return self._with(Fault("worker_drop", step, workers=to))

    def worker_join(self, step: int, to: int) -> "FaultPlan":
        return self._with(Fault("worker_join", step, workers=to))

    def straggler(self, step: int, indices: Tuple[int, ...] = (),
                  duration: int = 1) -> "FaultPlan":
        return self._with(Fault("straggler", step, indices=tuple(indices), duration=duration))

    def corrupt_ckpt(self, step: int, target_step: Optional[int] = None) -> "FaultPlan":
        return self._with(Fault("corrupt_ckpt", step, target_step=target_step))

    def save_fail(self, step: int, attempts: int = 1) -> "FaultPlan":
        return self._with(Fault("save_fail", step, attempts=attempts))

    def data_hiccup(self, step: int) -> "FaultPlan":
        return self._with(Fault("data_hiccup", step))

    def __add__(self, other: "FaultPlan") -> "FaultPlan":
        if self.seed != other.seed:
            raise ValueError("cannot compose FaultPlans with different seeds")
        return replace(self, faults=self.faults + other.faults)

    def __len__(self) -> int:
        return len(self.faults)

    @classmethod
    def single_fault_matrix(cls, step: int = 7, workers: int = 4, save_retries: int = 2,
                            seed: int = 0) -> Dict[str, "FaultPlan"]:
        """The chaos matrix: one fault class a plan, each at ``step`` (best
        strictly between two checkpoint steps, so recovery replays).
        ``corrupt_ckpt`` pairs the byte flip with a crash at the same step:
        a corruption shows only at a restore."""
        return {
            "crash": cls(seed=seed).crash(step),
            "worker_drop": cls(seed=seed).worker_drop(step, to=max(workers // 2, 1)),
            "straggler": cls(seed=seed).straggler(step, duration=2),
            "corrupt_ckpt": cls(seed=seed).corrupt_ckpt(step).crash(step),
            "save_fail_transient": cls(seed=seed).save_fail(step, attempts=save_retries),
            "save_fail_lost": cls(seed=seed).save_fail(step, attempts=save_retries + 2),
            "data_hiccup": cls(seed=seed).data_hiccup(step),
        }


class FaultInjector:
    """Stateful reader of a :class:`FaultPlan` (the ElasticTrainer's).

    Only the fired-once kinds keep state; membership and straggler queries
    are pure functions of the step. A straggler fault with no ``indices``
    strikes the worker drawn by ``default_rng((seed, fault_index))``, the
    JAX package's draw: the same worker in a replay, and in both packages.
    """

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self._fired: set = set()

    def _take(self, step: int, kind: str) -> Optional[Fault]:
        """The first unfired fault of ``kind`` at ``step`` (marked fired)."""
        for i, f in enumerate(self.plan.faults):
            if f.kind == kind and f.step == step and i not in self._fired:
                self._fired.add(i)
                return f
        return None

    # -- stateless (applied again on a replay) ---------------------------

    def resize_to(self, step: int) -> Optional[int]:
        """The worker count a membership event at ``step`` asks for."""
        for f in self.plan.faults:
            if f.kind in ("worker_drop", "worker_join") and f.step == step:
                return f.workers
        return None

    def straggler_mask(self, step: int, num_workers: int) -> Optional[np.ndarray]:
        """(num_workers,) bool force_skip mask, or None when no straggler is
        active at ``step``. A fault is active over [step, step + duration)."""
        mask = None
        for i, f in enumerate(self.plan.faults):
            if f.kind != "straggler" or not (f.step <= step < f.step + f.duration):
                continue
            if mask is None:
                mask = np.zeros(num_workers, bool)
            idx = f.indices or (
                int(np.random.default_rng((self.plan.seed, i)).integers(num_workers)),)
            for w in idx:
                mask[w % num_workers] = True
        return mask

    # -- fired once (never replayed) -------------------------------------

    def crash_at(self, step: int) -> bool:
        return self._take(step, "crash") is not None

    def corrupt_at(self, step: int) -> Optional[Fault]:
        return self._take(step, "corrupt_ckpt")

    def save_fail_attempts(self, step: int) -> int:
        f = self._take(step, "save_fail")
        return f.attempts if f is not None else 0

    def data_hiccup_at(self, step: int) -> bool:
        return self._take(step, "data_hiccup") is not None


def corrupt_checkpoint(ckpt_dir: str, step: Optional[int] = None,
                       rng: Optional[np.random.Generator] = None) -> Optional[int]:
    """Flip bytes in the middle of one leaf file of a committed checkpoint
    (the newest when ``step`` is None). Returns the corrupted step, or None
    when there is no checkpoint. The payload is flipped, not the ``.npy``
    header, so the file still loads: only the checksum catches it. The
    on-disk format is both packages' (``train/checkpoint.py``)."""
    from . import checkpoint as CKPT

    steps = CKPT.candidate_steps(ckpt_dir)
    if not steps:
        return None
    victim = step if step is not None else steps[0]
    path = os.path.join(ckpt_dir, f"step_{victim}")
    npys = sorted(f for f in os.listdir(path) if f.endswith(".npy"))
    if not npys:
        return None
    rng = rng or np.random.default_rng(0)
    fpath = os.path.join(path, npys[int(rng.integers(len(npys)))])
    size = os.path.getsize(fpath)
    with open(fpath, "r+b") as f:
        # clear of the ~128-byte npy header, so np.load still succeeds
        pos = min(max(size // 2, 192), size - 1)
        f.seek(pos)
        chunk = f.read(min(8, size - pos))
        f.seek(pos)
        f.write(bytes(b ^ 0xFF for b in chunk))
    return victim
