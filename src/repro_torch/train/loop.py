"""Training loop of the port: step through a batch source and log.

Port of ``repro/train/loop.py::Trainer.run`` without checkpoints. There is
no recovery branch yet: any exception, a kernel fault included, ends the
run and reaches the caller (a non-zero exit from ``launch/train.py``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Iterator, Optional

from .step import BuiltStep, TrainState


@dataclass
class TrainerConfig:
    total_steps: int = 100
    log_every: int = 10


class Trainer:
    def __init__(
        self,
        built: BuiltStep,
        data: Iterator[dict],
        cfg: TrainerConfig,
        log_fn: Callable[[str], None] = print,
    ):
        self.built = built
        self.data = data
        self.cfg = cfg
        self.log = log_fn
        self.history: list[dict] = []

    def _fetch_batch(self, step: int) -> dict:
        """Replayable sources are indexed by step; plain iterators consumed."""
        if hasattr(self.data, "batch_at"):
            return self.data.batch_at(step)
        return next(self.data)

    def run(self, seed: int = 0, state: Optional[TrainState] = None) -> TrainState:
        c = self.cfg
        if state is None:
            state = self.built.init(seed)
        for step in range(c.total_steps):
            state, mets = self.built.step(state, self._fetch_batch(step))
            row = {k: float(v) for k, v in mets.items()}
            self.history.append(row)
            if step % c.log_every == 0 or step == c.total_steps - 1:
                self.log(
                    f"[trainer] step {step:5d} loss {row['loss']:8.4f} "
                    f"sent {row['num_sent']:4.0f}/{self.built.num_workers} "
                    f"rounds {row['rounds_total']:9.0f} "
                    f"bits(paper) {row['bits_paper_total']:.3e}"
                )
        return state
