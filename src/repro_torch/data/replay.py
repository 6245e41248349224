"""Step-indexed, replayable classification stream (numpy, host side).

Port of ``repro/data/replay.py::{ReplayableStream,
indexed_classification_stream}``: batch ``t`` is a pure function of
``(seed, t)``, drawn from ``np.random.default_rng((seed, tag, t))`` with
the JAX package's domain-separation tag, so both packages see
byte-identical batches.
"""
from __future__ import annotations

from typing import Callable, Iterator

import numpy as np

_CLASS_TAG = 0xC1A5


class ReplayableStream:
    """Step-indexed batch source; iterating yields batches 0, 1, 2, ...
    (the JAX package's seekable cursor comes with checkpoint recovery)."""

    def __init__(self, batch_fn: Callable[[int], dict], start: int = 0):
        self._fn = batch_fn
        self._cursor = int(start)

    def batch_at(self, step: int) -> dict:
        """The batch consumed at training step ``step`` (pure; cursor-free)."""
        return self._fn(int(step))

    def __iter__(self) -> Iterator[dict]:
        return self

    def __next__(self) -> dict:
        batch = self._fn(self._cursor)
        self._cursor += 1
        return batch


def indexed_classification_stream(
    x: np.ndarray, y: np.ndarray, batch: int, seed: int = 0
) -> ReplayableStream:
    n = x.shape[0]

    def batch_fn(step: int) -> dict:
        rng = np.random.default_rng((seed, _CLASS_TAG, step))
        idx = rng.integers(0, n, size=batch)
        return {"x": x[idx], "labels": y[idx]}

    return ReplayableStream(batch_fn)
