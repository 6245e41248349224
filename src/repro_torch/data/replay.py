"""Step-indexed, replayable token and classification streams (numpy, host
side).

Port of ``repro/data/replay.py::{ReplayableStream, indexed_token_stream,
indexed_classification_stream, batch_fingerprint}``: batch ``t`` is a pure
function of ``(seed, t)``, drawn from ``np.random.default_rng((seed, tag,
t))`` with the JAX package's domain-separation tag, so both packages see
byte-identical batches. The Trainer seeks the cursor to the restored step
after a recovery, so a faulted run consumes exactly the batches of an
uninterrupted one.
"""
from __future__ import annotations

import hashlib
from typing import Callable, Iterator

import numpy as np

_TOKEN_TAG = 0x70CE
_CLASS_TAG = 0xC1A5


class ReplayableStream:
    """Step-indexed batch source with a seekable cursor; iterating yields
    ``batch_fn(cursor)`` and advances."""

    def __init__(self, batch_fn: Callable[[int], dict], start: int = 0):
        self._fn = batch_fn
        self._cursor = int(start)

    @property
    def cursor(self) -> int:
        return self._cursor

    def seek(self, step: int) -> None:
        if step < 0:
            raise ValueError(f"cannot seek to negative step {step}")
        self._cursor = int(step)

    def batch_at(self, step: int) -> dict:
        """The batch consumed at training step ``step`` (pure; cursor-free)."""
        return self._fn(int(step))

    def __iter__(self) -> Iterator[dict]:
        return self

    def __next__(self) -> dict:
        batch = self._fn(self._cursor)
        self._cursor += 1
        return batch


def indexed_token_stream(
    vocab: int, batch: int, seq: int, seed: int = 0,
    bigram_order: float = 0.8,
) -> ReplayableStream:
    """Tokens with a planted bigram structure (one fixed successor table
    per seed); batch ``t`` from an rng keyed on ``(seed, t)``. The JAX
    package's numpy calls in its order, so both give the same bytes."""
    trans = np.random.default_rng(seed).permutation(vocab)

    def batch_fn(step: int) -> dict:
        rng = np.random.default_rng((seed, _TOKEN_TAG, step))
        toks = np.empty((batch, seq + 1), np.int32)
        toks[:, 0] = rng.integers(0, vocab, size=batch)
        follow = rng.random(size=(batch, seq)) < bigram_order
        rand_next = rng.integers(0, vocab, size=(batch, seq))
        for t in range(seq):
            nxt = trans[toks[:, t]]
            toks[:, t + 1] = np.where(follow[:, t], nxt, rand_next[:, t])
        return {"tokens": toks[:, :-1].copy(), "labels": toks[:, 1:].copy()}

    return ReplayableStream(batch_fn)


def indexed_classification_stream(
    x: np.ndarray, y: np.ndarray, batch: int, seed: int = 0
) -> ReplayableStream:
    n = x.shape[0]

    def batch_fn(step: int) -> dict:
        rng = np.random.default_rng((seed, _CLASS_TAG, step))
        idx = rng.integers(0, n, size=batch)
        return {"x": x[idx], "labels": y[idx]}

    return ReplayableStream(batch_fn)


def batch_fingerprint(batch: dict) -> str:
    """Content hash of one batch (key-order independent), equal to the JAX
    package's for the same arrays; tensors are hashed as their host copy."""
    h = hashlib.md5()
    for k in sorted(batch):
        v = batch[k]
        v = v.detach().cpu().numpy() if hasattr(v, "detach") else np.asarray(v)
        h.update(k.encode())
        h.update(str(v.dtype).encode())
        h.update(str(v.shape).encode())
        h.update(np.ascontiguousarray(v).tobytes())
    return h.hexdigest()
