"""Host-side data pipeline: a background prefetch thread that puts batches
on the device.

Port of ``repro/data/pipeline.py::ShardedLoader`` for one device. A
bounded queue of ``prefetch`` batches decouples host data generation from
the device's step time. Each array is copied into pinned host memory and
sent to the card with a ``non_blocking`` copy, so the copy overlaps the
host's work; on ``device="cpu"`` the arrays become tensors in place. The
loader runs on ``cuda`` unless the caller asks for the CPU, and raises
without a card; it never falls back to the CPU.

Failure contract: an exception in the prefetch thread reaches the consumer
as a poison item, and the next ``__next__`` re-raises it (never a silent
end of stream); an exhausted source ends with ``StopIteration``.
``close()`` unblocks and joins the thread, so none outlives the consumer.
"""
from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np
import torch


class _Poison:
    """Carries the prefetch thread's exception to the consumer."""

    __slots__ = ("exc",)

    def __init__(self, exc: BaseException):
        self.exc = exc


_END = object()  # source exhausted: StopIteration at the consumer
_PUT_POLL_S = 0.1  # the thread's put() polls so close() can always unblock it


class ShardedLoader:
    def __init__(self, source: Iterator[dict], device=None, prefetch: int = 2):
        from repro_torch.train.step import resolve_device

        self.source = source
        self.device = resolve_device(device)
        self._q: queue.Queue = queue.Queue(maxsize=max(prefetch, 1))
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _place(self, batch: dict) -> dict:
        out = {}
        for k, v in batch.items():
            t = torch.from_numpy(np.ascontiguousarray(v))
            if self.device.type == "cuda":
                t = t.pin_memory().to(self.device, non_blocking=True)
            out[k] = t
        return out

    def _put(self, item) -> bool:
        """Bounded put that close() can interrupt."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=_PUT_POLL_S)
                return True
            except queue.Full:
                continue
        return False

    def _worker(self):
        try:
            for batch in self.source:
                if self._stop.is_set() or not self._put(self._place(batch)):
                    return
        except Exception as e:  # handed to the consumer, which re-raises it
            self._put(_Poison(e))
        else:
            self._put(_END)

    def __iter__(self):
        return self

    def __next__(self) -> dict:
        item = self._q.get()
        if item is _END:
            raise StopIteration
        if isinstance(item, _Poison):
            raise item.exc
        return item

    def close(self, timeout: float = 5.0):
        """Stop prefetching, drain the queue and join the thread."""
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
