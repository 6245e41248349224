"""Checkpoints of training state: one ``.npy`` per leaf and a manifest.

Port of ``repro/train/checkpoint.py``, in the same on-disk format, so a
tree saved by either package restores through the other:
``<dir>/step_<N>/`` holds one ``.npy`` per tree leaf (flatten order) and a
``manifest.json`` with each leaf's name, file, shape, dtype and md5, the
step, and a caller ``meta`` dict (the Trainer records the worker count, so
a restore knows when to re-initialize per-worker state).

- Writes are atomic: a ``.tmp`` directory renamed into place.
- Saves may be asynchronous: the device-to-host copy is taken on the
  caller's thread, *before* the writer thread starts, so the trainer may
  go on changing its state at once; only the file writes run behind it.
- The writer retries with exponential backoff; if every attempt fails, the
  handle's ``join()`` raises :class:`CheckpointSaveError`.
- ``restore`` puts each leaf on its template leaf's device and dtype. A
  leaf whose saved shape differs (worker-stacked state saved at another
  worker count) falls back to the template's value.

numpy has no bfloat16 of its own: a bf16 leaf is saved as float32 (exact)
and cast back on restore; a bf16 ``.npy`` written by the JAX package
(``ml_dtypes``) is read through float32 too.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
import time
from typing import Any, List, Optional

import numpy as np
import torch

from repro_torch.core.types import Tree, tree_flatten, tree_flatten_with_paths, tree_unflatten


class CheckpointSaveError(RuntimeError):
    """Raised from ``SaveHandle.join()`` when every write attempt failed."""

    def __init__(self, step: int, cause: BaseException):
        super().__init__(
            f"checkpoint step_{step} could not be written: "
            f"{type(cause).__name__}: {cause}"
        )
        self.step = step
        self.cause = cause


class SaveHandle:
    """Handle of a save. ``join()`` re-raises the writer's failure."""

    def __init__(self, thread: threading.Thread, step: int):
        self._thread = thread
        self.step = step
        self.error: Optional[CheckpointSaveError] = None

    def join(self, timeout: Optional[float] = None) -> None:
        self._thread.join(timeout)
        if self.error is not None:
            raise self.error

    def is_alive(self) -> bool:
        return self._thread.is_alive()


def _md5(a: np.ndarray) -> str:
    return hashlib.md5(np.ascontiguousarray(a).tobytes()).hexdigest()


def to_host(tree: Tree) -> list:
    """``[(name, numpy array)]`` of the tree's leaves in flatten order: the
    device-to-host copy of a save (a copy on the CPU too, so the caller may
    change its tensors while the writer runs). bf16 goes through float32."""
    paths, leaves, _ = tree_flatten_with_paths(tree)
    out = []
    for path, leaf in zip(paths, leaves):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        out.append((path.replace("/", "_"), t.to("cpu", copy=True).numpy()))
    return out


def _write(host: list, directory: str, step: int, meta: Optional[dict]) -> None:
    """One write attempt of ``<directory>/step_<step>``: the leaves and the
    manifest into a ``.tmp`` directory, then renamed into place."""
    final = os.path.join(directory, f"step_{step}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):  # debris of an earlier failed attempt
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    manifest = {"step": step, "meta": dict(meta or {}), "leaves": []}
    for i, (name, leaf) in enumerate(host):
        fname = f"{i:05d}.npy"
        np.save(os.path.join(tmp, fname), leaf)
        manifest["leaves"].append({
            "name": name, "file": fname, "shape": list(leaf.shape),
            "dtype": str(leaf.dtype), "crc": _md5(leaf),
        })
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)


def save(
    tree: Any,
    directory: str,
    step: int,
    blocking: bool = True,
    meta: Optional[dict] = None,
    retries: int = 2,
    backoff: float = 0.05,
    fail_attempts: int = 0,
) -> SaveHandle:
    """Serialize ``tree`` to ``<directory>/step_<step>``; returns a handle.

    ``meta`` is stored verbatim in the manifest (JSON-serializable).
    ``fail_attempts`` injects faults (``train.faults``' save_fail): the
    first N write attempts raise before touching the disk and count
    against ``retries``."""
    host = to_host(tree)

    def _run():
        last: Optional[BaseException] = None
        for attempt in range(retries + 1):
            try:
                if attempt < fail_attempts:
                    raise OSError(f"injected save failure (attempt {attempt + 1})")
                _write(host, directory, step, meta)
                return
            except Exception as e:  # any write failure: retry, then report via join()
                last = e
                shutil.rmtree(os.path.join(directory, f"step_{step}.tmp"), ignore_errors=True)
                if attempt < retries:
                    time.sleep(backoff * (2 ** attempt))
        handle.error = CheckpointSaveError(step, last)

    t = threading.Thread(target=_run)
    handle = SaveHandle(t, step)
    t.start()
    if blocking:
        handle.join()
    return handle


def candidate_steps(directory: str) -> List[int]:
    """Committed checkpoint steps, newest first: the restore fallback order.
    In-flight ``.tmp`` writes and manifest-less debris are never candidates."""
    if not os.path.isdir(directory):
        return []
    steps = []
    for d in os.listdir(directory):
        if d.startswith("step_") and not d.endswith(".tmp"):
            if os.path.exists(os.path.join(directory, d, "manifest.json")):
                steps.append(int(d.split("_")[1]))
    return sorted(steps, reverse=True)


def latest_step(directory: str) -> Optional[int]:
    steps = candidate_steps(directory)
    return steps[0] if steps else None


def manifest_meta(directory: str, step: int) -> dict:
    """The ``meta`` dict recorded at save time ({} when there is none)."""
    try:
        with open(os.path.join(directory, f"step_{step}", "manifest.json")) as f:
            manifest = json.load(f)
        return dict(manifest.get("meta") or {})
    except (OSError, json.JSONDecodeError):
        return {}


def verify(directory: str, step: int) -> bool:
    """Every leaf file loads and matches its manifest checksum."""
    path = os.path.join(directory, f"step_{step}")
    try:
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        return all(_md5(np.load(os.path.join(path, e["file"]))) == e["crc"]
                   for e in manifest["leaves"])
    except (OSError, json.JSONDecodeError, KeyError, ValueError):
        # ValueError: np.load of a truncated or garbled .npy
        return False


def _as_float(arr: np.ndarray) -> np.ndarray:
    """A bf16 array (``ml_dtypes``, or raw 2-byte records when that module
    is not loaded) as float32; anything else unchanged."""
    if arr.dtype.name == "bfloat16" or (arr.dtype.kind == "V" and arr.dtype.itemsize == 2):
        bits = arr.view(np.uint16).astype(np.uint32) << 16
        return bits.view(np.float32)
    return arr


def restore(template: Any, directory: str, step: int) -> Any:
    """Restore into the structure of ``template``, each leaf on its template
    leaf's device and dtype. A leaf whose shape mismatches (worker-stacked
    state saved at another worker count) falls back to the template's
    value."""
    path = os.path.join(directory, f"step_{step}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    files = [e["file"] for e in manifest["leaves"]]
    t_leaves, treedef = tree_flatten(template)
    if len(files) != len(t_leaves):
        raise ValueError(f"checkpoint has {len(files)} leaves, template has {len(t_leaves)}")
    out = []
    for f, t in zip(files, t_leaves):
        arr = np.load(os.path.join(path, f))
        if tuple(arr.shape) != tuple(t.shape):
            out.append(t)
            continue
        out.append(torch.from_numpy(np.array(_as_float(arr))).to(device=t.device, dtype=t.dtype))
    return tree_unflatten(treedef, out)


def gc_old(directory: str, keep: int = 3):
    """Drop all but the newest ``keep`` committed checkpoints. Safe against
    an in-flight save: ``.tmp`` directories are never candidates, and a
    rename landing mid-GC only adds a step in the kept set."""
    steps = sorted(candidate_steps(directory))
    for s in steps[:-keep] if keep > 0 else steps:
        shutil.rmtree(os.path.join(directory, f"step_{s}"), ignore_errors=True)
