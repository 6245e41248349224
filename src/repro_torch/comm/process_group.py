"""The worker group: P processes, each holding M/P of the M stacked workers.

The port's stand-in for ``repro/launch/mesh.py``'s role on the flat
strategy's worker axis (the JAX package's ``shard_map`` over the worker
mesh axes). Rank r holds workers ``r*M/P .. (r+1)*M/P - 1`` as a stacked
leading dim; the exchange all-gathers their payloads
(``comm.collectives``). On a ``DeviceMesh`` over the group,
``axis_group`` gives the sub-group of one mesh axis: the worker axis the
exchange gathers over, the model axis the params are gathered over. Every
``torch.distributed`` call of the port lives in ``repro_torch.comm``.

A group is made in one of two ways:

- ``from_env``: in a process started by ``torchrun``, from its ``RANK``,
  ``WORLD_SIZE``, ``LOCAL_RANK`` and rendezvous address;
- ``spawn``: the launcher starts P processes (``spawn`` start method) and
  gives each a rendezvous that cannot clash with another run's: a
  ``FileStore`` in a fresh temporary directory. It joins them within a
  stated timeout, kills what is left and raises on any rank's failure.

Backends:

- ``gloo``, the paper's own transport ("GLOO point-to-point", Table 3):
  payloads are staged to the host before each collective and moved back
  to the rank's device after it;
- ``nccl``: device tensors. NCCL refuses two ranks on one card, so a group
  with more ranks on a host than it has cards raises; it never falls back
  to gloo.

Every group has a stated ``timeout`` (``DEFAULT_TIMEOUT_S``), so a rank
that dies ends the run instead of hanging the others in a collective.
"""
from __future__ import annotations

import datetime
import multiprocessing as mp
import os
import queue
import shutil
import tempfile
import time
import traceback
from dataclasses import dataclass
from typing import Any, Callable, Sequence

import torch
import torch.distributed as dist

BACKENDS = ("gloo", "nccl")
DEFAULT_TIMEOUT_S = 60.0        # a collective waits this long for a dead rank
DEFAULT_JOIN_TIMEOUT_S = 900.0  # a spawned run ends within this, or is killed


@dataclass(frozen=True)
class WorkerGroup:
    rank: int
    world_size: int
    backend: str             # "gloo" | "nccl"
    device: torch.device     # this rank's device
    pg: Any = None           # the torch process group (None: the world)
    # the mesh axes it spans, which the wire log's rows name (the world:
    # the data axis of the flat mesh build_train_step makes of it)
    axes: tuple = ("data",)

    def workers(self, num_workers: int) -> tuple[int, int]:
        """``(start, count)`` of this rank's workers out of ``num_workers``."""
        if num_workers % self.world_size:
            raise ValueError(f"{num_workers} workers do not split over "
                             f"{self.world_size} processes")
        count = num_workers // self.world_size
        return self.rank * count, count


def axis_group(group: WorkerGroup, mesh, axis: str) -> WorkerGroup:
    """The ranks of ``group`` that differ only in their coordinate on one
    axis of the ``DeviceMesh`` ``mesh`` (this rank's slice along it), as a
    ``WorkerGroup`` over that axis's process group."""
    names = tuple(mesh.mesh_dim_names)
    return WorkerGroup(mesh.get_local_rank(axis), tuple(mesh.shape)[names.index(axis)],
                       group.backend, group.device, mesh.get_group(axis), (axis,))


def default_backend(device_type: str) -> str:
    return "nccl" if device_type == "cuda" else "gloo"


def rank_device(device_type: str, local_rank: int) -> torch.device:
    """Rank r's device: ``cuda:(local_rank % device_count)`` on the card
    (several gloo ranks may share one), else the CPU."""
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("a cuda worker group needs a CUDA device; none is available")
        return torch.device("cuda", local_rank % torch.cuda.device_count())
    return torch.device(device_type)


def check_backend(backend: str, device_type: str, ranks_on_host: int) -> None:
    """Refuse what the backend cannot run: an unknown backend, nccl off the
    card, or more nccl ranks on a host than it has cards."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; have {BACKENDS}")
    if backend != "nccl":
        return
    if device_type != "cuda":
        raise ValueError("the nccl backend exchanges device tensors: it needs --device cuda")
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if ranks_on_host > cards:
        raise ValueError(
            f"nccl: {ranks_on_host} ranks on a host with {cards} CUDA device(s); NCCL "
            "refuses two ranks on one device. Use --backend gloo to share a card, or "
            "fewer processes")


def _init(backend: str, rank: int, world_size: int, device: torch.device,
          timeout_s: float, **rendezvous) -> WorkerGroup:
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, rank=rank, world_size=world_size,
                            timeout=datetime.timedelta(seconds=timeout_s), **rendezvous)
    # every rank has joined before any goes on: a rank that finishes early
    # and tears its group down must not cut a late rank's connections
    dist.barrier()
    return WorkerGroup(rank, world_size, backend, device)


def from_env(backend: str | None, device_type: str,
             timeout_s: float = DEFAULT_TIMEOUT_S) -> WorkerGroup:
    """The group of a process started by torchrun (its ``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE`` and
    ``MASTER_ADDR``/``MASTER_PORT``)."""
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    backend = backend or default_backend(device_type)
    check_backend(backend, device_type, int(os.environ.get("LOCAL_WORLD_SIZE", world)))
    return _init(backend, rank, world, rank_device(device_type, local_rank), timeout_s,
                 init_method="env://")


def launched_by_torchrun() -> bool:
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def destroy() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def _bootstrap(fn, args, rank, world_size, backend, device_type, store_path, timeout_s,
               deterministic, results):
    """Body of a spawned rank: join the group, run ``fn(group, *args)``,
    report ``(rank, ok, result or traceback)``."""
    try:
        torch.use_deterministic_algorithms(deterministic)
        if device_type == "cpu":   # the ranks share the host's cores
            torch.set_num_threads(max(1, (os.cpu_count() or 1) // world_size))
        store = dist.FileStore(store_path, world_size)
        group = _init(backend, rank, world_size, rank_device(device_type, rank),
                      timeout_s, store=store)
        try:
            out = fn(group, *args)
        finally:
            destroy()
        results.put((rank, True, out))
    except Exception:  # reported to the launcher, which raises it
        results.put((rank, False, traceback.format_exc()))


def spawn(fn: Callable, nprocs: int, backend: str | None, device_type: str,
          args: Sequence = (), timeout_s: float = DEFAULT_TIMEOUT_S,
          join_timeout_s: float = DEFAULT_JOIN_TIMEOUT_S) -> list:
    """Run ``fn(group, *args)`` in ``nprocs`` new processes of one group and
    return their results in rank order. ``fn`` must be importable (a
    module-level function) and return something picklable. The ranks
    inherit the caller's deterministic-algorithms setting; CPU ranks split
    the host's cores between them. Raises the first
    failing rank's traceback, or ``TimeoutError`` when the ranks are not
    done within ``join_timeout_s``; either way no rank outlives the call."""
    backend = backend or default_backend(device_type)
    check_backend(backend, device_type, nprocs)
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    rdv = tempfile.mkdtemp(prefix="repro_torch_group_")
    deterministic = torch.are_deterministic_algorithms_enabled()
    procs = [
        ctx.Process(target=_bootstrap, daemon=True, args=(
            fn, tuple(args), rank, nprocs, backend, device_type,
            os.path.join(rdv, "store"), timeout_s, deterministic, results))
        for rank in range(nprocs)
    ]
    try:
        for p in procs:
            p.start()
        out: dict[int, Any] = {}
        deadline = time.monotonic() + join_timeout_s
        while len(out) < nprocs:
            try:
                rank, ok, value = results.get(timeout=1.0)
            except queue.Empty:
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"{nprocs - len(out)} of {nprocs} ranks not done after "
                        f"{join_timeout_s:.0f} s") from None
                dead = [p for i, p in enumerate(procs)
                        if i not in out and p.exitcode is not None]
                if dead and results.empty():
                    time.sleep(1.0)   # a last result may still be in flight
                    if results.empty():
                        raise RuntimeError(
                            f"rank {procs.index(dead[0])} exited with code "
                            f"{dead[0].exitcode} without a result")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} of {nprocs} failed:\n{value}")
            out[rank] = value
        for p in procs:
            p.join(max(deadline - time.monotonic(), 1.0))
        return [out[r] for r in range(nprocs)]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            if p.pid is not None:
                p.join(10.0)
        results.close()
        shutil.rmtree(rdv, ignore_errors=True)
