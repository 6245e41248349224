"""Mesh execution strategies for the SASG exchange (DESIGN.md §2/§6).

Port of ``repro/dist/strategy.py``. A ``Strategy`` names the role of every
mesh axis for one training run:

- ``upload_axes``: the axes whose slices are the SASG workers. Each slice
  computes its own gradient, runs the LASG send/skip rule, and contributes
  one (possibly cached) compressed upload per step.
- ``grad_axes``: the axes the global batch is split over, a superset of
  ``upload_axes``. The extra axis (in-pod data parallelism) splits a
  worker's rows; the worker's gradient is the mean over those slices.
- ``fsdp_axis`` / ``tp_axis``: parameter sharding (``dist.sharding``).
- ``data_axis``: the data axis *inside* the worker region (None when
  workers are the finest data split).

Three strategies:

- ``"flat"``: every data-axis slice is a worker (the paper's M-worker
  setting). Params are worker-replicated and TP-sharded over ``tp_axis``.
- ``"hierarchical"``: on 3-D pod meshes each pod is one worker; the in-pod
  ``data`` axis splits its rows. TP-only parameter sharding: the JAX
  package forces ``fsdp_axis`` None there (an XLA partitioner limit), and
  the port keeps the same choice so both pick the same layout.
- ``"plain"``: dense data-parallel SGD without the SASG exchange. Used as
  the non-SASG baseline and whenever one worker replica of the parameters
  (plus SASG worker state) does not fit beside the TP shards.

A mesh is anything with ``mesh_dim_names`` and ``shape``: a torch
``DeviceMesh`` or the one-process ``launch.mesh.StackedMesh``. The
pipeline fields (``stage_axis``, ``pipeline_stages``, ``microbatches``)
are chosen as in the JAX package; ``dist/pipeline.py`` runs them.

The replica budget is the device's own memory: ``total_memory`` of the
mesh's CUDA device, or the host's physical memory on a CPU mesh
(``default_replica_budget``).
"""
from __future__ import annotations

import math
import os
from dataclasses import dataclass
from typing import Optional, Tuple, Union

import torch

Axis = Union[str, Tuple[str, ...], None]

# Per-worker replica cost model for the fit check: each SASG worker holds
# the fp32 parameters plus error-feedback and stale-parameter buffers of the
# same footprint: ~3x params_bytes, sharded only over the TP axis.
REPLICA_OVERHEAD = 3.0


def axis_sizes(mesh) -> dict:
    """``{axis name: size}`` of a ``DeviceMesh`` or a ``StackedMesh``."""
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


def default_replica_budget(mesh=None) -> int:
    """Bytes one device offers a worker replica: the CUDA device's
    ``total_memory`` on a card's mesh, else the host's physical memory."""
    dev = getattr(mesh, "device_type", "cpu")
    if dev == "cuda":
        return int(torch.cuda.get_device_properties(torch.cuda.current_device()).total_memory)
    return int(os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES"))


@dataclass(frozen=True)
class Strategy:
    name: str                      # "flat" | "hierarchical" | "plain"
    upload_axes: Tuple[str, ...]   # worker axes (empty for plain)
    grad_axes: Tuple[str, ...]     # axes the global batch is split over
    fsdp_axis: Axis
    data_axis: Axis                # data axis inside the worker region
    tp_axis: Axis
    num_workers: int
    stage_axis: Optional[str] = None  # pipeline axis (None = no PP)
    pipeline_stages: int = 1       # size of stage_axis (1 = no pipelining)
    microbatches: int = 0          # GPipe microbatches (0 -> pipeline_stages)

    @property
    def uses_shard_map(self) -> bool:
        """True when the workers run the SASG exchange (the JAX package's
        manual shard_map region)."""
        return bool(self.upload_axes)

    @property
    def pipelined(self) -> bool:
        return self.stage_axis is not None and self.pipeline_stages > 1

    @property
    def worker_axes(self) -> Tuple[str, ...]:
        return tuple(self.upload_axes)

    @property
    def batch_axes(self) -> Tuple[str, ...]:
        return tuple(self.grad_axes)

    @property
    def membership(self) -> Tuple[bool, Tuple[str, ...], int]:
        """Worker-membership identity: (uses_shard_map, worker_axes, M).

        Two strategies with equal membership address the same worker set,
        so a restore between them carries the SASG worker state bitwise
        (pure resharding); unequal membership means the per-worker EF and
        stale buffers are re-initialized (DESIGN.md §5)."""
        return (self.uses_shard_map, self.worker_axes, self.num_workers)

    @property
    def inner_dp(self) -> Optional[str]:
        """The data axis inside the worker region, if any."""
        if not self.uses_shard_map or self.data_axis is None:
            return None
        if self.data_axis in self.upload_axes:
            return None
        return self.data_axis if isinstance(self.data_axis, str) else None


def worker_replication_fits(
    params_bytes: Optional[int],
    tp_size: int,
    budget_bytes: int,
) -> bool:
    """Can one SASG worker replica live beside its TP shard? (<= is a fit:
    the budget is the per-device ceiling, so the boundary value still
    fits.)"""
    if params_bytes is None:
        return True
    return REPLICA_OVERHEAD * params_bytes / max(tp_size, 1) <= budget_bytes


def choose_strategy(
    mesh,
    sasg_enabled: bool = True,
    params_bytes: Optional[int] = None,
    replica_budget_bytes: Optional[int] = None,
    pipeline_stages: int = 1,
    microbatches: int = 0,
    trunk_layers: Optional[int] = None,
) -> Strategy:
    """Pick the execution strategy for a mesh.

    - 3-D pod meshes -> "hierarchical" (pod = worker, TP-only params);
    - 2-D / 1-D data meshes -> "flat" (each data slice is a worker);
    - SASG disabled, or ``params_bytes`` too large to worker-replicate
      within ``replica_budget_bytes`` (default: the device's memory,
      ``default_replica_budget``) -> "plain" (FSDP over every data-like
      axis).

    ``pipeline_stages >= 2`` requests pipelining over the mesh's ``stage``
    axis. The request is dropped when the mesh has no ``stage`` axis, when
    the trunk depth (``trunk_layers``: None = unknown, 0 = no trunk)
    does not divide over it, or when the strategy is "plain"; the
    stage-axis size wins over the requested count.
    """
    names = tuple(mesh.mesh_dim_names)
    sizes = axis_sizes(mesh)
    tp = "model" if "model" in sizes else None
    dp = tuple(a for a in names if a in ("pod", "data"))
    if replica_budget_bytes is None and params_bytes is not None:
        replica_budget_bytes = default_replica_budget(mesh)

    stage = "stage" if "stage" in sizes and sizes["stage"] > 1 else None
    stages = sizes.get(stage, 1) if stage else 1
    if pipeline_stages <= 1 or stages <= 1:
        stage, stages = None, 1
    elif trunk_layers is not None and (
        trunk_layers <= 0 or trunk_layers % stages != 0
    ):
        stage, stages = None, 1

    if not dp:  # degenerate (TP-only) mesh: nothing to carve workers from
        return Strategy("plain", (), (), None, None, tp, 1)

    dp_degree = math.prod(sizes[a] for a in dp)
    fits = worker_replication_fits(
        params_bytes,
        (sizes.get(tp, 1) if tp else 1) * stages,
        replica_budget_bytes or 0,
    )
    if not sasg_enabled or not fits:
        fsdp = dp if len(dp) > 1 else dp[0]
        return Strategy("plain", (), dp, fsdp, fsdp, tp, dp_degree)

    if "pod" in sizes and "data" in sizes:
        return Strategy(
            "hierarchical", ("pod",), ("pod", "data"), None, "data", tp,
            sizes["pod"], stage, stages, microbatches,
        )

    wa = dp[0]
    return Strategy(
        "flat", (wa,), (wa,), None, None, tp, sizes[wa],
        stage, stages, microbatches,
    )
