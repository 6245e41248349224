"""Distribution layer of the port: mesh strategies, sharding rules and the
pipeline.

Port of ``repro/dist``:

- ``strategy``: which mesh axes are SASG workers and which shard the
  params, and the flat / hierarchical / plain selection
  (``choose_strategy``), with the device's memory as the replica budget.
- ``sharding``: role-aware partition specs for params, EF buffers,
  batches and decode caches, and their DTensor ``placements`` on a
  ``DeviceMesh``; consumed by the train step and the serving engine.
- ``pipeline``: the 1F1B and GPipe schedules over a stage axis and their
  composition with the SASG exchange (``build_pipelined_vag``).
"""
from .sharding import (
    PartitionSpec,
    batch_specs,
    cache_specs,
    ef_specs,
    param_specs,
    placements,
    stage_only_spec,
    strip_stage_spec,
)
from .pipeline import build_pipelined_vag, resolve_microbatches
from .strategy import Strategy, choose_strategy, worker_replication_fits

__all__ = [
    "Strategy",
    "choose_strategy",
    "worker_replication_fits",
    "PartitionSpec",
    "param_specs",
    "batch_specs",
    "cache_specs",
    "ef_specs",
    "placements",
    "stage_only_spec",
    "strip_stage_spec",
    "build_pipelined_vag",
    "resolve_microbatches",
]
