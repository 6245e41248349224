"""Distribution layer of the port: mesh strategies and sharding rules.

Port of ``repro/dist`` (the pipeline comes with ROADMAP item 9):

- ``strategy``: which mesh axes are SASG workers and which shard the
  params, and the flat / hierarchical / plain selection
  (``choose_strategy``), with the device's memory as the replica budget.
- ``sharding``: role-aware partition specs for params, EF buffers,
  batches and decode caches, and their DTensor ``placements`` on a
  ``DeviceMesh``; consumed by the train step and the serving engine.
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
]
