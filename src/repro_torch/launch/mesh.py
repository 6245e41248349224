"""Meshes of the port: named axes over one process or over a worker group.

Port of ``repro/launch/mesh.py::make_test_mesh`` (the production mesh and
the TPU constants are not ported). Two forms, both with the
``mesh_dim_names`` and ``shape`` that ``dist.strategy`` and
``dist.sharding`` read:

- ``StackedMesh`` (no group): names and sizes in one process. The worker
  axis is the stacked leading dim of the worker state, as in a run
  without a mesh; the other axes are not split in memory, but the
  exchange still takes its block geometry from the specs, as the JAX
  package's run on fake devices does.
- a torch ``DeviceMesh`` (with a ``WorkerGroup`` of matching world size):
  ``init_device_mesh(device_type, shape, mesh_dim_names=axes)`` over the
  group's ranks; each rank holds its shard of every sharded leaf.
"""
from __future__ import annotations

import math
from dataclasses import dataclass


@dataclass(frozen=True)
class StackedMesh:
    """A mesh of one process: axis names and sizes only."""

    shape: tuple
    mesh_dim_names: tuple
    device_type: str = "cpu"

    def size(self) -> int:
        return math.prod(self.shape)


def parse_mesh_shape(text: str) -> tuple:
    """``"data,model"`` sizes (``"4,2"``) or ``"pod,data,model"`` sizes
    (``"2,2,2"``) -> (shape, axes), as the JAX launcher spells them."""
    shape = tuple(int(x) for x in text.split(","))
    if not 1 <= len(shape) <= 3 or min(shape) < 1:
        raise ValueError(f"--mesh-shape {text!r}: give 1-3 positive sizes "
                         "(data,model or pod,data,model)")
    return shape, ("pod", "data", "model")[-len(shape):]


def make_test_mesh(shape=(2, 2, 2), axes=("pod", "data", "model"), group=None,
                   device_type: str = "cpu"):
    """A ``StackedMesh`` without a group; with a ``WorkerGroup`` whose world
    size is the mesh's size, a ``DeviceMesh`` on the group's device type."""
    shape, axes = tuple(shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in length")
    if group is None:
        return StackedMesh(shape, axes, device_type)
    if group.world_size != math.prod(shape):
        raise ValueError(f"a {shape} mesh needs {math.prod(shape)} ranks; the group "
                         f"has {group.world_size}")
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(group.device.type, shape, mesh_dim_names=axes)


def is_device_mesh(mesh) -> bool:
    return mesh is not None and not isinstance(mesh, StackedMesh)
