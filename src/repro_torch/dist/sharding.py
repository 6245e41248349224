"""Role-aware partition specs for FSDP x TP layouts, and their placements.

Port of ``repro/dist/sharding.py``. The model zoo stores weights as nested
dicts with conventional leaf names, so specs are assigned from the leaf's
*path*:

- column-parallel (input dim -> fsdp, output dim -> tp): wq/wk/wv, w_gate/
  w_up, w_in, lm_head, and any unrecognized >=2-D leaf (the safe default);
- row-parallel (input dim -> tp, output dim -> fsdp): wo, w_down, w_out;
- vocab-parallel embedding: embed -> (tp, fsdp);
- expert-parallel MoE: experts_* shard the expert dim over tp when
  divisible, otherwise fall back to TP over d_expert;
- 1-D leaves (norm scales, biases, gates) are replicated.

A dim is only sharded when its size divides the mesh axis size; stacked
leading layer axes are padded with None. Leaves may be tensors or anything
with a ``shape``.

A spec is a ``PartitionSpec``: a tuple of per-dim entries, each None, an
axis name, or a tuple of axis names (major first), as the JAX package's.
``placements(spec, mesh)`` gives the DTensor placements of a spec on a
``DeviceMesh`` (the counterpart of ``NamedSharding``).

Pipeline composition (``dist/pipeline.py``): leaves under a trunk
path take ``stage_axis`` on their stacked layer dim, their trailing dims
keep the role-aware assignment.
"""
from __future__ import annotations

import math
from typing import Tuple, Union

from repro_torch.core.types import Tree, tree_flatten_with_paths, tree_map, tree_unflatten

Axis = Union[str, Tuple[str, ...], None]

_ROW_PARALLEL = {"wo", "w_down", "w_out"}

# Leaves whose natural (unstacked) form is a vector: norm scales, biases,
# per-head gates. They pick up leading layer dims under the stacked-units
# layout, so rank alone cannot identify them; replicate by name.
_VECTOR = {"scale", "bias", "b", "lam", "a_log", "dt_bias", "d_skip", "norm_scale"}


class PartitionSpec(tuple):
    """Per-dim sharding entries of one leaf (trailing dims unspecified are
    replicated)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec


def is_spec(x) -> bool:
    return isinstance(x, PartitionSpec)


def _sizes(mesh) -> dict:
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


def _axis_size(mesh, axis: Axis) -> int:
    if axis is None:
        return 1
    if isinstance(axis, (tuple, list)):
        return math.prod(_axis_size(mesh, a) for a in axis)
    return _sizes(mesh)[axis]


def _fit(mesh, dim: int, axis: Axis):
    """``axis`` if ``dim`` divides evenly over it, else None (no sharding)."""
    if axis is None:
        return None
    size = _axis_size(mesh, axis)
    if size <= 1 or dim % size != 0:
        return None
    return tuple(axis) if isinstance(axis, list) else axis


def _keys(path: str) -> list:
    return path.split("/") if path else []


def _map_with_paths(f, tree: Tree) -> Tree:
    paths, leaves, treedef = tree_flatten_with_paths(tree)
    return tree_unflatten(treedef, [f(_keys(p), x) for p, x in zip(paths, leaves)])


def param_specs(params, mesh, fsdp_axis: Axis, tp_axis: Axis,
                stage_axis: Axis = None, trunk_paths: Tuple = ()):
    """PartitionSpec tree for a parameter tree (same structure).

    ``trunk_paths`` is a tuple of leaf-path prefixes (tuples of path keys)
    naming stage-stacked trunk subtrees; when ``stage_axis`` is set, their
    leaves shard the stacked leading layer dim over it."""
    prefixes = tuple(tuple(str(k) for k in p) for p in trunk_paths)

    def role_entries(key, shape) -> tuple:
        ndim = len(shape)
        if ndim <= 1 or key in _VECTOR:
            return (None,) * ndim

        if key.startswith("experts_") and ndim >= 3:
            e, a, b = shape[-3:]
            if _fit(mesh, e, tp_axis) is not None:
                # expert-parallel: expert dim over tp, d_model dim over fsdp
                if key == "experts_down":
                    spec3 = (tp_axis, None, _fit(mesh, b, fsdp_axis))
                else:
                    spec3 = (tp_axis, _fit(mesh, a, fsdp_axis), None)
            elif key == "experts_down":
                spec3 = (None, _fit(mesh, a, tp_axis), _fit(mesh, b, fsdp_axis))
            else:
                spec3 = (None, _fit(mesh, a, fsdp_axis), _fit(mesh, b, tp_axis))
            return (None,) * (ndim - 3) + spec3

        if key == "embed":
            return (_fit(mesh, shape[0], tp_axis), _fit(mesh, shape[1], fsdp_axis))

        if key in _ROW_PARALLEL:
            d2 = (_fit(mesh, shape[-2], tp_axis), _fit(mesh, shape[-1], fsdp_axis))
        else:
            d2 = (_fit(mesh, shape[-2], fsdp_axis), _fit(mesh, shape[-1], tp_axis))
        return (None,) * (ndim - 2) + d2

    def leaf(keys, x):
        shape = tuple(x.shape)
        if (stage_axis is not None and shape
                and any(keys[: len(p)] == list(p) for p in prefixes)):
            return P(_fit(mesh, shape[0], stage_axis), *role_entries(keys[-1], shape[1:]))
        if len(shape) <= 1 or keys[-1] in _VECTOR:
            return P()
        return P(*role_entries(keys[-1], shape))

    return _map_with_paths(leaf, params)


def stage_only_spec(spec, stage_axis: Axis):
    """Keep ONLY the stage axis of a param spec (the part that hands each
    pipeline stage its contiguous trunk slice)."""
    return P(*[e if (stage_axis is not None and e == stage_axis) else None
               for e in tuple(spec)])


def strip_stage_spec(spec, stage_axis: Axis):
    """A param spec with the stage axis stripped: the layout of quantities
    in the full-gradient exchange domain."""
    return P(*[None if (stage_axis is not None and e == stage_axis) else e
               for e in tuple(spec)])


def without_axes(spec, axes) -> PartitionSpec:
    """``spec`` with the mesh axes ``axes`` taken out of every entry (the
    layout of a quantity that is whole along them)."""
    def keep(entry):
        kept = tuple(n for n in _names(entry) if n not in axes)
        if not kept:
            return None
        return kept if len(kept) > 1 else kept[0]

    return P(*(keep(e) for e in tuple(spec)))


def splits_over(spec, axis: str, sizes: dict) -> bool:
    """True iff ``spec`` cuts some dim over ``axis`` (of size > 1)."""
    return sizes.get(axis, 1) > 1 and any(axis in _names(e) for e in tuple(spec))


def ef_specs(pspecs, stage_axis: Axis, stage_sharded: bool):
    """Specs of the error-feedback buffers: the param specs when the trunk
    EF is stage-sharded like the params (the payload-gather path), else
    the param specs with the stage axis stripped. Checkpoints keep the
    full logical arrays either way, so a restore onto another stage count
    is pure resharding (``core.error_feedback.remap_error_state``)."""
    if stage_sharded:
        return pspecs
    return tree_map(lambda s: strip_stage_spec(s, stage_axis), pspecs, is_leaf=is_spec)


def batch_specs(batch, mesh, data_axis: Axis):
    """Leading (batch) dim over the data axes; everything else replicated."""

    def leaf(x):
        shape = tuple(x.shape)
        if not shape:
            return P()
        return P(_fit(mesh, shape[0], data_axis), *([None] * (len(shape) - 1)))

    return tree_map(leaf, batch)


def cache_specs(cache, mesh, data_axis: Axis, tp_axis: Axis):
    """Decode-cache specs: batch dim over data, KV head dim over tp.

    Handles the stacked-units layout (leading n_units dim under the "unit"
    subtree) and flat per-layer ("rem") states. Position tables
    ("pos"/"ppos") and block tables ("bt") stay replicated. Paged block
    pools ("pk"/"pv", shape (num_blocks, block, Hkv, Dh)) shard the pool
    dim over data and the head dim over tp like dense k/v; KV heads that
    tp does not divide stay whole. The SSD and RG-LRU states stay
    replicated here; the port's tensor-parallel engine departs from that
    (each rank's model builds its own part, ``serve/engine.py``)."""

    def leaf(keys, x):
        key = keys[-1]
        shape = tuple(x.shape)
        ndim = len(shape)
        b = 1 if "unit" in keys else 0  # stacked leading layer axis
        if key in ("pos", "ppos", "bt") or ndim <= b + 1:
            return P()
        entries = [None] * ndim
        entries[b] = _fit(mesh, shape[b], data_axis)
        if key in ("k", "v", "pk", "pv") and ndim - b >= 3:
            entries[-2] = _fit(mesh, shape[-2], tp_axis)  # (.., H, Dh) heads
        return P(*entries)

    return _map_with_paths(leaf, cache)


def _names(entry) -> tuple:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def placements(spec, mesh) -> list:
    """DTensor placements of ``spec`` on ``mesh``, one per mesh dim:
    ``Shard(d)`` on the mesh dims that split tensor dim d, ``Replicate()``
    elsewhere."""
    from torch.distributed.tensor import Replicate, Shard

    out = [Replicate() for _ in mesh.mesh_dim_names]
    for d, entry in enumerate(tuple(spec)):
        for name in _names(entry):
            out[list(mesh.mesh_dim_names).index(name)] = Shard(d)
    return out


def with_leading(spec, entry) -> PartitionSpec:
    """``spec`` behind one more leading dim sharded as ``entry`` (the worker
    dim of worker-stacked state)."""
    return P(entry, *tuple(spec))


def live_spec(spec, mesh) -> PartitionSpec:
    """``spec`` with the axes that ``mesh`` lacks, or holds at size 1,
    stripped: sharding over such an axis is replication."""
    sizes = _sizes(mesh)

    def norm(entry):
        kept = tuple(n for n in _names(entry) if sizes.get(n, 1) > 1)
        if not kept:
            return None
        return kept if len(kept) > 1 else kept[0]

    return P(*(norm(e) for e in tuple(spec)))


def shard_counts(spec, sizes: dict, ndim: int = 0) -> tuple:
    """Per tensor dim, how many shards ``spec`` cuts it into over axes of
    ``sizes`` (``{axis: size}``); at least ``ndim`` entries (the dims the
    spec leaves out are whole)."""
    counts = tuple(math.prod(sizes.get(n, 1) for n in _names(e)) for e in tuple(spec or ()))
    return counts + (1,) * (ndim - len(counts))


def shard_index(spec, mesh, coords: dict) -> tuple:
    """Per tensor dim, this rank's shard index (names major first), given
    its ``{axis: coordinate}`` on ``mesh``."""
    sizes = _sizes(mesh)
    out = []
    for e in tuple(spec):
        i = 0
        for n in _names(e):
            i = i * sizes.get(n, 1) + coords.get(n, 0)
        out.append(i)
    return tuple(out)


def mesh_coords(mesh) -> dict:
    """``{axis: this rank's coordinate}`` on a ``DeviceMesh`` (all 0 on a
    ``StackedMesh``, which splits nothing)."""
    if not hasattr(mesh, "get_local_rank"):
        return {n: 0 for n in mesh.mesh_dim_names}
    return {n: mesh.get_local_rank(n) for n in mesh.mesh_dim_names}


def take_local(full, spec, mesh):
    """This rank's shard of the full logical array ``full`` under ``spec``
    (a slice, no communication); the array itself on a ``StackedMesh``."""
    if not hasattr(mesh, "get_local_rank"):
        return full
    x = full
    coords = mesh_coords(mesh)
    counts = shard_counts(spec, _sizes(mesh))
    for d, (c, i) in enumerate(zip(counts, shard_index(spec, mesh, coords))):
        if c > 1:
            n = x.shape[d] // c
            x = x.narrow(d, i * n, n)
    return x.contiguous()


def as_dtensor(local, spec, mesh, full_shape):
    """This rank's shard as a DTensor of the global ``full_shape``, placed
    by ``spec`` on the ``DeviceMesh`` (no communication)."""
    from torch.distributed.tensor import DTensor

    stride, acc = [], 1
    for d in reversed(tuple(full_shape)):
        stride.append(acc)
        acc *= d
    return DTensor.from_local(local, mesh, placements(spec, mesh), run_check=False,
                              shape=tuple(full_shape), stride=tuple(reversed(stride)))


def place(full, spec, mesh):
    """The full logical array placed by ``spec``: a DTensor of this rank's
    shard on a ``DeviceMesh``, the array itself on a ``StackedMesh``."""
    if not hasattr(mesh, "get_local_rank"):
        return full
    return as_dtensor(take_local(full, spec, mesh), spec, mesh, tuple(full.shape))
