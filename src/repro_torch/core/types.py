"""Tree utilities over nested dicts of tensors, and the shared counters.

Trees are nested ``dict`` / ``list`` / ``tuple`` (NamedTuples included)
containers of tensors, plus the payload classes that register themselves
with :func:`register_node` (``core/topk.py``). Flatten order is the JAX
package's: dict keys in **sorted** order, not insertion order. The order
fixes the flat layout's concatenation, the per-bucket bit rows and the
payload / error-feedback pairing, so it must match ``jax.tree`` exactly.

Inside the exchange every leaf carries a leading worker dim (the M
simulated workers are stacked on one device); helpers that reduce a tree
take ``batch_dims`` to keep those leading dims.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

Tree = Any

_DTYPES = {
    "float32": torch.float32,
    "float16": torch.float16,
    "bfloat16": torch.bfloat16,
}


def dtype_of(name) -> torch.dtype:
    """torch dtype for a config dtype string (``"float32"``, ...)."""
    if isinstance(name, torch.dtype):
        return name
    return _DTYPES[name]


# ---------------------------------------------------------------------------
# flatten / unflatten
# ---------------------------------------------------------------------------

# cls -> (flatten(obj) -> (children, aux), unflatten(aux, children) -> obj)
_NODES: dict = {}


def register_node(cls, flatten: Callable, unflatten: Callable) -> None:
    """Make ``cls`` a tree node whose children are flattened in order."""
    _NODES[cls] = (flatten, unflatten)


class _LeafMark:
    __slots__ = ()

    def __repr__(self):
        return "*"


_LEAF = _LeafMark()


class TreeDef(NamedTuple):
    """Skeleton of a flattened tree: the containers with leaves marked."""

    skeleton: Any
    num_leaves: int


def _flatten(tree, is_leaf, path, paths, leaves):
    if is_leaf is not None and is_leaf(tree):
        paths.append(path)
        leaves.append(tree)
        return _LEAF
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _flatten(tree[k], is_leaf, path + (k,), paths, leaves)
                for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        subs = [_flatten(x, is_leaf, path + (i,), paths, leaves)
                for i, x in enumerate(tree)]
        if isinstance(tree, list):
            return subs
        if hasattr(tree, "_fields"):  # NamedTuple
            return ("namedtuple", type(tree), subs)
        return ("tuple", subs)
    node = _NODES.get(type(tree))
    if node is not None:
        children, aux = node[0](tree)
        subs = [_flatten(x, is_leaf, path + (i,), paths, leaves)
                for i, x in enumerate(children)]
        return ("node", type(tree), aux, subs)
    paths.append(path)
    leaves.append(tree)
    return _LEAF


def _unflatten(skel, it):
    if skel is _LEAF:
        return next(it)
    if skel is None:
        return None
    if isinstance(skel, dict):
        return {k: _unflatten(v, it) for k, v in skel.items()}
    if isinstance(skel, list):
        return [_unflatten(v, it) for v in skel]
    tag = skel[0]
    if tag == "tuple":
        return tuple(_unflatten(v, it) for v in skel[1])
    if tag == "namedtuple":
        return skel[1](*[_unflatten(v, it) for v in skel[2]])
    _, cls, aux, subs = skel
    return _NODES[cls][1](aux, [_unflatten(v, it) for v in subs])


def path_str(path) -> str:
    """Render a tree path as the "/"-joined key string of the JAX package
    (``"trunk/conv1"``, ``"fc1/w"``)."""
    return "/".join(str(k) for k in path)


def tree_flatten(tree: Tree, is_leaf=None):
    paths, leaves = [], []
    skel = _flatten(tree, is_leaf, (), paths, leaves)
    return leaves, TreeDef(skel, len(leaves))


def tree_flatten_with_paths(tree: Tree, is_leaf=None):
    """(paths, leaves, treedef) with paths rendered via ``path_str``."""
    paths, leaves = [], []
    skel = _flatten(tree, is_leaf, (), paths, leaves)
    return [path_str(p) for p in paths], leaves, TreeDef(skel, len(leaves))


def tree_unflatten(treedef: TreeDef, leaves) -> Tree:
    leaves = list(leaves)
    if len(leaves) != treedef.num_leaves:
        raise ValueError(
            f"treedef has {treedef.num_leaves} leaves, got {len(leaves)}"
        )
    return _unflatten(treedef.skeleton, iter(leaves))


def tree_leaves(tree: Tree, is_leaf=None) -> list:
    return tree_flatten(tree, is_leaf)[0]


def tree_map(f: Callable, tree: Tree, *rest: Tree, is_leaf=None) -> Tree:
    leaves, treedef = tree_flatten(tree, is_leaf)
    others = [tree_leaves(r, is_leaf) for r in rest]
    for o in others:
        if len(o) != len(leaves):
            raise ValueError("tree_map over trees of different structure")
    return tree_unflatten(treedef, [f(*xs) for xs in zip(leaves, *others)])


# ---------------------------------------------------------------------------
# numeric helpers
# ---------------------------------------------------------------------------

def tree_sub(a: Tree, b: Tree) -> Tree:
    return tree_map(torch.sub, a, b)


def tree_scale(a: Tree, s) -> Tree:
    return tree_map(lambda x: x * s, a)


def tree_zeros_like(a: Tree, dtype=None) -> Tree:
    return tree_map(lambda x: torch.zeros_like(x, dtype=dtype or x.dtype), a)


def tree_cast(a: Tree, dtype) -> Tree:
    dtype = dtype_of(dtype)
    return tree_map(lambda x: x.to(dtype), a)


def _bcast(pred: torch.Tensor, ndim: int) -> torch.Tensor:
    """Right-pad ``pred`` with singleton dims up to ``ndim`` dims."""
    return pred.reshape(pred.shape + (1,) * (ndim - pred.dim()))


def tree_where(pred: torch.Tensor, a: Tree, b: Tree) -> Tree:
    """Select between two trees on a boolean predicate. A scalar ``pred``
    selects whole trees; a ``(M,)`` one selects per worker (leading dim)."""
    return tree_map(
        lambda x, y: torch.where(_bcast(pred, max(x.dim(), y.dim())), x, y.to(x.dtype)),
        a, b,
    )


def tree_sq_norm(a: Tree, batch_dims: int = 0) -> torch.Tensor:
    """Squared l2 norm of a tree in fp32, summed leaf by leaf in flatten
    order. ``batch_dims=1`` keeps the leading worker dim: one norm per
    worker."""
    leaves = tree_leaves(a)
    if not leaves:
        return torch.zeros((), dtype=torch.float32)
    return sum(
        x.float().square().reshape(x.shape[:batch_dims] + (-1,)).sum(-1)
        for x in leaves
    )


def tree_size(a: Tree) -> int:
    """Total element count of a tree."""
    return sum(x.numel() for x in tree_leaves(a))


def tree_flatten_concat(a: Tree, dtype=torch.float32, batch_dims: int = 0):
    """Concatenate every leaf into one vector per batch index (the paper's
    global view); leading ``batch_dims`` are kept."""
    leaves = tree_leaves(a)
    return torch.cat(
        [x.reshape(x.shape[:batch_dims] + (-1,)).to(dtype) for x in leaves],
        dim=-1,
    )


def tree_unflatten_concat(flat: torch.Tensor, like: Tree) -> Tree:
    """Inverse of tree_flatten_concat against a reference tree (no batch
    dims: ``flat`` is one vector, ``like`` gives the leaf shapes)."""
    leaves, treedef = tree_flatten(like)
    out, off = [], 0
    for x in leaves:
        n = x.numel()
        out.append(flat[off: off + n].reshape(x.shape).to(x.dtype))
        off += n
    return tree_unflatten(treedef, out)


class CommCounters(NamedTuple):
    """Algorithmic communication accounting (paper Tables 1-2 semantics).

    ``rounds`` counts uploads; ``bits_paper`` uses the paper's
    32-bits-per-transmitted-element convention; ``bits_wire`` also charges
    index bits for sparse payloads. float32 scalars, as in the JAX package.
    """

    rounds: torch.Tensor
    bits_paper: torch.Tensor
    bits_wire: torch.Tensor

    @staticmethod
    def zeros(device=None) -> "CommCounters":
        z = torch.zeros((), dtype=torch.float32, device=device)
        return CommCounters(rounds=z, bits_paper=z.clone(), bits_wire=z.clone())


def pad_to_multiple(x: torch.Tensor, multiple: int, axis: int = 0) -> torch.Tensor:
    """Zero-pad ``x`` along ``axis`` so its size is a multiple of ``multiple``."""
    axis = axis % x.dim()
    n = x.shape[axis]
    rem = (-n) % multiple
    if rem == 0:
        return x
    shape = list(x.shape)
    shape[axis] = rem
    return torch.cat([x, x.new_zeros(shape)], dim=axis)


def ceil_div(a: int, b: int) -> int:
    return -(-a // b)
