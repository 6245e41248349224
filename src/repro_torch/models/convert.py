"""Parameters from the JAX package to the port.

``params_from_numpy`` takes a parameter tree of numpy arrays (for the JAX
package: ``jax.tree.map(np.asarray, params)``) and returns the port's
tree: the same nested dicts, the same leaf shapes and paths, as tensors on
``device``. Both packages then compute the same function.

numpy has no bfloat16 of its own: JAX hands out ``ml_dtypes.bfloat16``
arrays, which ``torch.from_numpy`` refuses. Such a leaf goes through
float32 and back to ``torch.bfloat16``; both casts are exact.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.types import Tree, tree_map


def _leaf(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def params_from_numpy(tree: Tree, device=None) -> Tree:
    return tree_map(lambda a: _leaf(a, device), tree)
