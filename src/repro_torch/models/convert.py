"""Parameters from the JAX package to the port.

``params_from_numpy`` takes a parameter tree of numpy arrays (for the JAX
package: ``jax.tree.map(np.asarray, params)``) and returns the port's
tree: the same nested dicts, the same leaf shapes and paths, as tensors on
``device``. Both packages then compute the same function.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.types import Tree, tree_map


def params_from_numpy(tree: Tree, device=None) -> Tree:
    return tree_map(
        lambda a: torch.from_numpy(np.array(a, copy=True)).to(device), tree
    )
