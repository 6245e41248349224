"""Parameter update of the paper's algorithms. Port of
``repro/optim/optimizers.py::apply_updates``: the learning rate is folded
into the exchanged update (fold_lr), so the step is ``params - update``.
The optax-style transforms of the JAX package (momentum, AdamW, clipping)
are not ported yet."""
from __future__ import annotations

from repro_torch.core.types import Tree, tree_map


def apply_updates(params: Tree, updates: Tree) -> Tree:
    """params - updates, computed in fp32 and cast back to each param's
    dtype."""
    return tree_map(lambda p, u: (p.float() - u).to(p.dtype), params, updates)
