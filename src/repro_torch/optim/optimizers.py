"""Optimizer transforms on trees (init / update), and the parameter update.

Port of ``repro/optim/optimizers.py``. The paper's algorithms fold the
learning rate into the exchanged update (``fold_lr``), so the step is
``params - update``. With ``fold_lr=False`` the exchange returns the
compressed mean gradient, and one of the transforms below turns it into
the applied delta (SASG + Adam is the CADA-style variant). They are
functional transforms on trees, as in the JAX package, and not
``torch.optim``: they consume the exchanged update, not ``.grad``.

``update(grads, state, params) -> (delta, state')``; ``delta`` carries the
sign convention of ``apply_updates`` (``params - delta``). A learning rate
may be a float or a schedule (``optim.schedules``), called on the
transform's own int32 step count.

XLA contracts ``a * x + y`` into one fused multiply-add; torch's ``a * x +
y`` rounds twice. The moment updates are therefore written
``torch.add(y, x, alpha=a)``, whose vector path is ``fma(x, a, y)`` on the
CPU (and which nvcc contracts on the card), the rounding XLA's CPU backend
gives: momentum matches the JAX package bitwise on the CPU, AdamW to an
ulp or two of its square root and division.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import torch

from repro_torch.core.types import Tree, tree_leaves, tree_map


class GradientTransformation(NamedTuple):
    init: Callable[[Tree], Any]
    update: Callable[[Tree, Any, Optional[Tree]], tuple]  # (grads, state, params)


def _count(params: Tree) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32, device=tree_leaves(params)[0].device)


def _rate(lr, count: torch.Tensor):
    return lr(count) if callable(lr) else lr


def scale_by_lr(lr) -> GradientTransformation:
    def init(params):
        return _count(params)

    def update(grads, count, params=None):
        rate = _rate(lr, count)
        return tree_map(lambda g: g * rate, grads), count + 1

    return GradientTransformation(init, update)


def sgd(lr=1.0) -> GradientTransformation:
    return scale_by_lr(lr)


def momentum(lr, beta: float = 0.9, nesterov: bool = False) -> GradientTransformation:
    def init(params):
        return {"mu": tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params),
                "count": _count(params)}

    def update(grads, state, params=None):
        def ema(m, g):   # beta * m + g, one rounding
            return torch.add(g.float(), m, alpha=beta)

        mu = tree_map(ema, state["mu"], grads)
        upd = tree_map(ema, mu, grads) if nesterov else mu
        rate = _rate(lr, state["count"])
        return tree_map(lambda u: u * rate, upd), {"mu": mu, "count": state["count"] + 1}

    return GradientTransformation(init, update)


def adamw(lr, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 0.0) -> GradientTransformation:
    def init(params):
        def z(p):
            return torch.zeros_like(p, dtype=torch.float32)

        return {"m": tree_map(z, params), "v": tree_map(z, params), "count": _count(params)}

    def update(grads, state, params=None):
        c = state["count"] + 1
        cf = c.float()
        # b * m + (1 - b) * g, the product b * m fused into the add
        m = tree_map(lambda m_, g: torch.add((1 - b1) * g.float(), m_, alpha=b1),
                     state["m"], grads)
        v = tree_map(lambda v_, g: torch.add((1 - b2) * g.float().square(), v_, alpha=b2),
                     state["v"], grads)
        # b ** c in fp32, as jnp computes it
        c1 = 1 - torch.pow(torch.tensor(b1, dtype=torch.float32, device=cf.device), cf)
        c2 = 1 - torch.pow(torch.tensor(b2, dtype=torch.float32, device=cf.device), cf)
        rate = _rate(lr, state["count"])
        upd = tree_map(lambda m_, v_: rate * (m_ / c1) / (torch.sqrt(v_ / c2) + eps), m, v)
        if weight_decay and params is not None:
            wd = torch.as_tensor(rate * weight_decay, dtype=torch.float32, device=c.device)
            upd = tree_map(lambda u, p: torch.addcmul(u, p.float(), wd), upd, params)
        return upd, {"m": m, "v": v, "count": c}

    return GradientTransformation(init, update)


def clip_by_global_norm(max_norm: float) -> GradientTransformation:
    def init(params):
        return ()

    def update(grads, state, params=None):
        gn = torch.sqrt(sum(x.float().square().sum() for x in tree_leaves(grads)))
        scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
        return tree_map(lambda g: g * scale, grads), state

    return GradientTransformation(init, update)


def chain(*transforms: GradientTransformation) -> GradientTransformation:
    def init(params):
        return tuple(t.init(params) for t in transforms)

    def update(grads, states, params=None):
        new_states = []
        for t, s in zip(transforms, states):
            grads, ns = t.update(grads, s, params)
            new_states.append(ns)
        return grads, tuple(new_states)

    return GradientTransformation(init, update)


def apply_updates(params: Tree, updates: Tree) -> Tree:
    """params - updates, computed in fp32 and cast back to each param's
    dtype."""
    return tree_map(lambda p, u: (p.float() - u).to(p.dtype), params, updates)
