"""Learning-rate schedules (callables: step -> fp32 0-d tensor on the
step's device). Port of ``repro/optim/schedules.py``."""
from __future__ import annotations

import torch


def _f32(x, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=like.device)


def constant(lr: float):
    return lambda step: _f32(lr, step)


def step_decay(lr: float, boundaries, factor: float = 0.1):
    """Paper's schedule: decay by `factor` at each boundary step."""
    bounds = sorted(int(b) for b in boundaries)

    def fn(step):
        n = (step >= torch.as_tensor(bounds, device=step.device)).sum()
        return _f32(lr, step) * _f32(factor, step) ** n

    return fn
