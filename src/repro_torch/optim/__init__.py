from .optimizers import (
    GradientTransformation,
    adamw,
    apply_updates,
    chain,
    clip_by_global_norm,
    momentum,
    scale_by_lr,
    sgd,
)
from .schedules import constant, step_decay
