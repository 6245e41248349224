from .optimizers import apply_updates
from .schedules import constant, step_decay
