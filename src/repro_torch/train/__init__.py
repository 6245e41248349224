from .loop import Trainer, TrainerConfig
from .step import BuiltStep, TrainState, build_train_step, resolve_device, step_seed
