from .loop import Trainer, TrainerConfig
from .step import BuiltStep, TrainState, build_train_step, resolve_device, step_seed
from .elastic import ElasticTrainer, WorkerMembership, fresh_worker_state, remap_state
from .faults import (DataStreamError, Fault, FaultInjector, FaultPlan, InjectedFault,
                     corrupt_checkpoint)
