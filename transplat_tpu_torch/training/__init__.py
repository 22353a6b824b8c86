from .checkpointing import CheckpointManager
from .schedule import make_lr_schedule
from .step import TrainState, create_train_state, make_optimizer, make_train_step
from .trainer import Trainer

__all__ = [
    "CheckpointManager", "TrainState", "Trainer", "create_train_state", "make_lr_schedule",
    "make_optimizer", "make_train_step",
]
