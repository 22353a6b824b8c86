from .schedule import make_lr_schedule
from .step import TrainState, create_train_state, make_optimizer, make_train_step

__all__ = ["TrainState", "create_train_state", "make_lr_schedule", "make_optimizer", "make_train_step"]
