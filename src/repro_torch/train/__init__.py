"""Training substrate of the port: the train step (on one device or a
mesh), the trainer loop, elastic rescale, and a TrainState as checkpoint
leaves."""

from .interop import train_state_dict, train_state_from_dict, train_state_from_numpy
from .step import (
    TrainState,
    batch_shardings,
    init_train_state,
    make_train_step,
    reshard_state,
    train_state_shardings,
)
from .trainer import Trainer, TrainerConfig, TrainStateCheckpointer

__all__ = [
    "TrainState",
    "batch_shardings",
    "make_train_step",
    "reshard_state",
    "train_state_shardings",
    "init_train_state",
    "Trainer",
    "TrainerConfig",
    "TrainStateCheckpointer",
    "train_state_dict",
    "train_state_from_dict",
    "train_state_from_numpy",
]
