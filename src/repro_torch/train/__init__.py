"""Training substrate of the port: the train step, the trainer loop, and
a TrainState as checkpoint leaves.  The sharded step and elastic rescale
wait for ``ROADMAP.md`` Queue 1, item 4."""

from .interop import train_state_dict, train_state_from_dict, train_state_from_numpy
from .step import TrainState, init_train_state, make_train_step
from .trainer import Trainer, TrainerConfig, TrainStateCheckpointer

__all__ = [
    "TrainState",
    "make_train_step",
    "init_train_state",
    "Trainer",
    "TrainerConfig",
    "TrainStateCheckpointer",
    "train_state_dict",
    "train_state_from_dict",
    "train_state_from_numpy",
]
