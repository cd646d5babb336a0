"""Training of the port: optimizer, state, step, checkpoints, the epoch
loop (:func:`phnet_torch.train.trainer.train`) and its command lines
(``python -m phnet_torch.train`` for VIL-100,
``python -m phnet_torch.train.openlane`` for OpenLane-V)."""
from .optimizer import Optimizer, build_optimizer, cosine_schedule
from .state import TrainState, create_train_state
from .step import make_train_step

__all__ = ["Optimizer", "build_optimizer", "cosine_schedule", "TrainState",
           "create_train_state", "make_train_step"]
