"""Training state (port of ``phnet_tpu/train/state.py``)."""

from __future__ import annotations

import dataclasses
import math

import torch

from ..config import Config
from ..models.phnet import PHNet
from .optimizer import Optimizer


@dataclasses.dataclass
class TrainState:
    """What a step changes: the model's parameters and BatchNorm
    statistics (in ``model``), the optimizer's moments and update count
    (in ``optimizer``), the step count and the running minimum epoch loss
    (the checkpoint policy's)."""

    model: PHNet
    optimizer: Optimizer
    step: int = 0
    min_loss: float = math.inf


def create_train_state(cfg: Config, total_steps: int, device=None,
                       seed=None) -> TrainState:
    """A model with random weights drawn from ``seed`` (default
    ``cfg.train.seed``) on ``device`` (default the card), in train mode,
    and its optimizer for a run of ``total_steps`` updates."""
    model = PHNet(cfg.model, device=device)
    model.reset_parameters(torch.Generator().manual_seed(
        cfg.train.seed if seed is None else seed))
    model.train()
    return TrainState(model, Optimizer(cfg.train, total_steps,
                                       model.parameters()))
