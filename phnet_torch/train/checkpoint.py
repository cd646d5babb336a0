"""Checkpoints of a training run (the port's own format, ``torch.save``).

Semantics of ``phnet_tpu/train/checkpoint.py`` (reference
``save_checkpoint_V2`` and the resume path of ``trainVIL.py:136-153``):
periodic per-epoch files ``epoch_{n}.pt`` and a ``best.pt`` copy, each
holding the step, the parameters, the BatchNorm statistics, the
optimizer's state, the running minimum loss, the epoch to start from and
the dataset curriculum's ``max_skip``. :meth:`restore_state` resumes all
of it; :meth:`restore_weights` takes the weights only. Orbax checkpoints
of the JAX package are not read.

In a process group rank 0 alone writes, as the JAX package's
``phnet_tpu/train/checkpoint.py:46``, and every rank waits at a barrier
after the save; every rank reads the same files. A model sharded over a
mesh's model axis (:mod:`phnet_torch.parallel.tensor`) is saved whole:
every rank takes part in gathering the parameters and the optimizer's
moments, and the file is the one a one-process run writes; restoring
cuts whole tensors to the rank's blocks, so that a checkpoint resumes
at any model axis size.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional, Union

import torch

from ..parallel.multihost import barrier, rank
from ..parallel.tensor import full_state_dict, load_full_state_dict
from .state import TrainState


def _split(model) -> Dict[str, Dict[str, torch.Tensor]]:
    buffers = {n for n, _ in model.named_buffers()}
    sd = full_state_dict(model)
    return {"params": {k: v for k, v in sd.items() if k not in buffers},
            "batch_stats": {k: v for k, v in sd.items() if k in buffers}}


def _device(model) -> torch.device:
    return next(model.parameters()).device


class CheckpointManager:
    def __init__(self, directory: str):
        self.dir = os.path.abspath(directory)
        os.makedirs(self.dir, exist_ok=True)

    def _path(self, name: Union[str, int]) -> str:
        if isinstance(name, int) or name.isdigit():
            name = f"epoch_{name}"
        return os.path.join(self.dir, f"{name}.pt")

    def save(self, state: TrainState, epoch: int, max_skip: int,
             is_best: bool = False, periodic: bool = True):
        whole = dict(_split(state.model),
                     opt_state=state.optimizer.state_dict())
        if rank() == 0:
            payload = dict(params=whole["params"],
                           batch_stats=whole["batch_stats"], step=state.step,
                           opt_state=whole["opt_state"],
                           min_loss=float(state.min_loss), epoch=int(epoch),
                           max_skip=int(max_skip))
            if periodic:
                torch.save(payload, self._path(epoch))
            if is_best:
                torch.save(payload, self._path("best"))
        barrier()

    def latest_epoch(self) -> Optional[int]:
        epochs = [int(f[6:-3]) for f in os.listdir(self.dir)
                  if f.startswith("epoch_") and f.endswith(".pt")
                  and f[6:-3].isdigit()]
        return max(epochs) if epochs else None

    def restore(self, name: Union[str, int, None] = None,
                device=None) -> Dict[str, Any]:
        """The payload of ``name``: 'best', an epoch, or None for the latest
        epoch."""
        if name is None:
            name = self.latest_epoch()
            if name is None:
                raise FileNotFoundError(f"no checkpoints in {self.dir}")
        return torch.load(self._path(name), map_location=device,
                          weights_only=True)

    def restore_state(self, state: TrainState, name=None):
        """Resume everything: returns (state, epoch to start from,
        max_skip)."""
        payload = self.restore(name, _device(state.model))
        load_full_state_dict(state.model, {**payload["params"],
                                           **payload["batch_stats"]})
        state.optimizer.load_state_dict(payload["opt_state"])
        state.step = int(payload["step"])
        state.min_loss = float(payload["min_loss"])
        return state, int(payload["epoch"]), int(payload["max_skip"])

    def restore_weights(self, state: TrainState, name="best") -> TrainState:
        """Weights-only initialisation (the reference's ``initial_model``):
        parameters and BatchNorm statistics."""
        payload = self.restore(name, _device(state.model))
        load_full_state_dict(state.model, {**payload["params"],
                                           **payload["batch_stats"]})
        return state
