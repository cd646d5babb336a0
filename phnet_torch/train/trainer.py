"""The epoch training loop (port of ``phnet_tpu/train/trainer.py``,
reference ``trainVIL.py:55-265``).

Per epoch: the loader's seeded shuffle, one step a batch with the
per-iteration cosine learning rate, a windowed loss meter, a NaN check,
the ``max_skip`` curriculum every ``epochs_per_increment`` epochs, and
the checkpoint policy (``best`` when the epoch's mean loss is the lowest
so far, ``epoch_{n}`` every ``epoch_per_test`` epochs). ``resume`` picks up
the latest periodic checkpoint, curriculum included; ``initial`` loads
weights only. A text log (epoch, learning rate, loss) goes to
``workdir/log.txt``. One device: the card unless ``device="cpu"``. The
model's compute dtype (float32, or the JAX trainers' bf16) is the
configuration's. Batches hold numpy arrays (synthetic clips) or tensors
(the readers' train mode, frames already on the reader's device).

In a process group (:mod:`phnet_torch.parallel.multihost`) each rank
trains on ``device`` from its shard of the batches (the caller's loader,
``ClipLoader(num_shards=world, shard_index=rank)``), the parameters and
buffers start from rank 0's, and the step all-reduces the gradients and
the metrics. Rank 0 alone prints, writes the log and writes the
checkpoints, as the JAX trainer does; a barrier follows each save, and
every rank resumes from the same files. At each epoch's end the ranks
check that they hold the same bits.

``mesh`` (:func:`phnet_torch.parallel.make_mesh`, as the JAX trainer's
``train(mesh=)``) lays the group's ranks out over its ``(data, model)``
axes (one rank a device of the mesh; each computes on ``device``): the
model is built whole, restored or broadcast from rank 0, then its large
kernels are tensor-sharded over ``model`` as the JAX package's
``shard_params`` places them (:func:`phnet_torch.parallel.tensor.
shard_module`, at :data:`phnet_torch.parallel.mesh.TP_MIN_SIZE`); the
BatchNorm statistics, the dropout masks and the caller's loader
(``ClipLoader(num_shards=data_size(), shard_index=data_index())``) follow
the data axis (make the loader after :func:`phnet_torch.parallel.
multihost.init_axes`; each epoch's first batch is checked to be the same
on the ranks of a model group). The bit check holds whole tensors over
the world and sharded ones over each data group. ``mesh=None`` is data-parallel
training over the whole group.
"""

from __future__ import annotations

import os
import time
from collections import deque
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..config import Config
from ..device import resolve_device
from ..losses.criterion import LaneCriterion
from ..models.phnet import check_trainable
from ..parallel.multihost import (broadcast_module, check_same_bits,
                                  init_axes, rank, same_over)
from ..parallel.tensor import cut_optimizer_state, shard_module
from .checkpoint import CheckpointManager
from .state import TrainState, create_train_state
from .step import make_train_step, step_seed


class AverageMeter:
    """Mean over a window of the last ``window`` values (the reference's
    480-deque)."""

    def __init__(self, window: int = 480):
        self.values = deque(maxlen=window)
        self.val = 0.0

    def update(self, val: float):
        self.val = val
        self.values.append(val)

    @property
    def avg(self) -> float:
        return sum(self.values) / max(len(self.values), 1)


class TextLogger:
    """Append-only tab-separated log."""

    def __init__(self, path: str, items):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self.file = open(path, "a")
        self.file.write("\t".join(items) + "\n")
        self.file.flush()

    def log(self, *values):
        self.file.write("\t".join(f"{v:.6g}" if isinstance(v, float)
                                  else str(v) for v in values) + "\n")
        self.file.flush()

    def close(self):
        self.file.close()


def _on_device(x, dev) -> torch.Tensor:
    """A batch's array, or tensor (the readers' train mode makes them on
    the reader's device), on ``dev``."""
    return (x if torch.is_tensor(x) else torch.from_numpy(x)).to(dev)


def train(cfg: Config, dataset, loader, workdir: str,
          epochs: Optional[int] = None, resume: bool = False,
          initial: Optional[str] = None, log_every: int = 10,
          verbose: bool = True, device=None,
          timings: Optional[List[Tuple[float, float]]] = None,
          mesh=None) -> Tuple[TrainState, List[float]]:
    """Train ``cfg`` on ``loader``'s batches of ``dataset`` into
    ``workdir``. Returns the final state and each epoch's mean loss. A
    configuration that does not train (a quantized one) raises
    ValueError before anything is built. ``timings``, where given, gets a
    step's (seconds waiting for the batch, seconds from the end of the
    last step to the loss on the host) each step. ``mesh``: the ranks'
    ``(data, model)`` layout (see the module's docstring)."""
    check_trainable(cfg.model)
    if mesh is not None:
        init_axes(mesh)
    tcfg = cfg.train
    epochs = epochs or tcfg.epochs
    dev = resolve_device(device)
    total_steps = max(len(loader) * epochs, 1)
    state = create_train_state(cfg, total_steps, dev)
    criterion = LaneCriterion(cfg.model, tcfg.loss)
    ckpt = CheckpointManager(workdir)
    start_epoch = 0
    if resume:
        state, start_epoch, max_skip = ckpt.restore_state(state)
        dataset.set_max_skip(max_skip)
    elif initial:
        state = ckpt.restore_weights(state, initial)
    broadcast_module(state.model)
    if mesh is not None:
        shard_module(state.model, mesh)
        cut_optimizer_state(state.optimizer.opt)  # moments restored whole
    check_same_bits(state.model)
    step_fn = make_train_step(criterion, tcfg.accum_steps)
    lead = rank() == 0
    verbose = verbose and lead
    logger = (TextLogger(os.path.join(workdir, "log.txt"),
                         ["Epoch", "LR", "TrainLoss"]) if lead else None)
    history = []
    try:
        for epoch in range(start_epoch, epochs):
            loader.set_epoch(epoch)
            meter = AverageMeter()
            t_end = time.time()
            for it, batch in enumerate(loader):
                data_s = time.time() - t_end
                frames = _on_device(batch["frames"], dev)
                labels = _on_device(batch["labels"], dev)
                if mesh is not None and it == 0 and not same_over(
                        [frames, labels], "model"):
                    raise RuntimeError(
                        "the ranks of a model group loaded different "
                        "batches: shard the loader over the data axis "
                        "(init_axes(mesh) before data_size(), "
                        "data_index())")
                state, metrics = step_fn(state, frames, labels,
                                         step_seed(tcfg.seed, state.step))
                loss = float(metrics["loss"])
                if timings is not None:
                    timings.append((data_s, time.time() - t_end))
                if not np.isfinite(loss):
                    raise FloatingPointError(f"Loss is NaN! ({loss} at step "
                                             f"{state.step})")
                meter.update(loss)
                if verbose and it % log_every == 0:
                    print(f"epoch {epoch + 1}/{epochs} it {it + 1}/"
                          f"{len(loader)} loss {loss:.4f} (avg "
                          f"{meter.avg:.4f}) data {data_s:.3f}s", flush=True)
                t_end = time.time()
            train_loss = meter.avg
            history.append(train_loss)
            check_same_bits(state.model)
            if logger is not None:
                logger.log(epoch + 1, state.optimizer.lr(), train_loss)
            if (epoch + 1) % tcfg.epochs_per_increment == 0:
                dataset.increase_max_skip()
            is_best = train_loss <= state.min_loss
            state.min_loss = min(state.min_loss, train_loss)
            periodic = (epoch + 1) % tcfg.epoch_per_test == 0
            if is_best or periodic:
                ckpt.save(state, epoch + 1, dataset.max_skip,
                          is_best=is_best, periodic=periodic)
    finally:
        if logger is not None:
            logger.close()
    return state, history
