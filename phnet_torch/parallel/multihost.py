"""Data-parallel training over a ``torch.distributed`` process group (port
of ``phnet_tpu/parallel/multihost.py``; the reference's
``init_process_group`` DDP, ``trainVIL.py:156-161``).

One process a device. :func:`initialize` joins the group: NCCL for a CUDA
device, gloo for the CPU, at ``tcp://<coordinator>`` with the given world
size and rank, or from torchrun's ``env://`` variables. A rank on a card
takes ``cuda:{LOCAL_RANK}``. Nothing falls back: NCCL without a card
raises.

The JAX package computes the sharded step as one step over the global
batch; the port's ranks compute the same step. Each rank loads its shard
of the batch (``ClipLoader(num_shards=world, shard_index=rank)``), the
gradients and the metrics are all-reduced to their mean
(:func:`all_reduce_mean`), train-mode BatchNorm takes its statistics over
the global batch (``phnet_torch.ops.batchnorm``) and the dropout masks
are rows of the global batch's draw (:func:`batch_rand`). The parameters
and buffers start from rank 0's (:func:`broadcast_module`), and
:func:`check_same_bits` verifies that every rank holds the same bits.
Rank 0 alone writes the log and the checkpoints.

Without a process group every helper is the one-process case: world size
1, rank 0, no collective.
"""

from __future__ import annotations

import os
from typing import Iterable, Optional, Union

import torch
import torch.distributed as dist


def world_size() -> int:
    """Ranks in the process group (1 without one)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    """This process's rank (0 without a group)."""
    return dist.get_rank() if dist.is_initialized() else 0


def local_rank() -> int:
    """This process's index among the ranks of its host (torchrun's
    ``LOCAL_RANK``; 0 where it is not set)."""
    return int(os.environ.get("LOCAL_RANK", "0"))


def in_group() -> bool:
    """A process group is initialized (of any size)."""
    return dist.is_initialized()


def is_multihost() -> bool:
    """More than one rank."""
    return world_size() > 1


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               device: Union[str, torch.device, None] = None
               ) -> torch.device:
    """Join the process group and return this rank's device.

    ``coordinator_address`` (``host:port`` of rank 0) with
    ``num_processes`` and ``process_id`` gives ``tcp://host:port``;
    without it torchrun's ``MASTER_ADDR``, ``MASTER_PORT``,
    ``WORLD_SIZE`` and ``RANK`` are read (``env://``). ``device``: None or
    a CUDA device gives NCCL on ``cuda:{LOCAL_RANK}`` (a card is required:
    without one this raises); ``"cpu"`` gives gloo."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("initialize: NCCL needs a CUDA device and "
                               "none is available; pass device='cpu' for "
                               "gloo")
        dev = torch.device("cuda", local_rank() if dev.index is None
                           else dev.index)
        torch.cuda.set_device(dev)
        backend = "nccl"
    elif dev.type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"initialize: no backend for device {dev}")
    if coordinator_address is not None:
        if num_processes is None or process_id is None:
            raise ValueError("initialize: a coordinator needs num_processes "
                             "and process_id")
        kw = dict(init_method=f"tcp://{coordinator_address}",
                  world_size=num_processes, rank=process_id)
    else:
        kw = dict(init_method="env://")
    if backend == "nccl":
        kw["device_id"] = dev
    dist.init_process_group(backend, **kw)
    return dev


def shutdown():
    """Leave the process group (a no-op without one)."""
    if dist.is_initialized():
        dist.destroy_process_group()


def barrier():
    """Block until every rank gets here (a no-op without a group)."""
    if dist.is_initialized():
        dist.barrier()


def all_reduce_mean(buf: torch.Tensor) -> torch.Tensor:
    """``buf`` (a flat float32 tensor) replaced, in place, by its mean over
    the ranks; returned. The sum goes through the group's all-reduce,
    which gives every rank the same bits, then each rank divides by the
    world size. Without a group ``buf`` is returned as it is."""
    if dist.is_initialized():
        dist.all_reduce(buf)
        if dist.get_world_size() > 1:
            buf /= dist.get_world_size()
    return buf


def all_reduce_sum(buf: torch.Tensor) -> torch.Tensor:
    """``buf`` replaced, in place, by its sum over the ranks (BatchNorm's
    statistics); a no-op with one rank."""
    if is_multihost():
        dist.all_reduce(buf)
    return buf


def batch_rand(shape, generator: Optional[torch.Generator],
               device) -> torch.Tensor:
    """``torch.rand(shape)``, batch-major, as this rank's rows of one
    process's draw over the global batch: with W ranks the draw has
    ``W * shape[0]`` rows and rank r takes rows ``[r * shape[0], (r + 1) *
    shape[0])``, so that the ranks' dropout masks are those of the
    one-process step. With one rank, the draw of ``shape`` itself."""
    shape = tuple(shape)
    w = world_size()
    if w == 1:
        return torch.rand(shape, generator=generator, device=device)
    b = shape[0]
    full = torch.rand((w * b,) + shape[1:], generator=generator,
                      device=device)
    r = rank()
    return full[r * b:(r + 1) * b]


def _state(module: torch.nn.Module) -> Iterable[torch.Tensor]:
    return list(module.state_dict(keep_vars=True).values())


@torch.no_grad()
def broadcast_module(module: torch.nn.Module, src: int = 0):
    """Every parameter and buffer of ``module`` set to rank ``src``'s (a
    no-op with one rank)."""
    if not is_multihost():
        return
    for t in _state(module):
        dist.broadcast(t.data, src)


@torch.no_grad()
def check_same_bits(module: torch.nn.Module):
    """Raise RuntimeError unless every rank holds the same bits in every
    parameter and buffer of ``module`` (their bytes, as 32-bit words: the
    elementwise maximum and minimum over the ranks equal to the local
    words; a no-op with one rank)."""
    if not is_multihost():
        return
    words = []
    for t in _state(module):
        b = t.detach().contiguous().reshape(-1).view(torch.uint8)
        if b.numel() % 4:
            b = torch.cat([b, b.new_zeros(4 - b.numel() % 4)])
        words.append(b.view(torch.int32))
    local = torch.cat(words)
    hi, lo = local.clone(), local.clone()
    dist.all_reduce(hi, op=dist.ReduceOp.MAX)
    dist.all_reduce(lo, op=dist.ReduceOp.MIN)
    same = torch.tensor([int(torch.equal(hi, local)
                             and torch.equal(lo, local))], device=local.device)
    dist.all_reduce(same, op=dist.ReduceOp.MIN)
    if not same.item():
        raise RuntimeError(f"rank {rank()}: the ranks' parameters or "
                           f"buffers differ")
