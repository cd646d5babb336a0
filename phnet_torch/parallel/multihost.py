"""Data-parallel training over a ``torch.distributed`` process group (port
of ``phnet_tpu/parallel/multihost.py``; the reference's
``init_process_group`` DDP, ``trainVIL.py:156-161``).

One process a device. :func:`initialize` joins the group: NCCL for a CUDA
device, gloo for the CPU, or the backend the caller names, at
``tcp://<coordinator>`` with the given world size and rank, or from
torchrun's ``env://`` variables. A rank on a card takes
``cuda:{LOCAL_RANK}``. Nothing falls back: NCCL without a card raises.

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

A mesh with a ``model`` axis (:func:`init_axes`) splits the group into
axis groups as the JAX package's ``make_mesh`` lays devices out: rank r
sits at ``(r // m, r % m)`` of the ``(data, model)`` array, so that the
model groups are runs of m consecutive ranks and the data groups every
m-th rank. The data axis then takes the place of the world above: the
loader's shard, BatchNorm's statistics and the dropout masks follow the
data index and size (the m ranks of one data row load, normalize and
drop alike), and the model axis carries the tensor-sharded layers'
collectives (:mod:`.tensor`). Without axes the data axis is the world and
the model axis has size 1.

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
               device: Union[str, torch.device, None] = None,
               backend: Optional[str] = None) -> torch.device:
    """Join the process group and return this rank's device.

    ``coordinator_address`` (``host:port`` of rank 0) with
    ``num_processes`` and ``process_id`` gives ``tcp://host:port``;
    without it torchrun's ``MASTER_ADDR``, ``MASTER_PORT``,
    ``WORLD_SIZE`` and ``RANK`` are read (``env://``). ``device``: None or
    a CUDA device puts the rank on ``cuda:{LOCAL_RANK}`` (a card is
    required: without one this raises); ``"cpu"`` on the CPU.
    ``backend``: None gives NCCL for a card and gloo for the CPU; a name
    (``"gloo"`` for ranks that share one card, which NCCL refuses) is
    taken as it is."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("initialize: NCCL needs a CUDA device and "
                               "none is available; pass device='cpu' for "
                               "gloo")
        dev = torch.device("cuda", local_rank() if dev.index is None
                           else dev.index)
        torch.cuda.set_device(dev)
        backend = backend or "nccl"
    elif dev.type == "cpu":
        backend = backend or "gloo"
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
    """Leave the process group and drop its axis groups (a no-op without
    one)."""
    global _AXES
    _AXES = None
    if dist.is_initialized():
        dist.destroy_process_group()


# -- the mesh's axes -----------------------------------------------------------

class _Axes:
    """This rank's place on a ``(data, model)`` mesh of the group and the
    axis groups holding it."""

    def __init__(self, data: int, model: int):
        w, r = world_size(), rank()
        self.shape = {"data": data, "model": model}
        self.index = {"data": r // model, "model": r % model}
        # every rank creates every group, in one order: the model groups
        # (consecutive ranks), then the data groups (every model-th rank)
        rows = [list(range(i * model, (i + 1) * model)) for i in range(data)]
        cols = [list(range(j, w, model)) for j in range(model)]
        made = {"model": [dist.new_group(g) for g in rows],
                "data": [dist.new_group(g) for g in cols]}
        self.groups = {"model": made["model"][self.index["data"]],
                       "data": made["data"][self.index["model"]]}


_AXES: Optional[_Axes] = None


def init_axes(mesh) -> None:
    """Lay the group's ranks out as ``mesh`` (:class:`.mesh.Mesh`; its
    ``shape`` is read) and make its axis groups; again with the same
    shape keeps them. The mesh must hold one device a rank."""
    global _AXES
    data, model = mesh.shape["data"], mesh.shape["model"]
    if data * model != world_size():
        raise ValueError(f"a mesh of {data} x {model} devices for a group "
                         f"of {world_size()} ranks")
    if _AXES is not None and _AXES.shape == {"data": data, "model": model}:
        return
    _AXES = _Axes(data, model) if world_size() > 1 else None


def axis_size(axis: str) -> int:
    """Ranks along ``axis`` ("data" or "model"): without axes the world
    and 1."""
    if _AXES is None:
        return world_size() if axis == "data" else 1
    return _AXES.shape[axis]


def axis_index(axis: str) -> int:
    """This rank's index along ``axis``: without axes the rank and 0."""
    if _AXES is None:
        return rank() if axis == "data" else 0
    return _AXES.index[axis]


def data_size() -> int:
    return axis_size("data")


def data_index() -> int:
    return axis_index("data")


def model_size() -> int:
    return axis_size("model")


def model_index() -> int:
    return axis_index("model")


def axis_group(axis: Optional[str]):
    """The process group of ``axis`` (None: the world)."""
    return None if axis is None or _AXES is None else _AXES.groups[axis]


def _size(axis: Optional[str]) -> int:
    return world_size() if axis is None else axis_size(axis)


def barrier():
    """Block until every rank gets here (a no-op without a group)."""
    if dist.is_initialized():
        dist.barrier()


def all_reduce_mean(buf: torch.Tensor, axis: Optional[str] = None
                    ) -> torch.Tensor:
    """``buf`` (a flat float32 tensor) replaced, in place, by its mean over
    the ranks (of the world, or of this rank's ``axis`` group); returned.
    The sum goes through the group's all-reduce, which gives every rank
    the same bits, then each rank divides by the group's size. Without a
    group ``buf`` is returned as it is."""
    if dist.is_initialized() and (axis is None or _size(axis) > 1):
        dist.all_reduce(buf, group=axis_group(axis))
        if _size(axis) > 1:
            buf /= _size(axis)
    return buf


def all_reduce_sum(buf: torch.Tensor, axis: Optional[str] = None
                   ) -> torch.Tensor:
    """``buf`` replaced, in place, by its sum over the ranks (of the world,
    or of ``axis``'s group: BatchNorm's statistics over ``data``); a no-op
    with one rank there."""
    if _size(axis) > 1:
        dist.all_reduce(buf, group=axis_group(axis))
    return buf


def batch_rand(shape, generator: Optional[torch.Generator],
               device) -> torch.Tensor:
    """``torch.rand(shape)``, batch-major, as this rank's rows of one
    process's draw over the global batch: with D ranks along the data
    axis (the world without a mesh) the draw has ``D * shape[0]`` rows and
    data index d takes rows ``[d * shape[0], (d + 1) * shape[0])``, so
    that the ranks' dropout masks are those of the one-process step and
    the ranks of one model group draw the same. With one, the draw of
    ``shape`` itself."""
    shape = tuple(shape)
    w = data_size()
    if w == 1:
        return torch.rand(shape, generator=generator, device=device)
    b = shape[0]
    full = torch.rand((w * b,) + shape[1:], generator=generator,
                      device=device)
    r = data_index()
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


def _words(tensors) -> torch.Tensor:
    words = []
    for t in tensors:
        b = t.detach().contiguous().reshape(-1).view(torch.uint8)
        if b.numel() % 4:
            b = torch.cat([b, b.new_zeros(4 - b.numel() % 4)])
        words.append(b.view(torch.int32))
    return torch.cat(words)


def _first_rank(axis: Optional[str]) -> int:
    """The global rank of the first rank of the world (or of this rank's
    ``axis`` group)."""
    if axis is None or _AXES is None:
        return 0
    if axis == "data":  # every model-th rank, from this model index
        return axis_index("model")
    return axis_index("data") * axis_size("model")


def _same_over(local: torch.Tensor, axis: Optional[str]) -> torch.Tensor:
    """1 where this rank holds the words ``local`` of the first rank of the
    world (or of ``axis``'s group), broadcast to it; else 0."""
    ref = local.clone()
    dist.broadcast(ref, _first_rank(axis), group=axis_group(axis))
    return torch.tensor([int(torch.equal(ref, local))], device=local.device)


@torch.no_grad()
def same_over(tensors, axis: Optional[str]) -> bool:
    """Every rank of the world (or of ``axis``'s group) holds the bits of
    ``tensors`` (the answer is the same on all of them); True with one
    rank there."""
    if _size(axis) == 1:
        return True
    same = _same_over(_words(tensors), axis)
    dist.all_reduce(same, op=dist.ReduceOp.MIN, group=axis_group(axis))
    return bool(same.item())


@torch.no_grad()
def check_same_bits(module: torch.nn.Module):
    """Raise RuntimeError unless every rank holds the same bits in every
    parameter and buffer of ``module`` (their bytes, as 32-bit words,
    against the first rank's, broadcast); a no-op with one rank. A
    parameter sharded over the model axis
    (:mod:`.tensor`) is held to the ranks of its data group, which hold
    the same block; every other tensor to the whole world."""
    if not is_multihost():
        return
    from .tensor import placement

    state = _state(module)
    whole = [t for t in state if placement(t) is None]
    sharded = [t for t in state if placement(t) is not None]
    same = _same_over(_words(whole), None)
    if sharded and data_size() > 1:
        same = same & _same_over(_words(sharded), "data")
    dist.all_reduce(same, op=dist.ReduceOp.MIN)
    if not same.item():
        raise RuntimeError(f"rank {rank()}: the ranks' parameters or "
                           f"buffers differ")
