"""Device mesh and the model axis's parameter placement (port of
``phnet_tpu/parallel/mesh.py``).

A mesh lays devices out over two axes, ``data`` and ``model``, as the JAX
package's ``make_mesh`` lays them out: ``devices`` is the ``(data,
model)`` array, ``reshape(n // m, m)`` of the device list, ``shape`` the
axis sizes by name. The server splits its streams over the ``data`` axis
and replicates its weights along ``model``
(:class:`phnet_torch.serving.StreamingServer`'s ``mesh=``); training runs
one process a device, its ranks laid out as the mesh
(:func:`.multihost.init_axes`), and tensor-shards the large kernels over
``model`` (:func:`shard_params` decides, :func:`.tensor.shard_module`
places).

:func:`shard_params` is the JAX package's rule, applied to the flax
leaf's shape: a kernel of rank >= 2 and at least ``min_size`` elements is
split over ``model`` on its last (output) dimension where the axis size
divides it, else on its first where it divides that, else it stays
whole. The port holds its kernels in PyTorch's layout
(:mod:`phnet_torch.convert`), so the flax dimension is translated: a
Linear's ``[in, out]`` is ``[out, in]`` (flax's last is torch dim 0, its
first dim 1), a conv's HWIO is OIHW (0 and 2, the kernel's rows) and a
1-D conv's ``[k, in, out]`` is ``[out, in, k]`` (0 and 2).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn as nn

from ..convert import LAYOUTS, flax_shape, module_layout

# only shard kernels with >= 64k elements by default (read at call time:
# the tests set it, as the JAX package's dry run passes ``min_size``)
TP_MIN_SIZE = 1 << 16

class Mesh:
    """``devices``: a ``(data, model)`` array of ``torch.device``;
    ``axis_names``: ``("data", "model")``; ``shape``: the size of each
    axis by name."""

    axis_names: Tuple[str, str] = ("data", "model")

    def __init__(self, devices: np.ndarray):
        self.devices = devices

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    def data_devices(self):
        """The devices along the ``data`` axis (the model axis's first
        column), in order."""
        return list(self.devices[:, 0])


def make_mesh(n_devices: Optional[int] = None, model_parallel: int = 1,
              devices: Optional[Sequence[Union[str, torch.device]]] = None
              ) -> Mesh:
    """A ``(data, model)`` mesh of ``devices`` (default every card), the
    first ``n_devices`` of them where given, ``model_parallel`` devices
    along ``model``. A device may be named more than once (two replicas,
    or two ranks, on one card)."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA device; pass devices= "
                               "(for example ['cpu', 'cpu'])")
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    if n_devices is not None:
        devices = devices[:n_devices]
    if not devices:
        raise ValueError("make_mesh: no devices")
    n = len(devices)
    if model_parallel < 1 or n % model_parallel:
        raise ValueError(f"make_mesh: {n} devices do not split into a "
                         f"model axis of {model_parallel}")
    arr = np.empty(n, dtype=object)
    arr[:] = devices
    return Mesh(arr.reshape(n // model_parallel, model_parallel))


def param_spec(shape: Sequence[int], model_size: int, min_size: int
               ) -> Optional[int]:
    """The JAX package's ``_param_spec`` on a flax shape: the flax
    dimension split over ``model`` (None: whole)."""
    ndim = len(shape)
    if model_size <= 1 or ndim < 2 or int(np.prod(shape)) < min_size:
        return None
    if shape[-1] % model_size == 0:
        return ndim - 1
    if shape[0] % model_size == 0:
        return 0
    return None


def torch_dim(flax_dim: Optional[int], change: str) -> Optional[int]:
    """The torch dimension holding flax dimension ``flax_dim``."""
    if flax_dim is None or not change:
        return flax_dim
    return LAYOUTS[change].index(flax_dim)


def shard_params(model: nn.Module, mesh: Mesh,
                 min_size: Optional[int] = None) -> Dict[str, Optional[int]]:
    """For every parameter of ``model`` (by its ``named_parameters``
    name): the torch dimension that the JAX rule splits over ``mesh``'s
    ``model`` axis, or None. ``min_size`` None reads
    :data:`TP_MIN_SIZE`. The decision is made on the flax leaf's shape
    (:func:`phnet_torch.convert.flax_shape`); the shapes read are the whole
    tensors' (a sharded parameter's whole shape is its placement's)."""
    min_size = TP_MIN_SIZE if min_size is None else min_size
    m = mesh.shape.get("model", 1)
    owners = dict(model.named_modules())
    out = {}
    for name, p in model.named_parameters():
        mod, _, leaf = name.rpartition(".")
        change = module_layout(owners[mod], leaf)
        placed = getattr(p, "tp_placement", None)
        shape = placed.full_shape if placed is not None else p.shape
        spec = param_spec(flax_shape(shape, change), m, min_size)
        out[name] = torch_dim(spec, change)
    return out
