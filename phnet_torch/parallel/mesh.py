"""Device mesh (port of ``phnet_tpu/parallel/mesh.py``).

A mesh lays local devices out over two axes, ``data`` and ``model``, as
the JAX package's ``make_mesh`` lays them out: ``devices`` is the
``(data, model)`` array, ``shape`` the axis sizes by name. The server
splits its streams over the ``data`` axis
(:class:`phnet_torch.serving.StreamingServer`'s ``mesh=``); data-parallel
training runs one process a device instead (:mod:`.multihost`).

The ``model`` axis (``shard_params``: tensor-sharding the large kernels)
is not ported yet: ``model_parallel > 1`` raises.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch


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
        """The devices along the ``data`` axis, in order."""
        return list(self.devices[:, 0])


def make_mesh(n_devices: Optional[int] = None, model_parallel: int = 1,
              devices: Optional[Sequence[Union[str, torch.device]]] = None
              ) -> Mesh:
    """A ``(data, model)`` mesh of ``devices`` (default every card), the
    first ``n_devices`` of them where given. A device may be named more
    than once (two replicas on one card). ``model_parallel > 1`` raises
    NotImplementedError."""
    if model_parallel != 1:
        raise NotImplementedError(
            f"model_parallel={model_parallel}: the mesh's model axis "
            "(shard_params) is not ported yet (ROADMAP.md Queue 1 item 3.3)")
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
    arr = np.empty((len(devices), 1), dtype=object)
    for i, d in enumerate(devices):
        arr[i, 0] = d
    return Mesh(arr)
