"""More than one device (port of ``phnet_tpu/parallel``): the process group
of data-parallel training (:mod:`.multihost`), the device mesh whose
``data`` axis splits the server's streams and the training batch and whose
``model`` axis tensor-shards the large kernels (:mod:`.mesh`), and the
sharded layers (:mod:`.tensor`)."""
from .mesh import TP_MIN_SIZE, Mesh, make_mesh, shard_params
from .multihost import (all_reduce_mean, barrier, broadcast_module,
                        check_same_bits, data_index, data_size, init_axes,
                        initialize, is_multihost, model_index, model_size,
                        rank, world_size)
from .tensor import shard_module

__all__ = ["TP_MIN_SIZE", "Mesh", "make_mesh", "shard_params",
           "all_reduce_mean", "barrier", "broadcast_module",
           "check_same_bits", "data_index", "data_size", "init_axes",
           "initialize", "is_multihost", "model_index", "model_size", "rank",
           "world_size", "shard_module"]
