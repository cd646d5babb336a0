"""More than one device (port of ``phnet_tpu/parallel``): the process group
of data-parallel training (:mod:`.multihost`) and the device mesh whose
``data`` axis splits the server's streams (:mod:`.mesh`)."""
from .mesh import Mesh, make_mesh
from .multihost import (all_reduce_mean, barrier, broadcast_module,
                        check_same_bits, initialize, is_multihost, rank,
                        world_size)

__all__ = ["Mesh", "make_mesh", "all_reduce_mean", "barrier",
           "broadcast_module", "check_same_bits", "initialize",
           "is_multihost", "rank", "world_size"]
