from .encoder import Encoder
from .flow_warp import FrozenBatchNorm, WarpModel, flow_warp
from .head import HeadOutputs, LaneHead
from .phnet import PHNet, MemoryState, init_memory
from .seg_decoder import SegDecoder

__all__ = ["Encoder", "FrozenBatchNorm", "HeadOutputs", "LaneHead", "PHNet",
           "MemoryState", "SegDecoder", "WarpModel", "flow_warp",
           "init_memory"]
