"""Data of the port: synthetic clips, the clip loader, and (in their own
modules) the VIL-100 and OpenLane-V readers, their decoders,
``transforms.TrainAugment``, the PNG codec (``png``) and the flow planes
(``flow``)."""
from .loader import ClipLoader, collate_clips
from .synthetic import SyntheticVideoDataset, synthetic_clip

__all__ = ["ClipLoader", "collate_clips", "SyntheticVideoDataset",
           "synthetic_clip"]
