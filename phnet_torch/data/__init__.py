"""Training data of the port: synthetic clips and the clip loader."""
from .loader import ClipLoader, collate_clips
from .synthetic import SyntheticVideoDataset, synthetic_clip

__all__ = ["ClipLoader", "collate_clips", "SyntheticVideoDataset",
           "synthetic_clip"]
