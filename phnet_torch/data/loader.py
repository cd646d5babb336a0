"""Clip loader: seeded per-epoch shuffling and batching, the last
incomplete batch dropped (the parts of ``phnet_tpu/data/loader.py`` a
one-process training run needs; no sharding, no prefetch thread)."""

from __future__ import annotations

from typing import Dict, Iterator, Sequence

import numpy as np


def collate_clips(samples: Sequence[Dict]) -> Dict:
    """Per-clip dicts to ``frames`` [B, T, H, W, 3] and ``labels``
    [B, T, L, dim] arrays."""
    return {"frames": np.stack([s["frames"] for s in samples]),
            "labels": np.stack([s["labels"] for s in samples])}


class ClipLoader:
    def __init__(self, dataset, batch_size: int = 1, seed: int = 3407):
        self.dataset = dataset
        self.batch_size = batch_size
        self.seed = seed
        self.epoch = 0

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def indices(self):
        idx = np.arange(len(self.dataset))
        np.random.default_rng(self.seed + self.epoch).shuffle(idx)
        return idx.tolist()

    def __len__(self):
        return len(self.dataset) // self.batch_size

    def __iter__(self) -> Iterator[Dict]:
        idx = self.indices()
        for i in range(len(self)):
            yield collate_clips([self.dataset[j] for j in
                                 idx[i * self.batch_size:
                                     (i + 1) * self.batch_size]])
