"""The readers' temporal sampling in training: a clip of
``sampled_frames`` frames drawn from a video with gaps of at most
``max_skip``, and the ``max_skip`` curriculum (reference
``dataV3.py:101-130``; ``phnet_tpu/data/vil100.py:99-124``, which
``phnet_tpu/data/openlane.py`` repeats)."""

from __future__ import annotations

from typing import List

import numpy as np


class FrameSampling:
    """Mixin of the readers: ``self.rng`` (a ``np.random.Generator``),
    ``self.train``, ``self.sampled_frames``, ``self.max_skip``,
    ``self.increment`` and the class's ``MAX_TRAINING_SKIP``."""

    MAX_TRAINING_SKIP = 100
    rng: np.random.Generator

    def increase_max_skip(self):
        self.max_skip = min(self.max_skip + self.increment,
                            self.MAX_TRAINING_SKIP)

    def set_max_skip(self, max_skip: int):
        self.max_skip = max_skip

    def _sample_frames(self, frames: List[str]) -> List[str]:
        """In training, ``min(sampled_frames, len(frames))`` frames in
        order: the first uniform over the starts that leave room, each next
        one within ``max_skip`` of the last (and leaving room); the whole
        video otherwise. Draws from ``self.rng`` as the JAX readers do."""
        n = len(frames)
        if not self.train:
            return frames
        nsamples = min(self.sampled_frames, n)
        picked, last = [], -1
        for i in range(nsamples):
            if i == 0:
                last = int(self.rng.integers(0, n - nsamples + 1))
            else:
                hi = min(last + self.max_skip + 1, n - nsamples + i + 1)
                last = int(self.rng.integers(last + 1, hi))
            picked.append(frames[last])
        return picked
