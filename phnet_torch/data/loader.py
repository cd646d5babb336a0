"""Clip loader: sharding, shuffling, prefetch, fixed-shape collation.

Counterpart of ``phnet_tpu/data/loader.py`` (the reference's DataLoader
and DistributedSampler, ``trainVIL.py:96-103``): per-process index
sharding (every shard padded to the same number of batches), an
epoch-seeded shuffle (``set_epoch``), a background thread that prepares
up to ``prefetch`` batches ahead, and collation to ``[B, T, ...]``.

Clips may hold their frames as tensors on the card (the readers' train
mode), and their segmentation and flow planes (``seg``, ``flow``, which
ride in ``infos`` as in the JAX loader); these then stay there. The
worker thread makes them on a stream of its own and hands each batch over
with an event that the consumer's stream waits for, so that the step
never reads a frame or a plane before it is written; each of the batch's
card tensors is recorded on the consumer's stream for the caching
allocator. An exception in the worker is raised in the consumer
(the JAX loader's worker ends the epoch early instead, its ``finally``
hiding the error).
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, List, Sequence

import numpy as np
import torch


def collate_clips(samples: Sequence[Dict]) -> Dict:
    """Per-clip dicts to ``frames`` [B, T, H, W, 3] (a tensor when the
    clips hold tensors, else an array) and ``labels`` [B, T, L, dim]
    arrays, and ``infos``: each clip's other fields
    (``dataV3.py:23-42`` ``multibatch_collate_fn``)."""
    frames = [s["frames"] for s in samples]
    out = {"frames": (torch.stack(frames) if torch.is_tensor(frames[0])
                      else np.stack(frames)),
           "labels": np.stack([s["labels"] for s in samples])}
    out["infos"] = [{k: s[k] for k in s if k not in ("frames", "labels")}
                    for s in samples]
    return out


def _tensors(batch: Dict):
    """The batch's tensors: its frames and its clips' tensor fields."""
    if torch.is_tensor(batch["frames"]):
        yield batch["frames"]
    for info in batch["infos"]:
        yield from (v for v in info.values() if torch.is_tensor(v))


class _Failure:
    def __init__(self, exc: BaseException):
        self.exc = exc


_END = object()


class ClipLoader:
    def __init__(self, dataset, batch_size: int = 1, shuffle: bool = True,
                 seed: int = 3407, num_shards: int = 1, shard_index: int = 0,
                 prefetch: int = 2, drop_last: bool = True):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.num_shards = num_shards
        self.shard_index = shard_index
        self.prefetch = prefetch
        self.drop_last = drop_last
        self.epoch = 0

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def indices(self) -> List[int]:
        n = len(self.dataset)
        idx = np.arange(n)
        if self.shuffle:
            np.random.default_rng(self.seed + self.epoch).shuffle(idx)
        # pad so every shard sees the same number of batches
        per = -(-n // self.num_shards)
        idx = np.concatenate([idx, idx[: per * self.num_shards - n]])
        return idx[self.shard_index::self.num_shards].tolist()

    def __len__(self):
        per_shard = -(-len(self.dataset) // self.num_shards)
        if self.drop_last:
            return per_shard // self.batch_size
        return -(-per_shard // self.batch_size)

    def _batches(self) -> List[List[int]]:
        idx = self.indices()
        batches = [idx[i:i + self.batch_size]
                   for i in range(0, len(idx), self.batch_size)]
        if self.drop_last:
            batches = [b for b in batches if len(b) == self.batch_size]
        return batches

    def _collate(self, b: List[int]) -> Dict:
        return collate_clips([self.dataset[i] for i in b])

    def __iter__(self) -> Iterator[Dict]:
        batches = self._batches()
        if self.prefetch <= 0:
            for b in batches:
                yield self._collate(b)
            return
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        closed = threading.Event()
        cuda = torch.cuda.is_available()
        device = torch.cuda.current_device() if cuda else None

        def put(item) -> bool:
            while not closed.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            try:
                if cuda:
                    torch.cuda.set_device(device)
                    stream = torch.cuda.Stream(device)
                for b in batches:
                    if cuda:
                        with torch.cuda.stream(stream):
                            batch = self._collate(b)
                            ready = torch.cuda.Event()
                            ready.record(stream)
                    else:
                        batch, ready = self._collate(b), None
                    if not put((batch, ready)):
                        return
                put(_END)
            except BaseException as exc:  # raised in the consumer
                put(_Failure(exc))

        th = threading.Thread(target=worker, daemon=True,
                              name="ClipLoader-prefetch")
        th.start()
        try:
            while True:
                item = q.get()
                if item is _END:
                    break
                if isinstance(item, _Failure):
                    raise item.exc
                batch, ready = item
                if ready is not None:
                    on_card = [t for t in _tensors(batch) if t.is_cuda]
                    for dev in {t.device for t in on_card}:
                        torch.cuda.current_stream(dev).wait_event(ready)
                    for t in on_card:
                        t.record_stream(torch.cuda.current_stream(t.device))
                yield batch
        finally:
            closed.set()
            th.join()
