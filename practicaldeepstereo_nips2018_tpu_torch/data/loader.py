"""Host input pipeline: threaded prefetch, batching, host shards, and the
copy of a batch to the card.

Port of ``practicaldeepstereo_nips2018_tpu/data/loader.py``. :class:`Loader`
iterates a :class:`~.dataset.Dataset` and yields batches, nested dicts of
stacked float32 numpy arrays

    {'left': {'image': [B, H, W, 3], 'disparity_image': [B, H, W]},
     'right': {'image': [B, H, W, 3]},
     'names': [B source-file basenames]}

(``disparity_image`` left out when the dataset has no ground truth). A
thread pool decodes ``prefetch_factor * num_workers`` examples ahead;
shuffling is deterministic in (seed, epoch). :func:`batch_to_device` turns
a batch into tensors on the device.
"""

from __future__ import annotations

import concurrent.futures
import os
import random
from typing import Iterator

import numpy as np
import torch


def _stack_examples(examples: list[dict]) -> dict:
    batch = {
        "left": {
            "image": np.stack([e["left"]["image"] for e in examples]),
        },
        "right": {
            "image": np.stack([e["right"]["image"] for e in examples]),
        },
    }
    disparities = [e["left"].get("disparity_image") for e in examples]
    if all(d is not None for d in disparities):
        batch["left"]["disparity_image"] = np.stack(disparities)
    return batch


def batch_to_device(batch: dict, device: str | torch.device) -> dict:
    """The batch with every array a tensor on ``device`` (``names`` and
    other entries as they are).

    For a CUDA device each array is copied into a fresh pinned host tensor
    and from there to the card with ``non_blocking=True``, so the copy does
    not hold up the host. The pinned tensor is not reused: PyTorch's pinned
    allocator keeps its memory until the copy that reads it has run."""
    device = torch.device(device)

    def move(array):
        tensor = torch.from_numpy(np.ascontiguousarray(array))
        if device.type == "cuda":
            return tensor.pin_memory().to(device, non_blocking=True)
        return tensor.to(device)

    return {key: {name: move(array) for name, array in value.items()}
            if isinstance(value, dict) else value
            for key, value in batch.items()}


class Loader:
    """Prefetching, sharding batch loader over an indexable dataset."""

    def __init__(self,
                 dataset,
                 batch_size: int = 1,
                 shuffle: bool = False,
                 num_workers: int = 3,
                 drop_last: bool = False,
                 seed: int = 0,
                 host_index: int = 0,
                 host_count: int = 1,
                 prefetch_factor: int = 2,
                 equal_shards: bool = False):
        """Args:
            dataset: indexable dataset of example dicts.
            batch_size: examples per batch on this host.
            shuffle: a new example order each epoch, drawn from
                ``random.Random(seed + epoch)``.
            num_workers: decode threads.
            drop_last: drop the trailing incomplete batch.
            host_index, host_count: this host's shard of each epoch's order
                (every ``host_count``-th example from ``host_index``).
            prefetch_factor: examples decoded ahead, per worker.
            equal_shards: cut every shard to the shortest one's length, so
                that every host takes the same number of steps.
        """
        self._dataset = dataset
        self._batch_size = batch_size
        self._shuffle = shuffle
        self._num_workers = max(1, num_workers)
        self._drop_last = drop_last
        self._seed = seed
        self._host_index = host_index
        self._host_count = host_count
        self._prefetch = max(1, prefetch_factor) * max(1, num_workers)
        self._equal_shards = equal_shards
        self._epoch = 0

    def set_epoch(self, epoch: int) -> None:
        """Sets the epoch used for the deterministic shuffle."""
        self._epoch = epoch

    def epoch_indices(self) -> list[int]:
        """The dataset indices this host visits in the current epoch, in
        order."""
        indices = list(range(len(self._dataset)))
        if self._shuffle:
            random.Random(self._seed + self._epoch).shuffle(indices)
        shard = indices[self._host_index::self._host_count]
        if self._equal_shards and self._host_count > 1:
            shard = shard[:len(indices) // self._host_count]
        return shard

    def __len__(self) -> int:
        number = len(self.epoch_indices())
        if self._drop_last:
            return number // self._batch_size
        return -(-number // self._batch_size)

    def _example_names(self, indices: list[int]) -> list[str] | None:
        """Source-file basenames of the batch's examples (the submission
        files are named after them), or None when the dataset has no path
        records."""
        if not hasattr(self._dataset, "example_files"):
            return None
        names = []
        for index in indices:
            record = self._dataset.example_files(index)
            try:
                path = record["left"]["image"]
            except (KeyError, TypeError):
                return None
            names.append(os.path.basename(path))
        return names

    def _build_batch(self, examples: list[dict],
                     indices: list[int]) -> dict:
        batch = _stack_examples(examples)
        names = self._example_names(indices)
        if names is not None:
            batch["names"] = names
        return batch

    def __iter__(self) -> Iterator[dict]:
        if hasattr(self._dataset, "set_epoch"):
            self._dataset.set_epoch(self._epoch)
        indices = self.epoch_indices()
        with concurrent.futures.ThreadPoolExecutor(
                max_workers=self._num_workers) as pool:
            pending = []
            cursor = 0

            def enqueue():
                nonlocal cursor
                while cursor < len(indices) and len(pending) < self._prefetch:
                    pending.append(
                        (pool.submit(self._dataset.__getitem__,
                                     indices[cursor]), indices[cursor]))
                    cursor += 1

            enqueue()
            batch, batch_indices = [], []
            while pending:
                future, index = pending.pop(0)
                example = future.result()
                enqueue()
                batch.append(example)
                batch_indices.append(index)
                if len(batch) == self._batch_size:
                    yield self._build_batch(batch, batch_indices)
                    batch, batch_indices = [], []
            if batch and not self._drop_last:
                yield self._build_batch(batch, batch_indices)
        self._epoch += 1
