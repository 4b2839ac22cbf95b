"""Base stereo dataset: a list of example records and a transformer chain.

Port of ``practicaldeepstereo_nips2018_tpu/data/dataset.py``. An example is
a nested dict

    {'left':  {'image': [H, W, 3] float32, 'disparity_image': [H, W] or None},
     'right': {'image': [H, W, 3] float32}}

channels last, RGB, values 0..255; unknown disparity is ``inf``. Images are
read with :func:`~.png.read_png`, which returns RGB directly.
"""

from __future__ import annotations

import copy
import random
from typing import Sequence

import numpy as np

from practicaldeepstereo_nips2018_tpu_torch.data import png


class Dataset:
    """List-of-example-records dataset with a transformer chain."""

    def __init__(self, examples_files: Sequence[dict],
                 transformers: list | None = None):
        """Args:
            examples_files: example records (nested dicts of file paths
                plus optional metadata).
            transformers: callables example -> example, applied in order by
                :meth:`__getitem__`; one whose ``wants_index`` is true is
                also given the example's index.
        """
        self._examples_files = list(examples_files)
        self._transformers = transformers

    def _subset(self, examples_files: Sequence[dict]):
        """A copy of this dataset (transformers and any per-instance
        settings) over other example records."""
        subset = copy.copy(self)
        subset._examples_files = list(examples_files)
        return subset

    def split_in_two(self, size_of_first_subset: int):
        """Returns (first, second) subsets, each keeping the transformers
        and settings of this one."""
        return (self._subset(self._examples_files[:size_of_first_subset]),
                self._subset(self._examples_files[size_of_first_subset:]))

    def append_transformers(self, transformers: list) -> None:
        if not isinstance(transformers, list):
            raise ValueError('"transformers" should be a list.')
        if self._transformers is None:
            self._transformers = transformers
        else:
            self._transformers = self._transformers + transformers

    def subsample(self, number_of_examples: int,
                  random_seed: int | None = None) -> None:
        """Keeps a random subset of examples. With a seed it is the subset
        the JAX package's ``random.seed(seed); random.sample(...)`` keeps,
        drawn from a generator of its own (without a seed, from the
        system's entropy)."""
        self._examples_files = random.Random(random_seed).sample(
            self._examples_files, number_of_examples)

    def __len__(self) -> int:
        return len(self._examples_files)

    def _read_image(self, image_filename: str) -> np.ndarray:
        """Returns an ``[H, W, 3]`` float32 RGB image (values 0..255)."""
        return png.read_png(image_filename, "color").astype(np.float32)

    def _read_disparity_image(self, example_files: dict):
        """Returns an ``[H, W]`` float32 disparity (inf = unknown) or
        None."""
        raise NotImplementedError(
            '"_read_disparity_image" should be implemented in a child class.')

    def get_example(self, index: int) -> dict:
        if index >= len(self):
            raise IndexError
        example_files = self._examples_files[index]
        return {
            "left": {
                "image": self._read_image(example_files["left"]["image"]),
                "disparity_image":
                    self._read_disparity_image(example_files),
            },
            "right": {
                "image": self._read_image(example_files["right"]["image"]),
            },
        }

    def example_files(self, index: int) -> dict:
        """Returns the raw example record (paths and metadata)."""
        return self._examples_files[index]

    def set_epoch(self, epoch: int) -> None:
        """Forwards the epoch to transformers that draw per (epoch,
        example), such as a seeded RandomCrop; the Loader calls it at each
        epoch."""
        for transformer in self._transformers or []:
            if hasattr(transformer, "set_epoch"):
                transformer.set_epoch(epoch)

    def __getitem__(self, index: int) -> dict:
        example = self.get_example(index)
        for transformer in self._transformers or []:
            if getattr(transformer, "wants_index", False):
                example = transformer(example, index)
            else:
                example = transformer(example)
        return example
