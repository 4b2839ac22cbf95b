"""Example transformers: callables example -> example.

Port of ``practicaldeepstereo_nips2018_tpu/data/transforms.py``:
``CentralCrop`` (the small training split), ``RandomCrop`` (uniform batches,
its position drawn from (seed, epoch, example index)), ``PadToSize``
(top/left padding to one size, unknown disparity in the pad) and
``MaskLargeDisparities`` (the benchmark protocols).
"""

from __future__ import annotations

import random

import numpy as np


def _crop_example(example: dict, y_start: int, x_start: int, height: int,
                  width: int) -> dict:
    for side in ("left", "right"):
        for key, value in example[side].items():
            if value is None or not hasattr(value, "shape"):
                continue
            example[side][key] = value[y_start:y_start + height,
                                       x_start:x_start + width]
    return example


class CentralCrop:
    """Crops the same central area from the images and the disparity."""

    def __init__(self, height: int, width: int):
        self._height = height
        self._width = width

    def __call__(self, example: dict) -> dict:
        full_height, full_width = example["left"]["image"].shape[:2]
        y_start = (full_height - self._height) // 2
        x_start = (full_width - self._width) // 2
        return _crop_example(example, y_start, x_start, self._height,
                             self._width)


class RandomCrop:
    """Crops the same random area from the images and the disparity.

    The position is drawn from ``random.Random((seed * 1000003 + epoch) *
    1000003 + index)``, as in the JAX package: the Dataset passes the
    example's index (``wants_index``) and the Loader the epoch, so a run and
    its resume crop alike. A given ``rng`` replaces that generator.
    """

    wants_index = True

    def __init__(self, height: int, width: int,
                 rng: random.Random | None = None, seed: int = 0):
        self._height = height
        self._width = width
        self._rng = rng
        self._seed = seed
        self._epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self._epoch = epoch

    def __call__(self, example: dict, index: int = 0) -> dict:
        rng = self._rng
        if rng is None:
            rng = random.Random(
                (self._seed * 1_000_003 + self._epoch) * 1_000_003 + index)
        full_height, full_width = example["left"]["image"].shape[:2]
        y_start = rng.randint(0, max(0, full_height - self._height))
        x_start = rng.randint(0, max(0, full_width - self._width))
        return _crop_example(example, y_start, x_start, self._height,
                             self._width)


class PadToSize:
    """Pads the images with zeros and the disparity with inf, on the top
    and left (the network's own padding side), to a fixed size."""

    def __init__(self, height: int, width: int):
        self._height = height
        self._width = width

    def __call__(self, example: dict) -> dict:
        for side in ("left", "right"):
            for key, value in example[side].items():
                if value is None or not hasattr(value, "shape"):
                    continue
                pad_h = self._height - value.shape[0]
                pad_w = self._width - value.shape[1]
                if pad_h < 0 or pad_w < 0:
                    raise ValueError(
                        f"example of size {value.shape[:2]} exceeds pad "
                        f"target ({self._height}, {self._width})")
                pad = [(pad_h, 0), (pad_w, 0)] + [(0, 0)] * (value.ndim - 2)
                fill = np.inf if key == "disparity_image" else 0.0
                example[side][key] = np.pad(value, pad, constant_values=fill)
        return example


class MaskLargeDisparities:
    """Sets disparities outside [0, maximum] to inf (unknown)."""

    def __init__(self, maximum_disparity: float):
        self._maximum_disparity = maximum_disparity

    def __call__(self, example: dict) -> dict:
        disparity = example["left"].get("disparity_image")
        if disparity is not None:
            out_of_range = (disparity < 0) | (disparity >
                                              self._maximum_disparity)
            disparity = disparity.copy()
            disparity[out_of_range] = np.inf
            example["left"]["disparity_image"] = disparity
        return example
