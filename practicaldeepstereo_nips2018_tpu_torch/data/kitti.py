"""KITTI 2012 + 2015 stereo dataset.

Port of ``practicaldeepstereo_nips2018_tpu/data/kitti.py``:

* examples ``{index:06d}_10.png`` found in order from 0;
* KITTI 2012 ground truth: reflective-surface disparities replace the base
  ones where they are nonzero; zeros mean unknown and become inf;
* ``training_split``: KITTI 2012 then 2015 training examples, shuffled with
  seed 0 (``random.Random(0)``, the permutation of the JAX package's
  ``random.seed(0); random.shuffle``), the first 58 to validation;
* the 2012 and 2015 benchmark (testing) sets, without ground truth.

The 16-bit disparity PNGs (value = disparity * 256) are read as 8-bit
grayscale by default, as the reference does (``v >> 8``: whole pixels);
``use_sub_pixel_ground_truth=True`` reads ``v / 256``. It is a setting of
each dataset, where the JAX package has one for the class; ``split_in_two``
gives it to both halves.
"""

from __future__ import annotations

import os
import random

import numpy as np

from practicaldeepstereo_nips2018_tpu_torch.data import dataset, png


def _find_examples(left_images_folder: str,
                   right_images_folder: str,
                   disparity_images_folder: str | None = None,
                   reflective_disparity_images_folder: str | None = None
                   ) -> list[dict]:
    """Returns examples in index order."""
    examples = []
    example_index = 0
    while True:
        basename = f"{example_index:06d}_10.png"
        left_image_file = os.path.join(left_images_folder, basename)
        if not os.path.isfile(left_image_file):
            break
        disparity_image_file = None
        reflective_disparity_image_file = None
        if disparity_images_folder is not None:
            disparity_image_file = os.path.join(disparity_images_folder,
                                                basename)
        if reflective_disparity_images_folder is not None:
            reflective_disparity_image_file = os.path.join(
                reflective_disparity_images_folder, basename)
        examples.append({
            "left": {
                "image": left_image_file,
                "disparity_image": disparity_image_file,
                "reflective_disparity_image":
                    reflective_disparity_image_file,
            },
            "right": {
                "image": os.path.join(right_images_folder, basename)
            },
        })
        example_index += 1
    return examples


class Kitti(dataset.Dataset):
    """Combined KITTI 2012 / KITTI 2015 stereo dataset."""

    def __init__(self, examples_files, transformers: list | None = None,
                 use_sub_pixel_ground_truth: bool = False):
        super().__init__(examples_files, transformers)
        self.use_sub_pixel_ground_truth = use_sub_pixel_ground_truth

    def _read_single_disparity(self, filename: str) -> np.ndarray:
        if self.use_sub_pixel_ground_truth:
            raw = png.read_png(filename, "unchanged")
            return raw.astype(np.float32) / 256.0
        return png.read_png(filename, "grayscale").astype(np.float32)

    def _read_disparity_image(self, example_files: dict):
        disparity_image_file = example_files["left"]["disparity_image"]
        if disparity_image_file is None:
            return None
        disparity = self._read_single_disparity(disparity_image_file)
        reflective_file = example_files["left"].get(
            "reflective_disparity_image")
        if reflective_file is not None:
            reflective = self._read_single_disparity(reflective_file)
            available = reflective != 0
            disparity[available] = reflective[available]
        # Zeros encode unknown disparity in KITTI ground truth.
        disparity[disparity == 0] = np.inf
        return disparity

    @classmethod
    def training_split(cls, dataset_folder: str,
                       number_of_validation_examples: int = 58,
                       use_sub_pixel_ground_truth: bool = False):
        """Returns (training, validation), always the same seed-0 split."""
        examples = _find_examples(
            left_images_folder=os.path.join(
                dataset_folder, "data_stereo_flow", "training", "colored_0"),
            right_images_folder=os.path.join(
                dataset_folder, "data_stereo_flow", "training", "colored_1"),
            disparity_images_folder=os.path.join(
                dataset_folder, "data_stereo_flow", "training", "disp_occ"),
            reflective_disparity_images_folder=os.path.join(
                dataset_folder, "data_stereo_flow", "training",
                "disp_refl_occ"))
        examples += _find_examples(
            left_images_folder=os.path.join(
                dataset_folder, "data_scene_flow", "training", "image_2"),
            right_images_folder=os.path.join(
                dataset_folder, "data_scene_flow", "training", "image_3"),
            disparity_images_folder=os.path.join(
                dataset_folder, "data_scene_flow", "training", "disp_occ_0"))
        random.Random(0).shuffle(examples)
        validation, training = cls(
            examples, use_sub_pixel_ground_truth=use_sub_pixel_ground_truth
        ).split_in_two(number_of_validation_examples)
        return training, validation

    @classmethod
    def kitti2015_benchmark(cls, dataset_folder: str):
        return cls(_find_examples(
            left_images_folder=os.path.join(
                dataset_folder, "data_scene_flow", "testing", "image_2"),
            right_images_folder=os.path.join(
                dataset_folder, "data_scene_flow", "testing", "image_3")))

    @classmethod
    def kitti2012_benchmark(cls, dataset_folder: str):
        return cls(_find_examples(
            left_images_folder=os.path.join(
                dataset_folder, "data_stereo_flow", "testing", "colored_0"),
            right_images_folder=os.path.join(
                dataset_folder, "data_stereo_flow", "testing", "colored_1")))
