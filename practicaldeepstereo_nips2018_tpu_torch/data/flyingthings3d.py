"""FlyingThings3D: discovery, disparity statistics, splits and protocols.

Port of ``practicaldeepstereo_nips2018_tpu/data/flyingthings3d.py``, with the
same selection, example for example:

* examples found by a sorted walk of ``frames_cleanpass``, each with its
  ``disparity/.../left/NNNN.pfm``;
* per example, the integer minimum and maximum disparity and a 512-bin
  cumulative distribution, cached as ``.npz`` next to each PFM (or under a
  cache folder, same file names), so a cache written by either package is
  read by the other. Missing statistics are computed in one threaded call
  of the C++ scanner (``data/native.py``), or in Python one PFM at a time
  (``use_native_scanner=False``, and for a file the scanner cannot read);
* the 74 frames with rendering artifacts;
* ``training_split``: TRAIN only, shuffled as ``random.seed(0);
  random.shuffle`` does (here with ``random.Random(0)``), artifacts and
  examples with any disparity outside [0, maximum] dropped, the first
  ``number_of_validation_examples`` to validation;
* ``small_training_split``: 3000 / 300 examples, 256x256 central crops,
  maximum disparity 127;
* ``benchmark_dataset``: the TEST split with ground truth above 192 masked;
  the CRL protocol also drops examples with more than 25 % of their pixels
  above 300 px, the PSM protocol keeps every one.
"""

from __future__ import annotations

import os
import random

import numpy as np

from practicaldeepstereo_nips2018_tpu_torch.data import dataset
from practicaldeepstereo_nips2018_tpu_torch.data import native
from practicaldeepstereo_nips2018_tpu_torch.data import pfm
from practicaldeepstereo_nips2018_tpu_torch.data import transforms

# Frames with rendering artifacts (reference flyingthings3d_dataset.py:16-57):
# scene -> inclusive frame range; 74 left images in all.
ARTIFACT_FRAMES = {
    "TRAIN/A/0011": (11, 15),
    "TRAIN/A/0534": (10, 13),
    "TRAIN/A/0690": (8, 9),
    "TRAIN/A/0705": (8, 15),
    "TRAIN/B/0386": (8, 15),
    "TRAIN/B/0576": (8, 15),
    "TRAIN/B/0609": (10, 11),
    "TRAIN/B/0643": (6, 15),
    "TRAIN/B/0653": (6, 12),
    "TRAIN/C/0511": (6, 15),
    "TRAIN/C/0599": (6, 15),
}


def _is_example_with_artifacts(path_to_left_image: str) -> bool:
    for scene, (first, last) in ARTIFACT_FRAMES.items():
        if scene in path_to_left_image:
            basename = os.path.basename(path_to_left_image)
            frame = int(os.path.splitext(basename)[0])
            if first <= frame <= last:
                return True
    return False


def _compute_cumulative_distribution(disparity_image: np.ndarray,
                                     minimum_disparity: int,
                                     maximum_disparity: int) -> np.ndarray:
    """512 bins, in percent: element n is the share of pixels with
    disparity < n + 1; out-of-range disparities fall in the end bins."""
    bins = ([min(minimum_disparity, 0)] + list(range(1, 512)) +
            [max(maximum_disparity, 512)])
    histogram = np.histogram(disparity_image.reshape(-1), bins=bins)[0]
    histogram = histogram / histogram.sum()
    return np.cumsum(histogram) * 100.0


def _statistic_filename(disparity_image_file: str,
                        cache_folder: str | None) -> str:
    base = os.path.splitext(disparity_image_file)[0] + ".npz"
    if cache_folder is None:
        return base
    return os.path.join(cache_folder,
                        base.replace(os.sep, "__").lstrip("_"))


def compute_disparity_statistic(disparity_image_file: str) -> dict:
    disparity_image = pfm.read_pfm(disparity_image_file)
    minimum_disparity = int(np.floor(disparity_image.min()))
    maximum_disparity = int(np.ceil(disparity_image.max()))
    return {
        "minimum_disparity": minimum_disparity,
        "maximum_disparity": maximum_disparity,
        "cumulative_distribution": _compute_cumulative_distribution(
            disparity_image, minimum_disparity, maximum_disparity),
    }


def _save_statistic(statistic_file: str, **arrays) -> None:
    """Writes a statistics cache through a temporary file and a rename, so
    that a process reading it (the other processes of a group scan the
    same dataset at the same time) finds it whole or not at all."""
    temporary = f"{statistic_file}.{os.getpid()}.tmp"
    try:
        with open(temporary, "wb") as handle:
            np.savez(handle, **arrays)
        os.replace(temporary, statistic_file)
    finally:
        if os.path.exists(temporary):
            os.remove(temporary)


def _load_or_compute_statistic(disparity_image_file: str,
                               cache_folder: str | None) -> dict:
    statistic_file = _statistic_filename(disparity_image_file, cache_folder)
    if os.path.isfile(statistic_file):
        with np.load(statistic_file) as content:
            return {
                "minimum_disparity": int(content["minimum_disparity"]),
                "maximum_disparity": int(content["maximum_disparity"]),
                "cumulative_distribution":
                    content["cumulative_distribution"],
            }
    statistic = compute_disparity_statistic(disparity_image_file)
    try:
        _save_statistic(statistic_file, **statistic)
    except OSError:
        pass  # read-only dataset and no cache folder: computed again later
    return statistic


def _folders_with_left_images(images_folder: str) -> list[str]:
    return sorted(folder for folder, _, files in os.walk(images_folder)
                  if files and "left" in folder)


def _scan_missing_statistics_native(missing_files: list[str],
                                    cache_folder: str | None) -> None:
    """Computes the statistics of ``missing_files`` with the C++ scanner
    and writes their caches as the JAX package does (the float32
    cumulative distribution stored as float64). A file the scanner could
    not read, or whose cache cannot be written, is left to the Python
    path."""
    minimums, maximums, cumulatives, status = (
        native.scan_disparity_statistics(missing_files))
    for index, disparity_file in enumerate(missing_files):
        if status[index] != 0:
            continue
        try:
            _save_statistic(_statistic_filename(disparity_file, cache_folder),
                            minimum_disparity=int(minimums[index]),
                            maximum_disparity=int(maximums[index]),
                            cumulative_distribution=cumulatives[index].astype(
                                np.float64))
        except OSError:
            continue


def find_examples(dataset_folder: str,
                  cache_folder: str | None = None,
                  use_native_scanner: bool = True) -> list[dict]:
    """FlyingThings3D example records in a fixed order.

    Args:
        dataset_folder: holds ``frames_cleanpass`` (images) and
            ``disparity`` (PFM ground truth).
        cache_folder: where the statistics files go (default: next to each
            PFM).
        use_native_scanner: compute the missing statistics with the C++
            scanner first (its build raises if it fails); else in Python.

    Each record holds the image and disparity paths, ``minimum_disparity``,
    ``maximum_disparity`` and ``cumulative_distribution_from_0_to_511``.
    """
    dataset_folder = os.path.abspath(dataset_folder)
    images_folder = os.path.join(dataset_folder, "frames_cleanpass")
    disparity_folder = os.path.join(dataset_folder, "disparity")
    if cache_folder is not None:
        os.makedirs(cache_folder, exist_ok=True)
    records = []
    for folder in _folders_with_left_images(images_folder):
        for basename in sorted(name for name in os.listdir(folder)
                               if name.endswith(".png")):
            left_image_file = os.path.join(folder, basename)
            right_image_file = os.path.join(
                os.path.dirname(folder), "right", basename)
            relative = os.path.relpath(left_image_file, images_folder)
            disparity_image_file = os.path.join(
                disparity_folder, os.path.splitext(relative)[0] + ".pfm")
            records.append((left_image_file, right_image_file,
                            disparity_image_file))
    if use_native_scanner:
        missing = [disparity for _, _, disparity in records
                   if not os.path.isfile(_statistic_filename(disparity,
                                                             cache_folder))]
        if missing:
            _scan_missing_statistics_native(missing, cache_folder)
    examples = []
    for left_image_file, right_image_file, disparity_image_file in records:
        statistic = _load_or_compute_statistic(disparity_image_file,
                                               cache_folder)
        examples.append({
            "left": {
                "image": left_image_file,
                "disparity_image": disparity_image_file,
            },
            "right": {
                "image": right_image_file
            },
            "minimum_disparity": statistic["minimum_disparity"],
            "maximum_disparity": statistic["maximum_disparity"],
            "cumulative_distribution_from_0_to_511":
                statistic["cumulative_distribution"],
        })
    return examples


def precompute_disparity_statistics(dataset_folder: str,
                                    cache_folder: str | None = None) -> int:
    """Writes every missing statistics file (the C++ scanner); returns the
    number of examples."""
    return len(find_examples(dataset_folder, cache_folder))


def _split_training_test(examples: list[dict]):
    training = [e for e in examples if "TRAIN" in e["left"]["image"]]
    test = [e for e in examples if "TEST" in e["left"]["image"]]
    return training, test


def _filter_disparity_range(examples: list[dict],
                            maximum_disparity: float) -> list[dict]:
    return [
        e for e in examples
        if (e["maximum_disparity"] <= maximum_disparity
            and e["minimum_disparity"] >= 0)
    ]


def _filter_crl_large_disparities(
        examples: list[dict], maximum_percentage_of_large_disparities: float,
        large_disparity: int) -> list[dict]:
    return [
        e for e in examples
        if (100.0 - e["cumulative_distribution_from_0_to_511"]
            [large_disparity]) < maximum_percentage_of_large_disparities
    ]


class FlyingThings3D(dataset.Dataset):
    """FlyingThings3D stereo dataset."""

    def _read_disparity_image(self, example_files: dict) -> np.ndarray:
        return pfm.read_pfm(example_files["left"]["disparity_image"])

    @classmethod
    def training_split(cls,
                       dataset_folder: str,
                       number_of_validation_examples: int = 500,
                       maximum_disparity: float = 255,
                       cache_folder: str | None = None):
        """Returns (training, validation): TRAIN examples without rendering
        artifacts whose disparities all lie in [0, maximum_disparity],
        shuffled with seed 0, the first ``number_of_validation_examples``
        to validation."""
        examples = find_examples(dataset_folder, cache_folder)
        random.Random(0).shuffle(examples)
        examples = _split_training_test(examples)[0]
        examples = [
            e for e in examples
            if not _is_example_with_artifacts(e["left"]["image"])
        ]
        examples = _filter_disparity_range(examples, maximum_disparity)
        validation, training = cls(examples).split_in_two(
            number_of_validation_examples)
        return training, validation

    @classmethod
    def small_training_split(cls,
                             dataset_folder: str,
                             maximum_disparity: float = 127,
                             number_of_validation_examples: int = 300,
                             number_of_training_examples: int = 3000,
                             height: int = 256,
                             width: int = 256,
                             cache_folder: str | None = None):
        """The tuning split: 3000 / 300 examples, central crops, maximum
        disparity 127."""
        training, validation = cls.training_split(
            dataset_folder,
            number_of_validation_examples=number_of_validation_examples,
            maximum_disparity=maximum_disparity,
            cache_folder=cache_folder)
        training = training.split_in_two(number_of_training_examples)[0]
        crop = [transforms.CentralCrop(height, width)]
        training.append_transformers(crop)
        validation.append_transformers(crop)
        return training, validation

    @classmethod
    def benchmark_dataset(cls,
                          dataset_folder: str,
                          is_psm_protocol: bool,
                          maximum_disparity: float = 192,
                          maximum_percentage_of_large_disparities: float = 25.0,
                          large_disparity: int = 300,
                          cache_folder: str | None = None):
        """The TEST split under the PSM or CRL protocol: ground truth above
        ``maximum_disparity`` masked to inf; CRL also drops examples with
        more than 25 % of their pixels above 300 px."""
        examples = find_examples(dataset_folder, cache_folder)
        examples = _split_training_test(examples)[1]
        mask = [transforms.MaskLargeDisparities(maximum_disparity)]
        if not is_psm_protocol:
            examples = _filter_crl_large_disparities(
                examples, maximum_percentage_of_large_disparities,
                large_disparity)
        return cls(examples, mask)
