"""Data pipeline: PNG and PFM IO, datasets, transforms, the prefetching
loader and the copy of a batch to the card. numpy and the standard library
only (OpenCV is used for PNG decoding when it is installed)."""

from practicaldeepstereo_nips2018_tpu_torch.data.dataset import Dataset
from practicaldeepstereo_nips2018_tpu_torch.data.flyingthings3d import (
    FlyingThings3D,
    precompute_disparity_statistics,
)
from practicaldeepstereo_nips2018_tpu_torch.data.kitti import Kitti
from practicaldeepstereo_nips2018_tpu_torch.data.loader import (
    Loader,
    batch_to_device,
)

__all__ = [
    "Dataset",
    "FlyingThings3D",
    "Kitti",
    "Loader",
    "batch_to_device",
    "precompute_disparity_statistics",
]
