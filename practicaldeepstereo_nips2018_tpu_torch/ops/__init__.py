"""Numerics layer: padding, cost volume, the hand-written kernels (K1 in
``conv3d``, K2 in ``subpixel``, K3 and K4 in ``conv_transpose3d``, K5 in
``block_norm``, K6 in ``batch_norm``), the loss and the error metrics."""

from practicaldeepstereo_nips2018_tpu_torch.ops.conv3d import conv3d_k3s1
from practicaldeepstereo_nips2018_tpu_torch.ops.pad import (
    pad_to_multiple,
    unpad,
)
from practicaldeepstereo_nips2018_tpu_torch.ops.subpixel import subpixel_map

__all__ = ["conv3d_k3s1", "pad_to_multiple", "unpad", "subpixel_map"]
