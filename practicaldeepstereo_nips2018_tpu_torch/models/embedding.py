"""Embedding tower: shared-weight image descriptor network.

Port of ``practicaldeepstereo_nips2018_tpu/models/embedding.py::apply``;
module layout of the reference ``embedding.py:31-44``:

    _embedding_modules.0   InstanceNorm(3), no affine, on the PADDED image
    _embedding_modules.1   5x5 stride-2 conv block (3 -> 64)      # /2
    _embedding_modules.2   5x5 stride-2 conv block (64 -> 64)     # /4
    _embedding_modules.3-4 residual blocks (64)
    _shortcut              3x3 conv block (64 -> 8)

The same module runs on both images; only the left image's shortcut is
used (by the hourglass). With ``s2d_front`` the first conv runs in its
exact space-to-depth form (``ops/spacetodepth.py``), from the same weights.
With ``columns`` every block runs on this process's W-slice
(``models/blocks.py``): the input norm over the whole padded image, the
two 5x5 stride-2 convs with halos of 2 and 1 columns (the space-to-depth
form's 3x3 conv with 1 and 1 at half resolution), the 3x3 convs with 1 and
1.
"""

from __future__ import annotations

import torch
from torch import nn

from practicaldeepstereo_nips2018_tpu_torch.models import blocks
from practicaldeepstereo_nips2018_tpu_torch.ops import spacetodepth
from practicaldeepstereo_nips2018_tpu_torch.parallel import sharding


class Embedding(nn.Module):

    def __init__(self, number_of_input_features: int = 3,
                 number_of_embedding_features: int = 64,
                 number_of_shortcut_features: int = 8,
                 number_of_residual_blocks: int = 2):
        super().__init__()
        features = number_of_embedding_features
        self._embedding_modules = nn.Sequential(
            blocks.InstanceNorm(),
            blocks.conv2d_block(number_of_input_features, features, 5, 2),
            blocks.conv2d_block(features, features, 5, 2),
            *[blocks.ResidualBlock(features)
              for _ in range(number_of_residual_blocks)])
        self._shortcut = blocks.conv2d_block(
            features, number_of_shortcut_features, 3)

    def forward(self, image: torch.Tensor, with_shortcut: bool = True,
                s2d_front: bool = False,
                columns: sharding.ColumnSlice | None = None):
        """``[B, 3, H, W]`` padded image (0..255), or this process's
        columns of it -> descriptor ``[B, 64, H/4, W/4]`` and, if asked
        for, shortcut ``[B, 8, H/4, W/4]`` (else None), of those columns."""
        normalize, first, *rest = self._embedding_modules
        descriptor = normalize(image, columns)
        if s2d_front:
            conv = first[0]
            descriptor = first.tail(spacetodepth.conv5_stride2(
                descriptor, conv.weight, conv.bias, columns), columns)
        else:
            descriptor = first(descriptor, columns)
        for module in rest:
            descriptor = module(descriptor, columns)
        shortcut = (self._shortcut(descriptor, columns) if with_shortcut
                    else None)
        return descriptor, shortcut
