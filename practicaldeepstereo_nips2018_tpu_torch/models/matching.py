"""Matching stage: disparity-batched siamese head over the cost volume.

Port of ``practicaldeepstereo_nips2018_tpu/models/matching.py::apply`` (the
function of ``apply_folded`` with ``factor_conv1=False, tail_int8=False``).
Module layout of the reference ``matching.py:69-95``:

    _operation._matching_operation_modules.0   raw 3x3 conv 128 -> 64 (head)
    _operation._matching_operation_modules.1-2 residual blocks (64)
    _operation._matching_operation_modules.3   raw 3x3 conv 64 -> 8 (tail)

The head conv runs factored (``ops/costvolume.py``); the rest is weight-
shared across disparities, so it runs once with disparity folded into the
batch, ``[B * (D+1), 64, H, W]``. Instance norm then normalises per
(batch * disparity, channel) over H, W, as the reference's per-disparity
forward passes do. The JAX package's disparity pairing exists for the TPU's
128-wide lanes and is not carried over.
"""

from __future__ import annotations

import torch
from torch import nn

from practicaldeepstereo_nips2018_tpu_torch.models import blocks
from practicaldeepstereo_nips2018_tpu_torch.ops import costvolume


class MatchingOperation(nn.Module):

    def __init__(self, number_of_concatenated_descriptor_features: int = 128,
                 number_of_features: int = 64,
                 number_of_compact_matching_signature_features: int = 8,
                 number_of_residual_blocks: int = 2):
        super().__init__()
        self._matching_operation_modules = nn.ModuleList([
            blocks.Conv2d(number_of_concatenated_descriptor_features,
                          number_of_features, 3, 1, 1),
            *[blocks.ResidualBlock(number_of_features)
              for _ in range(number_of_residual_blocks)],
            blocks.Conv2d(number_of_features,
                          number_of_compact_matching_signature_features,
                          3, 1, 1),
        ])


class Matching(nn.Module):

    def __init__(self, **operation_kwargs):
        super().__init__()
        self._operation = MatchingOperation(**operation_kwargs)

    def forward(self, left_descriptor: torch.Tensor,
                right_descriptor: torch.Tensor,
                maximum_disparity: int) -> torch.Tensor:
        """``[B, 64, H, W]`` descriptors -> ``[B, D+1, 8, H, W]`` matching
        signatures for disparities 0 .. ``maximum_disparity`` (descriptor
        resolution)."""
        head, *residuals, tail = self._operation._matching_operation_modules
        volume = costvolume.build_cost_volume(
            head.weight, head.bias, left_descriptor, right_descriptor,
            maximum_disparity)
        batch, disparities, features, height, width = volume.shape
        x = volume.view(batch * disparities, features, height, width)
        for residual in residuals:
            x = residual(x)
        x = tail(x)
        return x.view(batch, disparities, x.shape[1], height, width)
