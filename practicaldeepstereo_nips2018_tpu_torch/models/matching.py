"""Matching stage: disparity-batched siamese head over the cost volume.

Port of ``practicaldeepstereo_nips2018_tpu/models/matching.py::apply_folded``
without its disparity pairing. Module layout of the reference
``matching.py:69-95``:

    _operation._matching_operation_modules.0   raw 3x3 conv 128 -> 64 (head)
    _operation._matching_operation_modules.1-2 residual blocks (64)
    _operation._matching_operation_modules.3   raw 3x3 conv 64 -> 8 (tail)

The head conv runs factored (``ops/costvolume.py``); the rest is weight-
shared across disparities, so it runs once with disparity folded into the
batch, ``[B * (D+1), 64, H, W]``. Instance norm then normalises per
(batch * disparity, channel) over H, W, as the reference's per-disparity
forward passes do. The JAX package's disparity pairing exists for the TPU's
128-wide lanes and is not carried over.

Two options of the JAX package, both off by default:

* ``factor_conv1``: residual block 1's first conv, the last linear point
  after the head, factors through the shift-assembly like the head
  (``ops/costvolume.py::conv1_volume``). Exact.
* ``tail_int8``: the residual blocks after that point and the tail conv run
  on int8 operands (``ops/int8.py``). Inference only: an approximation
  whose rounding has no gradient.

With ``columns`` the stage runs on this process's W-slice: the cost
volume of its columns (``ops/costvolume.py``), the tail's 3x3 convs with
1-column halos, its norms per (entry, channel) over the whole width, and
the int8 scale's maximum over the volume group.
"""

from __future__ import annotations

import torch
from torch import nn

from practicaldeepstereo_nips2018_tpu_torch.models import blocks
from practicaldeepstereo_nips2018_tpu_torch.ops import costvolume, int8
from practicaldeepstereo_nips2018_tpu_torch.parallel import sharding


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


def _quantized_residual_block(residual: blocks.ResidualBlock,
                              x: torch.Tensor, columns) -> torch.Tensor:
    """A residual block with its two convs on int8 operands; its
    LeakyReLUs and norms as they are."""
    y = x
    for conv, leaky_relu, norm in residual.convolutions:
        y = norm(leaky_relu(int8.quantized_conv(conv.weight, conv.bias, y,
                                                columns)), columns)
    return y + x


class Matching(nn.Module):

    def __init__(self, **operation_kwargs):
        super().__init__()
        self._operation = MatchingOperation(**operation_kwargs)

    def forward(self, left_descriptor: torch.Tensor,
                right_descriptor: torch.Tensor, maximum_disparity: int,
                factor_conv1: bool = False,
                tail_int8: bool = False,
                columns: sharding.ColumnSlice | None = None
                ) -> torch.Tensor:
        """``[B, 64, H, W]`` descriptors, or this process's columns of them
        -> ``[B, D+1, 8, H, W]`` matching signatures for disparities 0 ..
        ``maximum_disparity`` (descriptor resolution), of those columns."""
        head, *residuals, tail = self._operation._matching_operation_modules
        planes = costvolume.matching_head_planes(
            head.weight, head.bias, left_descriptor, right_descriptor,
            maximum_disparity, columns)
        volume = costvolume.shift_accumulate_volume(*planes,
                                                    maximum_disparity)
        if factor_conv1:
            block1, block2 = residuals[0].convolutions
            conv1, leaky_relu, norm = block1
            y = costvolume.conv1_volume(conv1.weight, conv1.bias, planes,
                                        maximum_disparity, columns)
        # The tail needs only the volumes: without autograd the planes'
        # memory is free again before it runs.
        del planes
        batch, disparities, features, height, width = volume.shape
        x = volume.view(batch * disparities, features, height, width)
        if factor_conv1:
            y = norm(leaky_relu(y.view(x.shape[0], -1, height, width)),
                     columns)
            x = x + block2(y, columns)
            residuals = residuals[1:]
        if tail_int8:
            for residual in residuals:
                x = _quantized_residual_block(residual, x, columns)
            x = int8.quantized_conv(tail.weight, tail.bias, x, columns)
        else:
            for residual in residuals:
                x = residual(x, columns)
            x = tail(x, columns)
        return x.view(batch, disparities, x.shape[1], height, width)
