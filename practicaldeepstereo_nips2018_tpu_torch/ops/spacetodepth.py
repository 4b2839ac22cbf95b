"""Space-to-depth execution of the embedding's first convolution.

Port of ``practicaldeepstereo_nips2018_tpu/ops/spacetodepth.py``. The
tower's first layer is a 5x5 stride-2 pad-2 conv of the 3-channel image.
Split into its four 2x2 phases, ``[B, 3, H, W] -> [B, 12, H/2, W/2]``, the
image turns that conv EXACTLY into a 3x3 stride-1 pad-1 conv: the input row
``2y + dy - 2`` is phase ``dy % 2`` of phase-grid row ``y + dy // 2 - 1``,
so tap ``dy`` of the 5x5 kernel becomes tap ``dy // 2`` of phase
``dy % 2`` (``dy = 2 * tap + phase``; tap 2 of phase 1 stays zero). The
even pad keeps the borders exact. H and W must be even, which the network
guarantees: it pads to multiples of 64 first.

Phase channels are ordered ``(py, px, c)``, as in the JAX package, and the
embedded kernel follows that order. The kernel is built from the unchanged
``[64, 3, 5, 5]`` weight at every call, so checkpoints are untouched and
gradients reach the 5x5 weight.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def space_to_depth(x: torch.Tensor) -> torch.Tensor:
    """``[B, C, H, W] -> [B, 4C, H/2, W/2]``; channel order
    ``(py, px, c)``."""
    batch, channels, height, width = x.shape
    phases = x.reshape(batch, channels, height // 2, 2, width // 2, 2)
    phases = phases.permute(0, 3, 5, 1, 2, 4)
    return phases.reshape(batch, 4 * channels, height // 2, width // 2)


def embed_conv5_kernel(weight: torch.Tensor) -> torch.Tensor:
    """``[cout, cin, 5, 5]`` stride-2 pad-2 kernel -> ``[cout, 4 cin, 3,
    3]`` stride-1 pad-1 kernel over the :func:`space_to_depth` image."""
    if tuple(weight.shape[2:]) != (5, 5):
        raise ValueError(f"expected a 5x5 kernel, got {tuple(weight.shape)}")
    cout, cin = weight.shape[:2]
    # dy = 2 * tap + phase for dy in 0..5; dy = 5 is the zero tap.
    taps = F.pad(weight, (0, 1, 0, 1)).reshape(cout, cin, 3, 2, 3, 2)
    return taps.permute(0, 3, 5, 1, 2, 4).reshape(cout, 4 * cin, 3, 3)


def conv5_stride2(x: torch.Tensor, weight: torch.Tensor,
                  bias: torch.Tensor) -> torch.Tensor:
    """The 5x5 stride-2 pad-2 conv of ``x`` ``[B, C, H, W]`` (H, W even),
    run as the 3x3 conv of its phase image, in ``x``'s dtype."""
    kernel = embed_conv5_kernel(weight).to(x.dtype)
    return F.conv2d(space_to_depth(x), kernel, bias.to(x.dtype), padding=1)
