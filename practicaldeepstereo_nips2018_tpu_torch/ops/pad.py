"""Size adaptation: pad images to the network's minimum-size grid.

Port of ``practicaldeepstereo_nips2018_tpu/ops/pad.py`` for channels-first
tensors. The network takes heights and widths that are multiples of 64; the
reference zero-pads on the **top and left** (``size_adapter.py:42-43``) and
crops the same rows and columns off the output. The asymmetry is
load-bearing: the matching stage shifts the right image rightwards, so the
left-column padding meets the disparity-0 boundary.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _ceil_to_multiple(size: int, multiple: int) -> int:
    return -(-size // multiple) * multiple


def pad_amounts(height: int, width: int, multiple: int = 64) -> tuple[int, int]:
    """Returns (pad_h, pad_w) needed to reach the next multiple of `multiple`."""
    return (_ceil_to_multiple(height, multiple) - height,
            _ceil_to_multiple(width, multiple) - width)


def pad_to_multiple(image: torch.Tensor, multiple: int = 64) -> torch.Tensor:
    """Zero-pads the top and left of a ``[..., H, W]`` tensor to a multiple."""
    pad_h, pad_w = pad_amounts(image.shape[-2], image.shape[-1], multiple)
    if pad_h == 0 and pad_w == 0:
        return image
    return F.pad(image, (pad_w, 0, pad_h, 0))


def unpad(output: torch.Tensor, original_height: int, original_width: int,
          spatial_axes: tuple[int, int] = (-2, -1)) -> torch.Tensor:
    """Crops a padded output back to the original size (a view).

    Drops the first ``pad_h`` rows and ``pad_w`` columns, the inverse of
    :func:`pad_to_multiple` (reference ``size_adapter.py:45-52``).
    """
    axis_h = spatial_axes[0] % output.ndim
    axis_w = spatial_axes[1] % output.ndim
    pad_h = output.shape[axis_h] - original_height
    pad_w = output.shape[axis_w] - original_width
    return output.narrow(axis_h, pad_h, original_height).narrow(
        axis_w, pad_w, original_width)


def pad_top_right(image: torch.Tensor, multiple: int) -> torch.Tensor:
    """Zero-pads the top and right of a ``[..., H, W]`` tensor to a
    multiple, as PSMNet's published test scripts pad (``Test_img.py``,
    ``submission.py``); :func:`unpad_top_right` crops it back."""
    pad_h, pad_w = pad_amounts(image.shape[-2], image.shape[-1], multiple)
    if pad_h == 0 and pad_w == 0:
        return image
    return F.pad(image, (0, pad_w, pad_h, 0))


def unpad_top_right(output: torch.Tensor, original_height: int,
                    original_width: int) -> torch.Tensor:
    """Crops a ``[..., H', W']`` output of a :func:`pad_top_right` input
    back to ``original_height`` x ``original_width`` (a view)."""
    pad_h = output.shape[-2] - original_height
    return output[..., pad_h:, :original_width]
