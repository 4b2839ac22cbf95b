"""Disparity error metrics: absolute error and n-pixels error.

Port of ``practicaldeepstereo_nips2018_tpu/ops/errors.py`` (the reference's
``errors.py``). Pixels whose ground truth is ``inf`` are unknown: 0 in the
pixel-wise maps and left out of the averages; with no known pixel the
average is 0.0. Both stay on the tensor's device, with no data-dependent
shape and no host synchronisation.
"""

from __future__ import annotations

import torch


def _zero_like(tensor: torch.Tensor) -> torch.Tensor:
    return torch.zeros((), dtype=tensor.dtype, device=tensor.device)


def absolute_error(estimated_disparity: torch.Tensor,
                   ground_truth_disparity: torch.Tensor,
                   use_mean: bool = True):
    """Returns (pixel-wise absolute error, its mean or median over the
    known pixels)."""
    valid = ~torch.isinf(ground_truth_disparity)
    difference = torch.abs(estimated_disparity - ground_truth_disparity)
    pixelwise = torch.where(valid, difference, _zero_like(difference))
    number_valid = valid.sum()
    if use_mean:
        average = pixelwise.sum() / number_valid.clamp(min=1)
    else:
        # Linear interpolation, as jnp.nanmedian: an even count gives the
        # mean of the two middle values (torch.nanmedian gives the lower).
        average = torch.nanquantile(
            torch.where(valid, difference, float("nan")), 0.5)
    return pixelwise, torch.where(number_valid > 0, average,
                                  _zero_like(average))


def n_pixels_error(estimated_disparity: torch.Tensor,
                   ground_truth_disparity: torch.Tensor, n: float = 3.0):
    """Returns (pixel-wise indicator of ``|est - gt| > n``, strictly, and
    the percentage (x100) of such pixels among the known ones)."""
    valid = ~torch.isinf(ground_truth_disparity)
    difference = torch.abs(estimated_disparity - ground_truth_disparity)
    over_threshold = (difference > n).to(estimated_disparity.dtype)
    pixelwise = torch.where(valid, over_threshold, _zero_like(over_threshold))
    number_valid = valid.sum()
    percentage = 100.0 * pixelwise.sum() / number_valid.clamp(min=1)
    return pixelwise, torch.where(number_valid > 0, percentage,
                                  _zero_like(percentage))
